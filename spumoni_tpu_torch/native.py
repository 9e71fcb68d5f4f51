"""ctypes bindings for the native index builder / CPU query engine.

The C++ library (native/spumoni_native.cpp) replaces the reference's popen'd
helper executables (Big-BWT, pfp_thresholds — src/spumoni.cpp:442-545)
with an in-process build, and provides the multithreaded CPU query baseline.
This package's csrc/minimizers.cpp adds the minimizer digestion, and
csrc/values_writer.cpp the batch pass of the value files.

The shared object is compiled on demand with g++ from the repository's one
copy of the shared source (both packages build byte-identical index files
from it) and this package's two, linked after it, and cached in this
package's `_build/`, keyed by a hash of the three sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
_SOURCES = (os.path.join(_REPO, "native", "spumoni_native.cpp"),
            os.path.join(_HERE, "csrc", "minimizers.cpp"),
            os.path.join(_HERE, "csrc", "values_writer.cpp"))
_BUILD_DIR = os.path.join(_HERE, "_build")

_lock = threading.Lock()
_lib = None


def _compile() -> str:
    h = hashlib.sha256()
    for path in _SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libspumoni_native_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        "-march=native", "-funroll-loops", *_SOURCES, "-o", tmp,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so_path)
    return so_path


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_compile())
            c_i64 = ctypes.c_int64
            p_i64 = ctypes.POINTER(ctypes.c_int64)
            p_u8 = ctypes.POINTER(ctypes.c_uint8)
            lib.spn_suffix_array.restype = ctypes.c_int
            lib.spn_suffix_array.argtypes = [p_u8, c_i64, p_i64]
            lib.spn_build.restype = ctypes.c_void_p
            lib.spn_build.argtypes = [p_u8, c_i64]
            lib.spn_num_runs.restype = c_i64
            lib.spn_num_runs.argtypes = [ctypes.c_void_p]
            lib.spn_bwt_len.restype = c_i64
            lib.spn_bwt_len.argtypes = [ctypes.c_void_p]
            for name in ("spn_get_run_starts", "spn_get_thresholds",
                         "spn_get_samples_start", "spn_get_samples_last"):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, p_i64]
            lib.spn_get_run_heads.restype = None
            lib.spn_get_run_heads.argtypes = [ctypes.c_void_p, p_u8]
            lib.spn_free.restype = None
            lib.spn_free.argtypes = [ctypes.c_void_p]
            lib.spn_query_new.restype = ctypes.c_void_p
            lib.spn_query_new.argtypes = [c_i64, c_i64, p_u8, p_i64, p_i64,
                                          p_i64, p_i64, p_i64, p_i64, p_u8, c_i64]
            lib.spn_query_free.restype = None
            lib.spn_query_free.argtypes = [ctypes.c_void_p]
            lib.spn_query_pml_batch.restype = None
            lib.spn_query_pml_batch.argtypes = [ctypes.c_void_p, p_u8, p_i64,
                                                c_i64, p_i64, p_i64, ctypes.c_int]
            lib.spn_query_ms_batch.restype = None
            lib.spn_query_ms_batch.argtypes = [ctypes.c_void_p, p_u8, p_i64,
                                               c_i64, p_i64, p_i64, p_i64,
                                               ctypes.c_int]
            p_i32 = ctypes.POINTER(ctypes.c_int32)
            lib.spn_pfp_parse.restype = ctypes.c_void_p
            lib.spn_pfp_parse.argtypes = [p_u8, c_i64, ctypes.c_int,
                                          ctypes.c_int]
            for name in ("spn_parse_num_phrases", "spn_parse_len",
                         "spn_parse_dict_bytes"):
                fn = getattr(lib, name)
                fn.restype = c_i64
                fn.argtypes = [ctypes.c_void_p]
            lib.spn_parse_get_dict.restype = None
            lib.spn_parse_get_dict.argtypes = [ctypes.c_void_p, p_u8]
            lib.spn_parse_get_offsets.restype = None
            lib.spn_parse_get_offsets.argtypes = [ctypes.c_void_p, p_i64,
                                                  p_i64, p_i64]
            lib.spn_parse_get_parse.restype = None
            lib.spn_parse_get_parse.argtypes = [ctypes.c_void_p, p_i32]
            lib.spn_parse_free.restype = None
            lib.spn_parse_free.argtypes = [ctypes.c_void_p]
            lib.spn_build_pfp.restype = ctypes.c_void_p
            lib.spn_build_pfp.argtypes = [p_u8, c_i64, ctypes.c_int,
                                          ctypes.c_int]
            lib.spn_build_pfp_mt.restype = ctypes.c_void_p
            lib.spn_build_pfp_mt.argtypes = [p_u8, c_i64, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int]
            lib.spn_format_values.restype = c_i64
            lib.spn_format_values.argtypes = [p_i64, c_i64,
                                              ctypes.c_char_p]
            lib.spn_lcp_dbg_len.restype = c_i64
            lib.spn_lcp_dbg_len.argtypes = [ctypes.c_void_p]
            lib.spn_get_lcp_dbg.restype = None
            lib.spn_get_lcp_dbg.argtypes = [ctypes.c_void_p, p_i64]
            lib.spn_fastx_extract.restype = c_i64
            lib.spn_fastx_extract.argtypes = [p_u8, c_i64, ctypes.c_int,
                                              ctypes.c_int, p_u8, p_i64,
                                              p_i64]
            p_i32 = ctypes.POINTER(ctypes.c_int32)
            lib.spn_pack_rows.restype = c_i64
            lib.spn_pack_rows.argtypes = [p_u8, p_i64, p_i64, c_i64, c_i64,
                                          p_u8, ctypes.c_int, ctypes.c_int,
                                          p_u8, p_u8, p_i32, c_i64,
                                          ctypes.c_int]
            lib.spn_digest_reads.restype = c_i64
            lib.spn_digest_reads.argtypes = [p_u8, p_i64, c_i64, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int, p_u8,
                                             p_i64, p_u8, c_i64, p_i64]
            lib.spn_format_records.restype = c_i64
            lib.spn_format_records.argtypes = [p_i64, p_i64, c_i64,
                                               ctypes.c_int, p_u8, p_i64,
                                               p_u8, c_i64, p_i64, c_i64,
                                               c_i64, p_i64, p_i64, p_i64]
            _lib = lib
    return _lib


def fastx_extract(data: np.ndarray, fastq: bool, upper: bool = False):
    """One-pass native parse of a chunk of complete FASTX records: returns
    (seq_bytes, offs, idpos) — see spn_fastx_extract. upper folds the
    per-read toupper of the classify loop (compute_ms_pml.cpp:917) into the
    same pass."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    seq = np.empty(n, dtype=np.uint8)
    # Size the record-indexed outputs by a TIGHT record-count bound, not
    # n//4: degenerate records are as small as 2 bytes ('>\n'), so n//4
    # under-allocates up to 2x and the native writer (offs[nr+1],
    # idpos[2nr+1]) corrupts the heap. FASTA records each consume exactly
    # one '>' byte (the sequence scan stops at '>'), so count('>') bounds
    # nr; FASTQ records are >= 5 bytes ('@\n\n+\n' with an unterminated
    # empty quality line), plus 1 for a trailing partial the parser touches
    # before rejecting.
    if fastq:
        nmax = n // 5 + 2
    else:
        nmax = int(np.count_nonzero(data == ord(">"))) + 2
    offs = np.empty(nmax + 1, dtype=np.int64)
    idpos = np.empty(2 * nmax + 2, dtype=np.int64)
    nr = get_lib().spn_fastx_extract(_p_u8(data), n, int(fastq), int(upper),
                                     _p_u8(seq), _p_i64(offs), _p_i64(idpos))
    if nr < 0:
        raise ValueError("malformed FASTA/FASTQ chunk")
    offs = offs[:nr + 1]
    return seq[:offs[-1]].copy(), offs.copy(), idpos[:2 * nr].copy()


def digest_reads(buf: np.ndarray, offs: np.ndarray, dna: bool, k: int,
                 w: int, hash4: np.ndarray):
    """Minimizer digest of every read buf[offs[r]:offs[r+1]] in one native
    pass per read (csrc/minimizers.cpp): the DNA-letter scheme if dna,
    else the promotion scheme over the 4-entry CyclicHash table hash4.
    Returns (digested bytes, their int64 offsets)."""
    if k < 1:
        raise ValueError(f"minimizer k must be >= 1, got {k}")
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    nreads = len(offs) - 1
    # a read emits at most one minimizer per k-mer, of k bytes under -a
    nk = np.maximum(np.diff(offs) - (k - 1), 0)
    cap = int(nk.sum()) * (k if dna else 1)
    scratch = np.empty(int(nk.max()) if nreads else 0, dtype=np.int64)
    out = np.empty(cap, dtype=np.uint8)
    out_offs = np.empty(nreads + 1, dtype=np.int64)
    n = get_lib().spn_digest_reads(
        _p_u8(buf), _p_i64(offs), nreads, int(dna), int(k), int(w),
        _p_u8(np.ascontiguousarray(hash4, dtype=np.uint8)), _p_i64(scratch),
        _p_u8(out), cap, _p_i64(out_offs))
    if n < 0:
        raise RuntimeError(f"spn_digest_reads failed ({n})")
    return out[:n], out_offs


def format_records(addrs: np.ndarray, counts: np.ndarray, itemsize: int,
                   id_blob: np.ndarray, id_offs: np.ndarray, out: np.ndarray,
                   state: np.ndarray, bins=None, res=None) -> int:
    """One call of the value files' batch pass (csrc/values_writer.cpp):
    formats the records of reads state[0].. (row addresses, value counts,
    int32 or int64 by itemsize; ids as bytes and int64 offsets) into out,
    from the state the last call left, and leaves its own there. With bins
    = (bin_width, max_value_thr), fills res = (above, below, sum_maxes)
    for each read it starts. Returns the bytes written."""
    width, thr = bins if bins is not None else (0, 0)
    above, below, sums = (_p_i64(a) for a in res) if res is not None \
        else (None, None, None)
    m = get_lib().spn_format_records(
        _p_i64(addrs), _p_i64(counts), len(counts), int(itemsize),
        _p_u8(id_blob), _p_i64(id_offs), _p_u8(out), len(out), _p_i64(state),
        int(width), int(thr), above, below, sums)
    if m < 0:
        raise RuntimeError(f"spn_format_records failed ({m})")
    return m


_AMAP2_NONE = np.full(256, 255, dtype=np.uint8)


def pack_rows_native(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                     B: int, L: int, amap: np.ndarray, reverse: bool,
                     bits: int = 8, amap2: np.ndarray | None = None,
                     threads: int = 0):
    """[B, L*bits/8] packed, optionally-reversed, amap-mapped rows for the
    reads at buf[starts[r]:ends[r]].

    Returns (matrix, miss, exc) where miss means a byte hit amap sentinel
    255 (extend the alphabet and retry), and exc is the [k, 3] int32
    (row, col, value) exception list of the 2-bit mode (positions whose
    byte is not in amap2) — None when bits != 2 or on exception overflow
    (caller falls back to bits=4)."""
    nsel = len(starts)
    rowbytes = {8: L, 4: L // 2, 2: L // 4}[bits]
    out = np.zeros((B, rowbytes), dtype=np.uint8)
    if threads <= 0:
        threads = os.cpu_count() or 1
    cap = max(1024, (B * L) // 64)
    exc = np.empty((cap, 3), dtype=np.int32) if bits == 2 else \
        np.empty((1, 3), dtype=np.int32)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    rc = get_lib().spn_pack_rows(
        _p_u8(np.ascontiguousarray(buf)),
        _p_i64(np.ascontiguousarray(starts)),
        _p_i64(np.ascontiguousarray(ends)),
        nsel, L, _p_u8(np.ascontiguousarray(amap)), int(reverse),
        int(bits), _p_u8(out),
        _p_u8(amap2 if amap2 is not None else _AMAP2_NONE),
        exc.ctypes.data_as(p_i32), cap if bits == 2 else 0, threads)
    if rc == -2:
        return out, True, None
    if rc == -1:
        return out, False, None   # exception overflow: use bits=4
    return out, False, (exc[:rc].copy() if bits == 2 else None)


def _p_u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _p_i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of text + implicit sentinel (len(text)+1 entries)."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    sa = np.empty(n + 1, dtype=np.int64)
    rc = get_lib().spn_suffix_array(_p_u8(text), n, _p_i64(sa))
    if rc != 0:
        raise ValueError("text must not contain 0 bytes")
    return sa


class RawIndex:
    """Raw builder outputs: RLBWT runs, thresholds, SA samples.

    n is the BWT length (text length + 1 for the terminator). Samples are raw
    SA values; downstream applies the (sa-1) mod n convention of the reference
    (compute_ms_pml.cpp:431-434).
    """

    def __init__(self, n, run_heads, run_starts, thresholds,
                 samples_start, samples_last):
        self.n = int(n)
        self.r = len(run_heads)
        self.run_heads = run_heads
        self.run_starts = run_starts
        self.thresholds = thresholds
        self.samples_start = samples_start
        self.samples_last = samples_last


# Above roughly this text length, in-memory SA-IS construction (~13 B/char
# peak on the 32-bit path, ~26 B/char past 2^31) stops being the right tool;
# the PFP path builds identical output in O(parse + dict) working memory.
PFP_AUTO_THRESHOLD = 800_000_000


def build_raw_index(text: np.ndarray, method: str = "auto",
                    w: int = 10, mod: int = 100,
                    threads: int | None = None) -> RawIndex:
    """Builds the RLBWT + thresholds + SA samples for `text` (uint8, no 0/1
    bytes).

    method: 'sais' (in-memory suffix array), 'pfp' (prefix-free-parsing
    induction, O(parse+dict) memory, requires text bytes >= 3), or 'auto'
    (pfp above PFP_AUTO_THRESHOLD when the byte range allows).
    threads: PFP build parallelism (dict-SA overlap + segmented class sweep
    with seam stitching; output is byte-identical at any count). Defaults to
    the machine's core count; SPN_BUILD_THREADS overrides."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    lib = get_lib()
    if method == "auto":
        method = ("pfp" if len(text) > PFP_AUTO_THRESHOLD
                  and len(text) > 0 and int(text.min()) >= 3 else "sais")
    if method == "pfp":
        if threads is None:
            threads = int(os.environ.get("SPN_BUILD_THREADS",
                                         os.cpu_count() or 1))
        h = lib.spn_build_pfp_mt(_p_u8(text), len(text), int(w), int(mod),
                                 int(max(1, threads)))
        if not h:
            raise ValueError("pfp build requires text bytes >= 3 and "
                             "len(text) > w")
    else:
        h = lib.spn_build(_p_u8(text), len(text))
    if not h:
        raise ValueError("text must not contain bytes <= 1 "
                         "(reserved for the BWT terminator)")
    try:
        r = lib.spn_num_runs(h)
        n = lib.spn_bwt_len(h)
        run_heads = np.empty(r, dtype=np.uint8)
        run_starts = np.empty(r, dtype=np.int64)
        thresholds = np.empty(r, dtype=np.int64)
        samples_start = np.empty(r, dtype=np.int64)
        samples_last = np.empty(r, dtype=np.int64)
        lib.spn_get_run_heads(h, _p_u8(run_heads))
        lib.spn_get_run_starts(h, _p_i64(run_starts))
        lib.spn_get_thresholds(h, _p_i64(thresholds))
        lib.spn_get_samples_start(h, _p_i64(samples_start))
        lib.spn_get_samples_last(h, _p_i64(samples_last))
    finally:
        lib.spn_free(h)
    return RawIndex(n, run_heads, run_starts, thresholds,
                    samples_start, samples_last)


class PfpParse:
    """Prefix-free parse of a text: sorted dictionary + 1-based lex-rank
    parse, the file contract of Big-BWT's newscan.x (SURVEY.md §2.3).

    dict_concat follows the reference's on-disk .dict format: phrases in lex
    order, EndOfWord=1 after each, EndOfDict=0 at the end
    (include/common.hpp:54-56)."""

    def __init__(self, dict_concat, dict_off, dict_len, occ, parse, w, mod):
        self.dict_concat = dict_concat
        self.dict_off = dict_off
        self.dict_len = dict_len
        self.occ = occ
        self.parse = parse
        self.w = w
        self.mod = mod

    @property
    def num_phrases(self) -> int:
        return len(self.dict_off)

    def phrase(self, rank: int) -> bytes:
        o, l = int(self.dict_off[rank]), int(self.dict_len[rank])
        return self.dict_concat[o:o + l].tobytes()

    def reconstruct(self) -> bytes:
        """Inverse of the parsing: Dollar ++ text ++ Dollar^w."""
        parts = [self.phrase(self.parse[0] - 1)]
        for pid in self.parse[1:]:
            parts.append(self.phrase(int(pid) - 1)[self.w:])
        return b"".join(parts)

    def save(self, prefix: str) -> None:
        """Writes <prefix>.parse (4-byte ids) and <prefix>.dict, the formats
        Big-BWT emits and the reference's build consumes
        (src/spumoni.cpp:442-472)."""
        self.parse.astype(np.int32).tofile(prefix + ".parse")
        self.dict_concat.tofile(prefix + ".dict")
        self.occ.astype(np.int32).tofile(prefix + ".occ")

    def save_dicz(self, prefix: str) -> None:
        """compress_dictionary's exact transformation
        (src/compress_dictionary.cpp:100-167): strips the
        w-char trigger suffix from each lex-ordered phrase into
        <prefix>.dicz (+ 4-byte lengths in .dicz.len). The EMPTY FIRST
        PHRASE case — the lex-smallest phrase is exactly one trigger string,
        so it vanishes after stripping — skips that phrase and rewrites
        <prefix>.parse with every id shifted down by one (the old parse is
        kept as .parse_with_empty_phrase, mirroring the reference's mv)."""
        import os

        w = self.w
        comp = np.asarray(self.dict_len, dtype=np.int64) - w
        empty_first = len(comp) > 0 and comp[0] == 0
        if (comp[1:] <= 0).any() or (len(comp) > 0 and not empty_first
                                     and comp[0] < 0):
            raise ValueError("length<=0 phrase after removing the trigger "
                             "string (only the first may be empty)")
        start = 1 if empty_first else 0
        with open(prefix + ".dicz", "wb") as dz, \
                open(prefix + ".dicz.len", "wb") as dl:
            for i in range(start, len(comp)):
                o = int(self.dict_off[i])
                dz.write(self.dict_concat[o:o + int(comp[i])].tobytes())
            comp[start:].astype("<i4").tofile(dl)
        if empty_first:
            parse = np.asarray(self.parse, dtype=np.int64)
            # the empty phrase is lex-smallest (id 1) and opens the text
            assert parse[0] == 1, "parse should begin with the lowest " \
                                  "lexicographic phrase"
            assert (parse[1:] > 1).all(), "empty phrase must occur once"
            if os.path.exists(prefix + ".parse"):
                os.replace(prefix + ".parse",
                           prefix + ".parse_with_empty_phrase")
            (parse[1:] - 1).astype("<i4").tofile(prefix + ".parse")


def pfp_parse(text: np.ndarray, w: int = 10, mod: int = 100) -> PfpParse:
    """Prefix-free parsing of `text` (uint8; bytes must be >= 3, the PFP
    special range) with window w and modulus `mod` — the defaults of
    include/spumoni_main.hpp:139-140."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    lib = get_lib()
    h = lib.spn_pfp_parse(_p_u8(text), len(text), int(w), int(mod))
    if not h:
        raise ValueError("pfp_parse failed")
    try:
        d = lib.spn_parse_num_phrases(h)
        k = lib.spn_parse_len(h)
        db = lib.spn_parse_dict_bytes(h)
        dict_concat = np.empty(db, dtype=np.uint8)
        off = np.empty(d, dtype=np.int64)
        ln = np.empty(d, dtype=np.int64)
        occ = np.empty(d, dtype=np.int64)
        parse = np.empty(k, dtype=np.int32)
        lib.spn_parse_get_dict(h, _p_u8(dict_concat))
        lib.spn_parse_get_offsets(h, _p_i64(off), _p_i64(ln), _p_i64(occ))
        lib.spn_parse_get_parse(
            h, parse.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.spn_parse_free(h)
    return PfpParse(dict_concat, off, ln, occ, parse, w, mod)


class NativeQueryEngine:
    """Multithreaded CPU MS/PML query engine over the dense run tables.

    Mirrors the reference hot loops exactly; used both as the measured CPU
    baseline and as the oracle for the JAX/TPU engines.
    """

    def __init__(self, n, run_heads, run_starts, thresholds, samples_start,
                 samples_last, start_doc=None, end_doc=None, text=None):
        self._lib = get_lib()
        self._keep = []  # keep buffers alive for the C side

        def hold(a, dt):
            a = np.ascontiguousarray(a, dtype=dt)
            self._keep.append(a)
            return a

        run_heads = hold(run_heads, np.uint8)
        run_starts = hold(run_starts, np.int64)
        thresholds = hold(thresholds, np.int64)
        samples_start = hold(samples_start, np.int64)
        samples_last = hold(samples_last, np.int64)
        sdoc = edoc = None
        if start_doc is not None and end_doc is not None:
            sdoc = _p_i64(hold(start_doc, np.int64))
            edoc = _p_i64(hold(end_doc, np.int64))
        tptr, tlen = None, 0
        if text is not None:
            text = hold(text, np.uint8)
            tptr, tlen = _p_u8(text), len(text)
        self._h = self._lib.spn_query_new(
            int(n), len(run_heads), _p_u8(run_heads), _p_i64(run_starts),
            _p_i64(thresholds), _p_i64(samples_start), _p_i64(samples_last),
            sdoc, edoc, tptr, tlen)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.spn_query_free(h)
            self._h = None

    @staticmethod
    def _pack(reads):
        offsets = np.zeros(len(reads) + 1, dtype=np.int64)
        for i, rd in enumerate(reads):
            offsets[i + 1] = offsets[i] + len(rd)
        flat = np.empty(offsets[-1], dtype=np.uint8)
        for i, rd in enumerate(reads):
            flat[offsets[i]:offsets[i + 1]] = np.frombuffer(
                rd if isinstance(rd, (bytes, bytearray)) else bytes(rd), np.uint8)
        return flat, offsets

    def query_pml(self, reads, with_docs=False, threads=1):
        flat, offsets = self._pack(reads)
        out = np.empty(offsets[-1], dtype=np.int64)
        docs = np.empty(offsets[-1], dtype=np.int64) if with_docs else None
        self._lib.spn_query_pml_batch(
            self._h, _p_u8(flat), _p_i64(offsets), len(reads), _p_i64(out),
            _p_i64(docs) if with_docs else None, int(threads))
        lengths = [out[offsets[i]:offsets[i + 1]].copy() for i in range(len(reads))]
        if with_docs:
            dlist = [docs[offsets[i]:offsets[i + 1]].copy() for i in range(len(reads))]
            return lengths, dlist
        return lengths

    def query_ms(self, reads, with_docs=False, with_lengths=True, threads=1):
        flat, offsets = self._pack(reads)
        ptrs = np.empty(offsets[-1], dtype=np.int64)
        lens = np.empty(offsets[-1], dtype=np.int64) if with_lengths else None
        docs = np.empty(offsets[-1], dtype=np.int64) if with_docs else None
        self._lib.spn_query_ms_batch(
            self._h, _p_u8(flat), _p_i64(offsets), len(reads), _p_i64(ptrs),
            _p_i64(lens) if with_lengths else None,
            _p_i64(docs) if with_docs else None, int(threads))
        sl = lambda a: [a[offsets[i]:offsets[i + 1]].copy() for i in range(len(reads))]
        res = [sl(ptrs)]
        if with_lengths:
            res.append(sl(lens))
        if with_docs:
            res.append(sl(docs))
        return tuple(res) if len(res) > 1 else res[0]


def format_values(values: np.ndarray) -> bytes:
    """Decimal 'v v v ' text of an int array via the native formatter —
    byte-identical to the per-value Python path (negative values print as
    unsigned 64-bit, the reference's size_t underflow) at C speed; the
    value-file writers are otherwise the end-to-end bottleneck."""
    v = np.ascontiguousarray(values, dtype=np.int64)
    if v.size == 0:
        return b""
    out = ctypes.create_string_buffer(21 * v.size)
    m = get_lib().spn_format_values(_p_i64(v), v.size, out)
    return out.raw[:m]
