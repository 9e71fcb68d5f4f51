"""Block-bits index (engine v4 layout) for the PyTorch port.

Host side of `spumoni_tpu/engine/blockbits.py`: the row build, the
content-keyed `.bbrows.npz` cache (byte-compatible: a cache written by
either package serves the other), and the assembly into torch state. The
layout, one row per P BWT positions, is

    cp slots      F-space occ checkpoints per packed char code
                  (cp[code] = F[char] + occ(char, block_start)); in wide mode
                  (n >= 2^31) the u32 low word, with the high byte packed
                  into the H0 words at the end of the row
    char words    the block's characters, 2- or 4-bit codes
    bit words     up-bits: bit (c, pos) = pos < thr_next(c, pos)

so one backward PML step needs one row: bwt[pos], F[c] + rank(pos, c),
`has_next` and the up/down bit (see the JAX module's docstring for the
derivation from compute_ms_pml.cpp:237-286).

`pml_probe` is the plain PyTorch step; the CUDA kernels in
`csrc/blockbits_pml.cuh` compute the same function per thread.

MS and document tracking (the JAX package's v4-MS engine) add a side row
per block, `msrows`: per code slot a char-local run-rank checkpoint and P/32
words of run-start bits. `ms_probe` turns one step into a jump id (2*run,
+1 for a jump up; EMPTY = 2r, INIT = 2r+1), and the jump tables `jump_t`
(SA samples) and `jump_d` (doc ids) turn jump ids into values.

`pick_P` and `ROW_CLIFF` are the JAX package's TPU gather-cliff tuning,
kept unchanged so both packages pick the same P and share row caches.
"""

from __future__ import annotations

import hashlib
import math
import os
import zipfile
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import trace
from ..utils import present_chars

MAX_SIGMA = 15   # query-rank code of a character absent from the index
MAX_SIGMA4 = 8   # pack=4: 8 cp slots
MAX_SIGMA2 = 4   # pack=2: 4 cp slots (+ aliased terminator)
TERM_BYTE = 1    # coerced BWT terminator (ms_rle_string.hpp:21,66-68)
TERM_CODE = 14   # query-rank code for "the terminator character"
ROW_CLIFF = 1 << 17
_BB_CACHE_VERSION = 1


def _pack_of(idx) -> Optional[int]:
    cnt = np.asarray(idx.cnt)
    chars = np.nonzero(cnt)[0]
    real = [c for c in chars if c != TERM_BYTE]
    if len(real) <= MAX_SIGMA2 and cnt[TERM_BYTE] <= 1:
        return 2
    if len(chars) <= MAX_SIGMA4:
        return 4
    return None


def _width(P: int, pack: int, wide: bool = False) -> int:
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4
    nhw = -(-nslots // 4) if wide else 0   # packed checkpoint-high bytes
    if pack == 2:
        return nslots + P // 16 + nslots * (P // 32) + nhw
    return nslots + P // 8 + nslots * (P // 32) + nhw


def _ms_width(P: int, pack: int) -> int:
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4
    return nslots * (1 + P // 32)


def pick_P(n: int, pack: int, over_cliff: bool = False,
           wide: bool = False) -> Optional[int]:
    """The JAX package's block-size choice: the largest P whose row is at
    most 256 B (else 512 B) with at most ROW_CLIFF rows; past the cliff,
    the largest P whose row fits 512 B."""
    best = None
    for cap in (256, 512):
        for P in (64, 128, 256, 512):
            if -(-n // P) > ROW_CLIFF:
                continue
            if _width(P, pack, wide) * 4 > cap:
                continue
            best = P
        if best is not None:
            break
    if best is None and over_cliff:
        for P in (512, 256, 128, 64):
            if _width(P, pack, wide) * 4 <= 512:
                return P
    return best


def eligible_any(idx) -> bool:
    """True when the block-bits layout holds the index: at most 8 BWT
    characters and positions under 2^40 (the reference's SSABYTES=5
    addressing limit, include/spumoni_main.hpp:60)."""
    return _pack_of(idx) is not None and int(idx.n) < 2**40


# ---------------------------------------------------------------------------
# the .bbrows.npz cache (same key and manifest as the JAX package)
# ---------------------------------------------------------------------------

def _bb_cache_key(idx, P: int, pack: int, wide: bool) -> np.ndarray:
    """Cheap content fingerprint: shape scalars + sampled run/threshold
    values. Strong enough to catch a changed index at the same path."""
    r = int(idx.run_starts.shape[0])
    h = hashlib.sha256()
    for a in (idx.run_heads, idx.run_starts, idx.c_thr):
        s = np.ascontiguousarray(np.asarray(a)[:: max(1, r // 4096)])
        h.update(s.tobytes())
    dig = np.frombuffer(h.digest()[:16], dtype=np.int64)
    return np.concatenate([
        np.asarray([_BB_CACHE_VERSION, int(idx.n), r, P, pack, int(wide)],
                   dtype=np.int64), dig])


def _manifest_arrays(idx, src_path: Optional[str]) -> dict:
    """O(sigma) scalars stored beside the cached rows, so a later run can
    assemble the index without loading the dense index npz. m_stat pins
    the source index file (size, mtime_ns)."""
    cnt = np.asarray(idx.cnt, dtype=np.int64)
    term_pos = -1
    if cnt[TERM_BYTE]:
        run_heads = np.asarray(idx.run_heads, dtype=np.uint8)
        run_starts = np.asarray(idx.run_starts, dtype=np.int64)
        term_pos = int(run_starts[np.nonzero(run_heads == TERM_BYTE)[0][0]])
    stat = np.asarray([-1, -1], dtype=np.int64)
    if src_path is not None:
        try:
            st = os.stat(src_path)
            stat = np.asarray([st.st_size, st.st_mtime_ns], dtype=np.int64)
        except OSError:
            pass
    return dict(
        m_stat=stat,
        m_cnt=cnt,
        m_F=np.asarray(idx.F, dtype=np.int64),
        m_char_off=np.asarray(idx.char_off, dtype=np.int64),
        m_scalars=np.asarray([int(idx.last_run_sample),
                              int(idx.first_run_sdoc),
                              int(idx.last_run_edoc), term_pos],
                             dtype=np.int64))


class _CacheShim:
    """Stand-in for DenseIndex built from the cache manifest: exactly the
    fields the assembly reads on the PML path."""

    def __init__(self, d, n: int, r: int):
        self.n, self.r = n, r
        self.cnt = d["m_cnt"]
        self.F = d["m_F"]
        self.char_off = d["m_char_off"]
        term_pos = int(d["m_scalars"][3])
        self.run_heads = np.asarray([TERM_BYTE], dtype=np.uint8)
        self.run_starts = np.asarray([max(term_pos, 0)], dtype=np.int64)


#: what reading a cache file that is truncated, foreign or half-written raises
_CACHE_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile)


def _write_cache(cache_path: str, key: np.ndarray, rows: np.ndarray, idx,
                 src_path: Optional[str]) -> None:
    # pid-unique temporary: concurrent processes may race on one cache
    tmp = f"{cache_path}.tmp{os.getpid()}.npz"
    np.savez(tmp, key=key, rows=rows, **_manifest_arrays(idx, src_path))
    os.replace(tmp, cache_path)


def load_cached(cache_path: str, src_path: str, max_bytes=None):
    """Fast start: (BlockBitsIndex, CharTable, n, r) straight from the rows
    cache, skipping the dense index. None when the cache is absent,
    pre-manifest, stale against the index file's (size, mtime_ns), of
    another cache version, or larger than max_bytes."""
    if not os.path.exists(cache_path):
        return None
    try:
        d = np.load(cache_path)
        if "m_stat" not in d.files:
            return None
        st = os.stat(src_path)
        m_stat = d["m_stat"]
        if int(m_stat[0]) != st.st_size or int(m_stat[1]) != st.st_mtime_ns:
            return None
        version, n, r, P, pack, wide = (int(x) for x in d["key"][:6])
        if version != _BB_CACHE_VERSION:
            return None
        nb = -(-n // P)
        if max_bytes is not None and nb * _width(P, pack, bool(wide)) * 4 \
                > max_bytes:
            return None
        shim, rows = _CacheShim(d, n, r), d["rows"]
    except _CACHE_ERRORS:   # unreadable or foreign cache: no fast start
        return None
    index, table = _assemble(shim, rows, P, pack, bool(wide))
    return index, table, n, r


# ---------------------------------------------------------------------------
# row build
# ---------------------------------------------------------------------------

def build_blockbits(idx, P: Optional[int] = None, pack: Optional[int] = None,
                    wide: Optional[bool] = None,
                    cache_path: Optional[str] = None,
                    src_path: Optional[str] = None,
                    want_ms: bool = False, want_doc: bool = False,
                    ms_cache_path: Optional[str] = None):
    """DenseIndex -> (BlockBitsIndex on the CPU, CharTable).

    wide=True (automatic past 2^31 positions) selects the split-checkpoint
    row layout and int64 positions. cache_path: .npz of the packed rows,
    keyed by index content; src_path: the index file the cache manifest
    pins for `load_cached`. want_ms / want_doc add the msrows and the SA
    sample (MS, with the text) or doc-id jump tables; ms_cache_path caches
    the msrows under the rows' key (`.bbms.npz`, shared with the JAX
    package)."""
    if want_ms and idx.c_ssamp is None:
        raise ValueError("MS needs an index with SA samples (build -M)")
    if want_doc and idx.c_sdoc is None:
        raise ValueError("doc tracking needs a doc-array index (build -d)")
    n = int(idx.n)
    if wide is None:
        wide = n >= 2**31
    if not wide and n >= 2**31:
        raise ValueError("n >= 2^31 needs the wide layout")
    if n >= 2**40:
        raise ValueError("block-bits positions are 40-bit (SSABYTES=5)")
    if pack is None:
        pack = _pack_of(idx)
        if pack is None:
            raise ValueError("alphabet too large for block-bits")
    if P is None:
        P = pick_P(n, pack, over_cliff=True, wide=wide)
    if P % 32 or P & (P - 1):
        raise ValueError(f"P must be a power of two >= 32, got {P}")

    cache_key = rows = None
    if cache_path is not None:
        cache_key = _bb_cache_key(idx, P, pack, wide)
        if os.path.exists(cache_path):
            try:
                d = np.load(cache_path)
                if (d["key"].shape == cache_key.shape
                        and (d["key"] == cache_key).all()):
                    rows, has_manifest = d["rows"], "m_stat" in d.files
            except _CACHE_ERRORS:
                rows = None   # unreadable or foreign cache: rebuild below
    if rows is not None:
        if not has_manifest and src_path is not None:
            # pre-manifest cache: rewrite it with the manifest so the next
            # run gets the fast start
            _write_cache(cache_path, cache_key, rows, idx, src_path)
    else:
        rows = _build_rows(idx, n, P, pack, wide)
        if cache_path is not None:
            _write_cache(cache_path, cache_key, rows, idx, src_path)
    msrows = None
    if want_ms or want_doc:
        with trace.span("load.msrows"):
            msrows = _build_msrows(idx, P, pack, ms_cache_path, cache_key)
    return _assemble(idx, rows, P, pack, wide, msrows=msrows,
                     want_ms=want_ms, want_doc=want_doc)


def _build_rows(idx, n: int, P: int, pack: int, wide: bool) -> np.ndarray:
    """The [nb, W] int32 rows (spumoni_tpu/engine/blockbits.py:366-485)."""
    cnt = np.asarray(idx.cnt, dtype=np.int64)
    F = np.asarray(idx.F, dtype=np.int64)
    index_chars = np.nonzero(cnt)[0]
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4
    code_chars = _code_chars(index_chars, pack)
    if pack == 2 and not (len(code_chars) <= MAX_SIGMA2
                          and cnt[TERM_BYTE] <= 1):
        raise ValueError("pack=2 needs <= 4 characters plus one terminator")
    if pack == 4 and len(code_chars) > MAX_SIGMA4:
        raise ValueError("pack=4 needs <= 8 characters")

    rmap = np.full(256, MAX_SIGMA, dtype=np.uint8)
    rmap[code_chars] = np.arange(len(code_chars), dtype=np.uint8)
    run_heads = np.asarray(idx.run_heads, dtype=np.uint8)
    run_starts = np.asarray(idx.run_starts, dtype=np.int64)
    run_len_rm = np.diff(np.concatenate([run_starts, [n]]))
    bwt_bytes = np.repeat(run_heads, run_len_rm)            # [n] u8

    nb = -(-n // P)
    term_pos = -1
    term_code = pad_code = 0
    if pack == 2 and cnt[TERM_BYTE]:
        # the terminator aliases code 0 at its single position; the step
        # corrects rank and match with static scalars. Block padding may
        # alias a code too: pad positions sit past offset (n-1) % P of the
        # last block, where no rank is taken.
        rmap[TERM_BYTE] = TERM_CODE
        term_pos = int(run_starts[np.nonzero(run_heads == TERM_BYTE)[0][0]])
        if not set(present_chars(run_heads).tolist()) <= (
                set(code_chars.tolist()) | {TERM_BYTE}):
            raise ValueError("BWT holds a character outside the code set")
        pad_code = 3 if len(code_chars) < 4 else term_code

    # rows are assembled in chunks of ~2^24 positions so that peak extra
    # memory stays ~300 MB whatever n is
    per_word = 32 // pack
    nwcw = P // per_word
    wpc = P // 32
    W = _width(P, pack, wide)
    C0, W0, T0 = 0, nslots, nslots + nwcw
    H0 = T0 + nslots * wpc
    rows = np.zeros((nb, W), dtype=np.int32)
    occ_run = F[code_chars].astype(np.int64).copy()
    char_off = np.asarray(idx.char_off, dtype=np.int64)
    c_start = np.asarray(idx.c_start, dtype=np.int64)
    c_thr = np.asarray(idx.c_thr, dtype=np.int64)
    shifts32 = np.arange(32, dtype=np.uint32)
    chunk_rows = max(1, (1 << 24) // P)
    for r0 in range(0, nb, chunk_rows):
        r1 = min(r0 + chunk_rows, nb)
        rc = r1 - r0
        p0, p1 = r0 * P, r1 * P
        if p1 <= n:
            bb = bwt_bytes[p0:p1]
        else:
            bb = np.concatenate(
                [bwt_bytes[p0:n], np.zeros(p1 - n, dtype=np.uint8)])
        bb2 = bb.reshape(rc, P)

        # occ checkpoints from the true characters (alias-free)
        for k, ch in enumerate(code_chars):
            bc = (bb2 == ch).sum(axis=1, dtype=np.int64)
            csum = np.zeros(rc, dtype=np.int64)
            np.cumsum(bc[:-1], out=csum[1:])
            cp = occ_run[k] + csum
            if wide:
                rows[r0:r1, C0 + k] = (
                    cp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
                rows[r0:r1, H0 + (k >> 2)] |= (
                    (cp >> 32).astype(np.uint32) << ((k & 3) * 8)
                ).view(np.int32)
            else:
                rows[r0:r1, C0 + k] = cp.astype(np.int32)
            occ_run[k] += int(bc.sum())

        # characters, pack-bit codes, little-endian within each word
        cc = rmap[bb]
        if pack == 2 and term_pos >= 0:
            cc[bb == TERM_BYTE] = term_code
            cc[bb == 0] = pad_code
        cc2 = cc.reshape(rc, P)
        words = np.zeros((rc, nwcw), dtype=np.uint32)
        for j in range(per_word):
            words += (cc2[:, j::per_word].astype(np.uint32)
                      & ((1 << pack) - 1)) << (pack * j)
        rows[r0:r1, W0:W0 + nwcw] = words.view(np.int32)

        # up-bits: pos < threshold of the run holding the next occurrence
        # of code-char k at/after pos (compute_ms_pml.cpp:270-277); 1 past
        # the last run (the step forces jump-up when has_next is false)
        pos = np.arange(p0, p1, dtype=np.int64)
        for k, ch in enumerate(code_chars):
            lo, hi = char_off[ch], char_off[ch + 1]
            cs, th = c_start[lo:hi], c_thr[lo:hi]
            ridx = np.searchsorted(cs, pos, side="right")
            past = ridx >= len(cs)
            up = np.where(past, True,
                          pos < th[np.minimum(ridx, len(cs) - 1)])
            packed = (up.reshape(-1, 32).astype(np.uint32)
                      << shifts32[None, :]).sum(axis=1, dtype=np.uint32)
            rows[r0:r1, T0 + k * wpc:T0 + (k + 1) * wpc] = (
                packed.reshape(rc, wpc).view(np.int32))
    return rows


def _code_chars(index_chars: np.ndarray, pack: int) -> np.ndarray:
    if pack == 2:
        return np.asarray([c for c in index_chars if c != TERM_BYTE],
                          dtype=np.int64)
    return np.asarray(index_chars, dtype=np.int64)


def _build_msrows(idx, P: int, pack: int, cache_path: Optional[str] = None,
                  cache_key: Optional[np.ndarray] = None) -> np.ndarray:
    """[nb, Wm] int32 run-rank rows (spumoni_tpu/engine/blockbits.py:504-
    561): per code slot k, the count of code-char-k runs starting before
    the block, then P/32 words whose bit (k, pos) says a run of code-char k
    starts at pos. Read from / written to the `.bbms.npz` cache under the
    rows' key."""
    n, r = int(idx.n), int(idx.r)
    if r >= 2**30:
        raise ValueError("v4-MS jump ids are int32 (2r+2 slots): r < 2^30")
    nslots = MAX_SIGMA2 if pack == 2 else MAX_SIGMA4
    wpc = P // 32
    Wm = _ms_width(P, pack)
    nb = -(-n // P)
    use_cache = cache_path is not None and cache_key is not None
    if use_cache and os.path.exists(cache_path):
        try:
            d = np.load(cache_path)
            if (d["key"].shape == cache_key.shape
                    and (d["key"] == cache_key).all()
                    and d["msrows"].shape == (nb, Wm)):
                return d["msrows"]
        except _CACHE_ERRORS:
            pass   # unreadable or foreign cache: rebuild below

    code_chars = _code_chars(np.nonzero(np.asarray(idx.cnt))[0], pack)
    char_off = np.asarray(idx.char_off, dtype=np.int64)
    c_start = np.asarray(idx.c_start, dtype=np.int64)
    logP = int(math.log2(P))
    msrows = np.zeros((nb, Wm), dtype=np.uint32)
    flat = msrows.reshape(-1)
    block_starts = np.arange(nb, dtype=np.int64) * P
    for k, ch in enumerate(code_chars):
        cs = c_start[char_off[ch]:char_off[ch + 1]]
        msrows[:, k] = np.searchsorted(cs, block_starts,
                                       side="left").astype(np.uint32)
        if len(cs) == 0:
            continue
        # run-start bits: cs is ascending, so its flat word indices are
        # non-decreasing and one OR-reduce per word replaces
        # np.bitwise_or.at (same bytes, vectorised)
        off = cs & (P - 1)
        word = (cs >> logP) * Wm + nslots + k * wpc + (off >> 5)
        bits = np.uint32(1) << (off & 31).astype(np.uint32)
        first = np.flatnonzero(np.concatenate([[True],
                                               word[1:] != word[:-1]]))
        flat[word[first]] |= np.bitwise_or.reduceat(bits, first)
    msrows = msrows.view(np.int32)
    if use_cache:
        tmp = f"{cache_path}.tmp{os.getpid()}.npz"
        np.savez(tmp, key=cache_key, msrows=msrows)
        os.replace(tmp, cache_path)
    return msrows


# ---------------------------------------------------------------------------
# torch state
# ---------------------------------------------------------------------------

class BitMeta(NamedTuple):
    """Static scalars of a block-bits index (kernel launch arguments)."""
    n: int
    P: int
    pack: int
    wide: bool
    term_pos: int = -1     # pack=2: the terminator's BWT position
    term_code: int = 0     # pack=2: the code the terminator aliases
    F_term: int = 0        # pack=2: F[terminator]
    r: int = 0             # runs (jump ids: EMPTY = 2r, INIT = 2r+1)
    term_runidx: int = -1  # pack=2: char-grouped run index of the terminator

    @property
    def nslots(self) -> int:
        return MAX_SIGMA2 if self.pack == 2 else MAX_SIGMA4

    @property
    def width(self) -> int:
        return _width(self.P, self.pack, self.wide)

    @property
    def ms_width(self) -> int:
        return _ms_width(self.P, self.pack)

    @property
    def pos_dtype(self) -> torch.dtype:
        """Positions, SA samples and MS values: int64 in wide mode."""
        return torch.int64 if self.wide else torch.int32


class BlockBitsIndex(nn.Module):
    """The block-bits rows as module buffers: `bblocks` [nb, W] int32 plus
    the 0-d scalars of `meta`, and for MS / doc tracking the optional
    `msrows` [nb, Wm] int32, `jump_t` [2r+2] (SA samples, meta.pos_dtype),
    `jump_d` [2r+2] int32 (doc ids) and `text` [n-1] uint8, so one
    `.to(device)` moves them all. `meta` keeps the same scalars as Python
    ints, so a launch reads none of them back from the device."""

    def __init__(self, bblocks: torch.Tensor, meta: BitMeta,
                 msrows: Optional[torch.Tensor] = None,
                 jump_t: Optional[torch.Tensor] = None,
                 jump_d: Optional[torch.Tensor] = None,
                 text: Optional[torch.Tensor] = None):
        super().__init__()
        nb = -(-meta.n // meta.P)
        if bblocks.dtype != torch.int32 or bblocks.dim() != 2:
            raise ValueError("bblocks must be a 2-D int32 tensor")
        if tuple(bblocks.shape) != (nb, meta.width):
            raise ValueError(f"bblocks shape {tuple(bblocks.shape)} does not "
                             f"match n={meta.n}, P={meta.P}, W={meta.width}")
        njump = 2 * meta.r + 2
        for name, t, dtype, shape in (
                ("msrows", msrows, torch.int32, (nb, meta.ms_width)),
                ("jump_t", jump_t, meta.pos_dtype, (njump,)),
                ("jump_d", jump_d, torch.int32, (njump,))):
            if t is not None and (t.dtype != dtype
                                  or tuple(t.shape) != shape):
                raise ValueError(f"{name} must be {dtype} of shape {shape}, "
                                 f"not {t.dtype} {tuple(t.shape)}")
        if (jump_t is not None or jump_d is not None) and msrows is None:
            raise ValueError("jump tables need the msrows")
        if text is not None and (text.dtype != torch.uint8
                                 or text.dim() != 1):
            raise ValueError("text must be a 1-D uint8 tensor")
        self.meta = meta
        self.register_buffer("bblocks", bblocks)
        self.register_buffer("msrows", msrows)
        self.register_buffer("jump_t", jump_t)
        self.register_buffer("jump_d", jump_d)
        self.register_buffer("text", text)
        for name, value in meta._asdict().items():
            self.register_buffer(name, torch.tensor(int(value),
                                                    dtype=torch.int64))

    @property
    def text_bound(self) -> int:
        """The extension's text bound: the text length rounded up to a power
        of two. The JAX package zero-pads its device text to that length
        (blockbits.py:616-621) and compares reads against the padding; the
        kernels read positions past the text as 0 instead of storing it."""
        return max(1, 1 << (int(self.text.shape[0]) - 1).bit_length())

    def extra_repr(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.meta._asdict().items())


class CharTable:
    """Host companion of BlockBitsIndex: the query-rank mapping of a read
    alphabet and its per-character table. Replaces the JAX package's
    OccHost without its 8-bit float plane split, which only served the TPU
    matrix unit's bf16 exactness: the kernels read `tab[qc]` directly."""

    COLS = 5  # code, empty, F, Fnext, run_base

    def __init__(self, F_all, cnt_all, rmap, F_sigma, Fnext_sigma,
                 index_chars, runbase_sigma=None):
        self.F_all = np.asarray(F_all, dtype=np.int64)
        self.cnt_all = np.asarray(cnt_all, dtype=np.int64)
        self.rmap = np.asarray(rmap, dtype=np.uint8)
        self.F_sigma = np.asarray(F_sigma, dtype=np.int64)
        self.Fnext_sigma = np.asarray(Fnext_sigma, dtype=np.int64)
        self.index_chars = tuple(int(c) for c in index_chars)
        self.runbase_sigma = np.zeros(16, dtype=np.int64) \
            if runbase_sigma is None \
            else np.asarray(runbase_sigma, dtype=np.int64)
        self._tables: dict = {}

    def table_for_alphabet(self, alphabet: tuple) -> torch.Tensor:
        """[sq, 5] int64 per-rank rows for `alphabet` (sorted bytes, rank =
        position): the char's code (MAX_SIGMA when absent from the index,
        TERM_CODE for the pack=2 terminator), empty, F, F + cnt, and the
        run base char_off[char] of MS / doc tracking (zero on a PML-only
        index)."""
        tab = self._tables.get(alphabet)
        if tab is None:
            sq = max(16, -(-len(alphabet) // 16) * 16)
            mat = np.zeros((sq, self.COLS), dtype=np.int64)
            for i, byte in enumerate(alphabet):
                rk = int(self.rmap[byte])
                mat[i, 0] = rk
                mat[i, 1] = 1 if self.cnt_all[byte] == 0 else 0
                mat[i, 2] = self.F_all[byte]
                mat[i, 3] = 0 if rk == MAX_SIGMA else self.Fnext_sigma[rk]
                mat[i, 4] = self.runbase_sigma[rk]
            tab = self._tables[alphabet] = torch.from_numpy(mat)
        return tab

    @staticmethod
    def rank_map(alphabet: tuple) -> np.ndarray:
        amap = np.zeros(256, dtype=np.uint8)
        for i, c in enumerate(alphabet):
            amap[c] = i
        return amap


def alphabet_seed(table: CharTable) -> set:
    """The bytes every staged alphabet holds before any read is seen: byte
    0, ACGTN and the index's characters (ScanEngine._ensure_alpha)."""
    return {0} | set(b"ACGTN") | set(int(c) for c in table.index_chars)


def staged_alphabet(table: CharTable, reads) -> tuple:
    """The alphabet ScanEngine stages `reads` with: alphabet_seed and the
    reads' bytes, sorted (rank = position)."""
    return tuple(sorted(alphabet_seed(table) | set(b"".join(reads))))


def ranked_rows(table: CharTable, reads, L: int, device="cpu") -> tuple:
    """(tab, [B, L] reversed rank-mapped rows, [B, L] forward raw rows,
    [B] int64 lens) on `device`, as ScanEngine stages a list of reads for
    a block-bits or occ-block index (small kernel checks in the tests and
    chip_smoke.py)."""
    alpha = staged_alphabet(table, reads)
    amap = table.rank_map(alpha)
    rev = np.zeros((len(reads), L), np.uint8)
    fwd = np.zeros((len(reads), L), np.uint8)
    for i, rd in enumerate(reads):
        a = np.frombuffer(rd, np.uint8)
        rev[i, :len(a)] = amap[a[::-1]]
        fwd[i, :len(a)] = a
    lens = np.asarray([len(r) for r in reads], np.int64)
    return (table.table_for_alphabet(alpha).to(device),
            *(torch.from_numpy(x).to(device) for x in (rev, fwd, lens)))


def _assemble(idx, rows: np.ndarray, P: int, pack: int, wide: bool,
              msrows: Optional[np.ndarray] = None, want_ms: bool = False,
              want_doc: bool = False):
    """Host rows (built or loaded) -> (BlockBitsIndex on the CPU,
    CharTable); with msrows, also the jump tables of want_ms (SA samples,
    and the text when the index has it) and want_doc (doc ids)
    (spumoni_tpu/engine/blockbits.py:564-664, without the TPU's 128-slot
    padding of the tables)."""
    n, r = int(idx.n), int(idx.r)
    cnt = np.asarray(idx.cnt, dtype=np.int64)
    F = np.asarray(idx.F, dtype=np.int64)
    char_off = np.asarray(idx.char_off, dtype=np.int64)
    index_chars = np.nonzero(cnt)[0]
    code_chars = _code_chars(index_chars, pack)
    rmap = np.full(256, MAX_SIGMA, dtype=np.uint8)
    rmap[code_chars] = np.arange(len(code_chars), dtype=np.uint8)
    term_pos, F_term, term_runidx = -1, 0, -1
    if pack == 2 and cnt[TERM_BYTE]:
        rmap[TERM_BYTE] = TERM_CODE
        run_heads = np.asarray(idx.run_heads, dtype=np.uint8)
        run_starts = np.asarray(idx.run_starts, dtype=np.int64)
        term_pos = int(run_starts[np.nonzero(run_heads == TERM_BYTE)[0][0]])
        F_term = int(F[TERM_BYTE])
        term_runidx = int(char_off[TERM_BYTE])
    meta = BitMeta(n=n, P=P, pack=pack, wide=bool(wide), term_pos=term_pos,
                   term_code=0, F_term=F_term, r=r, term_runidx=term_runidx)
    # F / Fnext / run base by query-rank code; slot TERM_CODE serves the
    # terminator
    f_by_code = np.zeros(16, dtype=np.int64)
    fnext_by_code = np.zeros(16, dtype=np.int64)
    runbase_by_code = np.zeros(16, dtype=np.int64)
    for k, ch in enumerate(code_chars):
        f_by_code[k] = F[ch]
        fnext_by_code[k] = F[ch] + cnt[ch]
        runbase_by_code[k] = char_off[ch]
    if term_pos >= 0:
        f_by_code[TERM_CODE] = F_term
        fnext_by_code[TERM_CODE] = F_term + cnt[TERM_BYTE]
        runbase_by_code[TERM_CODE] = term_runidx

    ms = dict(msrows=None, jump_t=None, jump_d=None, text=None)
    if msrows is not None:
        ms["msrows"] = torch.from_numpy(np.ascontiguousarray(msrows))
        with trace.span("load.jumps"):
            if want_ms:
                sdt = np.int64 if wide else np.int32
                T = np.zeros(2 * r + 2, dtype=sdt)
                T[0:2 * r:2] = np.asarray(idx.c_ssamp, dtype=sdt)
                T[1:2 * r:2] = np.asarray(idx.c_esamp, dtype=sdt)
                T[2 * r + 1] = idx.last_run_sample
                ms["jump_t"] = torch.from_numpy(T)
                if idx.text is not None:
                    ms["text"] = torch.from_numpy(
                        np.ascontiguousarray(idx.text, dtype=np.uint8))
            if want_doc:
                D = np.zeros(2 * r + 2, dtype=np.int32)
                D[0:2 * r:2] = np.asarray(idx.c_sdoc, dtype=np.int32)
                D[1:2 * r:2] = np.asarray(idx.c_edoc, dtype=np.int32)
                D[2 * r] = idx.first_run_sdoc   # the MS empty-char reset
                D[2 * r + 1] = idx.last_run_edoc
                ms["jump_d"] = torch.from_numpy(D)
    table = CharTable(F, cnt, rmap, f_by_code, fnext_by_code, index_chars,
                      runbase_by_code if msrows is not None else None)
    index = BlockBitsIndex(torch.from_numpy(np.ascontiguousarray(rows)), meta,
                           **ms)
    return index, table


def from_jax(bblocks_np: np.ndarray, meta_fields: dict,
             occhost_fields: dict, ms_arrays: Optional[dict] = None):
    """(BlockBitsIndex, CharTable) from the JAX package's state, passed as
    numpy: `bblocks_np` = np.asarray(BitArrays.bblocks); `meta_fields` =
    BitMeta._asdict() plus `n`; `occhost_fields` = vars(OccHost);
    `ms_arrays` (v4-MS state) = the BitArrays fields msrows, jump_t,
    jump_d and text as numpy (None where absent). The JAX package's
    128-slot table padding and power-of-two text padding are cut off."""
    if meta_fields.get("tp_axis") is not None:
        raise ValueError("a sharded (TP) block-bits state does not carry "
                         "over")
    n, r = int(meta_fields["n"]), int(meta_fields.get("r", 0))
    meta = BitMeta(n=n, P=int(meta_fields["P"]),
                   pack=int(meta_fields["pack"]),
                   wide=bool(meta_fields["wide"]),
                   term_pos=int(meta_fields["term_pos"]),
                   term_code=int(meta_fields["term_code"]),
                   F_term=int(meta_fields["F_term"]), r=r,
                   term_runidx=int(meta_fields.get("term_runidx", -1)))
    h = occhost_fields
    table = CharTable(h["F_all"], h["cnt_all"], h["rmap"], h["F_sigma"],
                      h["Fnext_sigma"], h["index_chars"],
                      h.get("runbase_sigma"))
    ms = {}
    if meta_fields.get("has_ms"):
        cut = dict(jump_t=2 * r + 2, jump_d=2 * r + 2, text=n - 1)
        for name, a in (ms_arrays or {}).items():
            if a is not None:
                a = np.asarray(a)
                ms[name] = torch.from_numpy(np.array(
                    a[:cut[name]] if name in cut else a))
        if "msrows" not in ms:
            raise ValueError("a v4-MS state needs its msrows")
    rows = torch.from_numpy(np.require(bblocks_np, np.int32, ["C", "W"]))
    return BlockBitsIndex(rows, meta, **ms), table


# ---------------------------------------------------------------------------
# the plain PyTorch step
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding values in [0, 2^32). The
    caller masks each word to 32 bits first: a sign-extended int32 word
    would count 32 phantom high bits."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def pml_probe(index: BlockBitsIndex, tab: torch.Tensor, pos: torch.Tensor,
              qc: torch.Tensor):
    """One backward PML step for a [B] batch of lanes: the port of
    `_make_probe_fn` + `make_blockbits_step_fn`
    (spumoni_tpu/engine/blockbits.py:667-823, no TP, no MS).

    pos: [B] int64 BWT positions; qc: [B] query-rank codes into `tab`
    ([sq, 5] int64, CharTable.table_for_alphabet). Returns
    (new_pos [B] int64, is_match [B] bool); the caller updates the PML
    length as is_match ? length + 1 : 0."""
    pr = _probe(index, tab, pos, qc)
    return pr["new_pos"], pr["is_match"]


def ms_probe(index: BlockBitsIndex, tab: torch.Tensor, pos: torch.Tensor,
             qc: torch.Tensor):
    """One backward v4-MS / doc step: the probe of `pml_probe` plus the
    msrow read of the same block (make_blockbits_ms_step_fn,
    spumoni_tpu/engine/blockbits.py:864-899). Returns (new_pos, is_match,
    empty, jjump): jjump [B] int64 is the jump id a mismatch takes,
    2 * (run base + char-local run rank), minus one for a jump up (the
    previous run's end entry), floored at 0; 2 * term_runidx for a
    terminator query. The caller applies the MS or PML+doc carry."""
    m = index.meta
    if index.msrows is None:
        raise ValueError("index built without want_ms / want_doc")
    pr = _probe(index, tab, pos, qc)
    rk, off = pr["rk"], pr["off"]
    wpc = m.P // 32
    # char-local run rank at pos: checkpoint + popcount of the start bits
    # at offsets < off over the code's P/32 words (each masked to 32 bits)
    msrow = index.msrows[pr["blkc"]].long() & _U32             # [B, Wm]
    k_local = msrow.gather(1, rk[:, None])[:, 0]
    bits = msrow.gather(1, m.nslots + rk[:, None] * wpc
                        + torch.arange(wpc, device=pos.device)[None, :])
    widx = torch.arange(wpc, device=pos.device)[None, :]
    wcut = (off >> 5)[:, None]
    lowmask = ((1 << (off & 31)) - 1)[:, None]
    mb = torch.where(widx < wcut, bits,
                     torch.where(widx == wcut, bits & lowmask,
                                 torch.zeros_like(bits)))
    k_local = k_local + _popcount32(mb).sum(dim=1)
    jdown = 2 * (pr["run_base"] + k_local)
    if pr["is_tq"] is not None:
        jdown = torch.where(pr["is_tq"],
                            torch.full_like(jdown, 2 * m.term_runidx), jdown)
    jjump = torch.clamp(jdown - pr["jump_up"].long(), min=0)
    return pr["new_pos"], pr["is_match"], pr["empty"], jjump


def _probe(index: BlockBitsIndex, tab: torch.Tensor, pos: torch.Tensor,
           qc: torch.Tensor) -> dict:
    """The shared per-step math of `pml_probe` and `ms_probe`
    (_make_probe_fn): THE row read, SWAR in-block rank, checkpoint and
    up-bit selects, terminator corrections and the 3-way branch."""
    m = index.meta
    P, pack, nslots = m.P, m.pack, m.nslots
    logP = int(math.log2(P))
    per_word = 32 // pack
    logW = int(math.log2(per_word))
    nwcw = P // per_word
    wpc = P // 32
    W0, T0 = nslots, nslots + nwcw
    H0 = T0 + nslots * wpc
    lsb = sum(1 << (pack * j) for j in range(per_word))  # 0x555.. / 0x111..

    t = tab[qc.long()]
    code, empty, Fb, Fnext = t[:, 0], t[:, 1] == 1, t[:, 2], t[:, 3]
    rk = code.clamp(0, nslots - 1)

    # THE row read; every word is masked to its 32 bits
    nb = index.bblocks.shape[0]
    blk = pos >> logP
    blkc = blk.clamp(0, nb - 1)
    row = index.bblocks[blkc].long() & _U32                    # [B, W]
    off = pos & (P - 1)

    # in-block rank: SWAR equality mask over the packed char words
    words = row[:, W0:W0 + nwcw]
    y = words ^ (rk * lsb)[:, None]
    z = y | (y >> 1)
    if pack == 4:
        z = z | (y >> 2) | (y >> 3)
    mm = ~z & lsb
    wsel = off >> logW
    widx = torch.arange(nwcw, device=pos.device)[None, :]
    sh = (off & (per_word - 1)) * pack
    lowmask = (1 << sh) - 1
    mm = torch.where(widx < wsel[:, None], mm,
                     torch.where(widx == wsel[:, None],
                                 mm & lowmask[:, None],
                                 torch.zeros_like(mm)))
    inblock = _popcount32(mm).sum(dim=1)
    w_at = words.gather(1, wsel[:, None])[:, 0]
    at_pos = ((w_at >> sh) & ((1 << pack) - 1)) == rk

    # occ checkpoint; wide mode adds the packed high byte
    cp = row.gather(1, rk[:, None])[:, 0]
    if m.wide:
        hw = row.gather(1, (H0 + (rk >> 2))[:, None])[:, 0]
        cp = (((hw >> ((rk & 3) * 8)) & 0xFF) << 32) | cp

    # up/down bit for char c at offset `off`
    word = row.gather(1, (T0 + rk * wpc + (off >> 5))[:, None])[:, 0]
    up_bit = (word >> (off & 31)) & 1

    is_tq = None
    if pack == 2 and m.term_pos >= 0:
        # the terminator's alias of term_code, corrected with scalars
        tb, to = m.term_pos >> logP, m.term_pos & (P - 1)
        at_term_blk = blk == tb
        inblock = inblock - (at_term_blk & (rk == m.term_code)
                             & (off > to)).long()
        at_pos = at_pos & ~(at_term_blk & (off == to))
        # terminator queries: one run, threshold 0 (first-run rule)
        is_tq = code == TERM_CODE
        inblock = torch.where(is_tq, (pos > m.term_pos).long(), inblock)
        at_pos = torch.where(is_tq, pos == m.term_pos, at_pos)
        cp = torch.where(is_tq, torch.full_like(cp, m.F_term), cp)
        up_bit = torch.where(is_tq, torch.zeros_like(up_bit), up_bit)

    A = cp + inblock                                  # F[c] + rank(pos, c)
    is_match = ~empty & at_pos
    jump_up = ~empty & ~is_match & ((A >= Fnext) | (up_bit == 1))
    new_pos = torch.where(empty, Fb, A - jump_up.long())
    return dict(new_pos=new_pos, is_match=is_match, empty=empty,
                jump_up=jump_up, rk=rk, off=off, blkc=blkc, is_tq=is_tq,
                run_base=t[:, 4])
