"""`build`, `import-ref` and `run` for the port.

`build` and `import_reference_build` are copies of the JAX package's
(spumoni_tpu/pipeline.py:52-427): the native builder, the document array,
the null databases and the index files, byte-identical to the JAX
package's. `run` streams a query file through the block-bits, layered or
occ-block kernels and writes the reference's output files.

`run` mirrors `spumoni_tpu/pipeline.py::run` on the staged fast path, for PML
(-P) and MS (-M), with or without document tracking (-d), on undigested
(-n) and minimizer-digested (-m, -a) indexes, and general text (-g): the
engine choice (block-bits where it holds the index and the mode, else
layered; `--engine bits|layered|occ` to force one), the fast start from the
`.bbrows.npz` cache (block-bits PML without -d), the null-DB threshold,
the prefetch thread that parses, digests and stages batches (feed.py), the
writer thread and the output files with the durable read cursor of
`--resume` (outputs.py), and `--ks-report` with its glibc rand() draws
kept in global read order. Outputs
(`.pseudo_lengths`, `.lengths`, `.pointers`, `.doc_numbers`, `.report`)
are byte-identical to the JAX package's. `--tp-devices S` shards the
index (parallel/tp.py) for report-only PML and -M value runs, as the JAX
package's sharded path does, and past the memory budget of several cards
the run shards on its own (`_tp_decision`).

With several visible GPUs one process runs on all of them in every mode
(the JAX package's `to_mesh`): the index is replicated on each, each
staged group's lanes are split over them (`ScanEngine.to_devices`), and a
sharded index puts shard i of each group of S cards on its i-th card,
read by its peers (S must divide the card count). Under
SPUMONI_NUM_PROCESSES = P > 1 (parallel/distributed.py) host p streams
the records i % P == p into its own shard files and cursor, and after the
one end-of-run all-gather process 0 merges the shards into the files a
single process writes. Nothing falls back silently.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from . import trace
from .classify import binmax, kstest, report
from .constants import (DEFAULT_BIN_SIZE, DEFAULT_MIN_K, DEFAULT_MIN_W,
                        MAX_BIN_SIZE, MIN_BIN_SIZE)
from .engine.blockbits import build_blockbits, eligible_any, load_cached
from .engine.layered import build_layered
from .engine import occblock
from .engine.scan_engine import ScanEngine
from .feed import general_text_feed, prefetched, read_feed
from .glibc_rand import GlibcRand
from .index import refbuilder
from .index.format import (DenseIndex, build_dense_index, build_doc_arrays,
                           load_dense_index, save_dense_index)
from .index.null_db import EmpNullDatabase
from .io import fasta
from .native import NativeQueryEngine, build_raw_index
from .outputs import OutputSet, Writer
from .parallel import distributed as dist
from .parallel.tp import (MAX_SHARDED_TEXT, MAX_SHARDS, place_shards,
                          shard_blockbits, shard_blockbits_ms, shard_layered,
                          sharded_text_bytes)

#: stats of the most recent run()'s streaming loop: reads, bases (input
#: bases, before digestion), symbols (the bases or digested symbols
#: scanned), stream_s; the sums of the counters `trace` counts per batch
LAST_RUN_STATS: dict = {}


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BuildConfig:
    """Mirror of SpumoniBuildOptions (spumoni_main.hpp:134-231)."""
    ref_file: str = ""
    input_list: str = ""
    output_prefix: str = ""
    ms_index: bool = False
    pml_index: bool = False
    build_doc: bool = False
    use_minimizers: bool = True
    use_promotions: bool = False
    use_dna_letters: bool = False
    is_general_text: bool = False
    use_rev_comp: bool = True
    keep_files: bool = False
    k: int = DEFAULT_MIN_K
    w: int = DEFAULT_MIN_W
    bin_size: int = DEFAULT_BIN_SIZE
    verbose: bool = False
    build_method: str = "auto"  # 'auto' | 'sais' | 'pfp' (native builder path)
    emit_ref_formats: bool = False  # also write the reference binary's
                                    # .bwt.heads/.bwt.len/.thr_pos/.ssa/.esa
                                    # intermediates (index/interchange.py)

    def validate(self) -> None:
        if not self.ref_file and not self.input_list:
            raise ValueError("a reference file (-r) or file list (-i) is required")
        if self.ref_file and not os.path.isfile(self.ref_file):
            raise FileNotFoundError(self.ref_file)
        if self.input_list and not os.path.isfile(self.input_list):
            raise FileNotFoundError(self.input_list)
        if not self.output_prefix:
            raise ValueError("an output prefix (-o) is required")
        if not self.ms_index and not self.pml_index:
            raise ValueError("at least one index type (-M or -P) is required")
        # -d with a single reference file needs a pre-made .fa.fdi
        # (spumoni_main.hpp:186-196); otherwise the doc-array build would
        # only fail later with a missing-.fdi error.
        if (self.build_doc and self.ref_file and not self.input_list
                and not os.path.isfile(self.output_prefix + ".fa.fdi")):
            raise ValueError(
                "cannot build a document array (-d) when indexing a single "
                "file unless a *.fa.fdi file is provided for it; use a file "
                "list (-i) instead")
        if self.use_minimizers and not self.is_general_text:
            if self.use_promotions and self.use_dna_letters:
                raise ValueError("only one minimizer type may be specified")
            if not self.use_promotions and not self.use_dna_letters:
                raise ValueError("a minimizer type (-m or -a) is required, "
                                 "or disable digestion with -n")
        else:
            if self.use_promotions or self.use_dna_letters:
                raise ValueError("minimizer type given but digestion disabled")
        if self.k > 4:
            raise ValueError("small window size (k) cannot exceed 4")
        if self.w < self.k:
            raise ValueError("large window (w) must be >= small window (k)")
        if not MIN_BIN_SIZE <= self.bin_size <= MAX_BIN_SIZE:
            raise ValueError(f"bin size must be in [{MIN_BIN_SIZE},{MAX_BIN_SIZE}]")


def _ref_paths(cfg: BuildConfig):
    parent = os.path.dirname(os.path.abspath(cfg.output_prefix))
    name = os.path.basename(cfg.output_prefix)
    ext = ".bin" if cfg.use_promotions else ".fa"
    ref_path = os.path.join(parent, name + ext)
    null_path = os.path.join(parent, "spumoni_null_reads.fa")
    return ref_path, null_path


def build(cfg: BuildConfig) -> str:
    """Runs the full build; returns the built-reference path (the run-time
    index prefix is that path)."""
    cfg.validate()
    t_start = time.time()
    ref_path, null_path = _ref_paths(cfg)
    rand = GlibcRand(0)  # process-wide rand() state (refbuilder.cpp:84)

    # ---- reference preparation (L4) ----
    if cfg.input_list:
        log("build_main", f"input: list of files ({cfg.input_list})")
        res = refbuilder.build_reference_from_filelist(
            cfg.input_list, ref_path, null_path, cfg.build_doc,
            cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w,
            cfg.use_rev_comp, rand=rand)
    elif not cfg.is_general_text:
        log("build_main", f"input: single reference file ({cfg.ref_file})")
        refbuilder.parse_null_reads(cfg.ref_file, null_path, rand=rand)
        res = refbuilder.build_reference(cfg.ref_file, ref_path,
                                         cfg.use_promotions,
                                         cfg.use_dna_letters, cfg.k, cfg.w,
                                         cfg.use_rev_comp)
        res.null_read_path = null_path
    else:
        log("build_main", "general text reference used directly")
        refbuilder.parse_null_reads_from_general_text(cfg.ref_file, null_path,
                                                      rand=rand)
        ref_path = cfg.ref_file
        with open(cfg.ref_file, "rb") as f:
            text = np.frombuffer(f.read(), dtype=np.uint8)
        res = refbuilder.RefBuildResult(ref_path, text, null_path)
        res.null_read_path = null_path

    # ---- index construction (replaces PFP/pfp_thresholds subprocesses) ----
    text = res.text
    # SA-IS is in-memory: ~13 bytes/char peak with 32-bit indexes
    # (n < 2^31), ~26 beyond. The PFP path (build_method='pfp', auto-selected
    # for very large texts) needs only O(parse + dict) working memory.
    from .native import PFP_AUTO_THRESHOLD
    uses_sais = cfg.build_method == "sais" or (
        cfg.build_method == "auto"
        and not (len(text) > PFP_AUTO_THRESHOLD and len(text) > 0
                 and int(text.min()) >= 3))
    if uses_sais:
        try:
            avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
            need = (13 if len(text) < 2**31 - 2 else 26) * len(text)
            if need > avail:
                raise MemoryError(
                    f"SA-IS construction needs ~{need / 1e9:.1f} GB "
                    f"({len(text) / 1e6:.0f} Mbp reference) but only "
                    f"{avail / 1e9:.1f} GB RAM is available; use "
                    f"--build-method pfp (O(parse+dict) memory)")
        except (ValueError, OSError):
            pass
    content_hash = hashlib.sha256(text.tobytes()).hexdigest()[:16]
    raw = _build_raw_cached(ref_path, text, content_hash, cfg.build_method)
    n, r = raw.n, raw.r
    log("build_main", f"bwt statistics: r = {r}, n = {n}, n/r = {n / r:.3f}")

    if cfg.emit_ref_formats:
        from .index.interchange import export_reference_index
        paths = export_reference_index(raw, ref_path)
        log("build_main", "wrote reference-format intermediates: "
            + ", ".join(os.path.basename(p) for p in paths))

    # ---- document array (L2, doc_array.cpp) ----
    doc_start = doc_end = None
    if cfg.build_doc:
        fdi = res.fdi_path or (ref_path + ".fdi")
        seq_lengths = refbuilder.read_fdi(fdi)
        doc_start, doc_end = build_doc_arrays(raw, seq_lengths)

    # CPU engine used for null-DB generation (build-time self-query,
    # spumoni.cpp:654); avoids needing a device at build time.
    cpu_engine = NativeQueryEngine(
        raw.n, raw.run_heads, raw.run_starts, raw.thresholds,
        raw.samples_start, raw.samples_last, start_doc=doc_start,
        end_doc=doc_end, text=text)
    threads = os.cpu_count() or 1

    if cfg.ms_index:
        log("build_ms", "building the MS index")
        dense = build_dense_index(raw, text=text, with_samples=True,
                                  doc_start=doc_start, doc_end=doc_end)
        save_dense_index(dense, ref_path + ".thrbv.ms")
        _write_stats(dense, cfg.output_prefix + ".ms_index_stats.txt")

        log("build_main", "building the empirical null statistic database for MS")
        qfn = lambda reads: cpu_engine.query_ms(reads, threads=threads)[1]
        null_db = EmpNullDatabase.from_null_reads(
            qfn, res.null_read_path, cfg.use_promotions, cfg.use_dna_letters,
            cfg.k, cfg.w, cfg.is_general_text)
        if not cfg.is_general_text:
            null_db.ks_stat_threshold = kstest.find_ks_threshold(
                qfn, res.null_read_path, null_db, cfg.bin_size,
                cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w,
                rand=rand)
        else:
            null_db.ks_stat_threshold = 0.10
        null_db.save(ref_path + ".msnulldb")

    if cfg.pml_index:
        log("build_pml", "building the PML index")
        dense = build_dense_index(raw, with_samples=False,
                                  doc_start=doc_start, doc_end=doc_end)
        save_dense_index(dense, ref_path + ".thrbv.spumoni")
        _write_stats(dense, cfg.output_prefix + ".pml_index_stats.txt")

        log("build_main", "building the empirical null statistic database for PML")
        qfn = lambda reads: cpu_engine.query_pml(reads, threads=threads)
        null_db = EmpNullDatabase.from_null_reads(
            qfn, res.null_read_path, cfg.use_promotions, cfg.use_dna_letters,
            cfg.k, cfg.w, cfg.is_general_text)
        if not cfg.is_general_text:
            null_db.ks_stat_threshold = kstest.find_ks_threshold(
                qfn, res.null_read_path, null_db, cfg.bin_size,
                cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w,
                rand=rand)
        else:
            null_db.ks_stat_threshold = 0.10
        null_db.save(ref_path + ".pmlnulldb")

    if cfg.build_doc:
        np.savez(ref_path + ".doc.npz", start_runs_doc=doc_start,
                 end_runs_doc=doc_end)

    if not cfg.keep_files:
        _rm_temp_files(ref_path)
    log("build_main", f"total elapsed time for build process (s): "
                      f"{time.time() - t_start:.3f}")
    return ref_path


def _build_raw_cached(ref_path: str, text: np.ndarray, content_hash: str,
                      method: str = "auto"):
    """Quick-build analog: cache the raw index keyed by the text hash."""
    from .native import RawIndex
    cache = ref_path + ".rawindex.npz"
    if os.path.exists(cache):
        data = np.load(cache)
        if str(data.get("content_hash")) == content_hash:
            log("build_main", "quick build is activated (raw index cache hit)")
            return RawIndex(int(data["n"]), data["run_heads"],
                            data["run_starts"], data["thresholds"],
                            data["samples_start"], data["samples_last"])
    raw = build_raw_index(text, method=method)
    np.savez(cache, content_hash=content_hash, n=raw.n,
             run_heads=raw.run_heads, run_starts=raw.run_starts,
             thresholds=raw.thresholds, samples_start=raw.samples_start,
             samples_last=raw.samples_last)
    return raw


def import_reference_build(cfg: BuildConfig) -> str:
    """Builds run-ready indexes from a reference binary's intermediate files
    (<ref_file>.bwt.heads/.bwt.len/.thr_pos/.ssa/.esa) — i.e. resumes a
    reference `spumoni build` at the point after pfp_thresholds ran
    (spumoni.cpp:524-545). `cfg.ref_file` is the built-reference path the
    intermediates are named after (usually `<prefix>.fa`); indexes are
    written next to it so `run -r <prefix>` works unchanged.

    The empirical null databases are rebuilt from `spumoni_null_reads.fa`
    in the same directory when present (the reference keeps it for its own
    quick-build, spumoni.cpp:570-601); without it, value-output runs work
    but classification (-c) has no threshold source."""
    from .index.interchange import import_reference_index

    ref_path = cfg.ref_file
    raw = import_reference_index(ref_path,
                                 with_samples=cfg.ms_index)
    n, r = raw.n, raw.r
    log("import_ref", f"imported reference intermediates: r = {r}, n = {n}, "
                      f"n/r = {n / r:.3f}")

    text = None
    if cfg.ms_index and os.path.isfile(ref_path):
        with open(ref_path, "rb") as f:
            t = np.frombuffer(f.read(), dtype=np.uint8)
        if len(t) + 1 != n and len(t) and t[0] == ord(">"):
            # the built reference is a FASTA (RefBuilder's .fa output,
            # refbuilder.cpp:318): the indexed text is the concatenation of
            # its record sequences
            t = np.frombuffer(
                b"".join(rec.seq for rec in fasta.read_fastx(ref_path)),
                np.uint8)
        if len(t) + 1 == n:
            text = t
        else:
            log("import_ref", f"WARNING: {ref_path} is {len(t)} bytes but "
                              f"the BWT implies a {n - 1}-byte text; MS runs "
                              f"will emit pointers without lengths")

    doc_start = doc_end = None
    if cfg.build_doc:
        # rebuild the document array from the imported SA samples + the
        # .fdi sequence boundaries, exactly like the reference's -d build
        # (doc_array.cpp:18-108 consumes .ssa/.esa + .fdi) — or, without an
        # .fdi, read the reference's own serialized .doc directly
        # (doc_array.cpp:184-201)
        fdi = ref_path + ".fdi"
        doc_file = ref_path + ".doc"
        if os.path.isfile(fdi):
            seq_lengths = refbuilder.read_fdi(fdi)
            doc_start, doc_end = build_doc_arrays(raw, seq_lengths)
        elif os.path.isfile(doc_file):
            from .index.interchange import read_reference_doc
            doc_start, doc_end = read_reference_doc(doc_file)
            if len(doc_start) != r:
                raise ValueError(f"{doc_file} holds {len(doc_start)} "
                                 f"entries for {r} runs")
            log("import_ref", f"document array read from {doc_file}")
        else:
            raise FileNotFoundError(f"-d import needs {fdi} or {doc_file}")
        np.savez(ref_path + ".doc.npz", start_runs_doc=doc_start,
                 end_runs_doc=doc_end)

    null_path = os.path.join(os.path.dirname(os.path.abspath(ref_path)),
                             "spumoni_null_reads.fa")
    have_nulls = os.path.isfile(null_path)
    engine = None
    if have_nulls:
        engine = NativeQueryEngine(
            raw.n, raw.run_heads, raw.run_starts, raw.thresholds,
            raw.samples_start, raw.samples_last, text=text)
    else:
        # no null reads: fall back to the reference's own serialized null
        # databases (emp_null_database.cpp:82-141) so a reference-built
        # index classifies without spumoni_null_reads.fa
        from .index.interchange import read_reference_nulldb
        converted = []
        for want_ms, ext in ((True, ".msnulldb"), (False, ".pmlnulldb")):
            if want_ms and not cfg.ms_index:
                continue
            if not want_ms and not cfg.pml_index:
                continue
            src = ref_path + ext
            if not os.path.isfile(src):
                continue
            d = read_reference_nulldb(src)
            db = EmpNullDatabase(d["null_stats"])
            # keep the reference's RECORDED scalars (its mean/percentile
            # computation is definitionally ours, but trust the file)
            db.ks_stat_threshold = d["ks_stat_threshold"]
            db.mean_null_stat = d["mean_null_stat"]
            db.percentile_value = d["percentile_value"]
            db.save(src)
            converted.append(ext)
        if converted:
            log("import_ref", "null databases read from the reference's "
                              f"serialized {'/'.join(converted)}")
        else:
            log("import_ref", f"WARNING: {null_path} not found and no "
                              f"reference .msnulldb/.pmlnulldb to read; "
                              f"skipping the null databases "
                              f"(classification runs need them)")

    threads = os.cpu_count() or 1
    rand = GlibcRand(0)
    for want_ms in (True, False):
        if want_ms and not cfg.ms_index:
            continue
        if not want_ms and not cfg.pml_index:
            continue
        kind = "ms" if want_ms else "spumoni"
        dense = build_dense_index(raw, text=text if want_ms else None,
                                  with_samples=want_ms,
                                  doc_start=doc_start, doc_end=doc_end)
        save_dense_index(dense, f"{ref_path}.thrbv.{kind}")
        _write_stats(dense, cfg.output_prefix
                     + (".ms" if want_ms else ".pml") + "_index_stats.txt")
        if have_nulls:
            if want_ms:
                qfn = lambda reads: engine.query_ms(reads, threads=threads)[1]
            else:
                qfn = lambda reads: engine.query_pml(reads, threads=threads)
            null_db = EmpNullDatabase.from_null_reads(
                qfn, null_path, cfg.use_promotions, cfg.use_dna_letters,
                cfg.k, cfg.w, cfg.is_general_text)
            null_db.ks_stat_threshold = kstest.find_ks_threshold(
                qfn, null_path, null_db, cfg.bin_size,
                cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w,
                rand=rand)
            null_db.save(ref_path + (".msnulldb" if want_ms
                                     else ".pmlnulldb"))
    return ref_path


def _rm_temp_files(ref_path: str) -> None:
    """Counterpart of rm_temp_build_files (spumoni.cpp:502-522)."""
    p = ref_path + ".rawindex.npz"
    if os.path.exists(p):
        os.remove(p)


def _write_stats(dense: DenseIndex, path: str) -> None:
    """*.ms_index_stats.txt / *.pml_index_stats.txt
    (compute_ms_pml.cpp:204-209,532-538)."""
    with open(path, "w") as f:
        for key, val in dense.index_stats().items():
            f.write(f"{key}: {val}\n")


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunConfig:
    """Mirror of SpumoniRunOptions (spumoni_main.hpp:233-330), with the
    port's devices."""
    ref_file: str = ""        # index prefix (without .fa/.bin)
    pattern_file: str = ""
    ms_requested: bool = False
    pml_requested: bool = False
    use_doc: bool = False
    write_report: bool = False
    min_digest: bool = True
    use_promotions: bool = False
    use_dna_letters: bool = False
    is_general_text: bool = False
    k: int = DEFAULT_MIN_K
    w: int = DEFAULT_MIN_W
    bin_size: int = DEFAULT_BIN_SIZE
    threads: int = 1
    device: str = "cuda"      # 'cuda': the CUDA kernels on every visible
                              # GPU; 'cpu': their plain PyTorch versions
    batch_bases: int = 33_554_432  # bases per streamed batch
    resume: bool = False      # resume from the durable read cursor
    process_index: int = 0    # multi-process read sharding: this host owns
    process_count: int = 1    # the records i % process_count == index
    ks_report: bool = False   # classify via windowed KS test instead of
                              # bin-max (the reference's build-time-live path,
                              # ks_test.cpp + compute_ms_pml.cpp:942-967)
    report_only: bool = False  # -c without value files: classification is
                              # fused on device and only O(B) verdict
                              # summaries leave it (extension flag; the
                              # reference always writes values)
    tp_devices: int = 0       # index rows in this many shards (>1); 0 or
                              # 1: sharded only past the cards' memory
    engine: str = "auto"      # 'auto' | 'layered' | 'occ' | 'bits'

    @property
    def mode(self) -> str:
        if self.ms_requested and not self.pml_requested:
            return "ms"
        if self.pml_requested and not self.ms_requested:
            return "pml"
        raise ValueError("exactly one of -M or -P must be specified")

    def validate(self) -> None:
        _ = self.mode
        if not self.ref_file or not self.pattern_file:
            raise ValueError("both a reference (-r) and pattern file (-p) "
                             "are required")
        if not os.path.isfile(self.pattern_file):
            raise FileNotFoundError(self.pattern_file)
        if self.min_digest and not self.is_general_text:
            if self.use_promotions and self.use_dna_letters:
                raise ValueError("only one minimizer type may be specified")
            if not self.use_promotions and not self.use_dna_letters:
                raise ValueError("a minimizer type (-m or -a) is required, "
                                 "or disable digestion with -n")
        # general-text restrictions (spumoni_main.hpp:305-310)
        if self.is_general_text and self.min_digest:
            raise ValueError("general-text querying requires -n (no digestion)")
        if self.is_general_text and self.write_report:
            raise ValueError("classification is not available for general text")
        if not MIN_BIN_SIZE <= self.bin_size <= MAX_BIN_SIZE:
            raise ValueError(f"bin size must be in [{MIN_BIN_SIZE},{MAX_BIN_SIZE}]")
        if self.report_only:
            if not self.write_report:
                raise ValueError("--report-only requires -c")
            if self.ks_report:
                raise ValueError("--report-only is bin-max only (the KS "
                                 "statistic needs the full value vectors)")
            if self.use_doc:
                # doc_numbers is a per-position VALUE file
                # (compute_ms_pml.cpp:853-860) — emitting it would defeat
                # --report-only's contract (only O(B) verdicts leave the
                # device). Reject instead of silently dropping the output
                # the user asked for.
                raise ValueError("--report-only cannot produce .doc_numbers "
                                 "(-d writes per-position value files); run "
                                 "without --report-only for doc output")
        if self.tp_devices > 1:
            pml_ok = (self.report_only and self.mode == "pml"
                      and not self.use_doc)
            ms_ok = self.mode == "ms" and not self.report_only
            if not (pml_ok or ms_ok):
                raise ValueError("--tp-devices (sharded index) supports "
                                 "-P -c --report-only without -d "
                                 "(classify-only PML) or -M value runs")
            if self.engine == "occ":
                raise ValueError("--tp-devices supports the layered and "
                                 "block-bits engines")
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process_index {self.process_index} is not in "
                             f"[0, {self.process_count})")
        if self.tp_devices > MAX_SHARDS:
            raise ValueError(f"--tp-devices takes at most {MAX_SHARDS} shards")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"--device must be cuda or cpu, not "
                             f"{self.device!r}")


def select_devices(name: str) -> list:
    """The devices a run uses: 'cpu' the CPU (the plain PyTorch versions);
    'cuda' every visible GPU, cuda:0 first, and raises when there is
    none."""
    if name == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain versions)")
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def _uses_blockbits(dense, mode: str, use_doc: bool, engine: str) -> bool:
    """The JAX package's engine choice (spumoni_tpu/pipeline.py:587-610):
    block-bits when forced, or with `auto` when it holds the index (at
    most 8 BWT characters, n < 2^40) and the mode (SA samples for MS, doc
    ids for -d, r < 2^30 for its int32 jump ids); else layered."""
    if engine == "bits":
        return True
    return (engine == "auto" and eligible_any(dense)
            and (mode == "pml" or dense.has_samples)
            and (not use_doc or dense.has_doc)
            and (mode == "pml" and not use_doc or dense.r < 2**30))


def _tp_decision(dense, *, mode: str, use_doc: bool, report_only: bool,
                 tp_devices: int, engine: str = "auto", ndev: int = 1) -> int:
    """The shard count of the index (spumoni_tpu/pipeline.py:614-658), for
    report-only PML without -d and -M value runs (else 1): the explicit
    tp_devices (> 1); else, with ndev >= 2 cards (1 for the CPU), 1 when
    the estimated engine footprint fits the budget (SPN_HBM_BUDGET_GB where
    set, else the least free memory of the cards, `_card_budget`), or the
    smallest power of two from 2 whose share fits, stopping at the first
    at or past ndev."""
    pml_ok = report_only and mode == "pml" and not use_doc
    ms_ok = mode == "ms" and not report_only
    if not (pml_ok or ms_ok):
        return 1
    if tp_devices > 1:
        return tp_devices
    if tp_devices < 0 or ndev < 2:
        return 1
    bits_ok = engine in ("auto", "bits") and eligible_any(dense)
    if ms_ok:
        if not (bits_ok and dense.has_samples and dense.r < 2**30
                and dense.text is not None
                and (not use_doc or dense.has_doc)):
            return 1   # sharded MS rides the block-bits MS tables only
        ssz = 8 if dense.n >= 2**31 else 4
        nb = -(-dense.n // 512)
        est = (nb * 404                      # rows (wide upper bound)
               + nb * 68 * 4                 # msrows (pack=2: 68 i32 words)
               + (2 * dense.r + 2) * ssz     # jump_t
               + (((2 * dense.r + 2) * 4) if use_doc else 0)
               + dense.n)                    # the text bytes
    elif bits_ok:
        est = (-(-dense.n // 512)) * 404     # P=512 row bytes (wide)
    else:
        est = (dense.r + 1) * 8 * 4 * 2      # layered fields upper bound
    budget = _card_budget(ndev)
    if est <= budget:
        return 1
    tp_n = 2
    while tp_n < ndev and est / tp_n > budget:
        tp_n *= 2
    log("run", f"auto TP: estimated index {est / 1e9:.1f} GB exceeds the "
               f"{budget / 1e9:.0f} GB budget")
    return tp_n


def _card_budget(ndev: int) -> float:
    """Bytes of index one card may hold: SPN_HBM_BUDGET_GB where set, else
    the least free memory of cuda:0 .. cuda:ndev-1."""
    env = os.environ.get("SPN_HBM_BUDGET_GB")
    if env:
        return float(env) * 1e9
    return float(min(torch.cuda.mem_get_info(k)[0] for k in range(ndev)))


def _sharded_index(dense, S: int, index_path: str, mode: str, use_doc: bool,
                   engine: str):
    """(sharded index, CharTable or None) of a run with S shards
    (spumoni_tpu/pipeline.py:661-709): for -M the block-bits MS tables
    whatever --engine says, as the JAX package builds them; for report-only
    PML the block-bits rows when --engine allows and they hold the index,
    else the layered fields. Built on the host, then cut into shards: the
    device never holds the whole table beside its shards. A text whose
    shards would hold 2^36 bytes or more, past K16's limit, is refused
    here, before anything is built."""
    if mode == "ms":
        if not (eligible_any(dense) and dense.has_samples
                and dense.r < 2**30 and dense.text is not None):
            raise ValueError("--tp-devices for -M needs a v4-MS-capable "
                             "index (SA samples + text, sigma <= 8, "
                             "r < 2^30)")
        nbytes = sharded_text_bytes(len(dense.text), S)
        if nbytes >= MAX_SHARDED_TEXT:
            raise ValueError(f"--tp-devices {S}: the text's shards would "
                             f"hold {nbytes} bytes; K16 (ms_extend_tp) "
                             f"reads at most 2^36 - 1")
        index, table = build_blockbits(
            dense, cache_path=index_path + ".bbrows.npz",
            src_path=index_path + ".npz", want_ms=True, want_doc=use_doc,
            ms_cache_path=index_path + ".bbms.npz")
        return shard_blockbits_ms(index, S), table
    if engine in ("auto", "bits") and eligible_any(dense):
        index, table = build_blockbits(
            dense, cache_path=index_path + ".bbrows.npz",
            src_path=index_path + ".npz")
        return shard_blockbits(index, S), table
    return shard_layered(build_layered(dense), S), None


#: the counters `index_bytes.<part>` of an index's buffers on the device;
#: every other buffer (the rows or tables, the scalars) counts as `rows`
_INDEX_PARTS = {"msrows": "msrows", "jump_t": "jumps", "jump_d": "jumps",
                "text": "text"}


def make_engine(index_path: str, device: torch.device, mode: str = "pml",
                use_doc: bool = False, engine: str = "auto",
                fast_start: bool = True, tp_devices: int = 0,
                report_only: bool = False, devices=None) -> ScanEngine:
    """The engine for the index at index_path, chosen as the JAX package
    chooses (`_uses_blockbits`; `occ` only when asked for). Block-bits PML
    without doc tracking (with `auto` / `bits`, fast_start and no explicit
    shards) starts from the rows cache when it is fresh and under
    SPN_HBM_BUDGET_GB (default 12); otherwise the dense index is loaded and
    the block-bits rows (and for MS / doc tracking the msrows,
    `.bbms.npz`) are built or loaded from their caches, or the layered or
    occ-block tables are built. Where `_tp_decision` gives S > 1 shards,
    the index is sharded (`_sharded_index`). `devices` (default [device],
    device first): with several, the engine is data-parallel over them
    (ScanEngine.to_devices), a sharded index placed by `_place_sharded`."""
    devices = list(devices or [device])
    fast = None
    if fast_start and tp_devices <= 1 and engine in ("auto", "bits") \
            and mode == "pml" and not use_doc:
        budget = float(os.environ.get("SPN_HBM_BUDGET_GB", "12")) * 1e9
        with trace.span("load.rows"):
            fast = load_cached(index_path + ".bbrows.npz",
                               index_path + ".npz", max_bytes=budget)
    table = None
    if fast is not None:
        index, table, n, r = fast
        log("run", "fast start: engine rows from cache "
                   "(dense index load skipped)")
    else:
        with trace.span("load.index"):
            dense = load_dense_index(index_path)
        if mode == "ms" and dense.text is None:
            raise ValueError("-M needs an index built with -M (SA samples "
                             "and text)")
        n, r = dense.n, dense.r
        S = _tp_decision(dense, mode=mode, use_doc=use_doc,
                         report_only=report_only, tp_devices=tp_devices,
                         engine=engine,
                         ndev=len(devices) if device.type == "cuda" else 1)
        if S > 1 and len(devices) > 1 and (len(devices) % S
                                           or len(devices) < S):
            raise ValueError(f"--tp-devices {S} does not divide the "
                             f"{len(devices)} available devices")
        with trace.span("load.build"):
            if S > 1:
                index, table = _sharded_index(dense, S, index_path, mode,
                                              use_doc, engine)
                if len(devices) > 1:
                    return _place_sharded(index, table, devices, mode,
                                          use_doc)
                log("run", f"sharded index: {S} shards, all on {device}")
            elif engine == "occ":
                if not occblock.eligible(dense):
                    raise ValueError("occ engine needs sigma <= 15 and "
                                     "n < 2^31 (use engine=layered)")
                # the JAX package builds every table the index has; the
                # port only what the run reads (samples and text for -M,
                # doc ids for -d): the outputs are the same
                index, table = occblock.build_occblock(
                    dense, want_samples=mode == "ms", want_doc=use_doc,
                    want_text=mode == "ms")
            elif _uses_blockbits(dense, mode, use_doc, engine):
                if not eligible_any(dense):
                    raise ValueError("block-bits engine needs sigma <= 8 and "
                                     "positions under 2^40 (use --engine "
                                     "layered)")
                want_ms, want_doc = mode == "ms", use_doc
                index, table = build_blockbits(
                    dense, cache_path=index_path + ".bbrows.npz",
                    src_path=index_path + ".npz", want_ms=want_ms,
                    want_doc=want_doc,
                    ms_cache_path=(index_path + ".bbms.npz")
                    if want_ms or want_doc else None)
            else:
                with trace.span("load.layered"):
                    index = build_layered(dense)
    with trace.span("load.upload"):
        index = index.to(device)
    parts: dict = {}
    for name, b in index.named_buffers():
        part = _INDEX_PARTS.get(name, "rows")
        parts[part] = parts.get(part, 0) + b.numel() * b.element_size()
    for part, n in parts.items():
        trace.count("index_bytes." + part, n)
    nbytes = sum(parts.values())
    m = index.meta
    if table is None:
        layout = f"layered, D={m.depth}, W={m.width}, wide={m.wide}"
    elif isinstance(index, occblock.OccIndex):
        layout = f"occ-block, P={m.P}, W={m.width}"
    else:
        layout = (f"block-bits, P={m.P}, pack={m.pack}, wide={m.wide}, "
                  f"msrows={index.msrows is not None}")
    if getattr(index, "S", 1) > 1:
        layout += f", {index.S} shards"
    log("run", f"index resident on {device}: {nbytes / 1e6:.1f} MB "
               f"(n={n}, r={r}, {layout})")
    out = ScanEngine(index, table, mode=mode, use_doc=use_doc)
    if len(devices) > 1:
        with trace.span("load.upload"):
            out.to_devices(devices)
        log("run", f"data-parallel over {len(devices)} devices (reads "
                   f"split, index replicated)")
    return out


def _place_sharded(index, table, devices, mode: str, use_doc: bool):
    """The engine of a sharded index across several devices: one group of
    S consecutive devices for each ndev / S lanes' share of a batch (the
    `data` axis of the JAX package's make_tp_mesh), shard i of a group on
    its i-th device, the group's kernels launched on its first and reading
    the other shards as peers (tp.place_shards opens the peer access)."""
    S = index.S
    groups = [devices[g:g + S] for g in range(0, len(devices), S)]
    placed = [place_shards(index, grp) for grp in groups]
    out = ScanEngine(placed[0], table, mode=mode, use_doc=use_doc)
    if len(groups) > 1:
        out.to_devices([grp[0] for grp in groups], placed)
    log("run", f"sharded index: {S} shards, shard i of each of "
               f"{len(groups)} groups on its i-th device "
               f"({', '.join(str(d) for d in devices)}); reads split over "
               f"the groups")
    return out


def run(cfg: RunConfig) -> int:
    """Streams the query file through the engine; writes the output files.
    Returns the number of reads processed (every host's, under P > 1).
    With SPUMONI_TRACE=<path> the call's spans and counters (trace.py) go
    to <path> (a file a host under P > 1)."""
    cfg.validate()
    export = os.environ.get(trace.ENV) or None
    if export:
        export = dist.shard_path(export, cfg.process_index,
                                 cfg.process_count)
    with trace.call(export):
        return _run(cfg)


def _run(cfg: RunConfig) -> int:
    """The run: the engine, the null DB and the output files loaded; the
    feed (feed.py), prefetched on its own thread, into the engine on this
    one, and its output into the writer thread (outputs.py); then the
    files closed and, under P > 1, merged."""
    devices = select_devices(cfg.device)
    if cfg.is_general_text:
        base = cfg.ref_file
    else:
        base = cfg.ref_file + (".bin" if cfg.use_promotions else ".fa")
    ms = cfg.mode == "ms"
    P, p = cfg.process_count, cfg.process_index
    outputs = OutputSet(cfg)
    if outputs.skip:
        log("run", f"resuming after {outputs.skip} completed reads"
                   + (f" (host {p})" if P > 1 else ""))
    thr = ks_test = header = None
    with trace.span("run.load"):
        engine = make_engine(
            base + (".thrbv.ms" if ms else ".thrbv.spumoni"), devices[0],
            cfg.mode, cfg.use_doc, cfg.engine,
            fast_start=not cfg.is_general_text,
            # general text runs unsharded, as in the JAX package
            # (spumoni_tpu/pipeline.py:807-810)
            tp_devices=-1 if cfg.is_general_text else cfg.tp_devices,
            report_only=cfg.report_only, devices=devices)
        if not cfg.is_general_text:
            with trace.span("load.null_db"):
                null_db = EmpNullDatabase.load(
                    base + (".msnulldb" if ms else ".pmlnulldb"))
            thr = binmax.max_value_threshold(
                null_db.percentile_value, cfg.use_promotions,
                cfg.use_dna_letters, cfg.mode)
            header = report.report_header(thr)
        if cfg.write_report and cfg.ks_report:
            # classification starts with srand(0) (compute_ms_pml.cpp:892);
            # reads this host does not yield (other hosts', or skipped by
            # --resume) still consume their rand() draws, one per KS
            # window: the writer's pending queue counts them per yielded
            # read
            ks_test = kstest.KSTest(null_db, cfg.bin_size, rand=GlibcRand(0))
            header = report.ks_report_header(null_db.ks_stat_threshold)
        with trace.span("load.files"):
            outputs.open(header)
    # classification and file output run on the writer thread, overlapped
    # with the next batch's device work
    writer = Writer(outputs, report_only=cfg.report_only, ks_test=ks_test,
                    bins=(cfg.bin_size, thr) if cfg.write_report
                    and not cfg.ks_report else None)
    if P > 1:
        log("run", f"host-stride shard {p}/{P}")
    if cfg.is_general_text:
        batches = general_text_feed(cfg, outputs.skip)
    else:
        batches = read_feed(cfg, engine, outputs.skip, writer.ks_pending)

    t0 = time.time()
    total_bases = total_symbols = 0
    try:
        for ids, work, bases, symbols in prefetched(batches):
            total_bases += bases
            total_symbols += symbols
            if cfg.is_general_text:
                out = engine.query(work)
            elif cfg.report_only:
                out = engine.classify_staged(work, cfg.bin_size, thr)
            else:
                out = engine.query_staged(work)
            if not writer.put(ids, out):
                break
    finally:
        writer.close()
        outputs.close()
    found, num_reads = writer.result()
    dt = time.time() - t0
    found, num_reads = outputs.finish(found, num_reads)
    if outputs.merges:
        log("run", f"merged {P} host shards; {found}/{num_reads} reads "
                   f"FOUND")
    log("run", f"processed {num_reads} reads ({total_bases} bases) in "
               f"{dt:.2f}s -> {num_reads / max(dt, 1e-9):.1f} reads/s")
    LAST_RUN_STATS.update(reads=num_reads, bases=total_bases,
                          symbols=total_symbols, stream_s=dt)
    return num_reads
