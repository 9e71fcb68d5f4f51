"""`run` for the port: streams a query file through the block-bits,
layered or occ-block kernels and writes the reference's output files.

Mirrors `spumoni_tpu/pipeline.py::run` on the staged fast path, for PML
(-P) and MS (-M), with or without document tracking (-d), on undigested
(-n) and minimizer-digested (-m, -a) indexes, and general text (-g): the
engine choice (block-bits where it holds the index and the mode, else
layered; `--engine bits|layered|occ` to force one), the fast start from the
`.bbrows.npz` cache (block-bits PML without -d), the null-DB threshold,
the prefetch thread that parses, digests and stages batches, the writer
thread, the durable read cursor with `--resume`, and `--ks-report` with
its glibc rand() draws kept in global read order. Outputs
(`.pseudo_lengths`, `.lengths`, `.pointers`, `.doc_numbers`, `.report`)
are byte-identical to the JAX package's.

What this slice does not cover raises NotImplementedError naming its
ROADMAP item; nothing falls back silently. `build` and `import-ref` are the
shared host pipeline's (spumoni_tpu_torch._host).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from . import _host
from .engine.blockbits import build_blockbits, eligible_any, load_cached
from .engine.layered import build_layered
from .engine import occblock
from .engine.scan_engine import ScanEngine

load_dense_index = _host.index_format.load_dense_index

#: stats of the most recent run()'s streaming loop: reads, bases, stream_s
LAST_RUN_STATS: dict = {}


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


@dataclasses.dataclass
class RunConfig(_host.RunConfig):
    """The JAX package's RunConfig with the port's devices: 'cuda' runs
    the CUDA kernels on one GPU, 'cpu' their plain PyTorch versions."""
    device: str = "cuda"


def _check_supported(cfg: RunConfig) -> None:
    unsupported = (
        (cfg.tp_devices > 1, "--tp-devices > 1 (sharded index) is "
                             "ROADMAP A10"),
        (cfg.process_count > 1, "multi-process runs are ROADMAP A9"),
    )
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"not in the port yet: {what}")
    if cfg.device not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, not {cfg.device!r}")


def select_device(name: str) -> torch.device:
    """'cpu' runs the plain PyTorch versions; 'cuda' runs the kernels on
    the first GPU and raises when there is none."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for the plain versions)")
    count = torch.cuda.device_count()
    if count > 1:
        log("run", f"{count} GPUs visible; running on cuda:0 only "
                   f"(multi-GPU is ROADMAP A9)")
    return torch.device("cuda", 0)


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


def make_engine(index_path: str, device: torch.device, mode: str = "pml",
                use_doc: bool = False, engine: str = "auto",
                fast_start: bool = True) -> ScanEngine:
    """The engine for the index at index_path, chosen as the JAX package
    chooses (`_uses_blockbits`; `occ` only when asked for). Block-bits PML
    without doc tracking (with `auto` / `bits` and fast_start) starts from
    the rows cache when it is fresh and under SPN_HBM_BUDGET_GB (default
    12); otherwise the dense index is loaded and the block-bits rows (and
    for MS / doc tracking the msrows, `.bbms.npz`) are built or loaded from
    their caches, or the layered or occ-block tables are built."""
    fast = None
    if fast_start and engine in ("auto", "bits") and mode == "pml" \
            and not use_doc:
        budget = float(os.environ.get("SPN_HBM_BUDGET_GB", "12")) * 1e9
        fast = load_cached(index_path + ".bbrows.npz", index_path + ".npz",
                           max_bytes=budget)
    table = None
    if fast is not None:
        index, table, n, r = fast
        log("run", "fast start: engine rows from cache "
                   "(dense index load skipped)")
    else:
        dense = load_dense_index(index_path)
        if mode == "ms" and dense.text is None:
            raise ValueError("-M needs an index built with -M (SA samples "
                             "and text)")
        n, r = dense.n, dense.r
        if engine == "occ":
            if not occblock.eligible(dense):
                raise ValueError("occ engine needs sigma <= 15 and n < 2^31 "
                                 "(use engine=layered)")
            # the JAX package builds every table the index has; the port
            # only what the run reads (samples and text for -M, doc ids for
            # -d): the outputs are the same
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
            index = build_layered(dense)
    index = index.to(device)
    nbytes = sum(b.numel() * b.element_size() for b in index.buffers())
    m = index.meta
    if table is None:
        layout = f"layered, D={m.depth}, W={m.width}, wide={m.wide}"
    elif isinstance(index, occblock.OccIndex):
        layout = f"occ-block, P={m.P}, W={m.width}"
    else:
        layout = (f"block-bits, P={m.P}, pack={m.pack}, wide={m.wide}, "
                  f"msrows={index.msrows is not None}")
    log("run", f"index resident on {device}: {nbytes / 1e6:.1f} MB "
               f"(n={n}, r={r}, {layout})")
    return ScanEngine(index, table, mode=mode, use_doc=use_doc)


def run(cfg: RunConfig) -> int:
    """Streams the query file through the engine; writes the output files.
    Returns the number of reads processed."""
    cfg.validate()
    _check_supported(cfg)
    device = select_device(cfg.device)
    if cfg.is_general_text:
        base = cfg.ref_file
    else:
        base = cfg.ref_file + (".bin" if cfg.use_promotions else ".fa")
    ms = cfg.mode == "ms"
    engine = make_engine(base + (".thrbv.ms" if ms else ".thrbv.spumoni"),
                         device, cfg.mode, cfg.use_doc, cfg.engine,
                         fast_start=not cfg.is_general_text)
    if cfg.is_general_text:
        return _run_general_text(cfg, engine)

    null_db = _host.null_db.EmpNullDatabase.load(
        base + (".msnulldb" if ms else ".pmlnulldb"))
    thr = _host.binmax.max_value_threshold(
        null_db.percentile_value, cfg.use_promotions, cfg.use_dna_letters,
        cfg.mode)

    out_prefix = cfg.pattern_file
    paths = {}
    if not cfg.report_only:
        if ms:
            paths["lengths"] = out_prefix + ".lengths"
            paths["pointers"] = out_prefix + ".pointers"
        else:
            paths["lengths"] = out_prefix + ".pseudo_lengths"
        if cfg.use_doc:
            paths["docs"] = out_prefix + ".doc_numbers"
    if cfg.write_report:
        paths["report"] = out_prefix + ".report"

    # restartable streaming: the cursor records how many reads are durably
    # written
    cursor_path = out_prefix + ".cursor"
    skip = 0
    if cfg.resume and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            skip = int(f.read().strip() or 0)
        log("run", f"resuming after {skip} completed reads")

    rep = _host.report
    ks_test = ks_pending = None
    if cfg.write_report and cfg.ks_report:
        # classification starts with srand(0) (compute_ms_pml.cpp:892);
        # reads skipped by --resume still consume their rand() draws, one
        # per KS window: the pending queue counts them per yielded read
        ks_test = _host.kstest.KSTest(null_db, cfg.bin_size,
                                      rand=_host.glibc_rand.GlibcRand(0))
        ks_thr = null_db.ks_stat_threshold
        ks_pending = deque()

    files = {k: open(v, ("a" if skip else "w") + ("" if k == "report"
                                                  else "b"))
             for k, v in paths.items()}
    if cfg.write_report and not skip:
        files["report"].write(rep.ks_report_header(ks_thr) if cfg.ks_report
                              else rep.report_header(thr))

    # classification and file output run on a writer thread, overlapped
    # with the next batch's device work
    wstate = {"num": skip, "err": None}
    wq: queue.Queue = queue.Queue(maxsize=2)

    def _write_batch(ids, out):
        if cfg.report_only:
            for i, rid in enumerate(ids):
                nbins = int(out["above"][i] + out["below"][i])
                status = "FOUND" if out["found"][i] else "NOT_PRESENT"
                files["report"].write(rep.report_line(
                    rid, status, out["sum_maxes"][i] / max(nbins, 1),
                    int(out["above"][i]), int(out["below"][i])))
                wstate["num"] += 1
        else:
            for i, rid in enumerate(ids):
                # the JAX package's writer order (spumoni_tpu/pipeline.py:
                # 971-977)
                if cfg.use_doc:
                    rep.write_values_record(files["docs"], rid,
                                            out["docs"][i])
                if ms:
                    rep.write_values_record(files["pointers"], rid,
                                            out["pointers"][i])
                lengths = out["lengths"][i]
                rep.write_values_record(files["lengths"], rid, lengths)
                if cfg.write_report and cfg.ks_report:
                    ks_test.rand.advance(ks_pending.popleft())
                    ks_list = ks_test.run_kstest(lengths)
                    above = sum(1 for x in ks_list if x >= ks_thr)
                    found = above / len(ks_list) > 0.50
                    files["report"].write(rep.ks_report_line(
                        rid, "FOUND" if found else "NOT_PRESENT",
                        sum(ks_list) / len(ks_list), above,
                        len(ks_list) - above))
                elif cfg.write_report:
                    res = _host.binmax.classify(lengths, cfg.bin_size, thr)
                    files["report"].write(rep.report_line(
                        rid, res.status, res.avg_max, res.bins_above,
                        res.bins_below))
                wstate["num"] += 1
        for f in files.values():
            f.flush()
        with open(cursor_path, "w") as f:
            f.write(str(wstate["num"]))

    def _writer():
        try:
            while True:
                item = wq.get()
                if item is None:
                    return
                _write_batch(*item)
        except Exception as e:  # re-raised by run() after the join
            wstate["err"] = e

    def digested(pk):
        if not cfg.min_digest:
            return pk
        return _host.minimizers.digest_packed(
            pk, cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w)

    def staged_batches():
        fb = _host.fastx_batch
        seen = 0        # records seen (the cursor counts in these units)
        ks_carry = 0    # rand() draws owed for records not yielded
        max_lanes = 65536 if cfg.report_only else 8192
        for pk in fb.iter_packed_batches(cfg.pattern_file, cfg.batch_bases,
                                         upper=True):
            npk = len(pk)
            csum = None
            if ks_pending is not None:
                # one draw per KS window of the DIGESTED read
                # (spumoni_tpu/pipeline.py:1040-1050)
                pk = digested(pk)
                nw = _host.kstest.n_windows_batch(pk.lens, cfg.bin_size)
                csum = np.zeros(npk + 1, dtype=np.int64)
                np.cumsum(nw, out=csum[1:])
            if seen + npk <= skip:   # resume: skip whole batches
                seen += npk
                if csum is not None:
                    ks_carry += int(csum[npk])
                continue
            a = max(0, skip - seen)  # records already durable
            seen += npk
            if csum is not None:
                # the first yielded read first draws for the skipped ones
                ks_pending.append(ks_carry + int(csum[a]))
                ks_pending.extend([0] * (npk - a - 1))
                ks_carry = 0
            if a:
                pk = fb.PackedReads(pk.ids[a:], pk.buf[pk.offs[a]:].copy(),
                                    (pk.offs[a:] - pk.offs[a]).copy())
            if ks_pending is None:
                pk = digested(pk)
            yield pk.ids, engine.stage(pk, max_lanes), pk.total_bases

    t0 = time.time()
    total_bases = 0
    wthread = threading.Thread(target=_writer, daemon=True)
    wthread.start()
    try:
        for ids, staged, bases in _host._prefetched(staged_batches()):
            total_bases += bases
            if cfg.report_only:
                out = engine.classify_staged(staged, cfg.bin_size, thr)
            else:
                out = engine.query_staged(staged)
            if wstate["err"] is not None:
                break
            wq.put((ids, out))
    finally:
        while wthread.is_alive():   # a writer that failed takes no more
            try:
                wq.put(None, timeout=0.1)
                break
            except queue.Full:
                continue
        wthread.join()
        for f in files.values():
            f.close()
    if wstate["err"] is not None:
        raise wstate["err"]
    num_reads = wstate["num"]
    dt = time.time() - t0
    if os.path.exists(cursor_path):
        os.remove(cursor_path)
    log("run", f"processed {num_reads} reads ({total_bases} bases) in "
               f"{dt:.2f}s -> {num_reads / max(dt, 1e-9):.1f} reads/s")
    LAST_RUN_STATS.update(reads=num_reads, bases=total_bases, stream_s=dt)
    return num_reads


def _run_general_text(cfg: RunConfig, engine: ScanEngine) -> int:
    """General-text querying (spumoni_tpu/pipeline.py:1141-1201): reads
    separated by \\x01 (compute_ms_pml.cpp:1219-1297), streamed in batches
    through engine.query; writes `.pseudo_lengths`, or `.lengths` and
    `.pointers`, and no report; keeps the durable cursor and --resume."""
    out_prefix = cfg.pattern_file
    paths = {"lengths": out_prefix + (".lengths" if cfg.mode == "ms"
                                      else ".pseudo_lengths")}
    if cfg.mode == "ms":
        paths["pointers"] = out_prefix + ".pointers"
    cursor_path = out_prefix + ".cursor"
    skip = 0
    if cfg.resume and os.path.exists(cursor_path):
        with open(cursor_path) as f:
            skip = int(f.read().strip() or 0)
        log("run", f"resuming after {skip} completed reads")
    fa = _host.fasta
    records = (item for i, item in enumerate(
        fa.iter_general_reads(cfg.pattern_file)) if i >= skip)
    num_reads = skip
    t0 = time.time()
    total_bases = 0
    files = {k: open(v, "ab" if skip else "wb") for k, v in paths.items()}
    try:
        for batch in _host._prefetched(fa.batch_iter(records,
                                                     cfg.batch_bases)):
            out = engine.query([rd for _, rd in batch])
            for i, (rid, rd) in enumerate(batch):
                for k, f in files.items():   # lengths, then pointers
                    _host.report.write_values_record(f, rid, out[k][i])
                num_reads += 1
                total_bases += len(rd)
            for f in files.values():
                f.flush()
            with open(cursor_path, "w") as f:
                f.write(str(num_reads))
    finally:
        for f in files.values():
            f.close()
    if os.path.exists(cursor_path):
        os.remove(cursor_path)
    dt = time.time() - t0
    log("run", f"processed {num_reads} reads ({total_bases} bases) in "
               f"{dt:.2f}s -> {num_reads / max(dt, 1e-9):.1f} reads/s")
    LAST_RUN_STATS.update(reads=num_reads, bases=total_bases, stream_s=dt)
    return num_reads
