#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spumoni_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--strains N] [--reads N]

Phases, each of which fails the script (exit != 0) on any fault:
  1. device: torch version, the GPU's name and power limit;
  2. kernel build: nvcc builds K1 `pml_scan` and K2 `pml_classify` from
     spumoni_tpu_torch/csrc for sm_90a;
  3. kernels vs plain versions on small seeded indexes: every layout the
     main path can pick (P in {64, 256, 512}, pack in {2, 4}, wide or not),
     a repetitive text, a 7-letter alphabet, reads with N and bytes absent
     from the index; equality is exact (integers, tolerance 0);
  4. the main path through the CLI at a real size: a synthetic stand-in for
     a 10-strain bacterial pangenome (10 x 4.6 Mbp at 1% divergence from one
     seeded base, reverse complements added: n ~ 92 M), 65,536 reads of
     1,024 bp (half mutated substrings at 8% error, half random);
     `build -P -n`, `run -P -n -c` and `run -P -n -c --report-only`. Checks:
     identical reports, sampled reads equal the native CPU engine, >= 95%
     of positives and <= 5% of negatives FOUND, both kernels launched;
  5. kernel vs plain timing at the main-path shape (B = 65,536, L = 1,024)
     on the main-path index.

The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "chip_smoke_work")
ACGT = np.frombuffer(b"ACGT", np.uint8)
BIN_WIDTH = 150


def phase(title: str) -> None:
    print(f"\n=== {title}", flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def device_phase():
    phase("1. device")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"device {name}; {torch.cuda.device_count()} visible")
    print(smi)
    return dev, name, smi


# ---------------------------------------------------------------------------
# 2. kernel build
# ---------------------------------------------------------------------------

def build_phase():
    phase("2. kernel build")
    from spumoni_tpu_torch.engine import kernels

    t0 = time.time()
    so = kernels.build()
    kernels._library()
    secs = time.time() - t0
    print(f"built {os.path.relpath(so, REPO)} in {secs:.1f} s")
    regs = [int(ln.split("Used ")[1].split()[0])
            for ln in kernels.build_log.splitlines() if "Used " in ln]
    spills = sum(int(ln.split("bytes spill stores")[0].split(",")[-1])
                 for ln in kernels.build_log.splitlines()
                 if "bytes spill stores" in ln)
    if regs:
        print(f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers per thread, {spills} bytes of spill stores")
    return secs


# ---------------------------------------------------------------------------
# 3. kernels vs plain on small indexes
# ---------------------------------------------------------------------------

SMALL_CASES = [
    ("P64-pack2", dict(P=64, pack=2, wide=False), b"ACGT", False),
    ("P256-pack2", dict(P=256, pack=2, wide=False), b"ACGT", False),
    ("P512-pack2-wide", dict(P=512, pack=2, wide=True), b"ACGT", False),
    ("P256-pack4", dict(P=256, pack=4, wide=False), b"ACGT", False),
    ("P512-pack4-wide", dict(P=512, pack=4, wide=True), b"ACGT", False),
    ("repetitive", {}, b"ACGT", True),
    ("alphabet7", {}, b"ACGTWXY", False),
]


def _small_index(seed, n, alphabet, repeat, build_kw):
    from spumoni_tpu_torch import _host
    from spumoni_tpu_torch.engine.blockbits import build_blockbits

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    if repeat:
        unit = rng.choice(alpha, size=n // 20)
        text = np.concatenate([np.tile(unit, 12), rng.choice(alpha, n // 4),
                               np.tile(unit, 3)])
    else:
        text = rng.choice(alpha, size=n)
    raw = _host.build_raw_index(text)
    dense = _host.index_format.build_dense_index(raw)
    native = _host.NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                                     raw.thresholds, raw.samples_start,
                                     raw.samples_last)
    index, table = build_blockbits(dense, **build_kw)
    return text, index, table, native


def _small_reads(seed, text, num, max_len):
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(num):
        m = int(rng.integers(1, max_len))
        if i % 2 == 0:
            st = int(rng.integers(0, len(text) - m))
            rd = text[st:st + m].copy()
            mut = rng.random(m) < 0.08
            rd[mut] = rng.choice(ACGT, size=int(mut.sum()))
        else:
            rd = rng.choice(ACGT, size=m)
        reads.append(rd.tobytes())
    return reads + [b"N" * 64, b"NXY" + text[:200].tobytes() + b"Q",
                    text[-150:].tobytes()]


def small_phase(device, n=20000, num_reads=300):
    phase("3. kernels vs plain versions on small indexes")
    from spumoni_tpu_torch.engine import kernels

    for ci, (label, build_kw, alphabet, repeat) in enumerate(SMALL_CASES):
        text, index, table, native = _small_index(100 + ci, n, alphabet,
                                                  repeat, build_kw)
        reads = _small_reads(200 + ci, text, num_reads, 1024)
        index = index.to(device)
        alpha = tuple(sorted({0} | set(b"ACGTN") | set(table.index_chars)
                             | set(b"".join(reads))))
        amap = table.rank_map(alpha)
        rev = np.zeros((len(reads), 1024), np.uint8)
        for i, rd in enumerate(reads):
            rev[i, :len(rd)] = amap[np.frombuffer(rd, np.uint8)[::-1]]
        lens = torch.tensor([len(r) for r in reads], dtype=torch.int64,
                            device=device)
        rev = torch.from_numpy(rev).to(device)
        tab = table.table_for_alphabet(alpha).to(device)

        got = kernels.pml_scan(index, tab, rev, lens)
        sync(device)
        want = kernels.pml_scan_reference(index, tab, rev, lens)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: pml_scan != pml_scan_reference")
        vals = got.cpu().numpy()
        for i, w in enumerate(native.query_pml(reads)):
            if not np.array_equal(vals[i, :len(w)], w):
                raise AssertionError(f"{label}: read {i} != native engine")
        got = kernels.pml_classify(index, tab, rev, lens, 7, BIN_WIDTH)
        sync(device)
        want = kernels.pml_classify_reference(index, tab, rev, lens, 7,
                                              BIN_WIDTH)
        for name, g, w in zip(("found", "above", "below", "sum_maxes"),
                              got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: pml_classify {name} differs")
        print(f"{label:16s} P={index.meta.P} pack={index.meta.pack} "
              f"wide={index.meta.wide} n={index.meta.n} B={len(reads)}: "
              f"K1 == plain == native, K2 == plain, exactly "
              f"({int(got[0].sum())} FOUND)")


# ---------------------------------------------------------------------------
# 4. the main path at a real size
# ---------------------------------------------------------------------------

def make_inputs(work, strains, strain_len, n_reads, read_len, seed=0):
    """Pangenome FASTA (one record per strain) and a read FASTA whose even
    reads are mutated substrings (pos_i) and odd reads random (neg_i)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, size=strain_len)
    copies = [base]
    for _ in range(strains - 1):
        c = base.copy()
        mut = rng.random(strain_len, dtype=np.float32) < 0.01
        c[mut] = rng.choice(ACGT, size=int(mut.sum()))
        copies.append(c)
    ref = os.path.join(work, "pangenome.fa")
    with open(ref, "wb") as f:
        for i, c in enumerate(copies):
            f.write(b">strain_%d synthetic\n" % i + c.tobytes() + b"\n")
    text = np.concatenate(copies)
    half = n_reads // 2
    starts = rng.integers(0, len(text) - read_len, size=half)
    pos = text[starts[:, None] + np.arange(read_len)[None, :]]
    mut = rng.random(pos.shape, dtype=np.float32) < 0.08
    pos[mut] = rng.choice(ACGT, size=int(mut.sum()))
    neg = rng.choice(ACGT, size=(n_reads - half, read_len))
    reads = os.path.join(work, "reads.fa")
    with open(reads, "wb") as f:
        f.write(b"".join(
            (b">pos_%d\n" % i + pos[i // 2].tobytes() if i % 2 == 0 else
             b">neg_%d\n" % i + neg[i // 2].tobytes()) + b"\n"
            for i in range(n_reads)))
    return ref, reads


def _read_values(path):
    """{read id: np.ndarray} of a .pseudo_lengths file."""
    out = {}
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    for i in range(0, len(lines) - 1, 2):
        out[lines[i][1:].decode()] = np.array(lines[i + 1].split(),
                                              dtype=np.int64)
    return out


def _read_report(path):
    with open(path) as f:
        next(f)
        return {p[0]: p[1] for p in (ln.split() for ln in f) if p}


def _native_engine(index_path):
    from spumoni_tpu_torch import _host

    dense = _host.index_format.load_dense_index(index_path)
    order = np.argsort(np.asarray(dense.run_heads), kind="stable")
    thr = np.empty_like(np.asarray(dense.c_thr))
    thr[order] = np.asarray(dense.c_thr)
    zeros = np.zeros(dense.r, dtype=np.int64)
    return _host.NativeQueryEngine(dense.n, dense.run_heads,
                                   dense.run_starts, thr, zeros, zeros)


class _KernelTimer:
    """CUDA-event time of every launch a wrapper makes while installed
    (the wrapper itself, and so its launch count, is unchanged)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.events = []

    def __call__(self, *args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.inner(*args, **kw)
        b.record()
        self.events.append((a, b))
        return out

    @property
    def launches(self):
        # the wrapper counts on itself by its module-level name, which is
        # this timer while installed: keep the count on the wrapper
        return self.inner.launches

    @launches.setter
    def launches(self, value):
        self.inner.launches = value

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def main_path_phase(device, strains, strain_len=4_600_000, n_reads=65536,
                    read_len=1024, n_check=2048, cpu_run=False):
    phase(f"4. main path: {strains} strains x {strain_len} bp, "
          f"{n_reads} reads x {read_len} bp, through the CLI")
    from spumoni_tpu_torch import cli, pipeline
    from spumoni_tpu_torch.engine import kernels

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.time()
    ref, reads = make_inputs(WORK, strains, strain_len, n_reads, read_len)
    print(f"inputs written in {time.time() - t0:.1f} s")
    prefix = os.path.join(WORK, "idx")
    t0 = time.time()
    cli.main(["build", "-r", ref, "-P", "-n", "-o", prefix])
    build_s = time.time() - t0
    print(f"build: {build_s:.1f} s")

    run_args = ["run", "-r", prefix, "-p", reads, "-P", "-n", "-c"]
    if cpu_run:
        run_args += ["--device", "cpu"]
    stats = {}
    kernels.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for label, extra in (("full", []), ("report_only", ["--report-only"])):
        timers = ([_KernelTimer(kernels, "pml_scan"),
                   _KernelTimer(kernels, "pml_classify")]
                  if device.type == "cuda" else [])
        for t in timers:
            t.__enter__()
        t0 = time.time()
        try:
            cli.main(run_args + extra)
        finally:
            for t in timers:
                t.__exit__()
        sync(device)
        wall = time.time() - t0
        st = dict(pipeline.LAST_RUN_STATS, wall_s=wall)
        if timers:
            st["kernel_ms"] = sum(t.ms() for t in timers)
        stats[label] = st
        shutil.copy(reads + ".report", reads + f".{label}.report")
    launches = {"pml_scan": kernels.pml_scan.launches,
                "pml_classify": kernels.pml_classify.launches}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    # checks
    with open(reads + ".full.report", "rb") as f:
        full = f.read()
    with open(reads + ".report_only.report", "rb") as f:
        fused = f.read()
    if full != fused:
        raise AssertionError("--report-only .report differs from the full "
                             "run's")
    vals = _read_values(reads + ".pseudo_lengths")
    if len(vals) != n_reads:
        raise AssertionError(f"{len(vals)} value records, {n_reads} reads")
    rng = np.random.default_rng(1)
    sample = rng.choice(n_reads, size=min(n_check, n_reads), replace=False)
    seqs = {}
    from spumoni_tpu_torch import _host
    for rec in _host.fasta.read_fastx(reads):
        seqs[rec.name] = rec.seq
    ids = list(seqs)
    chk = [ids[i] for i in sample]
    want = _native_engine(prefix + ".fa.thrbv.spumoni").query_pml(
        [seqs[i] for i in chk], threads=os.cpu_count() or 1)
    for rid, w in zip(chk, want):
        if not np.array_equal(vals[rid], w):
            raise AssertionError(f"{rid}: .pseudo_lengths != native engine")
    status = _read_report(reads + ".report_only.report")
    pos_found = np.mean([status[r] == "FOUND" for r in status
                         if r.startswith("pos")])
    neg_found = np.mean([status[r] == "FOUND" for r in status
                         if r.startswith("neg")])
    if pos_found < 0.95 or neg_found > 0.05:
        raise AssertionError(f"classification: {pos_found:.3f} of positives "
                             f"and {neg_found:.3f} of negatives FOUND")
    if not cpu_run and min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    for label, st in stats.items():
        kms = st.get("kernel_ms", float("nan"))
        print(f"run {label}: {st['reads']} reads in {st['stream_s']:.3f} s "
              f"streaming -> {st['reads'] / st['stream_s']:.1f} reads/s; "
              f"wall {st['wall_s']:.1f} s; kernel time {kms:.3f} ms "
              f"(device idle share of the stream "
              f"{1 - kms / 1e3 / st['stream_s']:.4f})")
    print(f"checks: reports identical; {len(chk)} sampled reads == native "
          f"engine; FOUND: {pos_found:.4f} of positives, {neg_found:.4f} of "
          f"negatives; launches {launches}; peak device memory "
          f"{peak / 1e6:.1f} MB")
    return prefix, reads, launches, stats, build_s, peak


# ---------------------------------------------------------------------------
# 5. kernel vs plain timing at the main-path shape
# ---------------------------------------------------------------------------

def _time_ms(fn, reps):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def timing_phase(device, prefix, reads, n_reads):
    phase(f"5. kernel vs plain at the main-path shape (B={n_reads})")
    from spumoni_tpu_torch import _host, pipeline
    from spumoni_tpu_torch.engine import kernels

    engine = pipeline.make_engine(prefix + ".fa.thrbv.spumoni", device)
    pk = next(_host.fastx_batch.iter_packed_batches(reads, 1 << 40,
                                                    upper=True))
    (g,) = engine.stage(pk, max_lanes=n_reads)
    args = (engine.index, g["tab"], g["rev_d"], g["lens_d"])
    print(f"batch: B={g['rev_d'].shape[0]} L={g['rev_d'].shape[1]}, "
          f"index P={engine.index.meta.P} pack={engine.index.meta.pack} "
          f"rows {engine.index.bblocks.numel() * 4 / 1e6:.1f} MB")
    results = []
    for name, kern, plain, extra, replaces in (
            ("pml_scan", kernels.pml_scan, kernels.pml_scan_reference, (),
             "spumoni_tpu/engine/scan_engine.py:145"),
            ("pml_classify", kernels.pml_classify,
             kernels.pml_classify_reference, (7, BIN_WIDTH),
             "spumoni_tpu/parallel/mesh.py:128")):
        # turns: plain, kernel (warm-up + timed), plain
        plain_ms1, want = _time_ms(lambda: plain(*args, *extra), 1)
        kern(*args, *extra)
        ms, got = _time_ms(lambda: kern(*args, *extra), 5)
        plain_ms2, _ = _time_ms(lambda: plain(*args, *extra), 1)
        outs = (got,) if name == "pml_scan" else got
        wants = (want,) if name == "pml_scan" else want
        err = max(int((o.long() - w.long()).abs().max()) for o, w in
                  zip(outs, wants))
        if err:
            raise AssertionError(f"{name}: kernel != plain (max |err| {err})")
        plain_ms = (plain_ms1 + plain_ms2) / 2
        print(f"{name}: kernel {ms:.3f} ms/call, plain {plain_ms:.3f} "
              f"ms/call ({plain_ms1:.3f}, {plain_ms2:.3f}); max |err| 0 "
              f"(tolerance 0: integer outputs)")
        results.append(dict(name=name, route="cuda",
                            source="spumoni_tpu_torch/csrc/blockbits_pml.cu",
                            replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strains", type=int, default=10,
                    help="pangenome strains of 4.6 Mbp (default 10)")
    ap.add_argument("--reads", type=int, default=65536,
                    help="reads of 1,024 bp (default 65,536)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    dev, name, _ = device_phase()
    build_phase()
    small_phase(dev)
    sync(dev)
    prefix, reads, launches, _, _, _ = main_path_phase(dev, args.strains,
                                                       n_reads=args.reads)
    sync(dev)
    results = timing_phase(dev, prefix, reads, args.reads)
    sync(dev)
    for r in results:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
