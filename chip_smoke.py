#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spumoni_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--strains N] [--reads N]

Phases, each of which fails the script (exit != 0) on any fault:
  1. device: torch version, the GPU's name and power limit;
  2. the inputs of phases 4-4e, and the CPU-bound index builds of 4, 4b
     and 4c (`build -P -n`, `-i list -M -P -d -n`, `-P -m`, `-P -a`) in a
     background process of this script (`--builds-only`), one after
     another while phases 2b-3f run; phase 4 waits for them, and the
     script ends the process if a phase fails first;
  2b. kernel build: nvcc builds K1 `pml_scan`, K2 `pml_classify`, K3
     `ms_scan`, K4 `ms_extend`, K5 `binmax_values`, K6 `gather_chase`, K7
     `layered_scan`, K8 `layered_classify`, K9 `occ_scan`, K10
     `occ_classify`, K11 `unpack2`, K12 `unpack4`, K13 `pml_classify_tp`,
     K14 `layered_classify_tp`, K15 `ms_scan_tp` and K16 `ms_extend_tp`
     from spumoni_tpu_torch/csrc for sm_90a, one nvcc per source, in
     parallel, beside the index builds;
  3. K1/K2 vs plain versions on small seeded indexes: every layout the
     main path can pick (P in {64, 256, 512}, pack in {2, 4}, wide or not),
     a repetitive text, a 7-letter alphabet, reads with N and bytes absent
     from the index; equality is exact (integers, tolerance 0); K1 on the
     main path's layout also on kernels.ms_edge_reads (lengths 0, 1, 7, 8,
     9 around its G = 8 threads a read, 1,023 and L; the terminator query;
     the W read) at L = 1,024 and 1,021, and K2 on the same reads with the
     bin-width corners added (kernels.classify_edge_reads: lengths 149,
     150, 151, 299, 300, 301 at BIN_WIDTH = 150; B not a multiple of 128 /
     G);
  3b. K3 (ms, ms+doc, pml+doc), K4, K5 and K6 vs plain versions the same
     way, on multi-document MS indexes of the same layouts; K3 with
     kernels.ms_edge_reads added (lengths 0, 1, 7, 8, 9 around its G = 8
     threads a read, 1,023 and L; a read whose last step jumps; the
     terminator query; ROADMAP
     section C's W read), on the main path's layout also at L = 1,021, and
     on section C's 3,000-base index of seed 5 at L = 1,024 and 1,021;
  3c. K7 `layered_scan` (pml, pml+doc, ms, ms+doc; int32 and int64), K8
     `layered_classify` and K4 on K7's pointers vs plain versions on small
     layered indexes: DNA of depth 2 and 3, two documents, general text
     (26 letters), -m digested text; DNA cases also vs the native engine;
     K7 and K8 on the main path's layout (int32, W = 8, two documents)
     also on the edge reads (kernels.ms_edge_reads without the terminator
     query) at L = 1,024 and 1,021;
  3d. K9 `occ_scan` (pml, pml+doc, ms, ms+doc), K10 `occ_classify` and K4
     on K9's pointers vs plain versions on small occ-block indexes: DNA
     with N at P = 128 and P = 16, two documents (with a read longer than
     4,096), a 14-letter text (sigma 15, the layout's bound), each in every
     row layout 4d builds (PML only, with SA samples, with doc ids, with
     both); reads with bytes absent from the index and past its largest
     character (W, Y); DNA cases also vs the native engine; K9 on the main
     path's layout (P = 128, samples and doc ids) also on the edge reads
     at L = 1,024 and 1,021;
  3e. K11 `unpack2` and K12 `unpack4` (with and without its byte table) vs
     plain versions on seeded packed rows (exceptions, a row of 8,192,
     widths of no whole 16-byte vector and of a tail; each also 1 byte off
     the 16-byte boundary with rows of length 1 and ending inside a vector);
     then a small -M -P index through the CLI: `run -P -c`, `run -M -c
     --report-only` and `run -M -c` over reads that stage at 2 bits with
     exceptions (N and IUPAC bytes), at 4 bits (more non-ACGT bytes than
     the exception list holds: MS forward rows at 4 bits too) and a read
     holding 0xFF (forward rows at 8 bits), every output file equal to a
     --device cpu run's, and the MS lengths equal to the native engine's;
  3f. the sharded index (1, 3 and 4 shards): K13 and K15 (ms, ms+doc,
     pml+doc; K15 also at 4 shards on the edge reads:
     vs K3 at L = 1,024, vs its plain version at L = 1,021 on the main
     path's layout; K13 at every shard count on K2's edge reads at L =
     1,024 and 1,021 vs its plain version, on the main path's layout and
     where n is a multiple of P) and K16 vs plain versions and vs their
     unsharded twins
     K2, K3 and K4 on small MS + doc block-bits indexes, K14 vs its plain
     version and K8 on small layered indexes, with reads holding a byte
     past every index character (ROADMAP section C); max |err| 0 (where n
     is a multiple of P that read reaches a pad row and the twins may
     differ, as the JAX sharded path differs from its replicated one);
  4. the main path through the CLI at a real size (reads staged at 2
     bits and decoded by K11 in every run but -m's, which stage at 8): a synthetic stand-in for
     a 10-strain bacterial pangenome (10 x 4.6 Mbp at 1% divergence from one
     seeded base, reverse complements added: n ~ 92 M), 65,536 reads of
     1,024 bp (half mutated substrings at 8% error, half random);
     `build -P -n`, `run -P -n -c` and `run -P -n -c --report-only`. Checks:
     identical reports, sampled reads equal the native CPU engine, >= 95%
     of positives and <= 5% of negatives FOUND;
  4b. the MS / doc main path through the CLI on the same strains written
     as 10 files (one document each): `build -i list -M -P -d -n`, then
     `run -M -n -c --report-only`, `run -M -n -c -d` and `run -P -n -d -c`
     over the same reads. Checks: the two MS reports identical, sampled
     reads' .pointers / .lengths / .doc_numbers (MS) and .pseudo_lengths /
     .doc_numbers (PML) equal the native CPU engine, FOUND rates;
  4c. the layered engine: 4b's runs and `-P -c [--report-only]` with
     `--engine layered` on 4b's index, every output file byte-identical to
     the block-bits run's; then `build -m -P` and `build -a -P` of the
     phase-4 FASTA, `run -m -P -c --report-only` (K8), `run -m -P -c` (K7;
     sampled reads equal the native engine on their digested bytes) and
     `run -a -P -c --report-only` (K2); FOUND rates checked as in 4;
  4d. the occ-block engine: 4b's runs and `-P -c [--report-only]` with
     `--engine occ` on 4b's index (n ~ 92 M, past the JAX package's 2^24
     bound), every output file byte-identical to the block-bits run's;
  4e. the sharded index, `--tp-devices 4` (all shards on the one card):
     `-P -n -c --report-only` on phase 4's index (K13), `--engine layered
     -P -n -c --report-only` (K14) and `-M -n -c -d` (K15, K16) on 4b's,
     every output file byte-identical to its unsharded twin run's;
  4f. more than one device and more than one process, on the first 8,192
     of phase 4's reads: (a) the engine API made data-parallel over
     [cuda:0, cuda:0] (ScanEngine.to_devices: each group's lanes in two
     slices), classify_staged (K11 -> K2) and query_staged (K11 -> K1) on
     phase 4's index and -M -d query_staged (K11 -> K3 -> K4) on 4b's, each
     output equal to the one-device engine's; (b) `run -P -n -c` and `run
     -M -n -c -d` once in this process and once in two worker processes
     joined by gloo on 127.0.0.1, both on cuda:0 (SPUMONI_NUM_PROCESSES=2:
     host p owns the records i % 2 == p, process 0 merges), every merged
     file byte-identical to the single-process run's, the workers' launch
     counts summed;
  5. K1/K2 vs plain timing at the main-path shape (B = 65,536, L = 1,024)
     on the main-path index; in 5-5f every kernel on a 10-strain run is
     also timed at the lanes the runs launch (B = 8,192 and 32,768:
     LAUNCH_SHAPES), outputs equal to the full batch's rows, with its
     bound there;
  5b. K3 (all three modes), K4 and K5 vs plain at the same shape on the
     MS index, and K6 through the gather-chase script's entry point at its
     shape (R = 9,728, W = 128, L = 64), also on the card alone
     (`graph_ms`), with its shared-memory floor (computed from the shape
     and the card, not measured) on a line of its own;
  5c. K7 (pml, pml+doc, ms, ms+doc) and K8 vs plain at the same shape on
     4b's index with the layered engine, and K7-pml and K8 on the -m index
     at the digested reads' bucket (L = 256);
  5d. K9 (pml, pml+doc, ms, ms+doc) and K10 vs plain at the same shape on
     4b's index with the occ-block engine, each mode on the rows its 4d run
     builds;
  5e. K11 and K12 vs plain at the main-path shape (B = 65,536, L = 1,024)
     on phase 4's reads: K11 on their 2-bit rows as staged (no
     exceptions) and with 1 in 128 bytes set to N, K12 on their 4-bit rows
     without and with the alphabet's byte table (each also at
     LAUNCH_SHAPES), and `lut[codes]` beside the table mode; every line
     also timed on the card alone (`graph_ms`: CUDA-graph replay, the
     host's enqueue out of the window); then the host time to stage the
     batch at 8 bits and at 2 bits with K11, in turns;
  5f. K13, K14, K15 (ms+doc and ms) and K16 vs plain at the main-path
     shape on 4 shards of the indexes 4e runs, each beside its unsharded
     twin (K2, K8, K3, K4) and itself on one shard, timed on the same
     inputs, outputs equal; K15's twin K3 also at LAUNCH_SHAPES.

Every CLI run of 3e, 4, 4b, 4c, 4d, 4e and 4f, 4f's engine calls on two
devices, and the gather-chase script of 5b, is a path of its own: the launch counts are set to 0 just before it and read
just after, and it must launch each kernel PATH_KERNELS gives it and no
other. The line before the last is the per-kernel JSON summary: each
kernel's launches on its paths, its time and its plain version's, its
bound, the least time the card could take for the same work (`_bound`),
its time and bound at each of LAUNCH_SHAPES (`shapes`), the time it
loses in each 10-strain run (`lost_ms`: launches x (ms - bound) at the
run's lanes, timed alone), and the CUDA events around its calls in each
run (`in_run_event_ms`: the kernel plus the card's waits on the host);
the last line is {"ok": true, "device": {...}}. Nothing of JAX is
imported.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
import weakref

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "chip_smoke_work")
ACGT = np.frombuffer(b"ACGT", np.uint8)
BIN_WIDTH = 150
_T0 = time.time()


def phase(title: str) -> None:
    print(f"\n=== {title} (t = {time.time() - _T0:.1f} s)", flush=True)


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
    phase("2b. kernel build")
    from spumoni_tpu_torch.engine import kernels

    t0 = time.time()
    paths = kernels.build()
    for name in paths:
        kernels.library(name)
    secs = time.time() - t0
    print(f"built {', '.join(os.path.relpath(p, REPO) for p in paths.values())}"
          f" in {secs:.1f} s")
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
    ("P512-pack2", dict(P=512, pack=2, wide=False), b"ACGT", False),
    ("P512-pack2-wide", dict(P=512, pack=2, wide=True), b"ACGT", False),
    ("P256-pack4", dict(P=256, pack=4, wide=False), b"ACGT", False),
    ("P512-pack4-wide", dict(P=512, pack=4, wide=True), b"ACGT", False),
    ("repetitive", {}, b"ACGT", True),
    ("alphabet7", {}, b"ACGTWXY", False),
]


def _small_index(seed, n, alphabet, repeat, build_kw, ms=False):
    """A seeded text, its block-bits index and the native engine over the
    same tables; ms=True adds SA samples, the text and two documents (the
    MS + doc index)."""
    from spumoni_tpu_torch.engine.blockbits import build_blockbits
    from spumoni_tpu_torch.index import format as fmt
    from spumoni_tpu_torch.native import NativeQueryEngine, build_raw_index

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    if repeat:
        unit = rng.choice(alpha, size=n // 20)
        text = np.concatenate([np.tile(unit, 12), rng.choice(alpha, n // 4),
                               np.tile(unit, 3)])
    else:
        text = rng.choice(alpha, size=n)
    raw = build_raw_index(text)
    docs = {}
    if ms:
        ds, de = fmt.build_doc_arrays(
            raw, [len(text) // 2, len(text) - len(text) // 2])
        docs = dict(start_doc=ds, end_doc=de, text=text)
        dense = fmt.build_dense_index(
            raw, text=text, with_samples=True, doc_start=ds, doc_end=de)
    else:
        dense = fmt.build_dense_index(raw)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last, **docs)
    index, table = build_blockbits(dense, want_ms=ms, want_doc=ms,
                                   **build_kw)
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
    from spumoni_tpu_torch.engine.blockbits import ranked_rows

    for ci, (label, build_kw, alphabet, repeat) in enumerate(SMALL_CASES):
        text, index, table, native = _small_index(100 + ci, n, alphabet,
                                                  repeat, build_kw)
        reads = _small_reads(200 + ci, text, num_reads, 1024)
        index = index.to(device)
        tab, rev, _, lens = ranked_rows(table, reads, 1024, device)
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
        edge = edge2 = ""
        if label == EDGE_CASE:
            edge = _group_edge_check(label, kernels.pml_scan,
                                     kernels.pml_scan_reference, index, [()],
                                     text, device, table, terminator=True)
            edge2 = _group_edge_check(label, kernels.pml_classify,
                                      kernels.pml_classify_reference, index,
                                      [(7, BIN_WIDTH)], text, device, table,
                                      classify=True)
        print(f"{label:16s} P={index.meta.P} pack={index.meta.pack} "
              f"wide={index.meta.wide} n={index.meta.n} B={len(reads)}: "
              f"K1 == plain == native{edge}, K2 == plain{edge2}, exactly "
              f"({int(got[0].sum())} FOUND)")


def _max_err(got, want) -> int:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want) if g is not None)


#: K3 / K15's modes: (mode, use_doc)
MS_MODES = (("ms", False), ("ms", True), ("pml", True))


def _scan_errs(scan, index, ref, ref_index, table, reads, L, device):
    """Max |err| of K3 / K15 (`scan` on `index`) in every mode against
    `ref` on ref_index (its plain version, or K15's twin K3), on reads at
    width L."""
    from spumoni_tpu_torch.engine.blockbits import ranked_rows

    tab, rev, _, lens = ranked_rows(table, reads, L, device)
    err = 0
    for mode, doc in MS_MODES:
        want = ref(ref_index, tab, rev, lens, mode, doc)
        got = scan(index, tab, rev, lens, mode, doc)
        sync(device)
        err = max(err, _max_err(got, want))
    return err


#: the 3 / 3b case whose K1 / K3 also run the edge reads (K1 at L = 1,024
#: and 1,021, K3 at L = 1,021): the main path's layout
EDGE_CASE = "P512-pack2"


def _edge_check(label, index, table, text, device, L=1021):
    """K3 against its plain version on the edge reads at width L; returns
    the note 3b prints."""
    from spumoni_tpu_torch.engine import kernels

    edge = kernels.ms_edge_reads(text, L)
    err = _scan_errs(kernels.ms_scan, index, kernels.ms_scan_reference,
                      index, table, edge, L, device)
    if err:
        raise AssertionError(f"{label}: ms_scan on the edge reads at L = {L}"
                             f" != plain (max |err| {err})")
    return f"; L = {L} edge reads, B={len(edge)}"


#: text bound of kernels.seeded_extend's matrices (their text: 3,000 bytes)
EXTEND_BOUND = 4096


def _extend_check(device, L, wide, S=None):
    """K4 (or K16 on the text in S shards) against its plain version on a
    seeded pointer matrix that holds no MS pointers (kernels.seeded_extend:
    random pointers, runs, pointers past the text and its bound, negative
    pointers inside matches); returns the note 3b / 3f print."""
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.parallel import tp

    text, reads, lens, ptrs = (torch.from_numpy(a).to(device) for a in
                               kernels.seeded_extend(L, L, wide))
    args = (reads, lens, ptrs)
    if S is None:
        got = kernels.ms_extend(text, EXTEND_BOUND, *args)
        want = kernels.ms_extend_reference(text, EXTEND_BOUND, *args)
    else:
        sh = tp.shard_text(text, S)
        got = kernels.ms_extend_tp(sh, EXTEND_BOUND, *args)
        want = kernels.ms_extend_tp_reference(sh, EXTEND_BOUND, *args)
    sync(device)
    err = _max_err(got, want)
    name = "K4" if S is None else f"K16 at S={S}"
    if err:
        raise AssertionError(f"{name} on seeded pointers at L = {L} != plain"
                             f" (max |err| {err})")
    return f"{name} on seeded pointers, L = {L}, B = {len(lens)}: == plain"


def small_ms_phase(device, n=20000, num_reads=300):
    """3b: K3 in each mode (on seeded reads and ms_edge_reads; EDGE_CASE
    also at L = 1,021), K4, K5 and K6 against their plain versions; K3 and
    K4 also
    against the native engine on the seeded reads. The last case is
    ROADMAP section C's seed-5 index, on the edge reads alone (L = 1,024
    and 1,021); then K4 on a seeded matrix of pointers that are no MS
    pointers at L = 1,021 (int32) and 1,024 (int64); then K6 at the
    gather-chase script's shape with one INT_MIN wrap and at its
    EDGE_SHAPES."""
    phase("3b. K3-K6 vs plain versions on small indexes")
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.blockbits import ranked_rows
    from spumoni_tpu_torch.scripts import exp_vmem_gather as chase

    for ci, (label, build_kw, alphabet, repeat) in enumerate(SMALL_CASES):
        seed = 300 + ci
        text, index, table, native = _small_index(seed, n, alphabet, repeat,
                                                  build_kw, ms=True)
        seeded = _small_reads(400 + ci, text, num_reads, 1024)
        # the edge reads add lengths 0, 1, G - 1 ... G + 1, the flush, the
        # terminator
        # query and section C's W (whose answer the engines do not share)
        reads = seeded + kernels.ms_edge_reads(text, 1024)
        index = index.to(device)
        tab, rev, fwd, lens = ranked_rows(table, reads, 1024, device)
        wptr, wlen, wdoc = native.query_ms(seeded, with_docs=True)
        plen, pdoc = native.query_pml(seeded, with_docs=True)
        natives = {("ms", True): (wptr, wdoc), ("pml", True): (plen, pdoc)}
        for mode, use_doc in MS_MODES:
            got = kernels.ms_scan(index, tab, rev, lens, mode, use_doc)
            sync(device)
            want = kernels.ms_scan_reference(index, tab, rev, lens, mode,
                                             use_doc)
            err = _max_err(got, want)
            if err:
                raise AssertionError(f"{label}: ms_scan {mode} doc={use_doc}"
                                     f" != ms_scan_reference (max |err| "
                                     f"{err})")
            if use_doc:
                vals, docs = (t.cpu().numpy() for t in got)
                for i, (wv, wd) in enumerate(zip(*natives[mode, use_doc])):
                    if not (np.array_equal(vals[i, :len(wv)], wv)
                            and np.array_equal(docs[i, :len(wd)], wd)):
                        raise AssertionError(f"{label}: {mode}+doc read {i} "
                                             f"!= native engine")
        ptrs = kernels.ms_scan(index, tab, rev, lens, "ms", False)[0]
        got = kernels.ms_extend(index.text, index.text_bound, fwd, lens,
                                ptrs)
        sync(device)
        if _max_err(got, kernels.ms_extend_reference(
                index.text, index.text_bound, fwd, lens, ptrs)):
            raise AssertionError(f"{label}: ms_extend != ms_extend_reference")
        vals = got.cpu().numpy()
        for i, w in enumerate(wlen):
            if not np.array_equal(vals[i, :len(w)], w):
                raise AssertionError(f"{label}: MS lengths of read {i} != "
                                     f"native engine")
        res = kernels.binmax_values(got, lens, 9, BIN_WIDTH)
        sync(device)
        if _max_err(res, kernels.binmax_values_reference(got, lens, 9,
                                                         BIN_WIDTH)):
            raise AssertionError(f"{label}: binmax_values != plain")
        edge = ""
        if label == EDGE_CASE:
            edge = _edge_check(label, index, table, text, device)
        print(f"{label:16s} P={index.meta.P} pack={index.meta.pack} "
              f"wide={index.meta.wide} n={index.meta.n} r={index.meta.r} "
              f"B={len(reads)}: K3 (3 modes{edge}) == plain, == native, K4 "
              f"== plain "
              f"== native, K5 == plain, exactly ({int(res[0].sum())} FOUND)")
    text, index, table, _ = _small_index(5, 3000, b"ACGT", False, {},
                                         ms=True)
    index = index.to(device)
    for L in (1024, 1021):
        _edge_check("seed5-3000", index, table, text, device, L)
    print(f"seed5-3000       P={index.meta.P} pack={index.meta.pack} "
          f"n={index.meta.n}: K3 (3 modes) on the "
          f"edge reads at L = 1024 and 1021 == plain, exactly")
    for L in (1021, 1024):
        print(_extend_check(device, L, wide=L == 1024) + ", exactly")
    cases = [(chase.int_min_inputs(device), chase.L, "INT_MIN wrap")] + [
        (chase.make_inputs(3, device, rows, width, neg), steps,
         "negative starts" if neg else "")
        for rows, width, steps, neg in chase.EDGE_SHAPES]
    for (table, idx0), steps, note in cases:
        got = kernels.gather_chase(table, idx0, steps)
        sync(device)
        if _max_err(got, kernels.gather_chase_reference(table, idx0, steps)):
            raise AssertionError(f"gather_chase != gather_chase_reference "
                                 f"at {tuple(table.shape)}, L={steps} {note}")
    print("gather_chase at R x W, L = " + ", ".join(
        f"{t.shape[0]} x {t.shape[1]}, {steps}" + (f" ({note})" if note
                                                    else "")
        for (t, _), steps, note in cases) + ": K6 == plain, exactly")


def _group_edge_check(label, scan, plain, index, modes, text, device,
                      table=None, terminator=False, classify=False):
    """K7 / K8 (table None: raw bytes) or K1 / K2 / K13 / K9 / K10
    (query-rank codes through table) against its plain version on the edge
    reads at L = 1,024 and 1,021 (with the terminator query for K1;
    classify: the classify scans', kernels.classify_edge_reads, with the
    bin-width corners), once for each of `modes`: the arguments after the
    reads ((mode, use_doc); K2 / K13 / K8 / K10's (thr, bin_width); () for
    K1). Returns the note 3 / 3c / 3d / 3f print."""
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.blockbits import ranked_rows
    from spumoni_tpu_torch.engine.layered import raw_rows

    for L in (1024, 1021):
        edge = (kernels.classify_edge_reads(text, L) if classify else
                kernels.ms_edge_reads(text, L, terminator=terminator))
        if table is None:
            rows = raw_rows(edge, L, device)[::2]   # reversed rows, lens
        else:
            tab, rev, _, lens = ranked_rows(table, edge, L, device)
            rows = (tab, rev, lens)
        for args in modes:
            want = plain(index, *rows, *args)
            got = scan(index, *rows, *args)
            sync(device)
            err = _max_err(got, want)
            if err:
                raise AssertionError(f"{label}: {scan.__name__} {args} on "
                                     f"the edge reads at L = {L} != plain "
                                     f"(max |err| {err})")
    return f"; edge reads at L = 1024, 1021, B={len(edge)}"


#: the 3c and 3d cases whose K7 / K8 and K9 also run the edge reads: the
#: main path's layouts (int32 fields of width 8 with doc ids; P = 128 rows
#: with samples and doc ids)
LAYERED_EDGE_CASE = "two-docs"
OCC_EDGE_CASE = "two-docs-long"
#: the 3d cases whose K10 also runs the classify edge reads (P = 16 and
#: 128), and the P of 3d's extra K10 case, where a step's char words take
#: a second round at either lane group
K10_EDGE_CASES = ("dna-n-P16", "two-docs-long")
K10_WIDE_P = 256


LAYERED_CASES = [
    # label, text length, alphabet, documents, -m digestion, position type
    ("dna-D2", 20000, b"ACGT", False, False, None),
    ("dna-D3", 300000, b"ACGT", False, False, None),
    ("two-docs", 20000, b"ACGT", True, False, None),
    ("int64-two-docs", 20000, b"ACGT", True, False, np.int64),
    ("text26", 20000, bytes(range(97, 123)), False, False, None),
    ("minimizer", 60000, b"ACGT", False, True, None),
]


def small_layered_phase(device, num_reads=300):
    """3c: K7 in each mode the index has (PML, MS; PML+doc, MS+doc with two
    documents), K8, and K4 on K7's pointers against their plain versions on
    small layered indexes (depth 2 and 3, int32 and int64, two documents,
    general text, -m digested text), and DNA cases against the native
    engine."""
    phase("3c. K7 / K8 (and K4 on K7's pointers) vs plain versions on small "
          "layered indexes")
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.layered import raw_rows, seeded_layered

    for ci, (label, n, alphabet, docs, digest, dtype) in enumerate(
            LAYERED_CASES):
        text, index, native = seeded_layered(500 + ci, n, alphabet, docs,
                                             digest, dtype)
        reads = _small_reads(600 + ci, text, num_reads, 1024)
        if alphabet != b"ACGT" or digest:   # the text's own alphabet
            rng = np.random.default_rng(700 + ci)
            reads += [rng.choice(np.unique(text), m).tobytes()
                      for m in rng.integers(1, 1024, size=num_reads // 4)]
        index = index.to(device)
        rev, fwd, lens = raw_rows(reads, 1024, device)
        m = index.meta
        modes = [("pml", False), ("ms", False)] + (
            [("pml", True), ("ms", True)] if m.has_doc else [])
        for mode, use_doc in modes:
            got = kernels.layered_scan(index, rev, lens, mode, use_doc)
            sync(device)
            want = kernels.layered_scan_reference(index, rev, lens, mode,
                                                  use_doc)
            if _max_err(got, want):
                raise AssertionError(f"{label}: layered_scan {mode} doc="
                                     f"{use_doc} != layered_scan_reference")
        ptrs = kernels.layered_scan(index, rev, lens, "ms")[0]
        mslen = kernels.ms_extend(index.text, index.text_bound, fwd, lens,
                                  ptrs)
        sync(device)
        if _max_err(mslen, kernels.ms_extend_reference(
                index.text, index.text_bound, fwd, lens, ptrs)):
            raise AssertionError(f"{label}: ms_extend on K7 pointers != "
                                 f"plain")
        res = kernels.layered_classify(index, rev, lens, 7, BIN_WIDTH)
        sync(device)
        if _max_err(res, kernels.layered_classify_reference(
                index, rev, lens, 7, BIN_WIDTH)):
            raise AssertionError(f"{label}: layered_classify != plain")
        edge = ""
        if label == LAYERED_EDGE_CASE:
            edge = _group_edge_check(label, kernels.layered_scan,
                                     kernels.layered_scan_reference, index,
                                     modes, text, device)
            _group_edge_check(label, kernels.layered_classify,
                              kernels.layered_classify_reference, index,
                              [(7, BIN_WIDTH)], text, device)
        checked = ""
        if alphabet == b"ACGT" and not digest:
            plen = kernels.layered_scan(index, rev, lens)[0].cpu().numpy()
            wptr, wlen = native.query_ms(reads)
            for i, (wp, wl) in enumerate(zip(native.query_pml(reads),
                                             wlen)):
                if not (np.array_equal(plen[i, :len(wp)], wp) and
                        np.array_equal(mslen[i, :len(wl)].cpu().numpy(),
                                       wl)):
                    raise AssertionError(f"{label}: read {i} != native "
                                         f"engine")
            checked = " == native"
        k8 = "K8 (edge reads too)" if edge else "K8"
        print(f"{label:16s} D={m.depth} W={m.width} wide={m.wide} "
              f"n={m.n} r={m.r} B={len(reads)}: K7 ({len(modes)} modes"
              f"{edge}), K4 on K7 pointers{checked}, {k8} == plain, exactly "
              f"({int(res[0].sum())} FOUND)")


OCC_CASES = [
    # label, text length, alphabet, P, documents, a read longer than 4,096
    ("dna-n-P128", 20000, b"ACGTN", 128, False, False),
    ("dna-n-P16", 20000, b"ACGTN", 16, False, False),
    ("two-docs-long", 20000, b"ACGT", 128, True, True),
    ("sigma15", 20000, b"ACDEFGHIKLMNPQ", 128, False, False),
]


#: occ-block row layouts (SA samples, doc ids): each run of 4d builds only
#: the tables it reads, so the main path gives K9 / K10 all four
OCC_LAYOUTS = {(False, False): "pml rows", (True, False): "ms rows",
               (False, True): "doc rows", (True, True): "ms+doc rows"}


def small_occ_phase(device, num_reads=300):
    """3d: K9 in each mode a row layout serves, K10, and K4 on K9's pointers
    against their plain versions on small occ-block indexes (P = 128 and 16,
    two documents with a read longer than 4,096, sigma 15), in each row
    layout the main path builds (PML only, with SA samples, with doc ids,
    with both), on reads with N, bytes absent from the index and bytes past
    its largest character, and DNA cases against the native engine; K10
    also on the classify edge reads at P = 16, 128 and K10_WIDE_P."""
    phase("3d. K9 / K10 (and K4 on K9's pointers) vs plain versions on small "
          "occ-block indexes")
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.blockbits import ranked_rows
    from spumoni_tpu_torch.engine.occblock import seeded_occ

    for ci, (label, n, alphabet, P, docs, long_read) in enumerate(OCC_CASES):
        text, index, table, native = seeded_occ(800 + ci, n, alphabet, docs,
                                                P)
        reads = _small_reads(900 + ci, text, num_reads, 1024)
        reads.append(text[300:340].tobytes() + b"W" + text[900:990].tobytes()
                     + b"YY")
        if alphabet != b"ACGT":   # the text's own alphabet
            rng = np.random.default_rng(1000 + ci)
            reads += [rng.choice(np.unique(text), m).tobytes()
                      for m in rng.integers(1, 1024, size=num_reads // 4)]
        if long_read:
            reads.append(text[:4500].tobytes() + b"N"
                         + text[5000:5700].tobytes())
        tab, rev, fwd, lens = ranked_rows(table, reads,
                                          8192 if long_read else 1024,
                                          device)
        layouts = [(True, docs)] + [lay for lay in OCC_LAYOUTS
                                    if lay != (True, docs)
                                    and (docs or not lay[1])]
        got, done = {}, []
        for samples, doc_rows in layouts:
            if (samples, doc_rows) != (True, docs):
                index = seeded_occ(800 + ci, n, alphabet, docs, P,
                                   samples=samples, doc_rows=doc_rows)[1]
            index = index.to(device)
            modes = [("pml", False)] + ([("ms", False)] if samples else []) \
                + ([("pml", True)] if doc_rows else []) \
                + ([("ms", True)] if samples and doc_rows else [])
            for mode, use_doc in modes:
                out = kernels.occ_scan(index, tab, rev, lens, mode, use_doc)
                sync(device)
                want = kernels.occ_scan_reference(index, tab, rev, lens, mode,
                                                  use_doc)
                if _max_err(out, want):
                    raise AssertionError(
                        f"{label} {OCC_LAYOUTS[samples, doc_rows]}: occ_scan "
                        f"{mode} doc={use_doc} != occ_scan_reference")
                got.setdefault((mode, use_doc), out)
            res = kernels.occ_classify(index, tab, rev, lens, 7, BIN_WIDTH)
            sync(device)
            if _max_err(res, kernels.occ_classify_reference(
                    index, tab, rev, lens, 7, BIN_WIDTH)):
                raise AssertionError(f"{label} {OCC_LAYOUTS[samples, doc_rows]}"
                                     f": occ_classify != plain")
            done.append(f"{OCC_LAYOUTS[samples, doc_rows]} W={index.meta.width}"
                        f" ({len(modes)})")
        # K4 on the pointers (the same in every layout), then the full
        # layout's outputs (the first of each mode) vs native
        ptrs = got["ms", False][0]
        mslen = kernels.ms_extend(index.text, index.text_bound, fwd, lens,
                                  ptrs)
        sync(device)
        if _max_err(mslen, kernels.ms_extend_reference(
                index.text, index.text_bound, fwd, lens, ptrs)):
            raise AssertionError(f"{label}: ms_extend on K9 pointers != "
                                 f"plain")
        edge = ""
        if label == OCC_EDGE_CASE:
            full = seeded_occ(800 + ci, n, alphabet, docs, P)[1].to(device)
            edge = _group_edge_check(
                label, kernels.occ_scan, kernels.occ_scan_reference, full,
                list(got), text, device, table)
        if label in K10_EDGE_CASES:
            edge += "; K10 on the classify" + _group_edge_check(
                label, kernels.occ_classify, kernels.occ_classify_reference,
                index, [(7, BIN_WIDTH)], text, device, table,
                classify=True)[1:]
        checked = ""
        if alphabet.startswith(b"ACGT"):
            # reads without bytes past the largest index character, on
            # which the engines agree (ROADMAP section C)
            top = max(table.index_chars)
            keep = [i for i, rd in enumerate(reads) if max(rd) <= top]
            sub = [reads[i] for i in keep]
            ms_w = native.query_ms(sub, with_docs=docs)
            pml_w = native.query_pml(sub, with_docs=docs)
            want = {"ptr": ms_w[0], "len": ms_w[1],
                    "pml": pml_w[0] if docs else pml_w}
            mats = {"pml": got["pml", False][0], "ptr": ptrs, "len": mslen}
            if docs:
                want.update(pdoc=pml_w[1], mdoc=ms_w[2])
                mats.update(pdoc=got["pml", True][1], mdoc=got["ms", True][1])
            for k, mat in mats.items():
                mat = mat.cpu().numpy()
                for j, i in enumerate(keep):
                    if not np.array_equal(mat[i, :len(want[k][j])],
                                          want[k][j]):
                        raise AssertionError(f"{label}: read {i} {k} != "
                                             f"native engine")
            checked = f", == native ({len(keep)} reads)"
        print(f"{label:16s} P={P} n={index.meta.n} B={len(reads)} "
              f"L={rev.shape[1]}: K9 (modes) and K10 on {', '.join(done)}, "
              f"K4 on K9 pointers == plain, exactly{checked}{edge} "
              f"({int(res[0].sum())} FOUND)")
    text, index, table, _ = seeded_occ(850, 20000, b"ACGT", False,
                                       K10_WIDE_P)
    edge = _group_edge_check(
        "K10 wide P", kernels.occ_classify, kernels.occ_classify_reference,
        index.to(device), [(7, BIN_WIDTH)], text, device, table,
        classify=True)
    print(f"{'dna-P' + str(K10_WIDE_P):16s} P={K10_WIDE_P} n={index.meta.n}"
          f": K10 on the classify{edge[1:]}, == plain, exactly")


#: 3e's CLI runs on its small index: (path, flags, output files)
STAGING_RUNS = (
    ("S-P-c", ["-P", "-c"], (".pseudo_lengths", ".report")),
    ("S-M-c-report-only", ["-M", "-c", "--report-only"], (".report",)),
    ("S-M-c", ["-M", "-c"], (".pointers", ".lengths", ".report")),
)


def _staging_reads(path, text, seed=1300):
    """Writes reads of three buckets as FASTA: L = 256 with 1 in 100 bytes
    N or IUPAC (2 bits with exceptions), L = 512 with 1 in 8 (more than
    the exception list holds: 4 bits), L = 128 of ACGT and one read
    starting with 0xFF (its group's forward rows at 8 bits). The IUPAC
    bytes sort before T, so no read holds a byte past the index's largest
    character (ROADMAP section C). Returns the reads."""
    rng = np.random.default_rng(seed)
    iupac = np.frombuffer(b"NRKMS", np.uint8)

    def sub(m, share=0.0):
        st = int(rng.integers(0, len(text) - m))
        a = text[st:st + m].copy()
        hit = rng.random(m) < share
        a[hit] = rng.choice(iupac, int(hit.sum()))
        return a.tobytes()

    reads = ([sub(int(m), 0.01) for m in rng.integers(129, 257, size=60)]
             + [sub(int(m), 0.125) for m in rng.integers(257, 513, size=60)]
             + [sub(int(m)) for m in rng.integers(64, 129, size=20)]
             + [b"\xff" + sub(100)])
    with open(path, "wb") as f:
        f.write(b"".join(b">s%d\n%s\n" % (i, rd)
                         for i, rd in enumerate(reads)))
    return reads


#: 3e's seeded packed rows (B, L, exceptions): staged widths, a width of no
#: whole 16-byte vector (Q = 5, H = 10), whole vectors and a tail (Q =
#: 1,025), each also 1 byte off the 16-byte boundary with the row ends at
#: the vectors' edges (kernels.edge_lengths)
STAGING_SHAPES = ((7, 128, 0), (33, 256, 40), (5, 8192, 300),
                  (1000, 1024, 5000), (9, 20, 7), (3, 4100, 50))


def staging_phase(device, n=30000, cpu_run=False):
    """3e: K11 / K12 vs plain on seeded packed rows (STAGING_SHAPES, at a
    16-byte boundary and 1 byte past one), then STAGING_RUNS on a small -M
    -P index through the CLI, each run's files equal to a --device cpu
    run's (skipped when the run is on the CPU already), and the MS lengths
    equal to the native engine's."""
    phase("3e. K11 / K12 vs plain versions, and 2- / 4- / 8-bit staging "
          "through the CLI")
    from spumoni_tpu_torch import cli
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.scan_engine import _alpha_table

    table = _alpha_table((0, 1, 65, 67, 71, 78, 84, 255))
    for (seed, (B, L, k)), off in itertools.product(
            enumerate(STAGING_SHAPES), (0, 1)):
        p2, p4, exc, lens = (torch.from_numpy(a).to(device) for a in
                             kernels.seeded_packed(
                                 1400 + seed, B, L, k,
                                 kernels.edge_lengths(B, L) if off else None))
        p2, p4 = kernels.misaligned(p2, off), kernels.misaligned(p4, off)
        exc = exc if k else None
        errs = []
        for values in ((1, 2, 4, 7), (65, 67, 71, 84)):
            got = kernels.unpack2(p2, values, exc, lens)
            sync(device)
            errs.append(_max_err(got, kernels.unpack2_reference(
                p2, values, exc, lens)))
        for tab in (None, table):
            got = kernels.unpack4(p4, lens, tab)
            sync(device)
            errs.append(_max_err(got, kernels.unpack4_reference(p4, lens,
                                                                tab)))
        where = " 1 byte off 16, edge lengths" if off else ""
        if any(errs):
            raise AssertionError(f"B={B} L={L} k={k}{where}: K11 / K12 != "
                                 f"plain (max |err| {errs})")
        print(f"B={B} L={L} exceptions={k}{where}: K11 (2 tables) == plain, "
              f"K12 (plain, byte table) == plain; max |err| 0")

    work = os.path.join(WORK, "staging")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(1310)
    text = rng.choice(ACGT, n)
    ref = os.path.join(work, "small.fa")
    with open(ref, "wb") as f:
        f.write(b">small\n" + text.tobytes() + b"\n")
    prefix = os.path.join(work, "stg")
    cli.main(["build", "-r", ref, "-M", "-P", "-n", "-o", prefix])
    reads_path = os.path.join(work, "reads.fa")
    reads = _staging_reads(reads_path, text)
    base = ["run", "-r", prefix, "-p", reads_path, "-n"]
    stats = {}
    for label, flags, exts in STAGING_RUNS:
        stats[label] = _timed_cli_run(device, label, base + flags + (
            ["--device", "cpu"] if cpu_run else []), cpu_run)
        got = _file_hashes(reads_path, exts)
        if not cpu_run:
            cli.main(base + flags + ["--device", "cpu"])
            want = _file_hashes(reads_path, exts)
            bad = [ext for ext in exts if got[ext] != want[ext]]
            if bad:
                raise AssertionError(f"{label}: {bad} differ from the "
                                     f"--device cpu run's")
    vals = _read_values(reads_path + ".lengths")
    want = _native_engine(prefix + ".fa.thrbv.ms").query_ms(reads)[1]
    for i, w in enumerate(want):
        if not np.array_equal(vals[f"s{i}"], w):
            raise AssertionError(f"s{i}: MS lengths != native engine")
    _print_runs(stats)
    print(f"checks: {len(STAGING_RUNS)} runs' files == --device cpu runs' "
          f"(staged at 2 bits with exceptions, at 4 bits, and with the 0xFF "
          f"read's forward rows at 8 bits); {len(reads)} reads' MS lengths "
          f"== native engine")
    return stats


#: 3f's block-bits cases: label, layout, text length (n = length + 1)
TP_CASES = [
    ("P512-pack2", dict(P=512, pack=2, wide=False), 20000),
    ("P256-pack4-wide", dict(P=256, pack=4, wide=True), 20000),
    ("n-multiple-of-P", dict(P=64, pack=2, wide=False), 4095),
]
#: shard counts of 3f: none, uneven padding, the main path's
TP_SHARDS = (1, 3, 4)


def _quirk(text):
    """ROADMAP section C's read: W sorts after every index character."""
    return text[100:160].tobytes() + b"W" + text[200:260].tobytes()


def _tp_reads(seed, text, num, max_len):
    """3f's reads, none longer than max_len: _small_reads' mutated and
    random reads, then reads with N and bytes absent from the index, the
    text's end and section C's read."""
    return _small_reads(seed, text, num, max_len)[:num] + [
        b"N" * 64, b"NXY" + text[:100].tobytes() + b"Q",
        text[-100:].tobytes(), _quirk(text)]


def small_tp_phase(device, num_reads=60, max_len=128):
    """3f: on small MS + doc block-bits indexes cut into 1, 3 and 4 shards,
    K13, K15 in its three modes and K16 against their plain versions and
    their unsharded twins K2, K3 and K4; on small layered indexes K14
    against its plain version and K8, also on the classify edge reads
    (_k14_edge_check). The reads hold bytes past every index
    character (ROADMAP section C). Where n is a multiple of P, such a read
    reaches position n in a pad row, which the twins clamp to the last real
    row: there only the plain versions must agree (the JAX sharded path
    differs from its replicated one the same way). K16 also runs on a
    seeded matrix of pointers that are no MS pointers at S = 3."""
    phase("3f. K13-K16 vs plain versions and unsharded twins on small "
          "sharded indexes")
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.blockbits import ranked_rows
    from spumoni_tpu_torch.engine.layered import raw_rows, seeded_layered
    from spumoni_tpu_torch.parallel import tp

    for ci, (label, build_kw, n) in enumerate(TP_CASES):
        text, index, table, _ = _small_index(1600 + ci, n, b"ACGT", False,
                                             build_kw, ms=True)
        reads = _tp_reads(1700 + ci, text, num_reads, max_len)
        tab, rev, fwd, lens = ranked_rows(table, reads, max_len, device)
        shards = {S: tp.shard_blockbits_ms(index, S).to(device)
                  for S in TP_SHARDS}
        index = index.to(device)
        twin_ok = index.meta.n % index.meta.P != 0
        plain_err = twin_err = 0
        for S, sh in shards.items():
            pairs = []
            got = kernels.pml_classify_tp(sh, tab, rev, lens, 7, BIN_WIDTH)
            pairs.append((got, kernels.pml_classify_tp_reference(
                sh, tab, rev, lens, 7, BIN_WIDTH), kernels.pml_classify(
                index, tab, rev, lens, 7, BIN_WIDTH)))
            for mode, doc in MS_MODES:
                want = kernels.ms_scan_tp_reference(sh, tab, rev, lens, mode,
                                                    doc)
                twin = kernels.ms_scan(index, tab, rev, lens, mode, doc)
                pairs.append((kernels.ms_scan_tp(sh, tab, rev, lens, mode,
                                                 doc), want, twin))
            ptrs = kernels.ms_scan_tp(sh, tab, rev, lens, "ms", False)[0]
            got = kernels.ms_extend_tp(sh.text, sh.text_bound, fwd, lens,
                                       ptrs)
            pairs.append((got, kernels.ms_extend_tp_reference(
                sh.text, sh.text_bound, fwd, lens, ptrs), kernels.ms_extend(
                index.text, index.text_bound, fwd, lens, ptrs)))
            sync(device)
            plain_err = max([plain_err] + [_max_err(g, w)
                                           for g, w, _ in pairs])
            twin_err = max([twin_err] + [_max_err(g, t) for g, _, t in pairs])
        # K15 at S = 4 on the edge reads: against its twin K3 (held to its
        # plain version on them in 3b) at L = 1,024 and, in the first case,
        # also against its plain version at L = 1,021
        S = TP_SHARDS[-1]
        edge_err = 0
        if twin_ok:
            edge_err = _scan_errs(kernels.ms_scan_tp, shards[S],
                                   kernels.ms_scan, index, table,
                                   kernels.ms_edge_reads(text, 1024), 1024,
                                   device)
        if ci == 0:
            edge_err = max(edge_err, _scan_errs(
                kernels.ms_scan_tp, shards[S], kernels.ms_scan_tp_reference,
                shards[S], table, kernels.ms_edge_reads(text, 1021), 1021,
                device))
        if plain_err or edge_err or (twin_ok and twin_err):
            raise AssertionError(f"{label}: K13 / K15 / K16 != plain (max "
                                 f"|err| {plain_err}; K15 on the edge reads "
                                 f"{edge_err}) or twins ({twin_err})")
        # K13 at every S on K2 / K13's edge reads, against its plain
        # version: the main path's layout, and n a multiple of P (the W
        # read in a pad row)
        k13_edge = ""
        if ci == 0 or not twin_ok:
            for sh in shards.values():
                k13_edge = _group_edge_check(
                    label, kernels.pml_classify_tp,
                    kernels.pml_classify_tp_reference, sh, [(7, BIN_WIDTH)],
                    text, device, table, classify=True)
            k13_edge = f"; K13 at S={TP_SHARDS}{k13_edge}"
        print(f"{label:16s} P={index.meta.P} pack={index.meta.pack} "
              f"wide={index.meta.wide} n={index.meta.n} S={TP_SHARDS} "
              f"B={len(reads)}: K13, K15 (3 modes), K16 == plain, max |err| "
              f"0; K15 at S={S}"
              f" on the edge reads: " + ("== K3 at L = 1024" if twin_ok
                                         else "not run (pad row)")
              + ("; == plain at L = 1021" if ci == 0 else "")
              + k13_edge
              + f"; vs twins K2, K3, K4: max |err| {twin_err}"
              + ("" if twin_ok else " (position n in a pad row)"))
    print(_extend_check(device, 1021, wide=False, S=3) + ", exactly")
    for ci, docs in enumerate((False, True)):
        text, index, _ = seeded_layered(1800 + ci, 20000, docs=docs)
        reads = _tp_reads(1900 + ci, text, num_reads, max_len)
        rev, _, lens = raw_rows(reads, max_len, device)
        shards = {S: tp.shard_layered(index, S).to(device)
                  for S in TP_SHARDS}
        index = index.to(device)
        errs = []
        for S, sh in shards.items():
            got = kernels.layered_classify_tp(sh, rev, lens, 7, BIN_WIDTH)
            sync(device)
            errs += [_max_err(got, kernels.layered_classify_tp_reference(
                sh, rev, lens, 7, BIN_WIDTH)), _max_err(
                got, kernels.layered_classify(index, rev, lens, 7,
                                              BIN_WIDTH))]
        if any(errs):
            raise AssertionError(f"layered docs={docs}: K14 != plain or K8 "
                                 f"(max |err| {errs})")
        m = shards[3].meta
        print(f"layered{'-docs' if docs else '':9s} D={m.depth} W={m.width} "
              f"r={m.r} S={TP_SHARDS} (bound {m.probe_bound} at S=3) "
              f"B={len(reads)}: K14 == plain == K8, max |err| 0")
    _k14_edge_check(device)


def _k14_edge_check(device):
    """3f: K14 at every S of TP_SHARDS on kernels.classify_edge_reads at
    L = 1,024 and 1,021, against its plain version and its twin K8, at
    int32 and int64 positions: on a 4,095-base index without samples (W =
    4, seed 12), whose W read probes past the real field rows into a pad
    row, and on a two-document index with samples (W = 8)."""
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.layered import (build_layered, raw_rows,
                                                  seeded_layered)
    from spumoni_tpu_torch.index import format as fmt
    from spumoni_tpu_torch.native import build_raw_index
    from spumoni_tpu_torch.parallel import tp

    ptext = np.random.default_rng(12).choice(ACGT, 4095)
    pdense = fmt.build_dense_index(build_raw_index(ptext))
    for dtype in (np.int32, np.int64):
        for label, (text, index) in (
                ("pad-row", (ptext, build_layered(pdense, dtype=dtype))),
                ("two-docs", seeded_layered(1850, 9000, docs=True,
                                            dtype=dtype)[:2])):
            errs = []
            flat = index.to(device)
            for S in TP_SHARDS:
                sh = tp.shard_layered(index, S).to(device)
                for L in (1024, 1021):
                    rev, _, lens = raw_rows(
                        kernels.classify_edge_reads(text, L), L, device)
                    got = kernels.layered_classify_tp(sh, rev, lens, 7,
                                                      BIN_WIDTH)
                    sync(device)
                    plain = kernels.layered_classify_tp_reference(
                        sh, rev, lens, 7, BIN_WIDTH)
                    twin = kernels.layered_classify(flat, rev, lens, 7,
                                                    BIN_WIDTH)
                    errs += [_max_err(got, plain), _max_err(got, twin)]
            if any(errs):
                raise AssertionError(f"K14 {label} {np.dtype(dtype).name} on "
                                     f"the edge reads != plain or K8 (max "
                                     f"|err| {errs})")
            m = index.meta
            print(f"{label + ' ' + np.dtype(dtype).name:16s} W={m.width} "
                  f"wide={m.wide} r={m.r} S={TP_SHARDS}: K14 on the "
                  f"classify edge reads at L = 1024, 1021 == plain == K8, "
                  f"max |err| 0")


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
    # the same strains as one file each (one document each) for 4b
    with open(os.path.join(work, "strains.txt"), "w") as lst:
        for i, c in enumerate(copies):
            path = os.path.join(work, f"strain_{i}.fa")
            with open(path, "wb") as f:
                f.write(b">strain_%d synthetic\n" % i + c.tobytes() + b"\n")
            lst.write(f"{path} {i + 1}\n")
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


def _read_values(path, ids=None):
    """{read id: np.ndarray} of a value file (.pseudo_lengths, .lengths,
    .pointers, .doc_numbers); with `ids`, reads outside it map to None
    (counted, not parsed). Values print as unsigned 64-bit (negative MS
    pointers), so they are read back as uint64 and viewed as int64."""
    out = {}
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    for i in range(0, len(lines) - 1, 2):
        rid = lines[i][1:].decode()
        out[rid] = None if ids is not None and rid not in ids else np.array(
            lines[i + 1].split(), dtype=np.uint64).view(np.int64)
    return out


def _sampled_reads(reads, n_reads, n_check):
    """n_check read ids drawn with seed 1, and their sequences."""
    from spumoni_tpu_torch.io.fasta import read_fastx

    seqs = {rec.name: rec.seq for rec in read_fastx(reads)}
    ids = list(seqs)
    sample = np.random.default_rng(1).choice(
        n_reads, size=min(n_check, n_reads), replace=False)
    chk = [ids[i] for i in sample]
    return chk, [seqs[i] for i in chk]


def _read_report(path):
    with open(path) as f:
        next(f)
        return {p[0]: p[1] for p in (ln.split() for ln in f) if p}


def _native_engine(index_path):
    """The native CPU engine over a dense index, with its SA samples, doc
    arrays and text where the index has them (the JAX package's CPU
    engine set-up, run-major order restored)."""
    from spumoni_tpu_torch import pipeline as pl
    from spumoni_tpu_torch.native import NativeQueryEngine

    dense = pl.load_dense_index(index_path)
    zeros = np.zeros(dense.r, dtype=np.int64)
    ss = pl._unorder_samples(dense, "c_ssamp")
    es = pl._unorder_samples(dense, "c_esamp")
    return NativeQueryEngine(
        dense.n, dense.run_heads, dense.run_starts,
        pl._unorder(dense, "c_thr"), zeros if ss is None else ss,
        zeros if es is None else es, start_doc=pl._unorder(dense, "c_sdoc"),
        end_doc=pl._unorder(dense, "c_edoc"), text=dense.text)


class _KernelTimer:
    """CUDA-event time around every call of a wrapper while installed (the
    wrapper itself, and so its launch count, is unchanged). Where the card
    is idle when the first event is recorded, the time holds the host's
    work in the wrapper too: an upper bound of the kernel's time."""

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


#: path -> the kernels it launches; a path must launch each of them, and no
#: other (a CPU run launches none)
PATH_KERNELS = {
    "P-c": ("pml_scan", "unpack2"),
    "P-c-report-only": ("pml_classify", "unpack2"),
    "M-c-report-only": ("ms_scan", "ms_extend", "binmax_values", "unpack2"),
    "M-c-d": ("ms_scan", "ms_extend", "unpack2"),
    "P-d-c": ("ms_scan", "unpack2"),
    "L-P-c-report-only": ("layered_classify", "unpack2"),
    "L-P-c": ("layered_scan", "unpack2"),
    "L-M-c-report-only": ("layered_scan", "ms_extend", "binmax_values",
                          "unpack2"),
    "L-M-c-d": ("layered_scan", "ms_extend", "unpack2"),
    "L-P-d-c": ("layered_scan", "unpack2"),
    "m-P-c-report-only": ("layered_classify",),   # -m rows stage at 8 bits
    "m-P-c": ("layered_scan",),
    "a-P-c-report-only": ("pml_classify", "unpack2"),
    "O-P-c-report-only": ("occ_classify", "unpack2"),
    "O-P-c": ("occ_scan", "unpack2"),
    "O-M-c-report-only": ("occ_scan", "ms_extend", "binmax_values",
                          "unpack2"),
    "O-M-c-d": ("occ_scan", "ms_extend", "unpack2"),
    "O-P-d-c": ("occ_scan", "unpack2"),
    "S-P-c": ("pml_scan", "unpack2", "unpack4"),
    "S-M-c-report-only": ("ms_scan", "ms_extend", "binmax_values", "unpack2",
                          "unpack4"),
    "S-M-c": ("ms_scan", "ms_extend", "unpack2", "unpack4"),
    "T-P-c-report-only": ("pml_classify_tp", "unpack2"),
    "T-L-P-c-report-only": ("layered_classify_tp", "unpack2"),
    "T-M-c-d": ("ms_scan_tp", "ms_extend_tp", "unpack2"),
    "exp_vmem_gather": ("gather_chase",),
    "D-P-classify": ("pml_classify", "unpack2"),
    "D-P-query": ("pml_scan", "unpack2"),
    "D-M-d-query": ("ms_scan", "ms_extend", "unpack2"),
    "F-P-c": ("pml_scan", "unpack2"),
    "F-M-c-d": ("ms_scan", "ms_extend", "unpack2"),
    "H-P-c": ("pml_scan", "unpack2"),
    "H-M-c-d": ("ms_scan", "ms_extend", "unpack2"),
}


def _check_launches(path, counts, cpu_run=False):
    owns = () if cpu_run else PATH_KERNELS[path]
    if any((n > 0) != (name in owns) for name, n in counts.items()):
        raise AssertionError(f"path {path} launched {counts}; it must "
                             f"launch {owns or 'no kernel'} and no other")


def _timed_cli_run(device, path, args, cpu_run=False):
    """Runs the port's CLI once as `path` of PATH_KERNELS, with the launch
    counts set to 0 just before and read just after (and checked); returns
    pipeline.LAST_RUN_STATS plus the wall time, the launch counts and, on a
    GPU, the CUDA-event time of every launch of the path's kernels."""
    from spumoni_tpu_torch import cli, pipeline
    from spumoni_tpu_torch.engine import kernels

    timers = ([_KernelTimer(kernels, name) for name in PATH_KERNELS[path]]
              if device.type == "cuda" else [])
    for t in timers:
        t.__enter__()
    kernels.reset_launch_counts()
    t0 = time.time()
    try:
        cli.main(args)
    finally:
        for t in timers:
            t.__exit__()
    sync(device)
    st = dict(pipeline.LAST_RUN_STATS, wall_s=time.time() - t0,
              launches=kernels.launch_counts())
    _check_launches(path, st["launches"], cpu_run)
    if timers:
        st["kernel_ms_by"] = {t.name: t.ms() for t in timers}
        st["kernel_ms"] = sum(st["kernel_ms_by"].values())
    return st


def _print_runs(stats):
    for label, st in stats.items():
        kms = st.get("kernel_ms", float("nan"))
        own = {k: st["launches"][k] for k in PATH_KERNELS[label]}
        print(f"run {label}: {st['reads']} reads in {st['stream_s']:.3f} s "
              f"streaming -> {st['reads'] / st['stream_s']:.1f} reads/s; "
              f"wall {st['wall_s']:.1f} s; in-run event time {kms:.3f} ms "
              + "".join(f"({' + '.join(f'{k} {v:.3f}' for k, v in by.items())}) "
                        for by in [st.get("kernel_ms_by")] if by)
              + f"launches {own}, no other kernel")


def _found_rates(report_path, check=True):
    """(FOUND share of pos_* reads, of neg_* reads); with check, fails
    outside >= 0.95 and <= 0.05."""
    status = _read_report(report_path)
    pos = np.mean([status[r] == "FOUND" for r in status
                   if r.startswith("pos")])
    neg = np.mean([status[r] == "FOUND" for r in status
                   if r.startswith("neg")])
    if check and (pos < 0.95 or neg > 0.05):
        raise AssertionError(f"{os.path.basename(report_path)}: {pos:.3f} of "
                             f"positives and {neg:.3f} of negatives FOUND")
    return pos, neg


def write_inputs(strains, strain_len=4_600_000, n_reads=65536,
                 read_len=1024):
    """Phase 4's inputs (make_inputs) in a fresh WORK: returns the paths of
    the pangenome FASTA and of the reads."""
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.time()
    ref, reads = make_inputs(WORK, strains, strain_len, n_reads, read_len)
    print(f"inputs written in {time.time() - t0:.1f} s: {strains} strains x "
          f"{strain_len} bp, {n_reads} reads x {read_len} bp")
    return ref, reads


def _build_args():
    """{build: CLI arguments} of the indexes of phases 4, 4b and 4c, on
    write_inputs' files."""
    ref = os.path.join(WORK, "pangenome.fa")
    return {
        "-P -n": ["build", "-r", ref, "-P", "-n", "-o",
                  os.path.join(WORK, "idx")],
        "-M -P -d": ["build", "-i", os.path.join(WORK, "strains.txt"), "-M",
                     "-P", "-d", "-n", "-o", os.path.join(WORK, "msidx")],
        "-m -P": ["build", "-r", ref, "-P", "-m", "-o",
                  os.path.join(WORK, "idx-m")],
        "-a -P": ["build", "-r", ref, "-P", "-a", "-o",
                  os.path.join(WORK, "idx-a")],
    }


def run_builds():
    """Builds phases 4-4c's indexes through the CLI, one after another;
    returns {build: seconds} and writes it to WORK/builds.json."""
    from spumoni_tpu_torch import cli

    secs = {}
    for key, args in _build_args().items():
        t0 = time.time()
        cli.main(args)
        secs[key] = time.time() - t0
    with open(os.path.join(WORK, "builds.json"), "w") as f:
        json.dump(secs, f)
    return secs


def start_builds(strains, n_reads):
    """write_inputs, then run_builds in a process of its own (this script
    with --builds-only), so that the CPU-bound builds run while the kernels
    build and phases 3-3f hold the card; its output goes to
    WORK/builds.log."""
    phase("2. inputs of phases 4-4e, and their index builds started in the "
          "background")
    write_inputs(strains, n_reads=n_reads)
    with open(os.path.join(WORK, "builds.log"), "wb") as log:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--builds-only"],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO)


def wait_builds(proc):
    """Waits for start_builds' process and prints its log; fails unless
    every build ended. Returns {build: seconds}."""
    t0 = time.time()
    rc = proc.wait()
    with open(os.path.join(WORK, "builds.log"), errors="replace") as f:
        print(f.read(), end="")
    if rc:
        raise RuntimeError(f"the background index builds failed (rc {rc})")
    with open(os.path.join(WORK, "builds.json")) as f:
        secs = json.load(f)
    print(f"builds (in the background): "
          + ", ".join(f"build {k}: {v:.1f} s" for k, v in secs.items())
          + f"; waited {time.time() - t0:.1f} s for them")
    return secs


def main_path_phase(device, builds, strains, strain_len=4_600_000,
                    n_reads=65536, read_len=1024, n_check=2048,
                    cpu_run=False):
    """4: the runs on write_inputs' files and the `-P -n` index of
    run_builds (builds: its seconds)."""
    phase(f"4. main path: {strains} strains x {strain_len} bp, "
          f"{n_reads} reads x {read_len} bp, through the CLI")
    reads = os.path.join(WORK, "reads.fa")
    prefix = os.path.join(WORK, "idx")
    print(f"build: {builds['-P -n']:.1f} s")

    run_args = ["run", "-r", prefix, "-p", reads, "-P", "-n", "-c"]
    if cpu_run:
        run_args += ["--device", "cpu"]
    stats = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for label, extra in (("P-c", []), ("P-c-report-only", ["--report-only"])):
        stats[label] = _timed_cli_run(device, label, run_args + extra,
                                      cpu_run)
        shutil.copy(reads + ".report", reads + f".{label}.report")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    # checks
    with open(reads + ".P-c.report", "rb") as f:
        full = f.read()
    with open(reads + ".P-c-report-only.report", "rb") as f:
        fused = f.read()
    if full != fused:
        raise AssertionError("--report-only .report differs from the full "
                             "run's")
    chk, chk_seqs = _sampled_reads(reads, n_reads, n_check)
    vals = _read_values(reads + ".pseudo_lengths", set(chk))
    if len(vals) != n_reads:
        raise AssertionError(f"{len(vals)} value records, {n_reads} reads")
    want = _native_engine(prefix + ".fa.thrbv.spumoni").query_pml(
        chk_seqs, threads=os.cpu_count() or 1)
    for rid, w in zip(chk, want):
        if not np.array_equal(vals[rid], w):
            raise AssertionError(f"{rid}: .pseudo_lengths != native engine")
    pos_found, neg_found = _found_rates(reads + ".P-c-report-only.report")
    _print_runs(stats)
    print(f"checks: reports identical; {len(chk)} sampled reads == native "
          f"engine; FOUND: {pos_found:.4f} of positives, {neg_found:.4f} of "
          f"negatives; peak device memory {peak / 1e6:.1f} MB")
    return prefix, reads, stats


def ms_main_path_phase(device, builds, reads, n_reads, n_check=2048,
                       cpu_run=False):
    """4b: the strains of phase 4 as 10 documents, built with -M -P -d
    (run_builds), and the MS report-only, MS + doc value and PML + doc
    value runs over phase 4's reads (a copy, so phase 4's outputs stay)."""
    phase(f"4b. MS / doc main path: the strains as documents, {n_reads} "
          f"reads, through the CLI")
    prefix = os.path.join(WORK, "msidx")
    build_s = builds["-M -P -d"]
    print(f"build -M -P -d: {build_s:.1f} s")
    ms_reads = os.path.join(WORK, "reads_ms.fa")
    shutil.copy(reads, ms_reads)
    base = ["run", "-r", prefix, "-p", ms_reads, "-n"] + (
        ["--device", "cpu"] if cpu_run else [])
    chk, chk_seqs = _sampled_reads(ms_reads, n_reads, n_check)
    chk_set = set(chk)
    stats, vals = {}, {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    hashes = {}    # run -> {output file: sha256}, held against 4c-4e
    for label, extra, exts in (
            ("M-c-report-only", ["-M", "-c", "--report-only"], ()),
            ("M-c-d", ["-M", "-c", "-d"],
             (".pointers", ".lengths", ".doc_numbers")),
            ("P-d-c", ["-P", "-d", "-c"],
             (".pseudo_lengths", ".doc_numbers"))):
        stats[label] = _timed_cli_run(device, label, base + extra, cpu_run)
        shutil.copy(ms_reads + ".report", ms_reads + f".{label}.report")
        hashes[label] = _file_hashes(ms_reads, exts + (".report",))
        for ext in exts:   # read now: the next run rewrites .doc_numbers
            vals[label, ext] = _read_values(ms_reads + ext, chk_set)
            if len(vals[label, ext]) != n_reads:
                raise AssertionError(f"{label}{ext}: {len(vals[label, ext])} "
                                     f"records, {n_reads} reads")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    # checks
    with open(ms_reads + ".M-c-report-only.report", "rb") as f:
        fused = f.read()
    with open(ms_reads + ".M-c-d.report", "rb") as f:
        full = f.read()
    if fused != full:
        raise AssertionError("-M --report-only .report differs from the "
                             "-M -d value run's")
    threads = os.cpu_count() or 1
    wptr, wlen, wdoc = _native_engine(prefix + ".fa.thrbv.ms").query_ms(
        chk_seqs, with_docs=True, threads=threads)
    plen, pdoc = _native_engine(prefix + ".fa.thrbv.spumoni").query_pml(
        chk_seqs, with_docs=True, threads=threads)
    for label, ext, want in (
            ("M-c-d", ".pointers", wptr),
            ("M-c-d", ".lengths", wlen),
            ("M-c-d", ".doc_numbers", wdoc),
            ("P-d-c", ".pseudo_lengths", plen),
            ("P-d-c", ".doc_numbers", pdoc)):
        for rid, w in zip(chk, want):
            if not np.array_equal(vals[label, ext][rid], w):
                raise AssertionError(f"{label}: {rid}{ext} != native engine")
    ms_found = _found_rates(ms_reads + ".M-c-report-only.report")
    pml_found = _found_rates(ms_reads + ".P-d-c.report")
    _print_runs(stats)
    print(f"checks: MS reports identical; {len(chk)} sampled reads' "
          f".pointers/.lengths/.doc_numbers (MS) and .pseudo_lengths/"
          f".doc_numbers (PML) == native engine; FOUND (pos, neg): MS "
          f"{ms_found[0]:.4f} {ms_found[1]:.4f}, PML {pml_found[0]:.4f} "
          f"{pml_found[1]:.4f}; build {build_s:.1f} s; peak device memory "
          f"{peak / 1e6:.1f} MB")
    return prefix, ms_reads, stats, hashes


def _file_hashes(prefix, exts):
    """{ext: sha256 hex} of the files prefix + ext."""
    out = {}
    for ext in exts:
        h = hashlib.sha256()
        with open(prefix + ext, "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                h.update(block)
        out[ext] = h.hexdigest()
    return out


#: 4c's layered runs on 4b's index: (path, flags, output files, the 4b
#: block-bits run whose files they must equal byte for byte)
LAYERED_RUNS = (
    ("L-P-c-report-only", ["-P", "-c", "--report-only"], (".report",),
     "P-d-c"),
    ("L-P-c", ["-P", "-c"], (".pseudo_lengths", ".report"), "P-d-c"),
    ("L-M-c-report-only", ["-M", "-c", "--report-only"], (".report",),
     "M-c-report-only"),
    ("L-M-c-d", ["-M", "-c", "-d"],
     (".pointers", ".lengths", ".doc_numbers", ".report"), "M-c-d"),
    ("L-P-d-c", ["-P", "-d", "-c"],
     (".pseudo_lengths", ".doc_numbers", ".report"), "P-d-c"),
)


#: 4d's occ-block runs on 4b's index, in the same form
OCC_RUNS = tuple(("O" + label[1:], flags, exts, twin)
                 for label, flags, exts, twin in LAYERED_RUNS)


def layered_main_path_phase(device, ms_prefix, ms_reads, hashes,
                            cpu_run=False):
    """4c, first half: 4b's index and reads with --engine layered, in every
    run mode; each output file must equal the block-bits run's of 4b (both
    engines are exact), which holds K7 / K8 on the card without JAX."""
    phase("4c. the layered engine on 4b's index (--engine layered), "
          "through the CLI")
    return _twin_runs(device, "layered", LAYERED_RUNS, ms_prefix, ms_reads,
                      hashes, cpu_run)


def occ_main_path_phase(device, ms_prefix, ms_reads, hashes, cpu_run=False):
    """4d: 4b's index and reads with --engine occ in every run mode, each
    output file equal to the block-bits run's of 4b: K10, K9, K9 -> K4 ->
    K5, K9 -> K4 and K9 on the card, at n ~ 92 M (past the JAX package's
    occ bound n <= 2^24)."""
    phase("4d. the occ-block engine on 4b's index (--engine occ), through "
          "the CLI")
    return _twin_runs(device, "occ", OCC_RUNS, ms_prefix, ms_reads, hashes,
                      cpu_run)


def _twin_runs(device, engine, runs, ms_prefix, ms_reads, hashes, cpu_run):
    """Runs each (path, flags, output files, 4b twin) of `runs` with
    --engine `engine`; fails unless every output file equals the twin's."""
    base = ["run", "-r", ms_prefix, "-p", ms_reads, "-n", "--engine",
            engine] + (["--device", "cpu"] if cpu_run else [])
    stats = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for label, extra, exts, twin in runs:
        stats[label] = _timed_cli_run(device, label, base + extra, cpu_run)
        got = _file_hashes(ms_reads, exts)
        bad = [ext for ext in exts if got[ext] != hashes[twin][ext]]
        if bad:
            raise AssertionError(f"{label}: {bad} differ from the "
                                 f"block-bits run {twin}")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    _print_runs(stats)
    print(f"checks: every output file of the {len(runs)} {engine} runs is "
          f"byte-identical to its block-bits run; peak device memory "
          f"{peak / 1e6:.1f} MB")
    return stats


#: 4e's sharded runs: (path, flags, output files, the twin run of 4 / 4b)
TP_RUNS = (
    ("T-P-c-report-only", ["-P", "-c", "--report-only"], (".report",),
     "P-c-report-only"),
    ("T-L-P-c-report-only", ["--engine", "layered", "-P", "-c",
                             "--report-only"], (".report",), "P-d-c"),
    ("T-M-c-d", ["-M", "-c", "-d"],
     (".pointers", ".lengths", ".doc_numbers", ".report"), "M-c-d"),
)


def tp_main_path_phase(device, prefix, reads, ms_prefix, ms_reads, hashes,
                       cpu_run=False):
    """4e: TP_RUNS with `--tp-devices 4`, the first on phase 4's index and
    reads, the others on 4b's (no new build); every output file must equal
    its twin run's, the unsharded run of the same mode: K13, K14, and K15
    -> K16 on the card, each shard on cuda:0."""
    phase("4e. the sharded index (--tp-devices 4) on 4's and 4b's indexes, "
          "through the CLI")
    twins = dict(hashes, **{"P-c-report-only": _file_hashes(
        reads + ".P-c-report-only", (".report",))})
    dev = ["--device", "cpu"] if cpu_run else []
    stats = {}
    for label, flags, exts, twin in TP_RUNS:
        idx, rd = (prefix, reads) if twin == "P-c-report-only" \
            else (ms_prefix, ms_reads)
        stats[label] = _timed_cli_run(
            device, label, ["run", "-r", idx, "-p", rd, "-n", *flags,
                            "--tp-devices", "4", *dev], cpu_run)
        got = _file_hashes(rd, exts)
        bad = [ext for ext in exts if got[ext] != twins[twin][ext]]
        if bad:
            raise AssertionError(f"{label}: {bad} differ from the unsharded "
                                 f"run {twin}")
    _print_runs(stats)
    print(f"checks: every output file of the {len(TP_RUNS)} sharded runs is "
          f"byte-identical to its unsharded twin run's")
    return stats


#: 4f's runs, each path of it (the engine API on [cuda:0, cuda:0]; the
#: single-process CLI runs; the two gloo processes): (label, flags, index
#: of phase 4 or 4b, output files)
DP_RUNS = (("P-c", ["-P"], "idx", (".pseudo_lengths", ".report")),
           ("M-c-d", ["-M", "-d"], "msidx",
            (".pointers", ".lengths", ".doc_numbers", ".report")))
#: 4f's reads: the first of phase 4's
DP_READS = 8192
#: seconds a 4f worker pair may take
DP_TIMEOUT_S = 300

_DP_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from spumoni_tpu_torch import cli, pipeline
from spumoni_tpu_torch.engine import kernels
kernels.reset_launch_counts()
cli.main(sys.argv[2:])
print(json.dumps({"launches": kernels.launch_counts(),
                  "stats": pipeline.LAST_RUN_STATS}))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_engine_runs(device, prefix, ms_prefix, pk, cpu_run):
    """4f (a): classify_staged / query_staged on phase 4's index and -M -d
    query_staged on 4b's, each on an engine made data-parallel over
    [device, device] (ScanEngine.to_devices: the lanes of each group in
    two slices, launched before either is fetched) and on the one-device
    engine, outputs equal; the launch counts of the two-device calls only
    (paths D-*)."""
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.scan_engine import ScanEngine

    stats = {}
    pml = prefix + ".fa.thrbv.spumoni"
    for label, one, lanes in (
            ("D-P-classify", _engine(pml, device), 32768),
            ("D-P-query", _engine(pml, device), 8192),
            ("D-M-d-query", _engine(ms_prefix + ".fa.thrbv.ms", device, "ms",
                                    use_doc=True), 8192)):
        two = ScanEngine(one.index, one.table, mode=one.mode,
                         use_doc=one.use_doc).to_devices([device, device])
        if label.endswith("classify"):
            want = one.classify_staged(one.stage(pk, lanes), BIN_WIDTH, 7)
            staged = two.stage(pk, lanes)
            sync(device)
            kernels.reset_launch_counts()
            t0 = time.time()
            got = two.classify_staged(staged, BIN_WIDTH, 7)
        else:
            want = one.query_staged(one.stage(pk, lanes))
            staged = two.stage(pk, lanes)
            sync(device)
            kernels.reset_launch_counts()
            t0 = time.time()
            got = two.query_staged(staged)
        secs = time.time() - t0
        counts = kernels.launch_counts()
        _check_launches(label, counts, cpu_run)
        parts = sorted({g["replica"] for g in staged})
        for key, w in want.items():
            g = got[key]
            same = (np.array_equal(g, w) if isinstance(w, np.ndarray) else
                    len(g) == len(w) and all(np.array_equal(a, b)
                                             for a, b in zip(g, w)))
            if not same:
                raise AssertionError(f"{label}: {key} on two devices != one")
        stats[label] = dict(launches=counts, reads=len(pk), stream_s=secs)
        own = {k: counts[k] for k in PATH_KERNELS[label]}
        print(f"{label}: {len(pk)} reads, {len(staged)} staged parts on "
              f"replicas {parts}, {secs:.3f} s ({len(pk) / secs:.1f} "
              f"reads/s) on two devices; launches {own}, no other kernel; "
              f"every output == the one-device engine's")
    return stats


def _dp_processes(runs, cpu_run):
    """4f (b): each (label, argv) of `runs` in two worker processes joined
    by gloo on 127.0.0.1 (SPUMONI_NUM_PROCESSES=2), one run's pair at a
    time (the two workers of a run start together); returns {label: (wall
    seconds, [each worker's last line])}. Fails when a worker fails or
    outlasts DP_TIMEOUT_S; ends every worker it started."""
    out = {}
    for label, argv in runs:
        port = _free_port()
        procs = []
        t0 = time.time()
        try:
            for p in range(2):
                env = dict(os.environ, SPUMONI_COORDINATOR=f"127.0.0.1:{port}",
                           SPUMONI_NUM_PROCESSES="2",
                           SPUMONI_PROCESS_ID=str(p))
                log = open(os.path.join(WORK, f"4f-{label}-{p}.log"), "w+b")
                procs.append((p, log, subprocess.Popen(
                    [sys.executable, "-c", _DP_WORKER, REPO, *argv]
                    + (["--device", "cpu"] if cpu_run else []),
                    stdout=log, stderr=subprocess.STDOUT, env=env)))
            lines = []
            for p, log, proc in procs:
                rc = proc.wait(timeout=max(1.0, DP_TIMEOUT_S
                                           - (time.time() - t0)))
                log.seek(0)
                text = log.read().decode(errors="replace")
                if rc:
                    raise RuntimeError(f"4f worker {label}/{p} failed (rc "
                                       f"{rc}):\n{text[-3000:]}")
                if f"host-stride shard {p}/2" not in text:
                    raise AssertionError(f"4f worker {label}/{p} ran no "
                                         f"stride")
                lines.append(json.loads(text.strip().splitlines()[-1]))
            out[label] = (time.time() - t0, lines)
        finally:
            for _, log, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
    return out


def data_parallel_phase(device, prefix, reads, ms_prefix, smi,
                        n=DP_READS, cpu_run=False):
    """4f: one process on two devices through the engine API (a), and two
    processes joined by gloo through the CLI (b), both on `device`: the
    first n of phase 4's reads in files of their own; `-P -n -c` on phase
    4's index and `-M -n -c -d` on 4b's, once in this process (paths F-*)
    and once in two worker processes (H-*: host p owns the records i % 2
    == p, process 0 merges), every merged file byte-identical to the
    single-process run's, the workers' launches summed."""
    phase(f"4f. data parallel on [{device}, {device}] and two gloo "
          f"processes on {device}, {n} reads")
    from spumoni_tpu_torch.io.fastx_batch import iter_packed_batches

    count = torch.cuda.device_count() if device.type == "cuda" else 0
    print(f"{smi}; torch.cuda.device_count() = {count}")
    t_phase = time.time()
    with open(reads, "rb") as f:
        head = b"".join(itertools.islice(f, 2 * n))
    files = {}
    for label, *_ in DP_RUNS:
        files[label] = os.path.join(WORK, f"reads_4f_{label}.fa")
        with open(files[label], "wb") as f:
            f.write(head)
    pk = next(iter_packed_batches(files["P-c"], 1 << 40, upper=True))
    if len(pk) != n:
        raise AssertionError(f"4f: {len(pk)} reads, {n} wanted")
    stats = _dp_engine_runs(device, prefix, ms_prefix, pk, cpu_run)

    dev = ["--device", "cpu"] if cpu_run else []
    argv, hashes = {}, {}
    for label, flags, idx, exts in DP_RUNS:
        argv[label] = ["run", "-r", os.path.join(WORK, idx), "-p",
                       files[label], "-n", "-c", *flags]
        stats["F-" + label] = _timed_cli_run(device, "F-" + label,
                                             argv[label] + dev, cpu_run)
        hashes[label] = _file_hashes(files[label], exts)
        for ext in exts:
            os.remove(files[label] + ext)
    workers = _dp_processes([("H-" + label, argv[label])
                             for label, *_ in DP_RUNS], cpu_run)
    for label, flags, idx, exts in DP_RUNS:
        wall, lines = workers["H-" + label]
        got = _file_hashes(files[label], exts)
        bad = [ext for ext in exts if got[ext] != hashes[label][ext]]
        if bad:
            raise AssertionError(f"H-{label}: merged {bad} differ from the "
                                 f"single-process run's")
        left = [name for name in os.listdir(WORK)
                if name.startswith(os.path.basename(files[label]))
                and (".shard" in name or name.endswith(".cursor"))]
        if left:
            raise AssertionError(f"H-{label}: left {left}")
        launches = {k: sum(w["launches"][k] for w in lines)
                    for k in lines[0]["launches"]}
        _check_launches("H-" + label, launches, cpu_run)
        loops = [w["stats"]["stream_s"] for w in lines]
        stats["H-" + label] = dict(launches=launches, reads=n,
                                   stream_s=max(loops), wall_s=wall)
        own = {k: launches[k] for k in PATH_KERNELS["H-" + label]}
        print(f"run H-{label}: 2 processes on {device}: {n} reads; "
              f"streaming {' / '.join(f'{x:.3f}' for x in loops)} s -> "
              f"{n / max(loops):.1f} reads/s (all reads over the longer "
              f"loop); {wall:.1f} s from the start of its two workers to "
              f"their last exit -> {n / wall:.1f} reads/s; launches "
              f"summed {own}, no other kernel")
    _print_runs({k: v for k, v in stats.items() if k.startswith("F-")})
    print(f"checks: the engine API's outputs on two devices == one "
          f"device's; every merged file of the two-process runs is "
          f"byte-identical to the single-process run's; 4f took "
          f"{time.time() - t_phase:.1f} s ({smi})")
    return stats


def digested_main_path_phase(device, builds, reads, n_reads, n_check=2048,
                             cpu_run=False):
    """4c, second half: the 10-strain FASTA built with -m -P (promoted
    minimizers: sigma > 8, the layered engine) and -a -P (DNA-letter
    minimizers: block-bits), and phase 4's reads: `run -m -P -c
    --report-only` (K8), `run -m -P -c` (K7) and `run -a -P -c
    --report-only` (K2). Checks: the two -m reports identical, sampled
    reads' .pseudo_lengths equal the native engine on their digested
    bytes, >= 95% of positives and <= 5% of negatives FOUND in both
    reports."""
    phase(f"4c. digested main path: build -m -P and -a -P, {n_reads} "
          f"reads, through the CLI")
    from spumoni_tpu_torch.engine.layered import depth_for
    from spumoni_tpu_torch.index.format import load_dense_index
    from spumoni_tpu_torch.io.minimizers import digest

    m_prefix = os.path.join(WORK, "idx-m")
    dense = load_dense_index(m_prefix + ".bin.thrbv.spumoni")
    sigma = int((np.asarray(dense.cnt) > 0).sum())
    print(f"build -m -P: {builds['-m -P']:.1f} s (sigma={sigma}, "
          f"n={dense.n}, r={dense.r}, D={depth_for(dense.char_off)}); build -a -P: "
          f"{builds['-a -P']:.1f} s")
    m_reads = os.path.join(WORK, "reads_m.fa")
    shutil.copy(reads, m_reads)
    a_reads = os.path.join(WORK, "reads_a.fa")
    shutil.copy(reads, a_reads)
    dev = ["--device", "cpu"] if cpu_run else []
    stats = {}
    for label, args, rd in (
            ("m-P-c-report-only", ["-r", m_prefix, "-m", "-c",
                                   "--report-only"], m_reads),
            ("m-P-c", ["-r", m_prefix, "-m", "-c"], m_reads),
            ("a-P-c-report-only", ["-r", os.path.join(WORK, "idx-a"), "-a",
                                   "-c", "--report-only"], a_reads)):
        stats[label] = _timed_cli_run(device, label,
                                      ["run", "-p", rd, "-P", *args, *dev],
                                      cpu_run)
        shutil.copy(rd + ".report", rd + f".{label}.report")
    with open(m_reads + ".m-P-c-report-only.report", "rb") as f:
        fused = f.read()
    with open(m_reads + ".m-P-c.report", "rb") as f:
        if f.read() != fused:
            raise AssertionError("-m --report-only .report differs from "
                                 "the -m value run's")
    chk, chk_seqs = _sampled_reads(m_reads, n_reads, n_check)
    vals = _read_values(m_reads + ".pseudo_lengths", set(chk))
    if len(vals) != n_reads:
        raise AssertionError(f"{len(vals)} value records, {n_reads} reads")
    digested = [digest(s.upper(), True, False) for s in chk_seqs]
    want = _native_engine(m_prefix + ".bin.thrbv.spumoni").query_pml(
        digested, threads=os.cpu_count() or 1)
    for rid, w in zip(chk, want):
        if not np.array_equal(vals[rid], w):
            raise AssertionError(f"{rid}: -m .pseudo_lengths != native "
                                 f"engine on its digested bytes")
    rates = {label: _found_rates(rd + f".{label}.report")
             for label, rd in (("m-P-c-report-only", m_reads),
                               ("a-P-c-report-only", a_reads))}
    _print_runs(stats)
    print(f"checks: -m reports identical; {len(chk)} sampled reads' -m "
          f".pseudo_lengths == native engine on the digested reads; FOUND "
          f"(pos, neg): -m {rates['m-P-c-report-only'][0]:.4f} "
          f"{rates['m-P-c-report-only'][1]:.4f}, -a "
          f"{rates['a-P-c-report-only'][0]:.4f} "
          f"{rates['a-P-c-report-only'][1]:.4f}")
    return m_prefix, m_reads, stats


# ---------------------------------------------------------------------------
# 5. kernel vs plain timing at the main-path shape
# ---------------------------------------------------------------------------

#: the least time the card could take for a kernel's work (`_bound`), from
#: the published peak rates of one H100 SXM at 700 W: HBM
#: bytes per second, and the CUDA-core float32 rate, which stands for the
#: integer operations these kernels do (the table has no int32 row)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
SECTOR = 32      # bytes: the least one dependent row read fetches
#: integer operations per scan step, a low count from each step's source
STEP_OPS = {"pml_scan": 20, "pml_classify": 24, "ms_scan": 30,
            "ms_extend": 10, "binmax_values": 3, "gather_chase": 4,
            "layered_scan": 40, "layered_classify": 44, "occ_scan": 40,
            "occ_classify": 44,
            # per output byte: shift, mask, length test, select, merge
            "unpack2": 5, "unpack4": 5,
            # the twins' steps and the shard divide
            "pml_classify_tp": 26, "layered_classify_tp": 46,
            "ms_scan_tp": 34, "ms_extend_tp": 12}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _scan_work(name, index_tensors, reads, lens, tab=None, dependent=1):
    """(input bytes, operations) of a scan over this run's reads: each
    read byte and the lens and table once, and of the index what the steps
    must read (one sector per dependent row read, at most the whole
    index); operations STEP_OPS[name] per step. _time_kernel adds the
    outputs, each written once."""
    steps = _steps(lens, reads.shape[1])
    nbytes = (steps + _nbytes(lens, tab)
              + min(_nbytes(*index_tensors), steps * SECTOR * dependent))
    return nbytes, steps * STEP_OPS[name]


def _steps(lens, L) -> int:
    return int(lens.clamp(0, L).sum())


def _reads_work(name, index_tensors, dependent=1, tab=True):
    """work(args, outputs) of a scan whose arguments start (index, tab,
    reads, lens) (tab=False: (index, reads, lens)): _scan_work on the
    call's reads."""
    if tab:
        return lambda a, _: _scan_work(name, index_tensors, a[2], a[3], a[1],
                                       dependent)
    return lambda a, _: _scan_work(name, index_tensors, a[1], a[2],
                                   dependent=dependent)


def _extend_work(name, text_tensors):
    """work(args, outputs) of K4 / K16 (text, text_bound, reads, lens,
    ptrs): each step reads a read byte and a pointer; of the text, the
    sectors the carry compares on this call (_extend_text_bytes)."""
    ntext = sum(t.numel() for t in text_tensors)

    def work(a, out):
        steps = _steps(a[3], a[2].shape[1])
        return (_extend_text_bytes(ntext, a[1], a[3], a[4], out[0]) + steps
                + steps * a[4].element_size() + _nbytes(a[3]),
                steps * STEP_OPS[name])
    return work


def _extend_text_bytes(ntext, nt, lens, ptrs, lengths) -> int:
    """The bytes of the distinct SECTOR-byte text sectors that the MS
    extension's carry compares, given its output `lengths`: at position i,
    ptrs[i] + l for l from the carried length (max(lengths[i - 1] - 1, 0),
    0 at i = 0) up to lengths[i] (the failing test included), where
    i + l < len, ptrs[i] >= 0 and ptrs[i] + l < min(ntext, nt) (past
    ntext the text reads as 0 without a load): the union of these ranges,
    counted on the device."""
    B, L = ptrs.shape
    p, o = ptrs.long(), lengths.long()
    lens = lens.clamp(0, L)[:, None]
    col = torch.arange(L, device=p.device)
    lo = p + torch.cat([o.new_zeros(B, 1), (o[:, :-1] - 1).clamp(min=0)], 1)
    hi = torch.minimum(p + o, p + lens - 1 - col).clamp(
        max=min(ntext, nt) - 1)
    keep = (col < lens) & (p >= 0) & (hi >= lo)
    start, order = torch.sort(lo[keep] // SECTOR)
    if not start.numel():
        return 0
    end = (hi[keep] // SECTOR + 1)[order]
    # sorted by start: the sectors an interval adds are those past the
    # furthest end of the intervals before it
    reach = torch.cat([start[:1], torch.cummax(end, 0).values[:-1]])
    return int((end - torch.maximum(start, reach)).clamp(min=0).sum()) \
        * SECTOR


def _bound(nbytes, ops) -> dict:
    """bound_ms: the larger of bytes over the HBM rate and operations over
    the core rate; bound_by: which. library_ms is None: no single PyTorch
    call computes any of these functions."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def _time_ms(fn, reps):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


_ENGINES: dict = {}
_STAGED: dict = {}


def _engine(path, device, *args, **kw):
    """pipeline.make_engine(path, device, *args, **kw), built once: the
    timing phases of an index share its engine (5f shards 5's, 5b's and
    5c's on the card)."""
    from spumoni_tpu_torch import pipeline

    key = (path, str(device), args, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        _ENGINES[key] = pipeline.make_engine(path, device, *args, **kw)
    return _ENGINES[key]


def _staged(engine, reads_path, n_reads):
    """The phase-4 reads staged by `engine` as one group of n_reads, its
    rows decoded (_decoded); staged once per engine (a weak reference
    tells a live engine from a new one at a freed one's id)."""
    from spumoni_tpu_torch.io.fastx_batch import iter_packed_batches

    key = (id(engine), reads_path, n_reads)
    if key not in _STAGED or _STAGED[key][0]() is not engine:
        pk = next(iter_packed_batches(reads_path, 1 << 40, upper=True))
        (g,) = engine.stage(pk, max_lanes=n_reads)
        _STAGED[key] = (weakref.ref(engine), _decoded(engine, g))
    return _STAGED[key][1]


def _decoded(engine, g):
    """A staged group with its rows decoded on the device by K11 / K12, as
    the engine decodes them before a scan: 'rev_d', and 'fwd_d' for MS."""
    g = dict(g, rev_d=engine._rev_d(g))
    if "fwd_p" in g:
        g["fwd_d"] = engine._fwd_d(g)
    return g


def timing_phase(device, prefix, reads, n_reads):
    phase(f"5. kernel vs plain at the main-path shape (B={n_reads})")
    from spumoni_tpu_torch.engine import kernels

    engine = _engine(prefix + ".fa.thrbv.spumoni", device)
    g = _staged(engine, reads, n_reads)
    args = (engine.index, g["tab"], g["rev_d"], g["lens_d"])
    print(f"batch: B={g['rev_d'].shape[0]} L={g['rev_d'].shape[1]}, "
          f"index P={engine.index.meta.P} pack={engine.index.meta.pack} "
          f"rows {engine.index.bblocks.numel() * 4 / 1e6:.1f} MB")
    src = "spumoni_tpu_torch/csrc/blockbits_pml.cu"
    rows = (engine.index.bblocks,)
    return [
        dict(_time_kernel("pml_scan", kernels.pml_scan,
                          kernels.pml_scan_reference, args, src,
                          "spumoni_tpu/engine/scan_engine.py:145",
                          _reads_work("pml_scan", rows)),
             group=kernels.GROUP),
        dict(_time_kernel("pml_classify", kernels.pml_classify,
                          kernels.pml_classify_reference,
                          (*args, 7, BIN_WIDTH), src,
                          "spumoni_tpu/parallel/mesh.py:128",
                          _reads_work("pml_classify", rows)),
             group=kernels.PML_CLASSIFY_GROUP)]


def _time_kernel(name, kern, plain, args, source, replaces, work,
                 plain_turns=2, shapes=True):
    """CUDA-event ms per call of a kernel wrapper and of its plain version,
    in turns (plain, kernel warm-up + 5 timed calls, plain; with
    plain_turns=1 the second plain call is left out); fails unless the
    outputs are equal (tolerance 0: integer outputs). work(args, outputs)
    = (input bytes, operations) of a call, for the bound, to which the
    outputs are added. With shapes, the kernel is also timed at LAUNCH_SHAPES
    (_time_shapes)."""
    plain_ms1, want = _time_ms(lambda: plain(*args), 1)
    kern(*args)
    ms, got = _time_ms(lambda: kern(*args), 5)
    plain_ms2 = _time_ms(lambda: plain(*args), 1)[0] if plain_turns == 2 \
        else plain_ms1
    err = _max_err(got, want)
    if err:
        raise AssertionError(f"{name}: kernel != plain (max |err| {err})")
    plain_ms = (plain_ms1 + plain_ms2) / 2
    bound = _call_bound(work, args, got)
    print(f"{name}: kernel {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call "
          f"({plain_ms1:.3f}, {plain_ms2:.3f}); bound {bound['bound_ms']:.4f}"
          f" ms ({bound['bound_by']}); max |err| 0 (tolerance 0: integer "
          f"outputs)")
    result = dict(name=name, route="cuda", source=source, replaces=replaces,
                  max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)
    return _time_shapes(result, kern, args, got, work) if shapes else result


def _call_bound(work, args, out) -> dict:
    """_bound of a call on args: work(args, outputs) plus its outputs, each
    written once."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    nbytes, ops = work(args, outs)
    return _bound(nbytes + _nbytes(*outs), ops)


def _with_modes(name, timed):
    """One kernel's line from its timings by mode ({label: result}): the
    first mode's numbers, the largest |err|, and every mode's ms, plain_ms,
    bound_ms, max_abs_err and ms by lane count (shapes; and a sharded
    kernel's twin, twin_ms and one_shard_ms) under `modes`."""
    first = next(iter(timed.values()))
    return dict(first, name=name,
                max_abs_err=max(r["max_abs_err"] for r in timed.values()),
                modes={label: {k: r[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "library_ms",
                                                 "max_abs_err", "graph_ms",
                                                 "twin",
                                                 "twin_ms", "one_shard_ms",
                                                 "shapes", "twin_shapes")
                               if k in r}
                       for label, r in timed.items()})


#: lane counts the runs launch: value runs stage at most 8,192 lanes a
#: group (pipeline.py), report-only runs a parse batch of 32,768 reads
LAUNCH_SHAPES = (8192, 32768)


def _cut_args(args, B, B_full):
    """The first B rows of every tensor argument of the full batch's rows
    (reads, lens, pointers, values); the others as they are."""
    return tuple(a[:B].contiguous() if isinstance(a, torch.Tensor)
                 and a.dim() and a.shape[0] == B_full else a for a in args)


def _graph_ms(fn):
    """(method, ms a call) of fn on the card alone, the host's enqueue out
    of the window (time_scan.graph_time: CUDA-graph replay, or the
    profiler's kernel durations where capture fails)."""
    from spumoni_tpu_torch.scripts.time_scan import graph_time

    return graph_time(fn)


def _with_graph_ms(result, kern, args):
    """Adds graph_ms (_graph_ms) and its method to a _time_kernel result
    and to each of its shapes (the first B rows of the arguments), and
    prints each beside the event time."""
    method, result["graph_ms"] = _graph_ms(lambda: kern(*args))
    result["graph_method"] = method
    shapes = result.get("shapes", {})
    B_full = max(shapes, default=0)
    for B, v in shapes.items():
        sub = _cut_args(args, B, B_full)
        v["graph_ms"] = result["graph_ms"] if B == B_full else \
            _graph_ms(lambda: kern(*sub))[1]
    print(f"  {result['name']} on the card alone ({method}): " + ", ".join(
        f"B={B} {v['graph_ms']:.4f} ms ({v['graph_ms'] / v['ms']:.0%} of "
        f"the event time)" for B, v in (shapes or {
            "full": result}).items()))
    return result


def _time_shapes(result, kern, args, full, work):
    """Times `kern` on the first B lanes of its arguments at each of
    LAUNCH_SHAPES below the full batch (every tensor argument of the full
    batch's rows cut: reads, lens, pointers, values), warm-up + 5 calls,
    and fails unless each output equals the first B rows of the full
    batch's (`full`, itself held to the plain version). Adds {B: {ms,
    bound_ms}} to result['shapes'], the full batch's included; bound_ms
    from work on the cut arguments (_call_bound)."""
    full = full if isinstance(full, (tuple, list)) else (full,)
    B_full = full[0].shape[0]
    shapes = {B_full: dict(ms=result["ms"], bound_ms=result["bound_ms"])}
    for B in (b for b in LAUNCH_SHAPES if b < B_full):
        sub = _cut_args(args, B, B_full)
        kern(*sub)
        ms, got = _time_ms(lambda: kern(*sub), 5)
        err = _max_err(got, tuple(None if f is None else f[:B]
                                  for f in full))
        if err:
            raise AssertionError(f"{result['name']} at B={B} != the full "
                                 f"batch's rows (max |err| {err})")
        shapes[B] = dict(ms=ms,
                         bound_ms=_call_bound(work, sub, got)["bound_ms"])
    result["shapes"] = dict(sorted(shapes.items()))
    print(f"  {result['name']} by lanes: " + ", ".join(
        f"B={B} {v['ms']:.3f} ms (bound {v['bound_ms']:.4f})"
        for B, v in result["shapes"].items()))
    return result


def ms_timing_phase(device, ms_prefix, reads, n_reads):
    """5b: K3 (in each of its modes: ms, the report-only run's, ms+doc and
    pml+doc, the value runs'), K4 and K5 against their plain versions at
    the main-path shape on the MS index, and K6 through the gather-chase
    script's entry point at its own shape, run as the path
    'exp_vmem_gather'. Returns (results, that path's launch counts)."""
    phase(f"5b. K3-K6 vs plain at the main-path shape (B={n_reads})")
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.scripts import exp_vmem_gather as chase

    engine = _engine(ms_prefix + ".fa.thrbv.ms", device, "ms",
                     use_doc=True)   # jump_d for the doc modes
    g = _staged(engine, reads, n_reads)
    index, lens = engine.index, g["lens_d"]
    print(f"batch: B={g['rev_d'].shape[0]} L={g['rev_d'].shape[1]}, index "
          f"P={index.meta.P} pack={index.meta.pack} wide={index.meta.wide} "
          f"r={index.meta.r}")
    ptrs = kernels.ms_scan(index, g["tab"], g["rev_d"], lens, "ms",
                           False)[0]
    ms_len = kernels.ms_extend(index.text, index.text_bound, g["fwd_d"],
                               lens, ptrs)
    src = "spumoni_tpu_torch/csrc/blockbits_ms.cu"
    replaces = "spumoni_tpu/engine/scan_engine.py:184"
    # the tables each mode reads: samples (jump_t) for ms, doc ids (jump_d)
    # with doc tracking; the row and the msrow every step
    tables = {"ms": (index.jump_t,), "ms+doc": (index.jump_t, index.jump_d),
              "pml+doc": (index.jump_d,)}
    modes = {}
    for label, mode, doc in (("ms", "ms", False), ("ms+doc", "ms", True),
                             ("pml+doc", "pml", True)):
        args = (index, g["tab"], g["rev_d"], lens, mode, doc)
        modes[label] = _time_kernel(
            f"ms_scan {label}", kernels.ms_scan, kernels.ms_scan_reference,
            args, src, replaces,
            _reads_work("ms_scan", (index.bblocks, index.msrows,
                                    *tables[label]), dependent=2))
    results = [dict(_with_modes("ms_scan", modes), group=kernels.GROUP)]
    results += [
        _time_kernel("ms_extend", kernels.ms_extend,
                     kernels.ms_extend_reference,
                     (index.text, index.text_bound, g["fwd_d"], lens, ptrs),
                     src, "spumoni_tpu/engine/scan_engine.py:1042",
                     _extend_work("ms_extend", (index.text,))),
        _time_kernel("binmax_values", kernels.binmax_values,
                     kernels.binmax_values_reference,
                     (ms_len, lens, 7, BIN_WIDTH), src,
                     "spumoni_tpu/engine/scan_engine.py:1110",
                     lambda a, _: (_steps(a[1], a[0].shape[1])
                                * a[0].element_size() + _nbytes(a[1]),
                                _steps(a[1], a[0].shape[1])
                                * STEP_OPS["binmax_values"]))]
    # K6 through the script's own entry point, as a path of its own
    kernels.reset_launch_counts()
    res = chase.main([])
    counts = kernels.launch_counts()
    _check_launches("exp_vmem_gather", counts)
    if res["max_abs_err"]:
        raise AssertionError("gather_chase != gather_chase_reference")
    # the shared-memory floor is computed, not measured: printed here, not
    # in the kernels line
    floor_ms, formula = res.pop("floor_ms"), res.pop("floor_formula")
    print(f"gather_chase floor_ms {floor_ms} = {formula}")
    cells = chase.R * chase.W   # table, idx0 and the output: int32 each
    results.append(dict(name="gather_chase", route="cuda",
                        source="spumoni_tpu_torch/csrc/gather_chase.cu",
                        replaces="scripts/exp_vmem_gather.py:35", **res,
                        **_bound(3 * 4 * cells,
                                 cells * chase.L * STEP_OPS["gather_chase"])))
    return results, counts


def layered_timing_phase(device, ms_prefix, ms_reads, m_prefix, m_reads,
                         n_reads):
    """5c: K7 in each of its modes and K8 against their plain versions at
    B = n_reads: on 4b's index with the layered engine at L = 1,024 (K7 on
    the MS + doc tables, K8 on the PML tables of 4c's report-only run), and
    K8 and K7-pml on the -m index at the digested reads' bucket."""
    phase(f"5c. K7 / K8 vs plain at the main-path shapes (B={n_reads})")
    from spumoni_tpu_torch import pipeline
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.io.fastx_batch import iter_packed_batches
    from spumoni_tpu_torch.io.minimizers import digest_packed

    src = "spumoni_tpu_torch/csrc/layered.cu"
    k7 = "spumoni_tpu/engine/scan_engine.py:120"
    k8_src = "spumoni_tpu/parallel/mesh.py:128"

    def work(name, index):
        return _reads_work(name, (index.charmeta, *index.levels,
                                  index.fields),
                           dependent=index.meta.depth + 1, tab=False)

    engine = pipeline.make_engine(ms_prefix + ".fa.thrbv.ms", device, "ms",
                                  use_doc=True, engine="layered")
    g = _staged(engine, ms_reads, n_reads)
    index, args = engine.index, (engine.index, g["rev_d"], g["lens_d"])
    m = index.meta
    print(f"batch: B={g['rev_d'].shape[0]} L={g['rev_d'].shape[1]}, layered "
          f"index D={m.depth} W={m.width} r={m.r}, fields "
          f"{index.fields.numel() * index.fields.element_size() / 1e6:.1f} "
          f"MB")
    modes = {label: _time_kernel(f"layered_scan {label}",
                                 kernels.layered_scan,
                                 kernels.layered_scan_reference,
                                 (*args, mode, doc), src, k7,
                                 work("layered_scan", index))
             for label, mode, doc in (("pml", "pml", False),
                                      ("pml+doc", "pml", True),
                                      ("ms", "ms", False),
                                      ("ms+doc", "ms", True))}
    del engine, g, index, args
    # K8 on the tables 4c's L-P-c-report-only run gives it
    engine = _engine(ms_prefix + ".fa.thrbv.spumoni", device,
                     engine="layered")
    g = _staged(engine, ms_reads, n_reads)
    m = engine.index.meta
    print(f"PML batch: B={g['rev_d'].shape[0]} L={g['rev_d'].shape[1]}, "
          f"layered index D={m.depth} W={m.width} r={m.r}")
    k8 = {"10-strain": _time_kernel(
        "layered_classify 10-strain", kernels.layered_classify,
        kernels.layered_classify_reference,
        (engine.index, g["rev_d"], g["lens_d"], 7, BIN_WIDTH), src, k8_src,
        work("layered_classify", engine.index))}
    del engine, g
    engine = pipeline.make_engine(m_prefix + ".bin.thrbv.spumoni", device)
    pk = digest_packed(next(iter_packed_batches(m_reads, 1 << 40,
                                                upper=True)), True, False)
    g = _decoded(engine, max(engine.stage(pk, max_lanes=n_reads),
                             key=lambda grp: len(grp["idxs"])))
    args = (engine.index, g["rev_d"], g["lens_d"])
    m = engine.index.meta
    print(f"-m batch: B={g['rev_d'].shape[0]} of {len(pk)} digested reads "
          f"at L={g['rev_d'].shape[1]} (mean digested length "
          f"{pk.total_bases / len(pk):.1f}), layered index D={m.depth} "
          f"W={m.width} r={m.r}")
    modes["-m pml"] = _time_kernel(
        "layered_scan -m pml", kernels.layered_scan,
        kernels.layered_scan_reference, (*args, "pml", False), src, k7,
        work("layered_scan", engine.index), shapes=False)
    k8["-m"] = _time_kernel(
        "layered_classify -m", kernels.layered_classify,
        kernels.layered_classify_reference, (*args, 7, BIN_WIDTH), src,
        k8_src, work("layered_classify", engine.index), shapes=False)
    return [dict(_with_modes("layered_scan", modes), group=kernels.GROUP),
            dict(_with_modes("layered_classify",
                             {"-m": k8["-m"], "10-strain": k8["10-strain"]}),
                 group=kernels.CLASSIFY_GROUP)]


def _occ_columns(index, mode, use_doc):
    """The row columns K9 / K10 read in a mode, as views (so _nbytes counts
    only them): checkpoints, chars and thresholds, the samples for ms, the
    doc ids with use_doc."""
    m = index.meta
    cols = [index.blocks[:, :m.T0 + m.P]]
    if mode == "ms":
        cols.append(index.blocks[:, m.S0:m.S0 + 2 * m.P])
    if use_doc:
        cols.append(index.blocks[:, m.D0:m.D0 + 2 * m.P])
    return tuple(cols)


#: 5d's K9 modes: (label, index file, mode, doc ids), each on the rows its
#: 4d run builds (OCC_LAYOUTS)
OCC_TIMED = (("pml", ".fa.thrbv.spumoni", "pml", False),
             ("pml+doc", ".fa.thrbv.spumoni", "pml", True),
             ("ms", ".fa.thrbv.ms", "ms", False),
             ("ms+doc", ".fa.thrbv.ms", "ms", True))


def occ_timing_phase(device, ms_prefix, ms_reads, n_reads):
    """5d: K9 in each of its modes and K10 against their plain versions at
    B = n_reads, L = 1,024 on 4b's index with the occ-block engine, each
    mode on the rows of the 4d run that uses it: K9-pml and K10 on the PML
    rows of `-P -c` (W = T0 + P), pml+doc on the doc rows of `-P -d -c`
    (T0 + 3P), ms on the sample rows of `-M -c --report-only` (T0 + 3P),
    ms+doc on the rows of `-M -c -d` (T0 + 5P)."""
    phase(f"5d. K9 / K10 vs plain at the main-path shape (B={n_reads})")
    from spumoni_tpu_torch import pipeline
    from spumoni_tpu_torch.engine import kernels

    src = "spumoni_tpu_torch/csrc/occblock.cu"
    timed = {}
    for label, path, mode, use_doc in OCC_TIMED:
        engine = pipeline.make_engine(ms_prefix + path, device, mode,
                                      use_doc=use_doc, engine="occ")
        g = _staged(engine, ms_reads, n_reads)
        index = engine.index
        args = (index, g["tab"], g["rev_d"], g["lens_d"])
        m = index.meta
        cols = _occ_columns(index, mode, use_doc)
        if sum(c.shape[1] for c in cols) != m.width:
            raise AssertionError(f"occ_scan {label}: rows of width {m.width} "
                                 f"hold tables the mode does not read")
        print(f"batch: B={g['rev_d'].shape[0]} L={g['rev_d'].shape[1]}, "
              f"occ-block index P={m.P} W={m.width}, rows "
              f"{_nbytes(index.blocks) / 1e6:.1f} MB")
        timed[label] = _time_kernel(
            f"occ_scan {label}", kernels.occ_scan,
            kernels.occ_scan_reference, (*args, mode, use_doc), src,
            "spumoni_tpu/engine/scan_engine.py:220",
            _reads_work("occ_scan", cols))
        if label == "pml":
            k10 = _time_kernel(
                "occ_classify", kernels.occ_classify,
                kernels.occ_classify_reference, (*args, 7, BIN_WIDTH), src,
                "spumoni_tpu/parallel/mesh.py:128",
                _reads_work("occ_classify", cols))
        del engine, g, index, args, cols
    return [dict(_with_modes("occ_scan", timed), group=kernels.GROUP),
            dict(k10, group=kernels.OCC_CLASSIFY_GROUP)]


def staging_timing_phase(device, prefix, reads, n_reads):
    """5e: K11 and K12 against their plain versions at B = n_reads, L =
    1,024 on phase 4's reads: K11 on their 2-bit rows as the main path
    stages them (no exceptions) and on the same reads with 1 in 128 bytes
    set to N (their exceptions written over the cells); K12 on the same
    reads packed at 4 bits in staged-alphabet ranks, through the
    alphabet's byte table (the MS forward rows' decode) and plain, with
    the time of `lut[codes]` (the one PyTorch call that computes the
    table's decode, _decode_alpha) beside the table mode. Each line and
    shape also carries graph_ms, the card alone (_with_graph_ms)."""
    phase(f"5e. K11 / K12 vs plain at the main-path shape (B={n_reads})")
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.scan_engine import _alpha_table
    from spumoni_tpu_torch.io.fastx_batch import (PackedReads,
                                                  iter_packed_batches)
    from spumoni_tpu_torch.native import pack_rows_native

    engine = _engine(prefix + ".fa.thrbv.spumoni", device)
    pk = next(iter_packed_batches(reads, 1 << 40, upper=True))
    buf = pk.buf.copy()
    buf[np.random.default_rng(1500).random(len(buf)) < 1 / 128] = ord("N")
    groups = {label: engine.stage(packed, max_lanes=n_reads)
              for label, packed in (("as staged", pk), (
                  "1/128 N", PackedReads(pk.ids, buf, pk.offs)))}
    if any(len(gs) != 1 or gs[0]["bits"] != 2 for gs in groups.values()):
        raise AssertionError("phase 4's reads did not stage as one group "
                             "at 2 bits")
    src = "spumoni_tpu_torch/csrc/staging.cu"
    k11 = {}
    for label, (g,) in groups.items():
        B, L = len(g["idxs"]), g["L"]
        nexc = 0 if g["exc_d"] is None else g["exc_d"].shape[0]
        print(f"K11 {label}: B={B} L={L}, {nexc} exceptions")
        args = (g["rev_p"], g["ranks2"], g["exc_d"], g["lens_d"])
        k11[label] = _with_graph_ms(_time_kernel(
            f"unpack2 {label}", kernels.unpack2, kernels.unpack2_reference,
            args, src, "spumoni_tpu/engine/scan_engine.py:1189",
            lambda a, _: (_nbytes(a[0], a[2], a[3]),
                       a[0].shape[0] * L * STEP_OPS["unpack2"]),
            # the exceptions name rows of the whole batch: no cut
            shapes=g["exc_d"] is None), kernels.unpack2, args)
    g = groups["as staged"][0]
    sel, lens = g["idxs"], g["lens_d"]
    p4 = torch.from_numpy(pack_rows_native(
        pk.buf, pk.offs[sel], pk.offs[sel + 1], len(sel), g["L"],
        engine._stage_amap, False, 4)[0]).to(device)
    table = _alpha_table(g["alpha"])
    # K12 runs on 3e's paths only; timed at LAUNCH_SHAPES all the same
    def work4(a, _):
        return _nbytes(a[0], a[1]), a[0].numel() * 2 * STEP_OPS["unpack4"]

    k12 = {"byte table": _with_graph_ms(_time_kernel(
               "unpack4 byte table", kernels.unpack4,
               kernels.unpack4_reference, (p4, lens, table), src,
               "spumoni_tpu/engine/scan_engine.py:1178", work4),
               kernels.unpack4, (p4, lens, table)),
           "plain": _with_graph_ms(_time_kernel(
               "unpack4", kernels.unpack4, kernels.unpack4_reference,
               (p4, lens), src, "spumoni_tpu/engine/scan_engine.py:1169",
               work4), kernels.unpack4, (p4, lens))}
    codes = kernels.unpack4(p4, lens).long()
    lut = torch.tensor(table, dtype=torch.uint8, device=device)
    _time_ms(lambda: lut[codes], 1)   # warm-up
    lib_ms, out = _time_ms(lambda: lut[codes], 5)
    if not torch.equal(out, kernels.unpack4(p4, lens, table)):
        raise AssertionError("lut[codes] != unpack4 with the byte table")
    k12["byte table"]["library_ms"] = lib_ms
    print(f"lut[codes] (int64 codes, [{codes.shape[0]}, {codes.shape[1]}]):"
          f" {lib_ms:.3f} ms/call")
    _staging_ab(device, engine, pk, g)
    return [_with_modes("unpack2", k11), _with_modes("unpack4", k12)]


def _staging_ab(device, engine, pk, g):
    """Host-clock ms to stage group g's reversed rows onto the device, in
    turns: 8 bits (pack, upload: the port's staging before K11) and 2 bits
    (pack, upload, K11), each ending in a synchronise; fails unless both
    give the same rows."""
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.native import pack_rows_native

    sel, L, lens = g["idxs"], g["L"], g["lens_d"]
    starts, ends = pk.offs[sel], pk.offs[sel + 1]

    def at8():
        rows = pack_rows_native(pk.buf, starts, ends, len(sel), L,
                                engine._stage_amap, True, 8)[0]
        return torch.from_numpy(rows).to(device)

    def at2():
        _, rows, exc = engine._pack_rev(pk.buf, starts, ends, L)
        return kernels.unpack2(
            torch.from_numpy(rows).to(device), g["ranks2"],
            None if exc is None else torch.from_numpy(exc).to(device), lens)

    times, rows = {8: [], 2: []}, {}
    for bits in (8, 2, 2, 8):
        t0 = time.perf_counter()
        rows[bits] = (at8 if bits == 8 else at2)()
        sync(device)
        times[bits].append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(rows[8], rows[2]):
        raise AssertionError("2-bit staging + K11 != 8-bit staging")
    print(f"staging the batch (host clock, pack + upload [+ K11], in turns "
          f"8, 2, 2, 8): 8 bits {times[8][0]:.3f} / {times[8][1]:.3f} ms, "
          f"2 bits {times[2][0]:.3f} / {times[2][1]:.3f} ms; equal rows")


def _time_twin(result, twin_name, twin, twin_args, got, one_shard):
    """Times a sharded kernel's unsharded twin on the same reads, and the
    sharded kernel on a one-shard cut of the same index (one_shard = (the
    kernel, its arguments)), warm-up + 5 calls each; fails unless both
    outputs equal the sharded kernel's `got`. Adds `twin`, `twin_ms` and
    `one_shard_ms` to the sharded kernel's result."""
    twin(*twin_args)
    ms, out = _time_ms(lambda: twin(*twin_args), 5)
    kern, args1 = one_shard
    kern(*args1)
    ms1, out1 = _time_ms(lambda: kern(*args1), 5)
    err = max(_max_err(got, out), _max_err(got, out1))
    if err:
        raise AssertionError(f"{result['name']} != its twin {twin_name} or "
                             f"its one-shard run (max |err| {err})")
    result.update(twin=twin_name, twin_ms=ms, one_shard_ms=ms1)
    print(f"  twin {twin_name}: {ms:.3f} ms/call; 1 shard: {ms1:.3f} "
          f"ms/call; outputs equal; sharded / twin {result['ms'] / ms:.3f}, "
          f"1 shard / twin {ms1 / ms:.3f}")


def tp_timing_phase(device, prefix, reads, ms_prefix, ms_reads, n_reads,
                    S=4):
    """5f: K13, K14, K15 (ms, the mode of -M -c, and ms+doc, the mode of
    4e's -M -c -d run) and K16 against their plain versions (one plain
    call each: seconds a call at this shape) at B = n_reads, L = 1,024 on
    S shards of the indexes 4e runs, cut on the card from the engines and
    staged reads of 5, 5b and 5c, each beside its unsharded twin and
    itself on one shard, on the same inputs (_time_twin). The bound counts
    the twin's bytes: the shards hold the same rows, plus pad."""
    phase(f"5f. K13-K16 vs plain and vs their unsharded twins at the "
          f"main-path shape (B={n_reads}, {S} shards)")
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.parallel import tp

    results = []
    engine = _engine(prefix + ".fa.thrbv.spumoni", device)
    g = _staged(engine, reads, n_reads)
    cut = {k: tp.shard_blockbits(engine.index, k) for k in (S, 1)}
    args = (cut[S], g["tab"], g["rev_d"], g["lens_d"], 7, BIN_WIDTH)
    r = _time_kernel("pml_classify_tp", kernels.pml_classify_tp,
                     kernels.pml_classify_tp_reference, args,
                     "spumoni_tpu_torch/csrc/blockbits_pml.cu",
                     "spumoni_tpu/parallel/tp.py:144",
                     _reads_work("pml_classify_tp", cut[S].bblocks.shards),
                     plain_turns=1)
    _time_twin(r, "pml_classify", kernels.pml_classify,
               (engine.index, *args[1:]), kernels.pml_classify_tp(*args),
               (kernels.pml_classify_tp, (cut[1], *args[1:])))
    results.append(dict(r, group=kernels.PML_CLASSIFY_GROUP))
    del engine, g, cut, args

    engine = _engine(ms_prefix + ".fa.thrbv.spumoni", device,
                     engine="layered")
    g = _staged(engine, ms_reads, n_reads)
    cut = {k: tp.shard_layered(engine.index, k) for k in (S, 1)}
    m = cut[S].meta
    print(f"layered: D={m.depth} W={m.width} r={m.r}, {S} shards of "
          f"{cut[S].fields.rows_per_shard} field rows, bound "
          f"{m.probe_bound}")
    args = (cut[S], g["rev_d"], g["lens_d"], 7, BIN_WIDTH)
    r = _time_kernel("layered_classify_tp", kernels.layered_classify_tp,
                     kernels.layered_classify_tp_reference, args,
                     "spumoni_tpu_torch/csrc/layered.cu",
                     "spumoni_tpu/engine/layered.py:327",
                     _reads_work("layered_classify_tp",
                                 (cut[S].charmeta, *cut[S].levels,
                                  *cut[S].fields.shards),
                                 dependent=m.depth + 1, tab=False),
                     plain_turns=1)
    _time_twin(r, "layered_classify", kernels.layered_classify,
               (engine.index, *args[1:]), kernels.layered_classify_tp(*args),
               (kernels.layered_classify_tp, (cut[1], *args[1:])))
    results.append(dict(r, group=kernels.CLASSIFY_GROUP))
    del engine, g, cut, args

    engine = _engine(ms_prefix + ".fa.thrbv.ms", device, "ms",
                     use_doc=True)
    g = _staged(engine, ms_reads, n_reads)
    cut = {k: tp.shard_blockbits_ms(engine.index, k) for k in (S, 1)}
    sh, lens = cut[S], g["lens_d"]
    modes = {}
    for label, doc in (("ms+doc", True), ("ms", False)):
        args = (sh, g["tab"], g["rev_d"], lens, "ms", doc)
        tables = [*sh.bblocks.shards, *sh.msrows.shards, *sh.jump_t.shards,
                  *(sh.jump_d.shards if doc else ())]
        work = _reads_work("ms_scan_tp", tables, dependent=2)
        r = _time_kernel(f"ms_scan_tp {label}", kernels.ms_scan_tp,
                         kernels.ms_scan_tp_reference, args,
                         "spumoni_tpu_torch/csrc/blockbits_ms.cu",
                         "spumoni_tpu/parallel/tp.py:297", work,
                         plain_turns=1)
        got = kernels.ms_scan_tp(*args)
        _time_twin(r, f"ms_scan {label}", kernels.ms_scan,
                   (engine.index, *args[1:]), got,
                   (kernels.ms_scan_tp, (cut[1], *args[1:])))
        twin = dict(name=f"twin ms_scan {label}", ms=r["twin_ms"],
                    bound_ms=r["bound_ms"])
        _time_shapes(twin, kernels.ms_scan, (engine.index, *args[1:]), got,
                     work)
        r["twin_shapes"] = twin["shapes"]
        modes[label] = r
    results.append(dict(_with_modes("ms_scan_tp", modes),
                        group=kernels.GROUP))
    ptrs = got[0]
    args = (sh.text, sh.text_bound, g["fwd_d"], lens, ptrs)
    r = _time_kernel("ms_extend_tp", kernels.ms_extend_tp,
                     kernels.ms_extend_tp_reference, args,
                     "spumoni_tpu_torch/csrc/blockbits_ms.cu",
                     "spumoni_tpu/engine/scan_engine.py:724",
                     _extend_work("ms_extend_tp", sh.text.shards),
                     plain_turns=1)
    _time_twin(r, "ms_extend", kernels.ms_extend,
               (engine.index.text, engine.index.text_bound, *args[2:]),
               kernels.ms_extend_tp(*args),
               (kernels.ms_extend_tp, (cut[1].text, cut[1].text_bound,
                                       *args[2:])))
    results.append(r)
    return results


def _annotate(results, runs, chase_counts):
    """Adds each path's launches, in-run event times and lost time to the
    kernel lines (runs: each CLI run's stats by path), and prints the lost
    times. A kernel's `launches` is its first path's."""
    paths = {label: st["launches"] for label, st in runs.items()}
    paths["exp_vmem_gather"] = chase_counts
    for r in results:
        own = [p for p in PATH_KERNELS if r["name"] in PATH_KERNELS[p]]
        r["launches"] = paths[own[0]][r["name"]]
        r["launches_by_path"] = {p: paths[p][r["name"]] for p in own}
        # the events around its calls in each run: the kernel and the
        # card's waits on the host between the two events
        r["in_run_event_ms"] = {
            p: dict(launches=paths[p][r["name"]],
                    event_ms=runs[p]["kernel_ms_by"][r["name"]])
            for p in own if "kernel_ms_by" in runs.get(p, {})}
        r["lost_ms"] = _lost_time(r, own, paths)
    _print_lost(results)


def _run_lanes(path):
    """The lanes of each launch of a 10-strain run (phases 4-4e): a
    report-only run's parse batch of 32,768 reads, a value run's group of
    8,192 (pipeline.py); None for 3e's runs, the digested runs (-m, -a)
    and 4f's 8,192-read runs, whose launches take other shapes."""
    if path.startswith(("S-", "m-", "a-", "D-", "F-", "H-")) \
            or path == "exp_vmem_gather":
        return None
    return 32768 if path.endswith("report-only") else 8192


def _run_line(r, path):
    """The timed line (shapes) of kernel line r in the mode run `path`
    launches it in."""
    modes = r.get("modes")
    if modes is None:
        return r
    if r["name"] == "layered_classify":
        return modes["10-strain"]
    if r["name"] == "unpack2":
        return modes["as staged"]
    return modes[("ms" if "M-" in path else "pml")
                 + ("+doc" if "-d" in path else "")]


def _lost_time(r, own, paths):
    """Per 10-strain run of kernel line r: launches x (ms - bound_ms) at
    the run's lanes, both timed alone on this run's inputs
    (_time_shapes)."""
    lost = {}
    for p in own:
        lanes = _run_lanes(p)
        # none where the batch is smaller than the run's lanes (--reads)
        shape = None if lanes is None else _run_line(r, p).get(
            "shapes", {}).get(lanes)
        if shape is None:
            continue
        n = paths[p][r["name"]]
        lost[p] = dict(lanes=lanes, launches=n, ms=shape["ms"],
                       bound_ms=shape["bound_ms"],
                       lost_ms=n * (shape["ms"] - shape["bound_ms"]))
    return lost


def _print_lost(results):
    rows = sorted(((v["lost_ms"], r["name"], p, v) for r in results
                   for p, v in r.get("lost_ms", {}).items()), reverse=True)
    print("lost a run, launches x (ms - bound) at the run's lanes, each "
          "kernel timed alone:")
    for lost, name, p, v in rows:
        print(f"  {lost:9.3f} ms  {name} in {p}: {v['launches']} x "
              f"({v['ms']:.3f} - {v['bound_ms']:.4f}) at B={v['lanes']}")
    total = {}
    for lost, name, p, _ in rows:
        total.setdefault(name, []).append((p, lost))
    print("lost over every 10-strain run that launches it, each kernel:")
    for name, runs in sorted(total.items(),
                             key=lambda kv: -sum(x for _, x in kv[1])):
        print(f"  {sum(x for _, x in runs):9.3f} ms  {name} in {len(runs)} "
              f"runs: " + ", ".join(f"{p} {x:.2f}" for p, x in runs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strains", type=int, default=10,
                    help="pangenome strains of 4.6 Mbp (default 10)")
    ap.add_argument("--reads", type=int, default=65536,
                    help="reads of 1,024 bp (default 65,536)")
    ap.add_argument("--builds-only", action="store_true",
                    help="run_builds on the inputs in chip_smoke_work/ and "
                         "exit (start_builds runs the script so)")
    args = ap.parse_args(argv)
    if args.builds_only:
        sys.path.insert(0, REPO)
        run_builds()
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    dev, name, smi = device_phase()
    build_proc = start_builds(args.strains, args.reads)
    try:
        build_phase()
        return _phases(args, dev, name, smi, build_proc)
    finally:
        if build_proc.poll() is None:
            build_proc.kill()
            build_proc.wait()


def _phases(args, dev, name, smi, build_proc) -> int:
    """Phases 3-5f, with the index builds of start_builds running until
    phase 4 waits for them."""
    small_phase(dev)
    small_ms_phase(dev)
    small_layered_phase(dev)
    small_occ_phase(dev)
    sync(dev)
    stg_stats = staging_phase(dev)
    sync(dev)
    small_tp_phase(dev)
    sync(dev)
    builds = wait_builds(build_proc)
    prefix, reads, stats = main_path_phase(dev, builds, args.strains,
                                           n_reads=args.reads)
    sync(dev)
    ms_prefix, ms_reads, ms_stats, hashes = ms_main_path_phase(
        dev, builds, reads, args.reads)
    sync(dev)
    lay_stats = layered_main_path_phase(dev, ms_prefix, ms_reads, hashes)
    sync(dev)
    m_prefix, m_reads, dig_stats = digested_main_path_phase(
        dev, builds, reads, args.reads)
    sync(dev)
    occ_stats = occ_main_path_phase(dev, ms_prefix, ms_reads, hashes)
    sync(dev)
    tp_stats = tp_main_path_phase(dev, prefix, reads, ms_prefix, ms_reads,
                                  hashes)
    sync(dev)
    dp_stats = data_parallel_phase(dev, prefix, reads, ms_prefix, smi,
                                   n=min(DP_READS, args.reads))
    sync(dev)
    results = timing_phase(dev, prefix, reads, args.reads)
    sync(dev)
    ms_results, chase_counts = ms_timing_phase(dev, ms_prefix, ms_reads,
                                               args.reads)
    results += ms_results
    sync(dev)
    results += layered_timing_phase(dev, ms_prefix, ms_reads, m_prefix,
                                    m_reads, args.reads)
    sync(dev)
    results += occ_timing_phase(dev, ms_prefix, ms_reads, args.reads)
    sync(dev)
    results += staging_timing_phase(dev, prefix, reads, args.reads)
    sync(dev)
    results += tp_timing_phase(dev, prefix, reads, ms_prefix, ms_reads,
                               args.reads)
    sync(dev)
    runs = {**stg_stats, **stats, **ms_stats, **lay_stats, **dig_stats,
            **occ_stats, **tp_stats, **dp_stats}
    _annotate(results, runs, chase_counts)
    print(f"chip_smoke: all phases passed in {time.time() - _T0:.1f} s")
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
