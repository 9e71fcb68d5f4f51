#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spumoni_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--strains N] [--reads N]

Phases, each of which fails the script (exit != 0) on any fault:
  1. device: torch version, the GPU's name and power limit;
  2. kernel build: nvcc builds K1 `pml_scan`, K2 `pml_classify`, K3
     `ms_scan`, K4 `ms_extend`, K5 `binmax_values`, K6 `gather_chase`, K7
     `layered_scan`, K8 `layered_classify`, K9 `occ_scan` and K10
     `occ_classify` from spumoni_tpu_torch/csrc for sm_90a, one nvcc per
     source, in parallel;
  3. K1/K2 vs plain versions on small seeded indexes: every layout the
     main path can pick (P in {64, 256, 512}, pack in {2, 4}, wide or not),
     a repetitive text, a 7-letter alphabet, reads with N and bytes absent
     from the index; equality is exact (integers, tolerance 0);
  3b. K3 (ms, ms+doc, pml+doc), K4, K5 and K6 vs plain versions the same
     way, on multi-document MS indexes of the same layouts;
  3c. K7 `layered_scan` (pml, pml+doc, ms, ms+doc; int32 and int64), K8
     `layered_classify` and K4 on K7's pointers vs plain versions on small
     layered indexes: DNA of depth 2 and 3, two documents, general text
     (26 letters), -m digested text; DNA cases also vs the native engine;
  3d. K9 `occ_scan` (pml, pml+doc, ms, ms+doc), K10 `occ_classify` and K4
     on K9's pointers vs plain versions on small occ-block indexes: DNA
     with N at P = 128 and P = 16, two documents (with a read longer than
     4,096), a 14-letter text (sigma 15, the layout's bound), each in every
     row layout 4d builds (PML only, with SA samples, with doc ids, with
     both); reads with bytes absent from the index and past its largest
     character (W, Y); DNA cases also vs the native engine;
  4. the main path through the CLI at a real size: a synthetic stand-in for
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
  5. K1/K2 vs plain timing at the main-path shape (B = 65,536, L = 1,024)
     on the main-path index;
  5b. K3 (all three modes), K4 and K5 vs plain at the same shape on the MS
     index, and K6 through the gather-chase script's entry point at its
     shape (R = 9,728, W = 128, L = 64);
  5c. K7 (pml, pml+doc, ms, ms+doc) and K8 vs plain at the same shape on
     4b's index with the layered engine, and K7-pml and K8 on the -m index
     at the digested reads' bucket (L = 256);
  5d. K9 (pml, pml+doc, ms, ms+doc) and K10 vs plain at the same shape on
     4b's index with the occ-block engine, each mode on the rows its 4d run
     builds.

Every CLI run of 4, 4b, 4c and 4d, and the gather-chase script of 5b, is
a path of its own: the launch counts are set to 0 just before it and read
just after, and it must launch each kernel PATH_KERNELS gives it and no
other. The line before the last is the per-kernel JSON summary: each
kernel's launches on its paths, its time and its plain version's, and its
bound, the least time the card could take for the same work (`_bound`);
the last line is {"ok": true, "device": {...}}. Nothing of JAX is
imported.
"""

from __future__ import annotations

import argparse
import hashlib
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
    docs = {}
    if ms:
        ds, de = _host.index_format.build_doc_arrays(
            raw, [len(text) // 2, len(text) - len(text) // 2])
        docs = dict(start_doc=ds, end_doc=de, text=text)
        dense = _host.index_format.build_dense_index(
            raw, text=text, with_samples=True, doc_start=ds, doc_end=de)
    else:
        dense = _host.index_format.build_dense_index(raw)
    native = _host.NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
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
        print(f"{label:16s} P={index.meta.P} pack={index.meta.pack} "
              f"wide={index.meta.wide} n={index.meta.n} B={len(reads)}: "
              f"K1 == plain == native, K2 == plain, exactly "
              f"({int(got[0].sum())} FOUND)")


def _max_err(got, want) -> int:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want) if g is not None)


def small_ms_phase(device, n=20000, num_reads=300):
    phase("3b. K3-K6 vs plain versions on small indexes")
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.blockbits import ranked_rows
    from spumoni_tpu_torch.scripts import exp_vmem_gather as chase

    for ci, (label, build_kw, alphabet, repeat) in enumerate(SMALL_CASES):
        text, index, table, native = _small_index(300 + ci, n, alphabet,
                                                  repeat, build_kw, ms=True)
        reads = _small_reads(400 + ci, text, num_reads, 1024)
        index = index.to(device)
        tab, rev, fwd, lens = ranked_rows(table, reads, 1024, device)
        wptr, wlen, wdoc = native.query_ms(reads, with_docs=True)
        plen, pdoc = native.query_pml(reads, with_docs=True)
        natives = {("ms", True): (wptr, wdoc), ("pml", True): (plen, pdoc)}
        for mode, use_doc in (("ms", False), ("ms", True), ("pml", True)):
            got = kernels.ms_scan(index, tab, rev, lens, mode, use_doc)
            sync(device)
            want = kernels.ms_scan_reference(index, tab, rev, lens, mode,
                                             use_doc)
            if _max_err(got, want):
                raise AssertionError(f"{label}: ms_scan {mode} doc={use_doc}"
                                     f" != ms_scan_reference")
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
        print(f"{label:16s} P={index.meta.P} pack={index.meta.pack} "
              f"wide={index.meta.wide} n={index.meta.n} r={index.meta.r} "
              f"B={len(reads)}: K3 (3 modes) == plain == native, K4 == plain "
              f"== native, K5 == plain, exactly ({int(res[0].sum())} FOUND)")
    table, idx0 = chase.make_inputs(0, device)
    table, idx0 = table[:1024].contiguous(), (idx0[:1024] % 1024).contiguous()
    i0 = int(idx0[5, 7])
    table[i0, 7] = np.int32(-2**31) ^ np.int32(i0)   # the INT_MIN wrap
    got = kernels.gather_chase(table, idx0)
    sync(device)
    if _max_err(got, kernels.gather_chase_reference(table, idx0)):
        raise AssertionError("gather_chase != gather_chase_reference")
    print("gather_chase R=1024 W=128 L=64 (one INT_MIN wrap): K6 == plain, "
          "exactly")


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
        print(f"{label:16s} D={m.depth} W={m.width} wide={m.wide} "
              f"n={m.n} r={m.r} B={len(reads)}: K7 ({len(modes)} modes), "
              f"K4 on K7 pointers{checked}, K8 == plain, exactly "
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
    its largest character, and DNA cases against the native engine."""
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
              f"K4 on K9 pointers == plain, exactly{checked} "
              f"({int(res[0].sum())} FOUND)")


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
    from spumoni_tpu_torch import _host

    seqs = {rec.name: rec.seq for rec in _host.fasta.read_fastx(reads)}
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
    from spumoni_tpu_torch import _host

    pl = _host._pipeline
    dense = _host.index_format.load_dense_index(index_path)
    zeros = np.zeros(dense.r, dtype=np.int64)
    ss = pl._unorder_samples(dense, "c_ssamp")
    es = pl._unorder_samples(dense, "c_esamp")
    return _host.NativeQueryEngine(
        dense.n, dense.run_heads, dense.run_starts,
        pl._unorder(dense, "c_thr"), zeros if ss is None else ss,
        zeros if es is None else es, start_doc=pl._unorder(dense, "c_sdoc"),
        end_doc=pl._unorder(dense, "c_edoc"), text=dense.text)


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


#: path -> the kernels it launches; a path must launch each of them, and no
#: other (a CPU run launches none)
PATH_KERNELS = {
    "P-c": ("pml_scan",),
    "P-c-report-only": ("pml_classify",),
    "M-c-report-only": ("ms_scan", "ms_extend", "binmax_values"),
    "M-c-d": ("ms_scan", "ms_extend"),
    "P-d-c": ("ms_scan",),
    "L-P-c-report-only": ("layered_classify",),
    "L-P-c": ("layered_scan",),
    "L-M-c-report-only": ("layered_scan", "ms_extend", "binmax_values"),
    "L-M-c-d": ("layered_scan", "ms_extend"),
    "L-P-d-c": ("layered_scan",),
    "m-P-c-report-only": ("layered_classify",),
    "m-P-c": ("layered_scan",),
    "a-P-c-report-only": ("pml_classify",),
    "O-P-c-report-only": ("occ_classify",),
    "O-P-c": ("occ_scan",),
    "O-M-c-report-only": ("occ_scan", "ms_extend", "binmax_values"),
    "O-M-c-d": ("occ_scan", "ms_extend"),
    "O-P-d-c": ("occ_scan",),
    "exp_vmem_gather": ("gather_chase",),
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
        st["kernel_ms"] = sum(t.ms() for t in timers)
    return st


def _print_runs(stats):
    for label, st in stats.items():
        kms = st.get("kernel_ms", float("nan"))
        own = {k: st["launches"][k] for k in PATH_KERNELS[label]}
        print(f"run {label}: {st['reads']} reads in {st['stream_s']:.3f} s "
              f"streaming -> {st['reads'] / st['stream_s']:.1f} reads/s; "
              f"wall {st['wall_s']:.1f} s; kernel time {kms:.3f} ms "
              f"(device idle share of the stream "
              f"{1 - kms / 1e3 / st['stream_s']:.4f}); launches {own}, "
              f"no other kernel")


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


def main_path_phase(device, strains, strain_len=4_600_000, n_reads=65536,
                    read_len=1024, n_check=2048, cpu_run=False):
    phase(f"4. main path: {strains} strains x {strain_len} bp, "
          f"{n_reads} reads x {read_len} bp, through the CLI")
    from spumoni_tpu_torch import cli

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


def ms_main_path_phase(device, reads, n_reads, n_check=2048,
                       cpu_run=False):
    """4b: the strains of phase 4 as 10 documents, built with -M -P -d, and
    the MS report-only, MS + doc value and PML + doc value runs over
    phase 4's reads (a copy, so phase 4's outputs stay)."""
    phase(f"4b. MS / doc main path: the strains as documents, {n_reads} "
          f"reads, through the CLI")
    from spumoni_tpu_torch import cli

    prefix = os.path.join(WORK, "msidx")
    t0 = time.time()
    cli.main(["build", "-i", os.path.join(WORK, "strains.txt"), "-M", "-P",
              "-d", "-n", "-o", prefix])
    build_s = time.time() - t0
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
    hashes = {}    # run -> {output file: sha256}, held against 4c
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


def digested_main_path_phase(device, reads, n_reads, n_check=2048,
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
    from spumoni_tpu_torch import _host, cli
    from spumoni_tpu_torch.engine.layered import depth_for

    ref = os.path.join(WORK, "pangenome.fa")
    builds = {}
    for flag in ("-m", "-a"):
        t0 = time.time()
        cli.main(["build", "-r", ref, "-P", flag, "-o",
                  os.path.join(WORK, f"idx{flag}")])
        builds[flag] = time.time() - t0
    m_prefix = os.path.join(WORK, "idx-m")
    dense = _host.index_format.load_dense_index(m_prefix
                                                + ".bin.thrbv.spumoni")
    sigma = int((np.asarray(dense.cnt) > 0).sum())
    print(f"build -m -P: {builds['-m']:.1f} s (sigma={sigma}, "
          f"n={dense.n}, r={dense.r}, D={depth_for(dense.char_off)}); build -a -P: "
          f"{builds['-a']:.1f} s")
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
    digested = [_host.minimizers.digest(s.upper(), True, False)
                for s in chk_seqs]
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
            "occ_classify": 44}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _scan_work(name, index_tensors, reads, lens, tab=None, dependent=1):
    """(input bytes, operations) of a scan over this run's reads: each
    read byte and the lens and table once, and of the index what the steps
    must read (one sector per dependent row read, at most the whole
    index); operations STEP_OPS[name] per step. _time_kernel adds the
    outputs, each written once."""
    steps = int(lens.clamp(0, reads.shape[1]).sum())
    nbytes = (steps + _nbytes(lens, tab)
              + min(_nbytes(*index_tensors), steps * SECTOR * dependent))
    return nbytes, steps * STEP_OPS[name]


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


def _staged(engine, reads_path, n_reads):
    """The phase-4 reads staged by `engine` as one group of n_reads."""
    from spumoni_tpu_torch import _host

    pk = next(_host.fastx_batch.iter_packed_batches(reads_path, 1 << 40,
                                                    upper=True))
    (g,) = engine.stage(pk, max_lanes=n_reads)
    return g


def timing_phase(device, prefix, reads, n_reads):
    phase(f"5. kernel vs plain at the main-path shape (B={n_reads})")
    from spumoni_tpu_torch import pipeline
    from spumoni_tpu_torch.engine import kernels

    engine = pipeline.make_engine(prefix + ".fa.thrbv.spumoni", device)
    g = _staged(engine, reads, n_reads)
    args = (engine.index, g["tab"], g["rev_d"], g["lens_d"])
    print(f"batch: B={g['rev_d'].shape[0]} L={g['rev_d'].shape[1]}, "
          f"index P={engine.index.meta.P} pack={engine.index.meta.pack} "
          f"rows {engine.index.bblocks.numel() * 4 / 1e6:.1f} MB")
    src = "spumoni_tpu_torch/csrc/blockbits_pml.cu"
    rows = (engine.index.bblocks,)
    return [
        _time_kernel("pml_scan", kernels.pml_scan,
                     kernels.pml_scan_reference, args, src,
                     "spumoni_tpu/engine/scan_engine.py:145",
                     _scan_work("pml_scan", rows, *args[2:], args[1])),
        _time_kernel("pml_classify", kernels.pml_classify,
                     kernels.pml_classify_reference, (*args, 7, BIN_WIDTH),
                     src, "spumoni_tpu/parallel/mesh.py:128",
                     _scan_work("pml_classify", rows, *args[2:], args[1]))]


def _time_kernel(name, kern, plain, args, source, replaces, work):
    """CUDA-event ms per call of a kernel wrapper and of its plain version,
    in turns (plain, kernel warm-up + 5 timed calls, plain); fails unless
    the outputs are equal (tolerance 0: integer outputs). work = (input
    bytes, operations) for the bound, to which the outputs are added."""
    plain_ms1, want = _time_ms(lambda: plain(*args), 1)
    kern(*args)
    ms, got = _time_ms(lambda: kern(*args), 5)
    plain_ms2, _ = _time_ms(lambda: plain(*args), 1)
    err = _max_err(got, want)
    if err:
        raise AssertionError(f"{name}: kernel != plain (max |err| {err})")
    plain_ms = (plain_ms1 + plain_ms2) / 2
    outs = got if isinstance(got, (tuple, list)) else (got,)
    bound = _bound(work[0] + _nbytes(*outs), work[1])
    print(f"{name}: kernel {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call "
          f"({plain_ms1:.3f}, {plain_ms2:.3f}); bound {bound['bound_ms']:.4f}"
          f" ms ({bound['bound_by']}); max |err| 0 (tolerance 0: integer "
          f"outputs)")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)


def _with_modes(name, timed):
    """One kernel's line from its timings by mode ({label: result}): the
    first mode's numbers, the largest |err|, and every mode's ms, plain_ms,
    bound_ms and max_abs_err under `modes`."""
    first = next(iter(timed.values()))
    return dict(first, name=name,
                max_abs_err=max(r["max_abs_err"] for r in timed.values()),
                modes={label: {k: r[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "max_abs_err")}
                       for label, r in timed.items()})


def ms_timing_phase(device, ms_prefix, reads, n_reads):
    """5b: K3 (in each of its modes: ms, the report-only run's, ms+doc and
    pml+doc, the value runs'), K4 and K5 against their plain versions at
    the main-path shape on the MS index, and K6 through the gather-chase
    script's entry point at its own shape, run as the path
    'exp_vmem_gather'. Returns (results, that path's launch counts)."""
    phase(f"5b. K3-K6 vs plain at the main-path shape (B={n_reads})")
    from spumoni_tpu_torch import pipeline
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.scripts import exp_vmem_gather as chase

    engine = pipeline.make_engine(ms_prefix + ".fa.thrbv.ms", device, "ms",
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
    modes = {label: _time_kernel(
                 f"ms_scan {label}", kernels.ms_scan,
                 kernels.ms_scan_reference,
                 (index, g["tab"], g["rev_d"], lens, mode, doc), src,
                 replaces,
                 _scan_work("ms_scan", (index.bblocks, index.msrows,
                                        *tables[label]),
                            g["rev_d"], lens, g["tab"], dependent=2))
             for label, mode, doc in (("ms", "ms", False),
                                      ("ms+doc", "ms", True),
                                      ("pml+doc", "pml", True))}
    steps = int(lens.sum())
    ext_work = (min(_nbytes(index.text), steps * SECTOR) + steps
                + steps * ptrs.element_size() + _nbytes(lens),
                steps * STEP_OPS["ms_extend"])
    results = [_with_modes("ms_scan", modes)]
    results += [
        _time_kernel("ms_extend", kernels.ms_extend,
                     kernels.ms_extend_reference,
                     (index.text, index.text_bound, g["fwd_d"], lens, ptrs),
                     src, "spumoni_tpu/engine/scan_engine.py:1042",
                     ext_work),
        _time_kernel("binmax_values", kernels.binmax_values,
                     kernels.binmax_values_reference,
                     (ms_len, lens, 7, BIN_WIDTH), src,
                     "spumoni_tpu/engine/scan_engine.py:1110",
                     (steps * ms_len.element_size() + _nbytes(lens),
                      steps * STEP_OPS["binmax_values"]))]
    # K6 through the script's own entry point, as a path of its own
    kernels.reset_launch_counts()
    res = chase.main([])
    counts = kernels.launch_counts()
    _check_launches("exp_vmem_gather", counts)
    if res["max_abs_err"]:
        raise AssertionError("gather_chase != gather_chase_reference")
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
    from spumoni_tpu_torch import _host, pipeline
    from spumoni_tpu_torch.engine import kernels

    src = "spumoni_tpu_torch/csrc/layered.cu"
    k7 = "spumoni_tpu/engine/scan_engine.py:120"
    k8_src = "spumoni_tpu/parallel/mesh.py:128"

    def work(name, index, g):
        return _scan_work(name, (index.charmeta, *index.levels,
                                 index.fields), g["rev_d"], g["lens_d"],
                          dependent=index.meta.depth + 1)

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
                                 work("layered_scan", index, g))
             for label, mode, doc in (("pml", "pml", False),
                                      ("pml+doc", "pml", True),
                                      ("ms", "ms", False),
                                      ("ms+doc", "ms", True))}
    del engine, g, index, args
    # K8 on the tables 4c's L-P-c-report-only run gives it
    engine = pipeline.make_engine(ms_prefix + ".fa.thrbv.spumoni", device,
                                  engine="layered")
    g = _staged(engine, ms_reads, n_reads)
    m = engine.index.meta
    print(f"PML batch: B={g['rev_d'].shape[0]} L={g['rev_d'].shape[1]}, "
          f"layered index D={m.depth} W={m.width} r={m.r}")
    k8 = {"10-strain": _time_kernel(
        "layered_classify 10-strain", kernels.layered_classify,
        kernels.layered_classify_reference,
        (engine.index, g["rev_d"], g["lens_d"], 7, BIN_WIDTH), src, k8_src,
        work("layered_classify", engine.index, g))}
    del engine, g
    engine = pipeline.make_engine(m_prefix + ".bin.thrbv.spumoni", device)
    pk = next(_host.fastx_batch.iter_packed_batches(m_reads, 1 << 40,
                                                    upper=True))
    pk = _host.minimizers.digest_packed(pk, True, False)
    g = max(engine.stage(pk, max_lanes=n_reads),
            key=lambda grp: len(grp["idxs"]))
    args = (engine.index, g["rev_d"], g["lens_d"])
    m = engine.index.meta
    print(f"-m batch: B={g['rev_d'].shape[0]} of {len(pk)} digested reads "
          f"at L={g['rev_d'].shape[1]} (mean digested length "
          f"{pk.total_bases / len(pk):.1f}), layered index D={m.depth} "
          f"W={m.width} r={m.r}")
    modes["-m pml"] = _time_kernel(
        "layered_scan -m pml", kernels.layered_scan,
        kernels.layered_scan_reference, (*args, "pml", False), src, k7,
        work("layered_scan", engine.index, g))
    k8["-m"] = _time_kernel(
        "layered_classify -m", kernels.layered_classify,
        kernels.layered_classify_reference, (*args, 7, BIN_WIDTH), src,
        k8_src, work("layered_classify", engine.index, g))
    return [_with_modes("layered_scan", modes),
            _with_modes("layered_classify", {"-m": k8["-m"],
                                             "10-strain": k8["10-strain"]})]


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
            _scan_work("occ_scan", cols, *args[2:], args[1]))
        if label == "pml":
            k10 = _time_kernel(
                "occ_classify", kernels.occ_classify,
                kernels.occ_classify_reference, (*args, 7, BIN_WIDTH), src,
                "spumoni_tpu/parallel/mesh.py:128",
                _scan_work("occ_classify", cols, *args[2:], args[1]))
        del engine, g, index, args, cols
    return [_with_modes("occ_scan", timed), k10]


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
    small_ms_phase(dev)
    small_layered_phase(dev)
    small_occ_phase(dev)
    sync(dev)
    prefix, reads, stats = main_path_phase(dev, args.strains,
                                           n_reads=args.reads)
    sync(dev)
    ms_prefix, ms_reads, ms_stats, hashes = ms_main_path_phase(dev, reads,
                                                               args.reads)
    sync(dev)
    lay_stats = layered_main_path_phase(dev, ms_prefix, ms_reads, hashes)
    sync(dev)
    m_prefix, m_reads, dig_stats = digested_main_path_phase(dev, reads,
                                                            args.reads)
    sync(dev)
    occ_stats = occ_main_path_phase(dev, ms_prefix, ms_reads, hashes)
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
    # each path's own counts; a kernel reports those of the paths it is on,
    # `launches` being its first path's
    paths = {label: st["launches"]
             for label, st in {**stats, **ms_stats, **lay_stats,
                               **dig_stats, **occ_stats}.items()}
    paths["exp_vmem_gather"] = chase_counts
    for r in results:
        own = [p for p in PATH_KERNELS if r["name"] in PATH_KERNELS[p]]
        r["launches"] = paths[own[0]][r["name"]]
        r["launches_by_path"] = {p: paths[p][r["name"]] for p in own}
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
