"""Grouped launches of K1, K3 and K4 (kernels.Lanes, ScanEngine.stage and
query_staged): the staged groups of a value batch on one device in one
launch each, their values flat and unpadded in the batch's read order.

Held element for element to one launch a staged group, the path before
them: at the kernels, at query_staged (and to the native engine), and
through `run` (-P -c, -P -d -c, -M -c -d) byte for byte; the data-parallel
engine groups each device's parts in a launch of their own; `scan.groups`
counts the groups each launch serves. The batches span many buckets (reads
of 1, 127, 128, 4,095, 4,097 and 9,000 bp at the kernels; of 1 to 2,500
bp elsewhere, where the plain versions would take minutes on longer reads)
or one.

This file imports neither JAX nor tests/conftest.py fixtures, so it also
runs on a machine with a GPU and no JAX:
    python -m pytest --noconftest tests/test_torch_grouped.py
"""

import os

import numpy as np
import pytest
import torch

import spumoni_tpu_torch.pipeline as tpl
from spumoni_tpu_torch import trace
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.scan_engine import (ScanEngine, _index_on,
                                                  _packed)

from test_torch_kernels import ACGT, needs_cuda
from test_torch_ms_kernels import _ms_index

#: 1 and 9,000 bp, and both sides of the 128 and 4,096 bucket edges
EDGE_LENGTHS = (1, 127, 128, 4095, 4097, 9000)
#: many buckets, shorter: 128 to 4,096
MIXED_LENGTHS = (1, 127, 128, 300, 700, 1500, 2500)
MODES = {"pml": ("pml", False), "pml+doc": ("pml", True),
         "ms": ("ms", False), "ms+doc": ("ms", True)}
_VALUE_EXTS = (".pointers", ".lengths", ".pseudo_lengths", ".doc_numbers",
               ".report")


@pytest.fixture(scope="module")
def ms_index():
    """A three-document MS + doc block-bits index (with its PML rows), its
    text and the native engine."""
    return _ms_index(31, [9000, 7000, 5000])


def _batch(text, kind: str, seed: int = 5) -> list:
    """Reads of a batch, mutated substrings and random reads: 'buckets' of
    the edge lengths and 200-6,000 bp, 'mixed' of MIXED_LENGTHS and
    200-2,000 bp, both with one more read holding N and bytes absent from
    the index; 'one-group' six reads of 129-256 bp (one bucket)."""
    rng = np.random.default_rng(seed)
    if kind == "one-group":
        lens = rng.integers(129, 257, 6)
    elif kind == "mixed":
        lens = np.concatenate([MIXED_LENGTHS, rng.integers(200, 2000, 5)])
    else:
        lens = np.concatenate([EDGE_LENGTHS, rng.integers(200, 6000, 6)])
    reads = []
    for i, m in enumerate(int(x) for x in lens):
        if i % 3 == 2:
            rd = rng.choice(ACGT, size=m)
        else:
            st = int(rng.integers(0, len(text) - m))
            rd = text[st:st + m].copy()
            mut = rng.random(m) < 0.05
            rd[mut] = rng.choice(ACGT, size=int(mut.sum()))
        reads.append(rd.tobytes())
    if kind != "one-group":
        reads.append(b"NN" + text[300:700].tobytes() + b"XY")
    return reads


def _engine(ms_index, mode: str, device="cpu") -> ScanEngine:
    """An engine on the fixture's index (a copy of it on a GPU)."""
    _, index, table, _ = ms_index
    m, doc = MODES[mode]
    if device != "cpu":
        index = _index_on(index, torch.device(device))
    return ScanEngine(index, table, mode=m, use_doc=doc)


def _per_group_query(engine: ScanEngine, staged) -> dict:
    """query_staged as it was before grouped launches: K1, or K3 then K4,
    launched once a staged group, each read's values cut from the group's
    [B, L] matrices."""
    n = sum(len(g["idxs"]) for g in staged)
    out = {}
    for g in staged:
        rev = engine._rev_d(g)
        if engine.mode == "ms":
            mats = engine._ms_values(g, rev, engine.use_doc)
        elif engine.use_doc:
            lengths, docs = engine._scan(g, rev, "pml", True)
            mats = {"lengths": lengths, "docs": docs}
        else:
            mats = {"lengths": kernels.pml_scan(engine._index(g), g["tab"],
                                                rev, g["lens_d"])}
        for f, m in mats.items():
            host = m.cpu().numpy()
            vals = out.setdefault(f, [None] * n)
            for j, i in enumerate(g["idxs"]):
                vals[i] = host[j, :g["lens"][j]]
    return out


def _launches(engine: ScanEngine, staged, kernel: str):
    """(the grouped launch's flat outputs, each part's [B, L] outputs of
    one launch a group) of `kernel`: 'pml' (K1), 'ms', 'ms+doc', 'pml+doc'
    (K3), 'extend' (K3 ms+doc, then K4 on its pointers)."""
    parts = staged   # one device
    lanes = parts[0]["lanes"]
    index, tab = engine._index(parts[0]), parts[0]["tab"]
    rev = engine._flat_rows(parts, engine._rev_d)
    if kernel == "pml":
        return ((kernels.pml_scan(index, tab, rev, lanes),),
                [(kernels.pml_scan(index, tab, engine._rev_d(g),
                                   g["lens_d"]),) for g in parts])
    mode, doc = MODES["ms+doc" if kernel == "extend" else kernel]
    grouped = kernels.ms_scan(index, tab, rev, lanes, mode, doc)
    per = [kernels.ms_scan(index, tab, engine._rev_d(g), g["lens_d"], mode,
                           doc) for g in parts]
    if kernel != "extend":
        return grouped, per
    fwd = engine._flat_rows(parts, engine._fwd_d)
    grouped = (*grouped, kernels.ms_extend(index.text, index.text_bound,
                                           fwd, lanes, grouped[0]))
    per = [(*p, kernels.ms_extend(index.text, index.text_bound,
                                  engine._fwd_d(g), g["lens_d"], p[0]))
           for g, p in zip(parts, per)]
    return grouped, per


def _check_kernels(ms_index, kernel: str, batch: str, device: str):
    text = ms_index[0]
    mode = "ms+doc" if kernel == "extend" else kernel
    engine = _engine(ms_index, mode, device)
    staged = engine.stage(_packed(_batch(text, batch)))
    if batch == "one-group":
        assert len(staged) == 1
    else:
        assert len(staged) >= 5
    kernels.reset_launch_counts()
    grouped, per = _launches(engine, staged, kernel)
    if device != "cpu":
        torch.cuda.synchronize()
        # one launch for the grouped scan, one a group beside it
        counts = kernels.launch_counts()
        name = "pml_scan" if kernel == "pml" else "ms_scan"
        assert counts[name] == 1 + len(staged)
        if kernel == "extend":
            assert counts["ms_extend"] == 1 + len(staged)
        # and the grouped kernels equal their grouped plain versions
        plain = _launches(_engine(ms_index, mode), _stage_cpu(
            ms_index, mode, _batch(text, batch)), kernel)[0]
        for got, want in zip(grouped, plain):
            assert (got is None and want is None) or torch.equal(
                got.cpu(), want), kernel
    lanes = staged[0]["lanes"]
    assert lanes.groups == len(staged)
    for k, out in enumerate(grouped):
        if out is None:
            assert all(p[k] is None for p in per)
            continue
        assert tuple(out.shape) == (lanes.size,)
        flat = out.cpu().numpy()
        for g, p in zip(staged, per):
            mat = p[k].cpu().numpy()
            for j, (o, n) in enumerate(zip(g["offs"], g["lens"])):
                assert np.array_equal(flat[o:o + n], mat[j, :n]), (k, j)


def _stage_cpu(ms_index, mode, reads):
    return _engine(ms_index, mode).stage(_packed(reads))


#: (kernel, batch): K3 ms+doc runs on the edge lengths under 'extend'
_KERNEL_CASES = [(k, "buckets") for k in ("pml", "ms", "pml+doc",
                                          "extend")] + [
    (k, "one-group") for k in ("pml", "ms", "ms+doc", "pml+doc", "extend")]


@pytest.mark.parametrize("kernel, batch", _KERNEL_CASES)
def test_grouped_launch_equals_one_launch_a_group(ms_index, kernel, batch):
    """K1, K3 in each mode and K4 over a batch's lanes in one grouped
    launch (the plain versions on CPU tensors) give, at each read's
    offset, the values of one launch a staged group, element for
    element."""
    _check_kernels(ms_index, kernel, batch, "cpu")


def test_lanes_are_laid_out_longest_first_in_read_order(ms_index):
    """stage lays a value batch out as a grouped launch wants it: every
    part's rows one after another, the lanes longest first, each read's
    values at the prefix sum of the lengths before it in read order."""
    text = ms_index[0]
    reads = _batch(text, "buckets")
    engine = _engine(ms_index, "ms")
    staged = engine.stage(_packed(reads))
    lanes = staged[0]["lanes"]
    rows, lens, offs = lanes.desc.numpy()
    assert (np.diff(lens) <= 0).all()
    assert lanes.size == sum(map(len, reads)) == lens.sum()
    assert lanes.width == max(map(len, reads))
    starts = np.concatenate([[0], np.cumsum([len(r) for r in reads])])
    at = 0
    for g in staged:
        assert g["lanes"] is lanes and g["at"] == at
        for j, i in enumerate(g["idxs"]):
            assert g["offs"][j] == starts[i]
            k = np.flatnonzero((rows == at + j * g["L"]))
            assert len(k) == 1 and offs[k[0]] == starts[i]
            assert lens[k[0]] == len(reads[i])
        at += len(g["idxs"]) * g["L"]


def _check_query(ms_index, mode: str, device: str):
    text, _, _, native = ms_index
    reads = _batch(text, "mixed")
    engine = _engine(ms_index, mode, device)
    got = engine.query_staged(engine.stage(_packed(reads)))
    want = _per_group_query(engine, engine.stage(_packed(reads)))
    assert set(got) == set(want)
    for f in want:
        for i, (a, b) in enumerate(zip(got[f], want[f])):
            assert a.dtype == b.dtype and np.array_equal(a, b), (f, i)
    m, doc = MODES[mode]
    if m == "ms":
        ptrs, lengths, docs = native.query_ms(reads, with_docs=True)
        wants = {"pointers": ptrs, "lengths": lengths, "docs": docs}
    else:
        lengths, docs = native.query_pml(reads, with_docs=True)
        wants = {"lengths": lengths, "docs": docs}
    for f in got:
        for i, w in enumerate(wants[f]):
            assert np.array_equal(got[f][i], w), (f, i)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_query_staged_equals_one_launch_a_group(ms_index, mode):
    """query_staged's per-read arrays (PML, PML + doc, MS, MS + doc) equal
    those of one launch a staged group, dtype and all, and the native
    engine's."""
    _check_query(ms_index, mode, "cpu")


def test_a_batch_that_grows_the_alphabet_shares_one_table(ms_index):
    """A byte new to the staged alphabet in a later bucket of the batch:
    every group of the batch is staged in the alphabet it grew to, so the
    grouped launch reads them all through one table, and uploaded once:
    `htod_bytes` counts each group's rows, lengths and exceptions and the
    lanes' descriptors, as a batch that grows nothing does."""
    text, _, _, native = ms_index
    reads = [text[:150].tobytes(), text[1000:1400].tobytes() + b"DHV",
             text[2000:4500].tobytes()]
    engine = _engine(ms_index, "pml")
    trace.enable()
    try:
        staged = engine.stage(_packed(reads))
        counts = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.clear()
    assert len(staged) == 3
    assert all(g["alpha"] == staged[-1]["alpha"] for g in staged)
    assert set(b"DHV") <= set(staged[0]["alpha"])
    assert counts["groups"] == 3
    assert counts["htod_bytes"] == staged[0]["lanes"].desc.numel() * 8 + sum(
        g["rev_p"].nbytes + g["lens_d"].nbytes
        + (0 if g["exc_d"] is None else g["exc_d"].nbytes) for g in staged)
    got = engine.query_staged(staged)["lengths"]
    for i, w in enumerate(native.query_pml(reads)):
        assert np.array_equal(got[i], w), i


@pytest.fixture(scope="module")
def ms_run(tmp_path_factory):
    """`build -i list -M -P -d -n` of three documents, and a reads file of
    the mixed batch and a one-group batch, in batches of about 12 kbp."""
    tmp = tmp_path_factory.mktemp("grouped")
    rng = np.random.default_rng(41)
    docs = [rng.choice(ACGT, n) for n in (9000, 7000, 5000)]
    lst = str(tmp / "docs.txt")
    with open(lst, "w") as f:
        for i, d in enumerate(docs):
            path = str(tmp / f"doc_{i}.fa")
            with open(path, "wb") as g:
                g.write(b">doc_%d\n" % i + d.tobytes() + b"\n")
            f.write(f"{path} {i + 1}\n")
    text = np.concatenate(docs)
    reads = str(tmp / "reads.fa")
    with open(reads, "wb") as f:
        for i, rd in enumerate(_batch(text, "mixed", 6)
                               + _batch(text, "one-group", 7)):
            f.write(b">read_%d\n" % i + rd + b"\n")
    prefix = str(tmp / "idx")
    tpl.build(tpl.BuildConfig(input_list=lst, output_prefix=prefix,
                              ms_index=True, pml_index=True, build_doc=True,
                              use_minimizers=False))
    return dict(ref_file=prefix, pattern_file=reads, min_digest=False,
                write_report=True, batch_bases=12000)


_RUNS = {"P-c": dict(pml_requested=True),
         "P-d-c": dict(pml_requested=True, use_doc=True),
         "M-c-d": dict(ms_requested=True, use_doc=True)}


def _outputs(reads_path) -> dict:
    out = {}
    for e in _VALUE_EXTS:
        if os.path.exists(reads_path + e):
            with open(reads_path + e, "rb") as f:
                out[e] = f.read()
            os.remove(reads_path + e)
    return out


def _check_run(ms_run, run_id, monkeypatch, device):
    cfg = tpl.RunConfig(device=device, **ms_run, **_RUNS[run_id])
    _outputs(ms_run["pattern_file"])
    tpl.run(cfg)
    got = _outputs(ms_run["pattern_file"])
    with monkeypatch.context() as m:
        m.setattr(ScanEngine, "query_staged", _per_group_query)
        tpl.run(cfg)
    want = _outputs(ms_run["pattern_file"])
    assert ".report" in want and len(want) >= 2
    assert got == want


@pytest.mark.parametrize("run_id", sorted(_RUNS))
def test_runs_write_the_files_of_one_launch_a_group(ms_run, run_id,
                                                    monkeypatch):
    """`run -P -c`, `-P -d -c` and `-M -c -d` over reads of many buckets,
    in several batches, write the value files and report of one launch a
    staged group, byte for byte."""
    _check_run(ms_run, run_id, monkeypatch, "cpu")


def _check_devices(ms_index, mode: str, k: int, device: str):
    text = ms_index[0]
    reads = _batch(text, "mixed")
    want = _engine(ms_index, mode, device).query(reads)
    many = _engine(ms_index, mode, device).to_devices([device] * k)
    staged = many.stage(_packed(reads), 8192)
    by_replica = {}
    for g in staged:
        by_replica.setdefault(g["replica"], []).append(g)
    assert len(by_replica) == k
    for parts in by_replica.values():
        lanes = parts[0]["lanes"]
        assert all(g["lanes"] is lanes for g in parts)
        assert lanes.groups == len(parts)
        assert lanes.size == sum(int(g["lens"].sum()) for g in parts)
        assert lanes.desc.device == torch.device(device)
    trace.enable()
    kernels.reset_launch_counts()
    try:
        got = many.query_staged(staged)
        counts = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.clear()
    per_launch = 2 if MODES[mode][0] == "ms" else 1
    assert counts["scan.groups"] == per_launch * len(staged)
    if device != "cpu":   # one grouped launch a device, K11 a part
        launched = kernels.launch_counts()
        name = "pml_scan" if mode == "pml" else "ms_scan"
        assert launched[name] == k
        assert launched["ms_extend"] == (k if mode.startswith("ms") else 0)
        assert launched["unpack2"] + launched["unpack4"] == len(staged) * (
            2 if mode.startswith("ms") else 1)
    for f in want:
        assert all(np.array_equal(a, b) for a, b in zip(got[f], want[f]))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("mode", ["pml", "ms+doc"])
def test_data_parallel_engine_groups_each_device(ms_index, mode, k):
    """On k devices (repeated CPUs) each device's parts share one Lanes
    and one grouped launch, which `scan.groups` counts with the groups it
    serves (K3 and K4 each in MS); the values equal the one-device
    engine's."""
    _check_devices(ms_index, mode, k, "cpu")


# ---------------------------------------------------------------------------
# on the GPU: the same checks with the CUDA kernels
# ---------------------------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("batch", ["buckets", "mixed", "one-group"])
@pytest.mark.parametrize("kernel", ["pml", "ms", "ms+doc", "pml+doc",
                                    "extend"])
def test_grouped_launch_equals_one_launch_a_group_on_gpu(ms_index, kernel,
                                                         batch):
    _check_kernels(ms_index, kernel, batch, "cuda:0")


@needs_cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_query_staged_equals_one_launch_a_group_on_gpu(ms_index, mode):
    _check_query(ms_index, mode, "cuda:0")


@needs_cuda
@pytest.mark.parametrize("run_id", sorted(_RUNS))
def test_runs_write_the_files_of_one_launch_a_group_on_gpu(
        ms_run, run_id, monkeypatch):
    _check_run(ms_run, run_id, monkeypatch, "cuda")


@needs_cuda
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", ["pml", "ms+doc"])
def test_data_parallel_engine_groups_each_device_on_gpu(ms_index, mode, k):
    _check_devices(ms_index, mode, k, "cuda:0")
