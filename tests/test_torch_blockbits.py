"""The port's block-bits index and plain PyTorch step, held against the JAX
package (JAX on its CPU backend) and the native engine: integers equal
exactly. Inputs come from numpy seeds and reach both packages as numpy."""

import os

import numpy as np
import pytest
import torch

from spumoni_tpu.engine import blockbits as jbb
from spumoni_tpu.engine.scan_engine import (ScanEngine as JaxScanEngine,
                                            query_batch_kernel_v4)
from spumoni_tpu.index.format import build_dense_index
from spumoni_tpu.native import NativeQueryEngine, build_raw_index
from spumoni_tpu.parallel.mesh import fused_classify_kernel

from spumoni_tpu_torch.classify import binmax
from spumoni_tpu_torch.engine import blockbits as tbb
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.scan_engine import ScanEngine

from test_torch_kernels import _EDGE_LAYOUTS, ACGT, _reads


def _setup(seed, n, alphabet=ACGT, repeat=False):
    rng = np.random.default_rng(seed)
    if repeat:
        unit = rng.choice(alphabet, size=400)
        text = np.concatenate([np.tile(unit, 12), rng.choice(alphabet, 500),
                               np.tile(unit, 3)])
    else:
        text = rng.choice(alphabet, size=n)
    raw = build_raw_index(text)
    dense = build_dense_index(raw)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last)
    return text, dense, native


def _rev_matrix(reads, L, amap):
    rev = np.zeros((len(reads), L), np.uint8)
    for i, rd in enumerate(reads):
        rev[i, :len(rd)] = amap[np.frombuffer(rd, np.uint8)[::-1]]
    return rev, np.asarray([len(r) for r in reads], np.int64)


def _planes_table(planes) -> np.ndarray:
    return sum(np.asarray(p).astype(np.int64) << (8 * k)
               for k, p in enumerate(planes))


@pytest.fixture(scope="module")
def dna():
    return _setup(11, 6000)


_LAYOUTS = [(P, pack, wide) for P in (64, 128, 256, 512) for pack in (2, 4)
            for wide in (False, True)]


@pytest.mark.parametrize("P,pack,wide", _LAYOUTS)
def test_rows_key_and_manifest_equal_jax(dna, tmp_path, P, pack, wide):
    """Rows, cache key and manifest of the port's build are array_equal to
    the JAX build_blockbits output, for every layout."""
    _, dense, _ = dna
    src = str(tmp_path / "idx.npz")
    np.savez(src, dummy=np.zeros(1))
    arrays, meta, _ = jbb.build_blockbits(dense, P=P, pack=pack, wide=wide,
                                          cache_path=str(tmp_path / "j.npz"),
                                          src_path=src)
    index, _ = tbb.build_blockbits(dense, P=P, pack=pack, wide=wide,
                                   cache_path=str(tmp_path / "t.npz"),
                                   src_path=src)
    assert np.array_equal(index.bblocks.numpy(), np.asarray(arrays.bblocks))
    assert (index.meta.P, index.meta.pack, index.meta.wide,
            index.meta.term_pos, index.meta.term_code, index.meta.F_term) == (
        meta.P, meta.pack, meta.wide, meta.term_pos, meta.term_code,
        meta.F_term)
    assert index.meta.width == meta.width and index.meta.n == dense.n
    j, t = np.load(str(tmp_path / "j.npz")), np.load(str(tmp_path / "t.npz"))
    assert sorted(j.files) == sorted(t.files)
    for name in j.files:
        assert np.array_equal(j[name], t[name]), name


@pytest.mark.parametrize("pack", [2, 4])
def test_char_table_equals_jax_planes(dna, pack):
    """table_for_alphabet equals OccHost's 8-bit planes, reassembled."""
    _, dense, _ = dna
    _, _, host = jbb.build_blockbits(dense, pack=pack)
    _, table = tbb.build_blockbits(dense, pack=pack)
    for alpha in ((0, 65, 67, 71, 78, 84), tuple(sorted(
            {0, 1, 65, 67, 71, 78, 84, 81, 88, 89, 200}))):
        want = _planes_table(host.planes_for_alphabet(alpha))
        got = table.table_for_alphabet(alpha).numpy()
        assert np.array_equal(got, want), alpha
        assert np.array_equal(table.rank_map(alpha), host.rank_map(alpha))


def test_from_jax_carries_the_state_over(dna):
    _, dense, _ = dna
    arrays, meta, host = jbb.build_blockbits(dense, P=128, wide=True)
    index, table = tbb.from_jax(np.asarray(arrays.bblocks),
                                {**meta._asdict(), "n": int(arrays.n)},
                                vars(host))
    own_index, own_table = tbb.build_blockbits(dense, P=128, wide=True)
    assert torch.equal(index.bblocks, own_index.bblocks)
    assert index.meta == own_index.meta
    alpha = (0, 65, 67, 71, 78, 84)
    assert torch.equal(table.table_for_alphabet(alpha),
                       own_table.table_for_alphabet(alpha))


_SCAN_CASES = {
    "random-P256": dict(seed=21, build=dict(P=256)),
    "random-P64-pack4": dict(seed=22, build=dict(P=64, pack=4)),
    "wide-P512": dict(seed=23, build=dict(P=512, wide=True)),
    "repetitive": dict(seed=24, repeat=True, build={}),
    "alphabet7-pack4": dict(seed=25, alphabet=b"ACGTWXY", build={}),
}


@pytest.mark.parametrize("case", sorted(_SCAN_CASES))
def test_scan_reference_equals_jax_v4_and_native(case):
    """pml_scan_reference (forward order) equals query_batch_kernel_v4
    (reversed order) and the native engine, read by read."""
    c = _SCAN_CASES[case]
    alphabet = np.frombuffer(c.get("alphabet", b"ACGT"), np.uint8)
    text, dense, native = _setup(c["seed"], 7000, alphabet,
                                 c.get("repeat", False))
    arrays, meta, host = jbb.build_blockbits(dense, **c["build"])
    index, table = tbb.build_blockbits(dense, **c["build"])
    reads = _reads(c["seed"] + 100, text, 14, 300)
    alpha = tuple(sorted({0} | set(b"".join(reads))))
    rev, lens = _rev_matrix(reads, 384, host.rank_map(alpha))
    jvals, _ = query_batch_kernel_v4(arrays, rev, meta,
                                     host.planes_for_alphabet(alpha))
    jvals = np.asarray(jvals)
    tvals = kernels.pml_scan_reference(
        index, table.table_for_alphabet(alpha), torch.from_numpy(rev),
        torch.from_numpy(lens)).numpy()
    for i, want in enumerate(native.query_pml(reads)):
        m = len(want)
        assert np.array_equal(jvals[i, :m][::-1], want), (case, i)
        assert np.array_equal(tvals[i, :m], want), (case, i)


def test_engine_list_api_and_long_reads(dna):
    """The port's ScanEngine.query / classify (list API: staging, length
    buckets, the growing alphabet) equal the JAX engine and the native
    engine; reads past the JAX chunk (4096) take one pass here while JAX
    carries the state across chunks."""
    text, dense, native = dna
    rng = np.random.default_rng(31)
    reads = _reads(32, text, 10, 900)
    for m in (4500, 5200):
        rd = np.concatenate([text, text])[:m].copy()
        mut = rng.random(m) < 0.03
        rd[mut] = rng.choice(ACGT, size=int(mut.sum()))
        reads.append(rd.tobytes())
    reads.append(rng.choice(ACGT, size=4200).tobytes())
    arrays, meta, host = jbb.build_blockbits(dense)
    jeng = JaxScanEngine(arrays, meta, mode="pml", host=host)
    jout = jeng.query(reads)
    jcls = jeng.classify(reads, 150, 9)
    eng = ScanEngine(*tbb.build_blockbits(dense))
    tout = eng.query(reads)
    tcls = eng.classify(reads, 150, 9)
    for i, want in enumerate(native.query_pml(reads)):
        assert np.array_equal(jout["lengths"][i], want), i
        assert np.array_equal(tout["lengths"][i], want), i
        res = binmax.classify(want, 150, 9)
        assert (tcls["above"][i], tcls["below"][i]) == (res.bins_above,
                                                        res.bins_below), i
    for key in ("found", "above", "below", "sum_maxes"):
        assert np.array_equal(tcls[key], jcls[key]), key


@pytest.mark.parametrize("wide", [False, True])
def test_classify_reference_equals_jax_fused(dna, wide):
    """pml_classify_reference equals fused_classify_kernel: found, above,
    below and sum_maxes, short reads and bin-tail merges included."""
    text, dense, _ = dna
    arrays, meta, host = jbb.build_blockbits(dense, wide=wide)
    index, table = tbb.build_blockbits(dense, wide=wide)
    reads = _reads(41, text, 20, 500) + [b"A", text[:149].tobytes(),
                                        text[:301].tobytes()]
    alpha = tuple(sorted({0} | set(b"".join(reads))))
    rev, lens = _rev_matrix(reads, 512, host.rank_map(alpha))
    want = fused_classify_kernel(arrays, rev, lens, 9, meta, "pml",
                                 int(arrays.bblocks.shape[0]), 150,
                                 host.planes_for_alphabet(alpha))
    got = kernels.pml_classify_reference(
        index, table.table_for_alphabet(alpha), torch.from_numpy(rev),
        torch.from_numpy(lens), 9, 150)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("layout", _EDGE_LAYOUTS,
                         ids=lambda d: "P{P}-pack{pack}-wide{wide}".format(**d))
def test_classify_reference_on_the_edge_reads_equals_jax_fused(layout):
    """pml_classify_reference equals fused_classify_kernel on K2's edge
    reads (kernels.classify_edge_reads: lengths around the lane group and
    L, the terminator query, the W read, and the bin-width corners 149-151,
    299-301) in each load width of the group probe."""
    text, dense, _ = _setup(12, 9000)
    arrays, meta, host = jbb.build_blockbits(dense, **layout)
    index, table = tbb.build_blockbits(dense, **layout)
    reads = kernels.classify_edge_reads(text, 1024)
    alpha = tuple(sorted({0} | set(b"".join(reads))))
    rev, lens = _rev_matrix(reads, 1024, host.rank_map(alpha))
    want = fused_classify_kernel(arrays, rev, lens, 7, meta, "pml",
                                 int(arrays.bblocks.shape[0]), 150,
                                 host.planes_for_alphabet(alpha))
    got = kernels.pml_classify_reference(
        index, table.table_for_alphabet(alpha), torch.from_numpy(rev),
        torch.from_numpy(lens), 7, 150)
    assert int(got[0].sum()) > 0
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


def test_rows_cache_serves_both_packages(dna, tmp_path):
    """A .bbrows.npz written by either package fast-starts the other."""
    _, dense, _ = dna
    src = str(tmp_path / "idx.npz")
    np.savez(src, dummy=np.zeros(1))
    for writer in ("jax", "torch"):
        cache = str(tmp_path / f"{writer}.bbrows.npz")
        if writer == "jax":
            jbb.build_blockbits(dense, cache_path=cache, src_path=src)
        else:
            tbb.build_blockbits(dense, cache_path=cache, src_path=src)
        arrays, meta, host, n, r = jbb.load_cached(cache, src)
        index, table, tn, tr = tbb.load_cached(cache, src)
        assert (n, r) == (tn, tr) == (dense.n, dense.r)
        assert np.array_equal(index.bblocks.numpy(),
                              np.asarray(arrays.bblocks))
        assert index.meta.term_pos == meta.term_pos
        alpha = (0, 65, 67, 71, 78, 84)
        assert np.array_equal(table.table_for_alphabet(alpha).numpy(),
                              _planes_table(host.planes_for_alphabet(alpha)))


def test_load_cached_guards(dna, tmp_path):
    """The port's fast start returns None (never a wrong index) for a
    missing cache, a pre-manifest cache, a stale source and a rows table
    past max_bytes."""
    _, dense, _ = dna
    src = str(tmp_path / "idx.npz")
    np.savez(src, dummy=np.zeros(1))
    cache = str(tmp_path / "idx.bbrows.npz")
    assert tbb.load_cached(cache, src) is None
    tbb.build_blockbits(dense, cache_path=cache, src_path=src)
    assert tbb.load_cached(cache, src) is not None
    assert tbb.load_cached(cache, src, max_bytes=16) is None
    d = dict(np.load(cache))
    np.savez(cache, key=d["key"], rows=d["rows"])      # pre-manifest
    assert tbb.load_cached(cache, src) is None
    tbb.build_blockbits(dense, cache_path=cache, src_path=src)  # upgrades
    assert tbb.load_cached(cache, src) is not None
    os.utime(src, ns=(0, 0))                           # stale stat
    assert tbb.load_cached(cache, src) is None
    with open(cache, "wb") as f:                       # truncated file
        f.write(b"PK\x03\x04 not a zip")
    assert tbb.load_cached(cache, src) is None
    index, _ = tbb.build_blockbits(dense, cache_path=cache, src_path=src)
    assert torch.equal(index.bblocks, tbb.load_cached(cache, src)[0].bblocks)
