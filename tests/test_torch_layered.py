"""The port's layered engine (engine v2) held against the JAX package (JAX
on its CPU backend) and the native engine: the build, state carried over
by from_jax, the plain versions of K7 / K8, and the engine's staged path.
Integers equal exactly (tolerance 0). Inputs come from numpy seeds and
reach both packages as numpy."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from spumoni_tpu.engine import layered as jl
from spumoni_tpu.engine.scan_engine import (ScanEngine as JaxScanEngine,
                                            query_batch_kernel_v2)
from spumoni_tpu.index.format import build_dense_index, build_doc_arrays
from spumoni_tpu.io.minimizers import digest_promotion
from spumoni_tpu.native import NativeQueryEngine, build_raw_index
from spumoni_tpu.parallel.mesh import fused_classify_kernel

from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine import layered as tl
from spumoni_tpu_torch.engine.scan_engine import ScanEngine

from test_torch_kernels import ACGT
from test_torch_ms import _packed_reads

LOWER = np.arange(97, 123, dtype=np.uint8)


def _index(kind):
    """(text, DenseIndex with SA samples, text and -- for the doc kinds --
    two documents, native engine, alphabet) of one of the index kinds."""
    rng = np.random.default_rng({"dna": 11, "dna-d3": 12, "int64": 13,
                                 "two-docs": 14, "text26": 15,
                                 "minimizer": 16}[kind])
    alpha = LOWER if kind == "text26" else ACGT
    if kind == "minimizer":   # a small -m index: sigma > 8
        genome = rng.choice(ACGT, 40000).tobytes()
        text = np.frombuffer(digest_promotion(genome), np.uint8)
    else:
        text = rng.choice(alpha, {"dna-d3": 270000}.get(kind, 7000))
    raw = build_raw_index(text)
    ds = de = None
    if kind in ("two-docs", "int64"):
        ds, de = build_doc_arrays(raw, [len(text) // 2,
                                        len(text) - len(text) // 2])
    dense = build_dense_index(raw, text=text, with_samples=True,
                              doc_start=ds, doc_end=de)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last, start_doc=ds, end_doc=de,
                               text=text)
    return text, dense, native, alpha


_KINDS = ("dna", "dna-d3", "int64", "two-docs", "text26", "minimizer")


@pytest.fixture(scope="module")
def indexes():
    return {kind: _index(kind) for kind in _KINDS}


def _dtype(kind):
    return np.int64 if kind == "int64" else None


def _reads(seed, text, alpha, num=14, max_len=300):
    """Substrings with 8% errors, random reads, an N-only read, bytes
    absent from the index, and bytes that sort after every index character
    (the position then leaves the BWT: see tl's docstring). No 0xFF: the
    JAX package's 2-bit staging drops a group's forward-row exceptions when
    a read holds it (ROADMAP section C)."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(num):
        m = int(rng.integers(1, max_len))
        if i % 3 == 2:
            rd = rng.choice(alpha, m)
        else:
            st = int(rng.integers(0, len(text) - m))
            rd = text[st:st + m].copy()
            mut = rng.random(m) < 0.08
            rd[mut] = rng.choice(alpha, size=int(mut.sum()))
        reads.append(rd.tobytes())
    return reads + [
        b"N" * 40,
        b"NXY\x00" + text[:100].tobytes() + b"Q" + text[300:340].tobytes(),
        text[50:90].tobytes() + b"\xfd" + text[200:260].tobytes() + b"\xfe"
        + text[7:30].tobytes(),
        text[-90:].tobytes()]


def _rows(reads, L):
    rev = np.zeros((len(reads), L), np.uint8)
    for i, rd in enumerate(reads):
        rev[i, :len(rd)] = np.frombuffer(rd, np.uint8)[::-1]
    return rev, np.asarray([len(r) for r in reads], np.int64)


def _from_jax(arrays, meta):
    return tl.from_jax(
        {name: (None if getattr(arrays, name) is None
                else [np.asarray(lv) for lv in arrays.levels]
                if name == "levels" else np.asarray(getattr(arrays, name)))
         for name in arrays._fields},
        meta._asdict())


def _state_equal(a, b):
    assert a.meta == b.meta
    for name in ("charmeta", "fields", "text", *(f"level{t}" for t in
                                                 range(a.meta.depth))):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("kind", _KINDS)
def test_build_equals_jax(indexes, kind):
    """charmeta, levels, fields (rows 0..r of the JAX table), text (its
    power-of-two padding cut) and the scalars equal the JAX build."""
    _, dense, _, _ = indexes[kind]
    arrays, meta, _ = jl.build_layered(dense, dtype=_dtype(kind))
    index = tl.build_layered(dense, dtype=_dtype(kind))
    m = index.meta
    assert (m.depth, m.width, m.wide) == (meta.depth, meta.width,
                                          meta.dtype == "int64")
    assert np.array_equal(index.charmeta.numpy(), np.asarray(arrays.charmeta))
    assert len(index.levels) == len(arrays.levels)
    for got, want in zip(index.levels, arrays.levels):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert m.probe_bound == arrays.fields.shape[0] * meta.group
    fields = np.asarray(arrays.fields).reshape(-1, meta.width)  # un-group
    assert np.array_equal(index.fields.numpy(), fields[:dense.r + 1])
    assert len(dense.text) == dense.n - 1
    assert np.array_equal(index.text.numpy(),
                          np.asarray(arrays.text)[:dense.n - 1])
    assert index.text_bound == arrays.text.shape[0]
    for name in ("n", "last_run_sample", "last_run_edoc", "first_run_sdoc"):
        assert int(getattr(index, name)) == int(getattr(arrays, name)), name
    if kind == "dna-d3":
        assert m.depth == 3
    if kind == "minimizer":
        assert int((np.asarray(dense.cnt) > 0).sum()) > 8
    _state_equal(_from_jax(arrays, meta), index)


@pytest.mark.parametrize("kind", ["dna", "int64"])
def test_from_jax_grouped_state(indexes, kind):
    """A grouped JAX state (group = 16, the 2^17-row cliff layout) carries
    over un-grouped, keeps the JAX row count as its probe bound, and scans
    as the JAX kernel does on it; its tables equal the port's build."""
    text, dense, _, alpha = indexes[kind]
    arrays, meta, _ = jl.build_layered(dense, group=16, dtype=_dtype(kind))
    assert meta.group == 16
    index = _from_jax(arrays, meta)
    own = tl.build_layered(dense, dtype=_dtype(kind))
    assert index.meta == own.meta._replace(
        probe_bound=arrays.fields.shape[0] * 16)
    for name in ("charmeta", "fields", "text", "level0"):
        assert torch.equal(getattr(index, name), getattr(own, name)), name
    rev, lens = _rows(_reads(21, text, alpha), 384)
    for mode in ("pml", "ms"):
        want = np.asarray(query_batch_kernel_v2(arrays, jnp.asarray(rev),
                                                meta, mode, False)[0])
        got = kernels.layered_scan_reference(
            index, torch.from_numpy(rev), torch.from_numpy(lens), mode,
            False)[0].numpy()
        for i, m in enumerate(lens):
            assert np.array_equal(got[i, :m], want[i, :m][::-1]), (mode, i)


def test_from_jax_refuses_sharded_state(indexes):
    _, dense, _, _ = indexes["dna"]
    arrays, meta, _ = jl.build_layered(dense)
    with pytest.raises(ValueError, match="sharded"):
        tl.from_jax({"charmeta": np.asarray(arrays.charmeta)},
                    meta._replace(tp_axis="model")._asdict())


@pytest.mark.parametrize("kind", _KINDS)
def test_scan_reference_equals_jax_v2_and_native(indexes, kind):
    """layered_scan_reference (forward order) equals query_batch_kernel_v2
    (reversed order) in every mode the index has (PML, MS, and with two
    documents PML+doc and MS+doc), and the native engine on reads whose
    bytes do not sort after every index character."""
    text, dense, native, alpha = indexes[kind]
    arrays, meta, _ = jl.build_layered(dense, dtype=_dtype(kind))
    index = tl.build_layered(dense, dtype=_dtype(kind))
    reads = _reads(31, text, alpha)
    rev, lens = _rows(reads, 384)
    top = max(np.nonzero(np.asarray(dense.cnt))[0])
    plain = [i for i, rd in enumerate(reads) if max(rd) <= top]
    doc = index.meta.has_doc
    nat = {("pml", False): native.query_pml(reads),
           ("ms", False): native.query_ms(reads)[0]}
    if doc:
        nat["pml", True] = native.query_pml(reads, with_docs=True)[1]
        nat["ms", True] = native.query_ms(reads, with_docs=True)[2]
    for mode, use_doc in nat:
        jv, jd, _ = query_batch_kernel_v2(arrays, jnp.asarray(rev), meta,
                                          mode, use_doc)
        tv, td = kernels.layered_scan_reference(
            index, torch.from_numpy(rev), torch.from_numpy(lens), mode,
            use_doc)
        assert tv.dtype == index.meta.pos_dtype
        got = (td if use_doc else tv).numpy()
        want = np.asarray(jd if use_doc else jv)
        for i, m in enumerate(lens):
            assert np.array_equal(tv.numpy()[i, :m],
                                  np.asarray(jv)[i, :m][::-1]), (mode, i)
            assert np.array_equal(got[i, :m], want[i, :m][::-1]), (mode, i)
            assert not tv.numpy()[i, m:].any()
        for i in plain:
            assert np.array_equal(got[i, :lens[i]],
                                  nat[mode, use_doc][i]), (mode, use_doc, i)
    assert len(plain) < len(reads)


@pytest.mark.parametrize("kind", ["dna-d3", "int64", "minimizer"])
def test_classify_reference_equals_jax(indexes, kind):
    """layered_classify_reference equals fused_classify_kernel on the
    layered arrays: short reads, tails merged into the last bin."""
    text, dense, _, alpha = indexes[kind]
    arrays, meta, _ = jl.build_layered(dense, dtype=_dtype(kind))
    index = tl.build_layered(dense, dtype=_dtype(kind))
    rev, lens = _rows(_reads(41, text, alpha, num=20), 384)
    for thr, bw in ((7, 150), (12, 64)):
        want = fused_classify_kernel(arrays, jnp.asarray(rev),
                                     jnp.asarray(lens), thr, meta, "pml",
                                     dense.r, bw)
        got = kernels.layered_classify_reference(
            index, torch.from_numpy(rev), torch.from_numpy(lens), thr, bw)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (thr, bw)


@pytest.mark.parametrize("kind", ["two-docs", "text26", "minimizer"])
def test_engine_matches_jax_staged_engine(indexes, kind):
    """The port's ScanEngine on a LayeredIndex (raw-byte staging; K7, K7
    -> K4, K8 and K7 -> K4 -> K5) equals the JAX engine's staged path on
    its layered arrays, read by read, in every mode the index has."""
    text, dense, _, alpha = indexes[kind]
    arrays, meta, host = jl.build_layered(dense)
    index = tl.build_layered(dense)
    reads = _reads(51, text, alpha, num=16, max_len=500)
    packed = _packed_reads(reads)
    modes = [("pml", False), ("ms", False)] + (
        [("pml", True), ("ms", True)] if index.meta.has_doc else [])
    for mode, use_doc in modes:
        jeng = JaxScanEngine(arrays, meta, mode=mode, use_doc=use_doc,
                             host=host)
        want = jeng.query_staged(jeng.stage(packed))
        got = ScanEngine(index, mode=mode, use_doc=use_doc).query(reads)
        assert set(got) == set(want)
        for field in want:
            for i in range(len(reads)):
                assert np.array_equal(got[field][i], want[field][i]), (
                    mode, use_doc, field, i)
        if not use_doc:
            jcls = JaxScanEngine(arrays, meta, mode=mode, host=host)
            want = jcls.classify_staged(jcls.stage(packed), 150, 9)
            got = ScanEngine(index, mode=mode).classify(reads, 150, 9)
            for key in want:
                assert np.array_equal(got[key], want[key]), (mode, key)


def test_engine_refuses_modes_the_index_lacks(indexes):
    _, dense, _, _ = indexes["dna"]
    dense_pml = build_dense_index(build_raw_index(
        np.frombuffer(b"ACGTTGCA" * 40, np.uint8)))
    with pytest.raises(ValueError, match="MS needs"):
        ScanEngine(tl.build_layered(dense_pml), mode="ms")
    with pytest.raises(ValueError, match="doc tracking"):
        ScanEngine(tl.build_layered(dense), mode="pml", use_doc=True)
