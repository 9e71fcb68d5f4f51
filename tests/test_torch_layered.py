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

from spumoni_tpu_torch.classify import binmax
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


def _past(dense, reads) -> list:
    """Indices of the reads holding a byte that sorts after every index
    character: from there the layered engine follows the native engine,
    where the JAX package's layered step reads padded field rows (ROADMAP
    section C)."""
    top = int(max(np.nonzero(np.asarray(dense.cnt))[0]))
    return [i for i, rd in enumerate(reads) if max(rd) > top]


def _native_values(native, reads, doc: bool) -> dict:
    """{(mode, use_doc): per-read values} of the native engine: PML
    lengths, MS pointers, and the doc ids of each with two documents."""
    nat = {("pml", False): native.query_pml(reads),
           ("ms", False): native.query_ms(reads)[0]}
    if doc:
        nat["pml", True] = native.query_pml(reads, with_docs=True)[1]
        nat["ms", True] = native.query_ms(reads, with_docs=True)[2]
    return nat


def _native_verdicts(lengths, thr: int, bw: int) -> tuple:
    """(found, above, below, sum_maxes) of per-read values by the host's
    bin-max (classify/binmax.py), as K5 / K8 compute them."""
    res = [binmax.classify(v, bw, thr) for v in lengths]
    return (np.array([r.status == "FOUND" for r in res]),
            np.array([r.bins_above for r in res]),
            np.array([r.bins_below for r in res]),
            np.array([int(r.bin_maxes.sum()) for r in res]))


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
    over un-grouped and scans as the JAX kernel does on it (as the native engine on reads with a
    byte past every index character); its tables equal the port's
    build."""
    text, dense, _, alpha = indexes[kind]
    arrays, meta, _ = jl.build_layered(dense, group=16, dtype=_dtype(kind))
    assert meta.group == 16
    index = _from_jax(arrays, meta)
    own = tl.build_layered(dense, dtype=_dtype(kind))
    assert index.meta == own.meta
    for name in ("charmeta", "fields", "text", "level0"):
        assert torch.equal(getattr(index, name), getattr(own, name)), name
    reads = _reads(21, text, alpha)
    past = _past(dense, reads)
    nat = _native_values(indexes[kind][2], reads, False)
    rev, lens = _rows(reads, 384)
    for mode in ("pml", "ms"):
        want = np.asarray(query_batch_kernel_v2(arrays, jnp.asarray(rev),
                                                meta, mode, False)[0])
        got = kernels.layered_scan_reference(
            index, torch.from_numpy(rev), torch.from_numpy(lens), mode,
            False)[0].numpy()
        for i, m in enumerate(lens):
            assert np.array_equal(got[i, :m], nat[mode, False][i]), (mode, i)
            if i not in past:
                assert np.array_equal(got[i, :m], want[i, :m][::-1]), (mode,
                                                                        i)
    assert past


def test_from_jax_refuses_sharded_state(indexes):
    _, dense, _, _ = indexes["dna"]
    arrays, meta, _ = jl.build_layered(dense)
    with pytest.raises(ValueError, match="sharded"):
        tl.from_jax({"charmeta": np.asarray(arrays.charmeta)},
                    meta._replace(tp_axis="model")._asdict())


@pytest.mark.parametrize("kind", _KINDS)
def test_scan_reference_equals_jax_v2_and_native(indexes, kind):
    """layered_scan_reference (forward order) equals the native engine in
    every mode the index has (PML, MS, and with two documents PML+doc and
    MS+doc), and query_batch_kernel_v2 (reversed order) on reads whose
    bytes do not sort after every index character."""
    text, dense, native, alpha = indexes[kind]
    arrays, meta, _ = jl.build_layered(dense, dtype=_dtype(kind))
    index = tl.build_layered(dense, dtype=_dtype(kind))
    reads = _reads(31, text, alpha)
    rev, lens = _rows(reads, 384)
    past = _past(dense, reads)
    nat = _native_values(native, reads, index.meta.has_doc)
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
            assert np.array_equal(got[i, :m],
                                  nat[mode, use_doc][i]), (mode, use_doc, i)
            assert not tv.numpy()[i, m:].any()
            if i in past:
                continue
            assert np.array_equal(tv.numpy()[i, :m],
                                  np.asarray(jv)[i, :m][::-1]), (mode, i)
            assert np.array_equal(got[i, :m], want[i, :m][::-1]), (mode, i)
    assert past


@pytest.mark.parametrize("kind", ["dna-d3", "int64", "minimizer"])
def test_classify_reference_equals_jax(indexes, kind):
    """layered_classify_reference equals the bin-max of the native
    engine's PML values, and fused_classify_kernel on the layered arrays
    on reads without a byte past every index character: short reads,
    tails merged into the last bin."""
    text, dense, native, alpha = indexes[kind]
    arrays, meta, _ = jl.build_layered(dense, dtype=_dtype(kind))
    index = tl.build_layered(dense, dtype=_dtype(kind))
    reads = _reads(41, text, alpha, num=20)
    plain = np.setdiff1d(np.arange(len(reads)), _past(dense, reads))
    rev, lens = _rows(reads, 384)
    for thr, bw in ((7, 150), (12, 64)):
        want = fused_classify_kernel(arrays, jnp.asarray(rev),
                                     jnp.asarray(lens), thr, meta, "pml",
                                     dense.r, bw)
        got = kernels.layered_classify_reference(
            index, torch.from_numpy(rev), torch.from_numpy(lens), thr, bw)
        nat = _native_verdicts(native.query_pml(reads), thr, bw)
        for g, w, v in zip(got, want, nat):
            assert np.array_equal(g.numpy(), v), (thr, bw)
            assert np.array_equal(g.numpy()[plain],
                                  np.asarray(w)[plain]), (thr, bw)
    assert len(plain) < len(reads)


@pytest.mark.parametrize("kind", ["two-docs", "text26", "minimizer"])
def test_engine_matches_jax_staged_engine(indexes, kind):
    """The port's ScanEngine on a LayeredIndex (raw-byte staging; K7, K7
    -> K4, K8 and K7 -> K4 -> K5) equals the native engine, read by read,
    in every mode the index has, and the JAX engine's staged path on its
    layered arrays on reads without a byte past every index character."""
    text, dense, native, alpha = indexes[kind]
    arrays, meta, host = jl.build_layered(dense)
    index = tl.build_layered(dense)
    reads = _reads(51, text, alpha, num=16, max_len=500)
    past = _past(dense, reads)
    plain = np.setdiff1d(np.arange(len(reads)), past)
    packed = _packed_reads(reads)
    nat = _native_values(native, reads, index.meta.has_doc)
    ms_lengths = native.query_ms(reads)[1]
    for mode, use_doc in nat:
        jeng = JaxScanEngine(arrays, meta, mode=mode, use_doc=use_doc,
                             host=host)
        want = jeng.query_staged(jeng.stage(packed))
        got = ScanEngine(index, mode=mode, use_doc=use_doc).query(reads)
        assert set(got) == set(want)
        exact = {"docs" if use_doc else "pointers" if mode == "ms"
                 else "lengths": nat[mode, use_doc]}
        if mode == "ms":
            exact["lengths"] = ms_lengths
        for field in want:
            for i in range(len(reads)):
                if field in exact:
                    assert np.array_equal(got[field][i], exact[field][i]), (
                        mode, use_doc, field, i)
                if i not in past:
                    assert np.array_equal(got[field][i], want[field][i]), (
                        mode, use_doc, field, i)
        if not use_doc:
            jcls = JaxScanEngine(arrays, meta, mode=mode, host=host)
            want = jcls.classify_staged(jcls.stage(packed), 150, 9)
            got = ScanEngine(index, mode=mode).classify(reads, 150, 9)
            verdicts = _native_verdicts(
                ms_lengths if mode == "ms" else nat["pml", False], 9, 150)
            for key, v in zip(("found", "above", "below", "sum_maxes"),
                              verdicts):
                assert np.array_equal(got[key], v), (mode, key)
                assert np.array_equal(got[key][plain], want[key][plain]), (
                    mode, key)
    assert past


def test_engine_refuses_modes_the_index_lacks(indexes):
    _, dense, _, _ = indexes["dna"]
    dense_pml = build_dense_index(build_raw_index(
        np.frombuffer(b"ACGTTGCA" * 40, np.uint8)))
    with pytest.raises(ValueError, match="MS needs"):
        ScanEngine(tl.build_layered(dense_pml), mode="ms")
    with pytest.raises(ValueError, match="doc tracking"):
        ScanEngine(tl.build_layered(dense), mode="pml", use_doc=True)


def test_jax_layered_step_past_the_last_character_differs(indexes):
    """The JAX package's divergent answer, pinned as the ROADMAP section C
    fault the port keeps out: on the read text[100:160] + a byte that
    sorts after every index character + text[200:260], its layered step
    reads a padded field row after the byte, and its PML values differ
    from the native engine's at positions 0-53 and 56 (51 where native
    gives 52 at position 0, 0 where it gives 1 at position 56). The port's
    plain step gives the native engine's values."""
    text, dense, native, _ = indexes["dna"]
    arrays, meta, _ = jl.build_layered(dense)
    index = tl.build_layered(dense)
    top = int(max(np.nonzero(np.asarray(dense.cnt))[0]))
    read = text[100:160].tobytes() + bytes([top + 1]) + text[200:260].tobytes()
    rev, lens = _rows([read], 128)
    want = native.query_pml([read])[0]
    jax = np.asarray(query_batch_kernel_v2(arrays, jnp.asarray(rev), meta,
                                           "pml", False)[0])[0, :len(read)]
    jax = jax[::-1]
    assert (int(jax[56]), int(want[56])) == (0, 1)
    assert (int(jax[0]), int(want[0])) == (51, 52)
    got = kernels.layered_scan_reference(index, torch.from_numpy(rev),
                                         torch.from_numpy(lens), "pml",
                                         False)[0].numpy()[0, :len(read)]
    assert np.array_equal(got, want)
