"""The port's occ-block engine (engine v3) held against the JAX package
(JAX on its CPU backend) and the native engine: the row build, state
carried over by from_jax, the plain versions of K9 / K10 with their
one-step lag (K10 also on the edge reads), long reads against the JAX
chunked path, and the engine's staged path. Integers equal exactly
(tolerance 0). Inputs come from numpy seeds and reach both packages as
numpy."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from spumoni_tpu.engine import occblock as jo
from spumoni_tpu.engine.scan_engine import (ScanEngine as JaxScanEngine,
                                            query_batch_kernel_v3)
from spumoni_tpu.index.format import build_dense_index, build_doc_arrays
from spumoni_tpu.native import NativeQueryEngine, build_raw_index
from spumoni_tpu.parallel.mesh import fused_classify_kernel

from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine import occblock as to
from spumoni_tpu_torch.engine.blockbits import staged_alphabet
from spumoni_tpu_torch.engine.scan_engine import ScanEngine

from test_torch_layered import _reads, _rows
from test_torch_ms import _packed_reads

ACGTN = np.frombuffer(b"ACGTN", np.uint8)
ALPHA14 = np.frombuffer(b"ACDEFGHIKLMNPQ", np.uint8)  # + terminator: sigma 15
#: index kind -> (seed, alphabet, P)
_KINDS = {"dna-n": (61, ACGTN, 128), "dna-p16": (62, ACGTN, 16),
          "alpha15": (63, ALPHA14, 128)}
_MODES = [("pml", False), ("pml", True), ("ms", False), ("ms", True)]
_FLAGS = {"pml": (False, False, False), "ms": (True, False, True),
          "doc": (False, True, False), "ms+doc": (True, True, True)}


def _index(kind):
    """(text, two-document DenseIndex with SA samples and text, native
    engine, alphabet, P); DNA texts hold N at 2%."""
    seed, alpha, P = _KINDS[kind]
    rng = np.random.default_rng(seed)
    p = [0.245] * 4 + [0.02] if alpha is ACGTN else None
    text = rng.choice(alpha, 6000, p=p)
    raw = build_raw_index(text)
    ds, de = build_doc_arrays(raw, [len(text) // 2, len(text) - len(text) // 2])
    dense = build_dense_index(raw, text=text, with_samples=True,
                              doc_start=ds, doc_end=de)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last, start_doc=ds, end_doc=de,
                               text=text)
    return text, dense, native, alpha, P


@pytest.fixture(scope="module")
def indexes():
    return {kind: _index(kind) for kind in _KINDS}


def _ranked(table, reads, L):
    """(alphabet, [B, L] reversed query-rank rows, lens)."""
    alpha = staged_alphabet(table, reads)
    rev, lens = _rows(reads, L)
    return alpha, table.rank_map(alpha)[rev], lens


def _from_jax(arrays, meta):
    return to.from_jax({name: (None if getattr(arrays, name) is None
                               else np.asarray(getattr(arrays, name)))
                        for name in arrays._fields}, meta._asdict())


@pytest.mark.parametrize("flags", sorted(_FLAGS))
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_build_equals_jax(indexes, kind, flags):
    """The rows equal the JAX `blocks` for the same flags and P; the text
    (its power-of-two padding cut), the scalars and the per-character
    table equal the JAX state's; from_jax of the JAX state gives the same
    index."""
    text, dense, _, _, P = indexes[kind]
    samples, doc, want_text = _FLAGS[flags]
    arrays, meta, host = jo.build_occblock(dense, want_samples=samples,
                                           want_doc=doc, want_text=want_text,
                                           P=P)
    index, table = to.build_occblock(dense, want_samples=samples,
                                     want_doc=doc, want_text=want_text, P=P)
    m = index.meta
    assert (m.P, m.width, m.sigma, m.has_samples, m.has_doc) == (
        meta.P, meta.width, meta.sigma, meta.has_samples, meta.has_doc)
    assert np.array_equal(index.blocks.numpy(), np.asarray(arrays.blocks))
    for name in ("n", "last_run_sample", "last_run_edoc", "first_run_sdoc"):
        assert int(getattr(index, name)) == int(getattr(arrays, name)), name
    if want_text:
        assert np.array_equal(index.text.numpy(),
                              np.asarray(arrays.text)[:dense.n - 1])
        assert index.text_bound == arrays.text.shape[0]
    else:
        assert index.text is None and arrays.text is None
    alpha = staged_alphabet(table, [b"NWY\x00\xfe"])
    planes = host.planes_for_alphabet(alpha)
    want = sum(np.asarray(pl).astype(np.int64) << (8 * k)
               for k, pl in enumerate(planes))
    assert np.array_equal(table.table_for_alphabet(alpha).numpy(), want)
    back = _from_jax(arrays, meta)
    assert back.meta == m
    assert torch.equal(back.blocks, index.blocks)
    assert (back.text is None) == (index.text is None)
    if want_text:
        assert torch.equal(back.text, index.text)


def test_from_jax_refuses_a_foreign_width(indexes):
    _, dense, _, _, _ = indexes["dna-n"]
    arrays, meta, _ = jo.build_occblock(dense)
    with pytest.raises(ValueError, match="width"):
        _from_jax(arrays, meta._replace(width=meta.width + 1))


@pytest.mark.parametrize("mode,use_doc", _MODES)
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_scan_reference_equals_jax_v3_and_native(indexes, kind, mode,
                                                 use_doc):
    """occ_scan_reference (forward order, lag resolved) equals
    query_batch_kernel_v3 (reversed order, sentinel step) on reads of mixed
    lengths in one bucket (N, absent bytes, bytes past the largest index
    character), and the native engine on reads without the last kind."""
    text, dense, native, alpha, P = indexes[kind]
    arrays, meta, host = jo.build_occblock(dense, P=P)
    index, table = to.build_occblock(dense, P=P)
    reads = _reads(71, text, alpha) + [
        text[:P + 3].tobytes(), b"WY" + text[900:1000].tobytes() + b"Y"]
    qalpha, rev, lens = _ranked(table, reads, 384)
    jv, jd, _ = query_batch_kernel_v3(arrays, jnp.asarray(rev), meta, mode,
                                      use_doc,
                                      host.planes_for_alphabet(qalpha))
    tv, td = kernels.occ_scan_reference(
        index, table.table_for_alphabet(qalpha), torch.from_numpy(rev),
        torch.from_numpy(lens), mode, use_doc)
    assert tv.dtype == torch.int32 and (td is None) == (not use_doc)
    top = max(np.nonzero(np.asarray(dense.cnt))[0])
    plain = [i for i, rd in enumerate(reads) if max(rd) <= top]
    assert len(plain) < len(reads)
    if mode == "ms":
        nat = native.query_ms(reads, with_docs=True)
        nat = (nat[0], nat[2])
    else:
        nat = native.query_pml(reads, with_docs=True)
    for i, m in enumerate(lens):
        assert np.array_equal(tv.numpy()[i, :m], np.asarray(jv)[i, :m][::-1])
        assert not tv.numpy()[i, m:].any()
        if use_doc:
            assert np.array_equal(td.numpy()[i, :m],
                                  np.asarray(jd)[i, :m][::-1]), i
            assert not td.numpy()[i, m:].any()
        if i in plain:
            assert np.array_equal(tv.numpy()[i, :m], nat[0][i]), i
            if use_doc:
                assert np.array_equal(td.numpy()[i, :m], nat[1][i]), i


@pytest.mark.parametrize("mode,use_doc", _MODES)
def test_long_reads_equal_jax_chunked_path(indexes, mode, use_doc):
    """Reads longer than CHUNK = 4096 run in one pass of the port's engine
    (K9's plain version); the JAX package cuts them into chunks, carries
    the unresolved state and realigns on the host (scan_engine.py:
    1346-1383). Both agree, and with a short read in the same call."""
    text, dense, native, alpha, P = indexes["dna-p16"]
    arrays, meta, host = jo.build_occblock(dense, P=P)
    index, table = to.build_occblock(dense, P=P)
    rng = np.random.default_rng(81)
    long_read = np.concatenate([text[200:2700], rng.choice(alpha, 1500),
                                text[3000:4400]])
    long_read[::97] = ord("N")
    reads = [long_read.tobytes(), text[10:300].tobytes(),
             b"Y" + long_read[::-1].tobytes()[:4700]]
    want = JaxScanEngine(arrays, meta, mode=mode, use_doc=use_doc,
                         host=host).query(reads)
    got = ScanEngine(index, table, mode=mode, use_doc=use_doc).query(reads)
    assert set(got) == set(want)
    for field in want:
        for i in range(len(reads)):
            assert np.array_equal(got[field][i], want[field][i]), (field, i)
    nat = (native.query_ms(reads[:2])[0] if mode == "ms"
           else native.query_pml(reads[:2]))
    for i in range(2):
        assert np.array_equal(got["pointers" if mode == "ms"
                                  else "lengths"][i], nat[i])


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_classify_reference_equals_jax(indexes, kind):
    """occ_classify_reference equals fused_classify_kernel on the occ
    arrays: short reads, tails merged into the last bin."""
    text, dense, _, alpha, P = indexes[kind]
    arrays, meta, host = jo.build_occblock(dense, P=P)
    index, table = to.build_occblock(dense, P=P)
    reads = _reads(91, text, alpha, num=20)
    qalpha, rev, lens = _ranked(table, reads, 384)
    tab = table.table_for_alphabet(qalpha)
    for thr, bw in ((7, 150), (12, 64)):
        want = fused_classify_kernel(arrays, jnp.asarray(rev),
                                     jnp.asarray(lens), thr, meta, "pml",
                                     dense.r, bw,
                                     host.planes_for_alphabet(qalpha))
        got = kernels.occ_classify_reference(
            index, tab, torch.from_numpy(rev), torch.from_numpy(lens), thr,
            bw)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), (thr, bw)


@pytest.mark.parametrize("P", [16, 128, 256])
def test_classify_reference_on_the_edge_reads_equals_jax(P):
    """occ_classify_reference equals fused_classify_kernel on the occ arrays
    on kernels.classify_edge_reads (lengths around the lane groups and L,
    the bin-width corners, the terminator query and section C's W read), at
    P = 16, 128 and 256 (where a step's char words need a second round)."""
    text = np.random.default_rng(64).choice(ACGTN[:4], 6000)
    dense = build_dense_index(build_raw_index(text))
    arrays, meta, host = jo.build_occblock(dense, P=P)
    index, table = to.build_occblock(dense, P=P)
    reads = kernels.classify_edge_reads(text, 1024)
    qalpha, rev, lens = _ranked(table, reads, 1024)
    want = fused_classify_kernel(arrays, jnp.asarray(rev), jnp.asarray(lens),
                                 7, meta, "pml", dense.r, 150,
                                 host.planes_for_alphabet(qalpha))
    got = kernels.occ_classify_reference(
        index, table.table_for_alphabet(qalpha), torch.from_numpy(rev),
        torch.from_numpy(lens), 7, 150)
    assert int(got[0].sum()) > 0
    for key, g, w in zip(("found", "above", "below", "sum_maxes"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), key


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_engine_matches_jax_staged_engine(indexes, kind):
    """The port's ScanEngine on an OccIndex (K9, K9 -> K4, K10 and K9 ->
    K4 -> K5) equals the JAX engine's staged path on its occ arrays, read
    by read, in every mode."""
    text, dense, _, alpha, P = indexes[kind]
    arrays, meta, host = jo.build_occblock(dense, P=P)
    index, table = to.build_occblock(dense, P=P)
    reads = _reads(101, text, alpha, num=16, max_len=500)
    packed = _packed_reads(reads)
    for mode, use_doc in _MODES:
        jeng = JaxScanEngine(arrays, meta, mode=mode, use_doc=use_doc,
                             host=host)
        want = jeng.query_staged(jeng.stage(packed))
        eng = ScanEngine(index, table, mode=mode, use_doc=use_doc)
        assert eng.occ and not eng.layered
        got = eng.query(reads)
        assert set(got) == set(want)
        for field in want:
            for i in range(len(reads)):
                assert np.array_equal(got[field][i], want[field][i]), (
                    mode, use_doc, field, i)
        if not use_doc:
            jcls = JaxScanEngine(arrays, meta, mode=mode, host=host)
            want = jcls.classify_staged(jcls.stage(packed), 150, 9)
            got = ScanEngine(index, table, mode=mode).classify(reads, 150, 9)
            for key in want:
                assert np.array_equal(got[key], want[key]), (mode, key)


class _Stub:
    """What eligible() reads of a dense index."""

    def __init__(self, sigma, n):
        self.cnt = np.zeros(256, np.int64)
        self.cnt[1:1 + sigma] = 1
        self.n = n


@pytest.mark.parametrize("sigma,n,port,jax", [
    (16, 1000, False, False),          # 4-bit ranks: sigma <= 15 in both
    (15, 1000, True, True),
    (4, 2**24 + 1, True, False),       # past the TPU's 2^17-row cliff
    (4, 2**31, False, False),          # int32 rows
])
def test_eligible(sigma, n, port, jax):
    """The port keeps the layout's bounds (sigma <= 15, n < 2^31) and
    drops the JAX package's n <= 128 * 2^17, the TPU gather cliff."""
    assert to.eligible(_Stub(sigma, n)) is port
    assert jo.eligible(_Stub(sigma, n)) is jax


def test_engine_refuses_modes_the_index_lacks(indexes):
    _, dense, _, _, _ = indexes["dna-n"]
    index, table = to.build_occblock(dense, want_samples=False,
                                     want_doc=False, want_text=False)
    with pytest.raises(ValueError, match="MS needs"):
        ScanEngine(index, table, mode="ms")
    with pytest.raises(ValueError, match="doc tracking"):
        ScanEngine(index, table, mode="pml", use_doc=True)
    pml_only = build_dense_index(build_raw_index(
        np.frombuffer(b"ACGTTGCA" * 40, np.uint8)))
    with pytest.raises(ValueError, match="SA samples"):
        to.build_occblock(pml_only, want_samples=True)
