"""The port's MS / doc-tracking state and plain versions of K3-K5, held
against the JAX package (JAX on its CPU backend) and the native engine:
integers equal exactly (tolerance 0). Inputs come from numpy seeds and
reach both packages as numpy."""

import os

import numpy as np
import pytest
import torch

from spumoni_tpu.engine import blockbits as jbb
from spumoni_tpu.engine.scan_engine import (ScanEngine as JaxScanEngine,
                                            binmax_values_kernel,
                                            extend_pointers_kernel,
                                            query_batch_kernel_v4ms)
from spumoni_tpu.index.format import build_dense_index, build_doc_arrays
from spumoni_tpu.io.fastx_batch import PackedReads
from spumoni_tpu.native import NativeQueryEngine, build_raw_index

from spumoni_tpu_torch.engine import blockbits as tbb
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.scan_engine import ScanEngine

from test_torch_kernels import ACGT, _reads


def _setup(seed, doc_lens, alphabet=ACGT):
    """A multi-document index with SA samples, doc arrays and text, and the
    native engine over it."""
    rng = np.random.default_rng(seed)
    text = np.concatenate([rng.choice(alphabet, m) for m in doc_lens])
    raw = build_raw_index(text)
    ds, de = build_doc_arrays(raw, doc_lens)
    dense = build_dense_index(raw, text=text, with_samples=True,
                              doc_start=ds, doc_end=de)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last, start_doc=ds, end_doc=de,
                               text=text)
    return text, dense, native


def _ms_reads(seed, text, num=14, max_len=300):
    """_reads plus an absent-character reset inside a match and a read
    running off the text's end into bytes the text does not have."""
    return _reads(seed, text, num, max_len) + [
        b"N" * 30 + text[100:220].tobytes() + b"NN" + text[300:380].tobytes(),
        text[-150:].tobytes() + b"ACGTA"]


def _matrices(reads, L, amap):
    rev = np.zeros((len(reads), L), np.uint8)
    fwd = np.zeros((len(reads), L), np.uint8)
    for i, rd in enumerate(reads):
        a = np.frombuffer(rd, np.uint8)
        rev[i, :len(a)] = amap[a[::-1]]
        fwd[i, :len(a)] = a
    return rev, fwd, np.asarray([len(r) for r in reads], np.int64)


def _packed_reads(reads):
    buf = np.frombuffer(b"".join(reads), np.uint8)
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    return PackedReads([f"r{i}" for i in range(len(reads))], buf, offs)


def _from_jax(arrays, meta, host):
    return tbb.from_jax(
        np.asarray(arrays.bblocks), {**meta._asdict(), "n": int(arrays.n)},
        vars(host), {name: None if getattr(arrays, name) is None
                     else np.asarray(getattr(arrays, name))
                     for name in ("msrows", "jump_t", "jump_d", "text")})


@pytest.fixture(scope="module")
def msdoc():
    return _setup(51, [3000, 2500, 2000])


_LAYOUTS = [(P, pack, wide) for P in (64, 256) for pack in (2, 4)
            for wide in (False, True)]


@pytest.mark.parametrize("P,pack,wide", _LAYOUTS)
def test_msrows_tables_and_from_jax_equal_jax(msdoc, P, pack, wide):
    """msrows, jump tables, text and the per-character table of the port's
    build equal the JAX build (its padding cut off), and from_jax carries
    the JAX state over unchanged."""
    _, dense, _ = msdoc
    arrays, meta, host = jbb.build_blockbits(dense, P=P, pack=pack,
                                             wide=wide, want_ms=True,
                                             want_doc=True)
    index, table = tbb.build_blockbits(dense, P=P, pack=pack, wide=wide,
                                       want_ms=True, want_doc=True)
    r = dense.r
    assert (index.meta.r, index.meta.term_runidx) == (meta.r,
                                                      meta.term_runidx)
    assert index.meta.ms_width == meta.ms_width
    assert np.array_equal(index.msrows.numpy(), np.asarray(arrays.msrows))
    assert np.array_equal(index.jump_t.numpy(),
                          np.asarray(arrays.jump_t)[:2 * r + 2])
    assert index.jump_t.dtype == (torch.int64 if wide else torch.int32)
    assert np.array_equal(index.jump_d.numpy(),
                          np.asarray(arrays.jump_d)[:2 * r + 2])
    assert np.array_equal(index.text.numpy(),
                          np.asarray(arrays.text)[:len(dense.text)])
    assert index.text_bound == int(arrays.text.shape[0])
    alpha = (0, 1, 65, 67, 71, 78, 84, 88)
    want = sum(np.asarray(p).astype(np.int64) << (8 * k)
               for k, p in enumerate(host.planes_for_alphabet(alpha)))
    assert np.array_equal(table.table_for_alphabet(alpha).numpy(), want)
    jindex, jtable = _from_jax(arrays, meta, host)
    assert jindex.meta == index.meta
    for name in ("bblocks", "msrows", "jump_t", "jump_d", "text"):
        assert torch.equal(getattr(jindex, name), getattr(index, name)), name
    assert torch.equal(jtable.table_for_alphabet(alpha),
                       table.table_for_alphabet(alpha))


_SCAN_CASES = {
    "P64-pack2": dict(P=64, pack=2),
    "P256-pack2": dict(P=256, pack=2),
    "P64-pack4": dict(P=64, pack=4),
    "P256-pack4": dict(P=256, pack=4),
    "P512-pack2": dict(P=512, pack=2),
    "P256-pack2-wide": dict(P=256, pack=2, wide=True),
    "P128-pack4-wide": dict(P=128, pack=4, wide=True),
}


@pytest.mark.parametrize("case", sorted(_SCAN_CASES))
def test_ms_scan_reference_equals_jax_v4ms_and_native(msdoc, case):
    """ms_scan_reference (forward order) equals query_batch_kernel_v4ms
    (reversed order) for ms, ms+doc and pml+doc, with the port's state made
    by from_jax, and equals the native engine's pointers, lengths and doc
    ids."""
    text, dense, native = msdoc
    arrays, meta, host = jbb.build_blockbits(dense, want_ms=True,
                                             want_doc=True,
                                             **_SCAN_CASES[case])
    index, table = _from_jax(arrays, meta, host)
    reads = _ms_reads(61, text)
    alpha = tuple(sorted({0} | set(b"".join(reads))))
    rev, _, lens = _matrices(reads, 384, host.rank_map(alpha))
    planes = host.planes_for_alphabet(alpha)
    tab = table.table_for_alphabet(alpha)
    wptr, _, wdoc = native.query_ms(reads, with_docs=True)
    plen, pdoc = native.query_pml(reads, with_docs=True)
    for mode, use_doc in (("ms", False), ("ms", True), ("pml", True)):
        jv, jd, _ = query_batch_kernel_v4ms(arrays, rev, meta, mode, use_doc,
                                            planes)
        tv, td = kernels.ms_scan_reference(index, tab, torch.from_numpy(rev),
                                           torch.from_numpy(lens), mode,
                                           use_doc)
        assert tv.dtype == index.meta.pos_dtype
        jv, tv = np.asarray(jv), tv.numpy()
        for i, m in enumerate(lens):
            assert np.array_equal(tv[i, :m], jv[i, :m][::-1]), (mode, i)
            assert not tv[i, m:].any(), (mode, i)
            assert np.array_equal(
                tv[i, :m], wptr[i] if mode == "ms" else plen[i]), (mode, i)
            if use_doc:
                assert np.array_equal(td.numpy()[i, :m],
                                      np.asarray(jd)[i, :m][::-1]), (mode, i)
                assert np.array_equal(
                    td.numpy()[i, :m],
                    wdoc[i] if mode == "ms" else pdoc[i]), (mode, i)
    assert (wptr[-2] <= 0).any()   # the absent-character reset


@pytest.mark.parametrize("wide", [False, True])
def test_ms_extend_reference_equals_jax_staged_lengths(msdoc, wide):
    """ms_extend_reference on the port's pointers equals the lengths of the
    JAX package's staged MS query (_query_group_dev: extend_pointers_sweep
    for ordinary reads, extend_pointers_kernel for reads with pointers
    <= 0) and the native engine, N reads and reads off the text's end
    included."""
    text, dense, native = msdoc
    arrays, meta, host = jbb.build_blockbits(dense, wide=wide, want_ms=True)
    index, table = tbb.build_blockbits(dense, wide=wide, want_ms=True)
    reads = _ms_reads(71, text, num=18) + [b"N" * 64, text[-90:].tobytes()]
    jeng = JaxScanEngine(arrays, meta, mode="ms", host=host)
    jout = jeng.query_staged(jeng.stage(_packed_reads(reads)))
    alpha = tuple(sorted({0} | set(b"".join(reads))))
    rev, fwd, lens = _matrices(reads, 512, table.rank_map(alpha))
    lens_t = torch.from_numpy(lens)
    ptrs, _ = kernels.ms_scan_reference(
        index, table.table_for_alphabet(alpha), torch.from_numpy(rev),
        lens_t, "ms", False)
    got = kernels.ms_extend_reference(index.text, index.text_bound,
                                      torch.from_numpy(fwd), lens_t,
                                      ptrs).numpy()
    _, wlen = native.query_ms(reads)
    anomalous = 0
    for i, m in enumerate(lens):
        assert np.array_equal(got[i, :m], jout["lengths"][i]), i
        assert np.array_equal(got[i, :m], wlen[i]), i
        assert not got[i, m:].any(), i
        anomalous += bool((ptrs[i, :m] <= 0).any())
    assert anomalous >= 2          # the fallback path was exercised


@pytest.mark.parametrize("L", [64, 1021])
@pytest.mark.parametrize("wide", [False, True])
def test_ms_extend_reference_equals_jax_kernel_on_any_pointers(L, wide):
    """ms_extend_reference equals extend_pointers_kernel, the JAX two-pointer
    carry, on pointer matrices that are no MS pointers
    (kernels.seeded_extend, the GPU tests' inputs): random pointers in
    [-3, nt + 3], runs of consecutive pointers, pointers into [ntext, nt)
    and past nt, negative pointers inside matches, reads running into the
    0 bytes past the text; lengths 0, 1, 7-9 and L among them."""
    nt = 4096
    text, reads, lens, ptrs = kernels.seeded_extend(11 + L, L, wide)
    ntext = len(text)
    assert (ptrs < 0).any() and ((ptrs >= ntext) & (ptrs < nt)).any()
    assert (ptrs >= nt).any() and {0, 1, 7, 8, 9, L} <= set(lens.tolist())
    want = np.asarray(extend_pointers_kernel(
        np.pad(text, (0, nt - ntext)), reads, lens, ptrs, nt=nt))
    got = kernels.ms_extend_reference(torch.from_numpy(text), nt,
                                      torch.from_numpy(reads),
                                      torch.from_numpy(lens),
                                      torch.from_numpy(ptrs))
    assert got.dtype == (torch.int64 if wide else torch.int32)
    assert np.array_equal(got.numpy(), want)
    # the carry emits a negative pointer's carried length, not 0
    carried = (ptrs < 0) & (want > 0)
    assert carried.any()


def test_binmax_values_reference_equals_jax(msdoc):
    """binmax_values_reference equals binmax_values_kernel: short reads,
    tails merged into the last bin, thresholds at a bin max."""
    rng = np.random.default_rng(81)
    B, L = 40, 640
    vals = rng.integers(0, 40, size=(B, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, size=B).astype(np.int64)
    lens[:4] = (1, 149, 150, 301)
    for b, m in enumerate(lens):
        vals[b, m:] = 0
    for dt in (np.int32, np.int64):
        for thr, bw in ((20, 150), (39, 64), (0, 1000)):
            want = binmax_values_kernel(vals.astype(dt), lens, thr, bw,
                                        max(1, -(-L // bw)))
            got = kernels.binmax_values_reference(
                torch.from_numpy(vals.astype(dt)), torch.from_numpy(lens),
                thr, bw)
            for w, g in zip(want, got):
                assert np.array_equal(np.asarray(w), g.numpy()), (dt, thr, bw)


def test_ms_engine_matches_jax_engine_and_native(msdoc):
    """The port's ScanEngine in MS, MS+doc and PML+doc modes (staging with
    the forward raw rows, K3 -> K4, K3 -> K4 -> K5) equals the JAX engine
    and the native engine, read by read."""
    text, dense, native = msdoc
    arrays, meta, host = jbb.build_blockbits(dense, want_ms=True,
                                             want_doc=True)
    index, table = tbb.build_blockbits(dense, want_ms=True, want_doc=True)
    reads = _ms_reads(91, text, num=16, max_len=500)
    wptr, wlen, wdoc = native.query_ms(reads, with_docs=True)
    plen, pdoc = native.query_pml(reads, with_docs=True)
    eng = ScanEngine(index, table, mode="ms", use_doc=True)
    out = eng.query(reads)
    jout = JaxScanEngine(arrays, meta, mode="ms", use_doc=True,
                         host=host).query(reads)
    for i in range(len(reads)):
        for field, want in (("pointers", wptr), ("lengths", wlen),
                            ("docs", wdoc)):
            assert np.array_equal(out[field][i], want[i]), (field, i)
            assert np.array_equal(out[field][i], jout[field][i]), (field, i)
    out = ScanEngine(index, table, mode="pml", use_doc=True).query(reads)
    for i in range(len(reads)):
        assert np.array_equal(out["lengths"][i], plen[i]), i
        assert np.array_equal(out["docs"][i], pdoc[i]), i
    cls = ScanEngine(index, table, mode="ms").classify(reads, 150, 9)
    # the JAX list API's classify() takes the v1 kernel on a block-bits
    # index and fails; `run` uses the staged path, held here
    jeng = JaxScanEngine(arrays, meta, mode="ms", host=host)
    jcls = jeng.classify_staged(jeng.stage(_packed_reads(reads)), 150, 9)
    for key in ("found", "above", "below", "sum_maxes"):
        assert np.array_equal(cls[key], jcls[key]), key


def test_engine_refuses_ms_and_doc_without_tables(msdoc):
    _, dense, _ = msdoc
    index, table = tbb.build_blockbits(dense)
    with pytest.raises(ValueError, match="MS needs"):
        ScanEngine(index, table, mode="ms")
    with pytest.raises(ValueError, match="doc tracking"):
        ScanEngine(index, table, mode="pml", use_doc=True)
    index, table = tbb.build_blockbits(dense, want_doc=True)
    with pytest.raises(ValueError, match="MS needs"):
        ScanEngine(index, table, mode="ms", use_doc=True)


def test_msrows_cache_serves_both_packages(msdoc, tmp_path):
    """A .bbms.npz written by either package is read by the other (no
    rewrite), under the rows cache's key."""
    _, dense, _ = msdoc
    for writer in ("jax", "torch"):
        rows_cache = str(tmp_path / f"{writer}.bbrows.npz")
        ms_cache = str(tmp_path / f"{writer}.bbms.npz")
        kw = dict(cache_path=rows_cache, want_ms=True, ms_cache_path=ms_cache)
        package = jbb if writer == "jax" else tbb
        package.build_blockbits(dense, **kw)
        stamp = os.stat(ms_cache).st_mtime_ns
        reader = tbb if writer == "jax" else jbb
        other = reader.build_blockbits(dense, **kw)
        assert os.stat(ms_cache).st_mtime_ns == stamp   # read, not rebuilt
        msrows = (other[0].msrows.numpy() if reader is tbb
                  else np.asarray(other[0].msrows))
        assert np.array_equal(msrows, np.load(ms_cache)["msrows"])
        assert np.array_equal(np.load(ms_cache)["key"],
                              np.load(rows_cache)["key"])
