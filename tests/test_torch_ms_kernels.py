"""The MS / doc and gather-chase kernel wrappers (K3-K6): CPU tensors take
the plain PyTorch versions, anything else launches the CUDA kernel or
raises, and on a GPU each kernel equals its plain version exactly.

This file imports neither JAX nor tests/conftest.py fixtures, so it also
runs on a machine with a GPU and no JAX:
    python -m pytest --noconftest tests/test_torch_ms_kernels.py
"""

import numpy as np
import pytest
import torch

from spumoni_tpu_torch.classify import binmax
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.blockbits import build_blockbits
from spumoni_tpu_torch.index import format as fmt
from spumoni_tpu_torch.native import NativeQueryEngine, build_raw_index
from spumoni_tpu_torch.scripts import exp_vmem_gather as chase

from test_torch_kernels import ACGT, _reads, needs_cuda


def _ms_index(seed, doc_lens, **kw):
    """A multi-document MS + doc index, its text and the native engine."""
    rng = np.random.default_rng(seed)
    text = np.concatenate([rng.choice(ACGT, m) for m in doc_lens])
    raw = build_raw_index(text)
    ds, de = fmt.build_doc_arrays(raw, doc_lens)
    dense = fmt.build_dense_index(raw, text=text, with_samples=True,
                                  doc_start=ds, doc_end=de)
    native = NativeQueryEngine(
        raw.n, raw.run_heads, raw.run_starts, raw.thresholds,
        raw.samples_start, raw.samples_last, start_doc=ds, end_doc=de,
        text=text)
    index, table = build_blockbits(dense, want_ms=True, want_doc=True, **kw)
    return text, index, table, native


def _stage(table, reads, L, device="cpu"):
    """(tab, reversed rank-mapped rows, forward raw rows, lens)."""
    alpha = tuple(sorted({0} | set(b"ACGTN") | set(table.index_chars)
                         | set(b"".join(reads))))
    amap = table.rank_map(alpha)
    rev = np.zeros((len(reads), L), np.uint8)
    fwd = np.zeros((len(reads), L), np.uint8)
    for i, rd in enumerate(reads):
        a = np.frombuffer(rd, np.uint8)
        rev[i, :len(a)] = amap[a[::-1]]
        fwd[i, :len(a)] = a
    lens = np.asarray([len(r) for r in reads], np.int64)
    return (table.table_for_alphabet(alpha).to(device),
            torch.from_numpy(rev).to(device),
            torch.from_numpy(fwd).to(device),
            torch.from_numpy(lens).to(device))


def _ms_reads(seed, text, num, max_len):
    return _reads(seed, text, num, max_len) + [
        b"N" * 20 + text[50:260].tobytes() + b"N" + text[400:500].tobytes(),
        text[-120:].tobytes() + b"TTGCA"]


def test_cpu_tensors_take_the_plain_paths():
    """K3, K4 and K5 on CPU tensors equal the native engine (pointers, doc
    ids, lengths) and host bin-max, and count no launch."""
    text, index, table, native = _ms_index(1, [2500, 2000])
    reads = _ms_reads(2, text, 10, 300)
    tab, rev, fwd, lens = _stage(table, reads, 512)
    kernels.reset_launch_counts()
    ptrs, docs = kernels.ms_scan(index, tab, rev, lens, "ms", True)
    ms_len = kernels.ms_extend(index.text, index.text_bound, fwd, lens,
                               ptrs)
    plen, pdocs = kernels.ms_scan(index, tab, rev, lens, "pml", True)
    found, above, below, summ = kernels.binmax_values(ms_len, lens, 9, 150)
    wptr, wlen, wdoc = native.query_ms(reads, with_docs=True)
    vlen, vdoc = native.query_pml(reads, with_docs=True)
    for i, m in enumerate(lens.tolist()):
        assert np.array_equal(ptrs[i, :m].numpy(), wptr[i]), i
        assert np.array_equal(docs[i, :m].numpy(), wdoc[i]), i
        assert np.array_equal(ms_len[i, :m].numpy(), wlen[i]), i
        assert np.array_equal(plen[i, :m].numpy(), vlen[i]), i
        assert np.array_equal(pdocs[i, :m].numpy(), vdoc[i]), i
        res = binmax.classify(wlen[i], 150, 9)
        assert bool(found[i]) == (res.status == "FOUND"), i
        assert (int(above[i]), int(below[i]), int(summ[i])) == (
            res.bins_above, res.bins_below, int(res.bin_maxes.sum())), i
    assert (kernels.ms_scan.launches, kernels.ms_extend.launches,
            kernels.binmax_values.launches) == (0, 0, 0)


@pytest.mark.parametrize("wrapper", ["ms_scan", "ms_extend",
                                     "binmax_values", "gather_chase"])
def test_wrappers_raise_for_non_cpu_tensors(wrapper):
    """A tensor that is not on the CPU must launch the kernel or raise —
    the plain version never stands in for it."""
    text, index, table, _ = _ms_index(3, [1500, 1200])
    tab, rev, fwd, lens = _stage(table, _reads(4, text, 4, 100), 128)
    index = index.to("meta")
    tab, rev, fwd, lens = (t.to("meta") for t in (tab, rev, fwd, lens))
    kernels.reset_launch_counts()
    ptrs = torch.zeros(rev.shape, dtype=torch.int32, device="meta")
    call = {
        "ms_scan": lambda: kernels.ms_scan(index, tab, rev, lens, "ms",
                                           False),
        "ms_extend": lambda: kernels.ms_extend(index.text, index.text_bound,
                                               fwd, lens, ptrs),
        "binmax_values": lambda: kernels.binmax_values(ptrs, lens, 9, 150),
        "gather_chase": lambda: kernels.gather_chase(
            torch.zeros((4, 4), dtype=torch.int32, device="meta"),
            torch.zeros((4, 4), dtype=torch.int32, device="meta")),
    }[wrapper]
    with pytest.raises(ValueError, match="unsupported device"):
        call()
    assert getattr(kernels, wrapper).launches == 0


@pytest.mark.parametrize("bad", ["mode", "no_tables", "ptr_dtype",
                                 "shape", "device_mix", "bin_width"])
def test_wrappers_check_their_inputs(bad):
    text, index, table, _ = _ms_index(5, [1500, 1200])
    tab, rev, fwd, lens = _stage(table, _reads(6, text, 4, 100), 128)
    ptrs, _ = kernels.ms_scan(index, tab, rev, lens, "ms", False)
    with pytest.raises(ValueError):
        if bad == "mode":
            kernels.ms_scan(index, tab, rev, lens, "pml", False)
        elif bad == "no_tables":
            bare, btab = build_blockbits(fmt.build_dense_index(
                build_raw_index(text)))
            kernels.ms_scan(bare, btab.table_for_alphabet((0, 65)), rev,
                            lens, "ms", False)
        elif bad == "ptr_dtype":
            kernels.ms_extend(index.text, index.text_bound, fwd, lens,
                              ptrs.to(torch.int16))
        elif bad == "shape":
            kernels.ms_extend(index.text, index.text_bound,
                              fwd[:, :64].contiguous(), lens, ptrs)
        elif bad == "device_mix":
            kernels.binmax_values(ptrs, lens.to("meta"), 9, 150)
        else:
            kernels.binmax_values(ptrs, lens, 9, 0)


@pytest.mark.parametrize("L", [1024, 1021])
@pytest.mark.parametrize("mode, use_doc", [("ms", False), ("ms", True),
                                           ("pml", True)])
def test_ms_scan_on_the_edge_reads_equals_native(L, mode, use_doc):
    """K3's plain version on the edge reads (the lengths around G = 8 and
    L, the read whose last step jumps) equals the native engine: pointers,
    PML lengths, doc ids."""
    text, index, table, native = _ms_index(5, [1500, 1200])
    reads = kernels.ms_edge_reads(text, L)[:-2]   # no terminator, no W
    assert {len(r) for r in reads} >= {0, 1, 7, 8, 9, L}
    tab, rev, _, lens = _stage(table, reads, L)
    vals, docs = kernels.ms_scan(index, tab, rev, lens, mode, use_doc)
    if mode == "ms":
        wvals, _, wdocs = native.query_ms(reads, with_docs=True)
    else:
        wvals, wdocs = native.query_pml(reads, with_docs=True)
    for i, m in enumerate(lens.tolist()):
        assert np.array_equal(vals[i, :m].numpy(), wvals[i]), i
        assert not vals[i, m:].any(), i
        if use_doc:
            assert np.array_equal(docs[i, :m].numpy(), wdocs[i]), i
        else:
            assert docs is None


def test_ms_tables_must_be_16_byte_aligned():
    """K3 / K15 read rows and msrows in 16-byte loads: a table that starts
    off 16 bytes is refused before any launch."""
    rows = torch.zeros(40, dtype=torch.int32)
    kernels._check_aligned("ms_scan", (("rows", rows[4:]),))
    with pytest.raises(ValueError, match="msrows is not 16-byte aligned"):
        kernels._check_aligned("ms_scan", (("rows", rows[4:]),
                                           ("msrows", rows[1:])))


def test_edge_reads_cover_the_group_splits():
    """ms_edge_reads: lengths 0, 1, G - 1, G, G + 1 for G = 8, 1,023 and
    L; a read whose last step (its first byte) jumps; the terminator
    query; section C's read."""
    text = np.random.default_rng(7).choice(ACGT, 2000)
    for L in (1024, 1021):
        reads = kernels.ms_edge_reads(text, L)
        lens = {len(r) for r in reads}
        assert {0, 1, 7, 8, 9, L} <= lens
        assert (1023 in lens) == (L >= 1023) and max(lens) == L
        assert reads[-3][0] != text[499] and reads[-3][1:] == text[
            500:700].tobytes()
        assert b"\x01" in reads[-2] and b"W" in reads[-1]


# ---------------------------------------------------------------------------
# on the GPU: kernel == plain version, exactly
# ---------------------------------------------------------------------------

# P=512, pack=2, non-wide is the layout pick_P gives the 10-strain index
_LAYOUTS = [dict(P=P, pack=pack, wide=wide) for P, pack, wide in (
    (64, 2, False), (256, 2, False), (512, 2, False), (512, 2, True),
    (256, 4, False), (512, 4, True))]


@needs_cuda
@pytest.mark.parametrize("layout", _LAYOUTS,
                         ids=lambda d: "P{P}-pack{pack}-wide{wide}".format(**d))
def test_ms_kernels_equal_plain_versions_on_gpu(layout):
    text, index, table, native = _ms_index(8, [4000, 3000, 2000], **layout)
    reads = _ms_reads(9, text, 40, 700)
    index = index.to("cuda")
    tab, rev, fwd, lens = _stage(table, reads, 1024, "cuda")
    kernels.reset_launch_counts()
    for mode, use_doc in (("ms", False), ("ms", True), ("pml", True)):
        got = kernels.ms_scan(index, tab, rev, lens, mode, use_doc)
        torch.cuda.synchronize()
        want = kernels.ms_scan_reference(index, tab, rev, lens, mode, use_doc)
        assert torch.equal(got[0], want[0]), (mode, use_doc)
        if use_doc:
            assert torch.equal(got[1], want[1]), (mode, use_doc)
    ptrs = kernels.ms_scan(index, tab, rev, lens, "ms", False)[0]
    got = kernels.ms_extend(index.text, index.text_bound, fwd, lens, ptrs)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.ms_extend_reference(
        index.text, index.text_bound, fwd, lens, ptrs))
    _, wlen = native.query_ms(reads)
    vals = got.cpu().numpy()
    for i, w in enumerate(wlen):
        assert np.array_equal(vals[i, :len(w)], w), i
    for thr, bw in ((9, 150), (20, 64)):
        for a, b in zip(kernels.binmax_values(got, lens, thr, bw),
                        kernels.binmax_values_reference(got, lens, thr, bw)):
            assert torch.equal(a, b), (thr, bw)
    assert (kernels.ms_scan.launches, kernels.ms_extend.launches,
            kernels.binmax_values.launches) == (4, 1, 2)
    # K3 on the edge reads (lengths around G = 8; B not a multiple of
    # 128 / G), at L = 1,024 and 1,021 (a read stride off 32 bytes)
    for L in (1024, 1021):
        tab, rev, _, lens = _stage(table, kernels.ms_edge_reads(text, L), L,
                                   "cuda")
        for mode, use_doc in (("ms", False), ("ms", True), ("pml", True)):
            want = kernels.ms_scan_reference(index, tab, rev, lens, mode,
                                             use_doc)
            got = kernels.ms_scan(index, tab, rev, lens, mode, use_doc)
            torch.cuda.synchronize()
            assert all(a is b is None or torch.equal(a, b)
                       for a, b in zip(got, want)), (L, mode)


@needs_cuda
@pytest.mark.parametrize("L", [64, 1021, 1024, 8192])
@pytest.mark.parametrize("wide", [False, True])
def test_ms_extend_equals_plain_version_on_any_pointers_on_gpu(L, wide):
    """K4 equals its plain version on pointer matrices that are no MS
    pointers (kernels.seeded_extend; tests/test_torch_ms.py holds the plain
    version to JAX on them): random pointers, runs, pointers into the 0
    bytes past the text and past its bound, negative pointers inside
    matches, lengths around every lane group. A text of 3,000 bytes ends in
    a partial 16-byte word. At L = 8,192 the block's rows take more than
    48 KB of shared memory (int32) or more than the card has (int64: the
    rows are walked from device memory)."""
    B = 20 if L == 8192 else 60
    text, reads, lens, ptrs = (torch.from_numpy(a) for a in
                               kernels.seeded_extend(11 + L, L, wide, B=B))
    want = kernels.ms_extend_reference(text, 4096, reads, lens, ptrs)
    kernels.reset_launch_counts()
    got = kernels.ms_extend(text.cuda(), 4096, reads.cuda(), lens.cuda(),
                            ptrs.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert kernels.ms_extend.launches == 1


@needs_cuda
@pytest.mark.parametrize("wide", [False, True])
def test_ms_extend_on_the_edge_reads_on_gpu(wide):
    """K4 on K3's MS pointers of the edge reads (lengths 0, 1, 7-9, 1,023
    and L, N, the terminator query, section C's read) equals its plain
    version at L = 1,024 and 1,021 (a pointer and read row stride off 16
    bytes)."""
    text, index, table, _ = _ms_index(8, [4000, 3000, 2000], P=512, pack=2,
                                      wide=wide)
    index = index.to("cuda")
    for L in (1024, 1021):
        tab, rev, fwd, lens = _stage(table, kernels.ms_edge_reads(text, L),
                                     L, "cuda")
        ptrs = kernels.ms_scan(index, tab, rev, lens, "ms", False)[0]
        got = kernels.ms_extend(index.text, index.text_bound, fwd, lens,
                                ptrs)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.ms_extend_reference(
            index.text, index.text_bound, fwd, lens, ptrs)), L


@needs_cuda
def test_gather_chase_equals_plain_version_on_gpu():
    table, idx0 = chase.make_inputs(0, "cuda")
    i0 = int(idx0[5, 7])
    table[i0, 7] = np.int32(-2**31) ^ np.int32(i0)   # the INT_MIN wrap
    kernels.reset_launch_counts()
    got = kernels.gather_chase(table, idx0)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.gather_chase_reference(table, idx0))
    assert kernels.gather_chase.launches == 1


@needs_cuda
@pytest.mark.parametrize("rows,width,steps,negative", chase.EDGE_SHAPES)
def test_gather_chase_edge_shapes_on_gpu(rows, width, steps, negative):
    """K6 equals its plain version at one element, one column (one wave),
    W = 130 (no multiple of the 4 columns a block), the capacity (R =
    58,112: one column a block, 227 KB), no steps and negative starts."""
    table, idx0 = chase.make_inputs(3, "cuda", rows, width, negative)
    kernels.reset_launch_counts()
    got = kernels.gather_chase(table, idx0, steps)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.gather_chase_reference(table, idx0,
                                                           steps))
    assert kernels.gather_chase.launches == 1
