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

from spumoni_tpu_torch import _host
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.blockbits import build_blockbits
from spumoni_tpu_torch.scripts import exp_vmem_gather as chase

from test_torch_kernels import ACGT, _reads, needs_cuda


def _ms_index(seed, doc_lens, **kw):
    """A multi-document MS + doc index, its text and the native engine."""
    rng = np.random.default_rng(seed)
    text = np.concatenate([rng.choice(ACGT, m) for m in doc_lens])
    raw = _host.build_raw_index(text)
    fmt = _host.index_format
    ds, de = fmt.build_doc_arrays(raw, doc_lens)
    dense = fmt.build_dense_index(raw, text=text, with_samples=True,
                                  doc_start=ds, doc_end=de)
    native = _host.NativeQueryEngine(
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
        res = _host.binmax.classify(wlen[i], 150, 9)
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
            bare, btab = build_blockbits(_host.index_format.build_dense_index(
                _host.build_raw_index(text)))
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
