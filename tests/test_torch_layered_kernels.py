"""The layered-engine kernel wrappers (K7 `layered_scan`, K8
`layered_classify`) and the shared K4 `ms_extend`: CPU tensors take the
plain PyTorch versions, anything else launches the CUDA kernel or raises,
and on a GPU each kernel equals its plain version exactly (integers,
tolerance 0) and the native engine.

This file imports neither JAX nor tests/conftest.py fixtures, so it also
runs on a machine with a GPU and no JAX:
    python -m pytest --noconftest tests/test_torch_layered_kernels.py
"""

import numpy as np
import pytest
import torch

from spumoni_tpu_torch.classify import binmax
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.layered import raw_rows, seeded_layered

from test_torch_kernels import ACGT, needs_cuda

LOWER = np.arange(97, 123, dtype=np.uint8)


def _reads(seed, text, alphabet, num, max_len):
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(num):
        m = int(rng.integers(1, max_len))
        if i % 2:
            rd = rng.choice(alphabet, m)
        else:
            st = int(rng.integers(0, len(text) - m))
            rd = text[st:st + m].copy()
            mut = rng.random(m) < 0.08
            rd[mut] = rng.choice(alphabet, size=int(mut.sum()))
        reads.append(rd.tobytes())
    return reads + [b"N" * 40, b"NXY" + text[:120].tobytes() + b"Q",
                    text[-90:].tobytes()]


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors K7 (PML, MS), K4 and K8 compute the plain versions
    (equal to the native engine), and their launch counters stay 0."""
    text, index, native = seeded_layered(1, 6000)
    reads = _reads(2, text, ACGT, 12, 300)
    rev, fwd, lens = raw_rows(reads, 512)
    kernels.reset_launch_counts()
    pml = kernels.layered_scan(index, rev, lens, "pml")[0].numpy()
    ptrs = kernels.layered_scan(index, rev, lens, "ms")[0]
    mslen = kernels.ms_extend(index.text, index.text_bound, fwd, lens,
                              ptrs).numpy()
    wptr, wlen = native.query_ms(reads)
    for i, want in enumerate(native.query_pml(reads)):
        assert np.array_equal(pml[i, :len(want)], want), i
        assert np.array_equal(ptrs.numpy()[i, :len(want)], wptr[i]), i
        assert np.array_equal(mslen[i, :len(want)], wlen[i]), i
    found, above, below, summ = kernels.layered_classify(index, rev, lens,
                                                         7, 150)
    for i, want in enumerate(native.query_pml(reads)):
        res = binmax.classify(want, 150, 7)
        assert bool(found[i]) == (res.status == "FOUND"), i
        assert (int(above[i]), int(below[i]), int(summ[i])) == (
            res.bins_above, res.bins_below, int(res.bin_maxes.sum())), i
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("wrapper", ["layered_scan", "layered_classify"])
def test_wrappers_raise_for_non_cpu_tensors(wrapper):
    """A tensor that is not on the CPU must launch the kernel or raise —
    the plain version never stands in for it."""
    text, index, _ = seeded_layered(3, 2000)
    rev, _, lens = raw_rows(_reads(4, text, ACGT, 4, 100), 128)
    args = (index.to("meta"), rev.to("meta"), lens.to("meta"))
    extra = (7, 150) if wrapper == "layered_classify" else ()
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(kernels, wrapper)(*args, *extra)
    assert getattr(kernels, wrapper).launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "device_mix", "mode",
                                 "doc"])
def test_layered_scan_checks_its_inputs(bad):
    text, index, _ = seeded_layered(5, 2000)
    rev, _, lens = raw_rows(_reads(6, text, ACGT, 4, 100), 128)
    mode, use_doc = "pml", False
    if bad == "dtype":
        rev = rev.to(torch.int32)
    elif bad == "shape":
        lens = lens[:-1]
    elif bad == "device_mix":
        index = index.to("meta")
    elif bad == "mode":
        mode = "occ"
    else:
        use_doc = True     # the index has no doc ids
    with pytest.raises(ValueError):
        kernels.layered_scan(index, rev, lens, mode, use_doc)


@pytest.mark.parametrize("L", [1024, 1021])
@pytest.mark.parametrize("mode", ["pml", "ms"])
def test_layered_scan_on_the_edge_reads_equals_native(L, mode):
    """K7's plain version on the edge reads (the lengths around its G = 8
    lanes and L, the read whose last step jumps, section C's W read, whose
    W sorts after every index character) equals the native engine: PML
    lengths or MS pointers, and doc ids."""
    text, index, native = seeded_layered(10, 3000, docs=True)
    reads = kernels.ms_edge_reads(text, L, terminator=False)
    assert {len(r) for r in reads} >= {0, 1, 7, 8, 9, L}
    rev, _, lens = raw_rows(reads, L)
    vals, docs = kernels.layered_scan(index, rev, lens, mode, True)
    if mode == "ms":
        wvals, _, wdocs = native.query_ms(reads, with_docs=True)
    else:
        wvals, wdocs = native.query_pml(reads, with_docs=True)
    for i, m in enumerate(lens.tolist()):
        assert np.array_equal(vals[i, :m].numpy(), wvals[i]), i
        assert np.array_equal(docs[i, :m].numpy(), wdocs[i]), i
        assert not vals[i, m:].any() and not docs[i, m:].any(), i


@pytest.mark.parametrize("L", [1024, 1021])
def test_layered_classify_on_the_edge_reads_equals_native(L):
    """K8's plain version on the edge reads (the lengths around its lanes
    and L, the read whose last step jumps, section C's W read) equals
    classify/binmax.py over the native engine's PML lengths; the empty
    read is NOT FOUND with no bins."""
    text, index, native = seeded_layered(10, 3000)
    reads = kernels.ms_edge_reads(text, L, terminator=False)
    assert {len(r) for r in reads} >= {0, 1, 7, 8, 9, L}
    rev, _, lens = raw_rows(reads, L)
    found, above, below, summ = kernels.layered_classify(index, rev, lens,
                                                         7, 150)
    for i, want in enumerate(native.query_pml(reads)):
        got = (bool(found[i]), int(above[i]), int(below[i]), int(summ[i]))
        if not len(want):
            assert got == (False, 0, 0, 0), i
            continue
        res = binmax.classify(want, 150, 7)
        assert got == (res.status == "FOUND", res.bins_above,
                       res.bins_below, int(res.bin_maxes.sum())), i


def test_layered_tables_must_be_16_byte_aligned():
    """K7 and K8 read level rows and field rows in 16-byte loads: their
    tables are every level and the fields, and one that starts off 16
    bytes is refused before any launch."""
    _, index, _ = seeded_layered(5, 2000)
    tables = kernels.layered_tables(index)
    assert [label for label, _ in tables] == [
        f"level {t}" for t in range(index.meta.depth)] + ["fields"]
    kernels._check_aligned("layered_scan", tables)
    fields = index.fields
    off = torch.zeros(fields.numel() + 1, dtype=fields.dtype)[1:].view(
        fields.shape)
    with pytest.raises(ValueError, match="fields is not 16-byte aligned"):
        kernels._check_aligned("layered_scan", tables[:-1] + [("fields",
                                                               off)])


# ---------------------------------------------------------------------------
# on the GPU: kernel == plain version, exactly
# ---------------------------------------------------------------------------

_GPU_CASES = {
    "dna-D2": dict(n=9000),
    "dna-D3": dict(n=270000),
    "int64-two-docs": dict(n=8000, docs=True, dtype=np.int64),
    "two-docs": dict(n=8000, docs=True),
    "text26": dict(n=9000, alphabet=LOWER),
    "minimizer": dict(n=40000, digest=True),
}


@needs_cuda
@pytest.mark.parametrize("case", sorted(_GPU_CASES))
def test_layered_kernels_equal_plain_versions_on_gpu(case):
    kw = _GPU_CASES[case]
    alphabet = kw.get("alphabet", ACGT)
    text, index, native = seeded_layered(8, **kw)
    reads = _reads(9, text, alphabet, 40, 700) + [
        text[50:90].tobytes() + b"\xfe" + text[200:260].tobytes()]
    index = index.to("cuda")
    rev, fwd, lens = raw_rows(reads, 1024, "cuda")
    kernels.reset_launch_counts()
    modes = [("pml", False), ("ms", False)] + (
        [("pml", True), ("ms", True)] if index.meta.has_doc else [])
    for mode, use_doc in modes:
        got = kernels.layered_scan(index, rev, lens, mode, use_doc)
        torch.cuda.synchronize()
        want = kernels.layered_scan_reference(index, rev, lens, mode,
                                              use_doc)
        for g, w in zip(got, want):
            assert g is None and w is None or torch.equal(g, w), (mode,
                                                                  use_doc)
    ptrs = kernels.layered_scan(index, rev, lens, "ms")[0]
    mslen = kernels.ms_extend(index.text, index.text_bound, fwd, lens, ptrs)
    assert torch.equal(mslen, kernels.ms_extend_reference(
        index.text, index.text_bound, fwd, lens, ptrs))
    if alphabet is ACGT and not kw.get("digest"):
        vals = mslen.cpu().numpy()
        for i, w in enumerate(native.query_ms(reads)[1]):
            assert np.array_equal(vals[i, :len(w)], w), i
    for a, b in zip(kernels.layered_classify(index, rev, lens, 7, 150),
                    kernels.layered_classify_reference(index, rev, lens, 7,
                                                       150)):
        assert torch.equal(a, b)
    assert kernels.layered_scan.launches == len(modes) + 1
    assert kernels.layered_classify.launches == 1
    # K7 on the edge reads (lengths around its G = 8 lanes; B not a multiple
    # of 128 / G), at L = 1,024 and 1,021 (a read stride off 32 bytes)
    for L in (1024, 1021):
        rev, _, lens = raw_rows(kernels.ms_edge_reads(text, L,
                                                      terminator=False),
                                L, "cuda")
        for mode, use_doc in modes:
            want = kernels.layered_scan_reference(index, rev, lens, mode,
                                                  use_doc)
            got = kernels.layered_scan(index, rev, lens, mode, use_doc)
            torch.cuda.synchronize()
            assert all(a is b is None or torch.equal(a, b)
                       for a, b in zip(got, want)), (L, mode, use_doc)


@needs_cuda
@pytest.mark.parametrize("case", ["dna-D2", "int64-two-docs", "minimizer"])
def test_layered_classify_on_the_edge_reads_on_gpu(case):
    """K8 on the edge reads (lengths around its lanes; B not a multiple of
    128 / G; the W read) at L = 1,024 and 1,021, with int32 and int64
    positions and on a -m index, equals its plain version."""
    kw = _GPU_CASES[case]
    text, index, _ = seeded_layered(8, **kw)
    index = index.to("cuda")
    for L in (1024, 1021):
        rev, _, lens = raw_rows(kernels.ms_edge_reads(text, L,
                                                      terminator=False),
                                L, "cuda")
        for thr, bw in ((7, 150), (3, 8)):
            want = kernels.layered_classify_reference(index, rev, lens, thr,
                                                      bw)
            got = kernels.layered_classify(index, rev, lens, thr, bw)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                L, thr, bw)
