"""The occ-block kernel wrappers (K9 `occ_scan`, K10 `occ_classify`) and
the shared K4 `ms_extend` on K9's pointers: CPU tensors take the plain
PyTorch versions, anything else launches the CUDA kernel or raises, and on
a GPU each kernel equals its plain version exactly (integers, tolerance
0) and the native engine.

This file imports neither JAX nor tests/conftest.py fixtures, so it also
runs on a machine with a GPU and no JAX:
    python -m pytest --noconftest tests/test_torch_occ_kernels.py
"""

import numpy as np
import pytest
import torch

from spumoni_tpu_torch import _host
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.blockbits import ranked_rows
from spumoni_tpu_torch.engine.occblock import seeded_occ

from test_torch_kernels import ACGT, needs_cuda
from test_torch_layered_kernels import _reads


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors K9 (PML, MS, with doc ids), K4 on its pointers and
    K10 compute the plain versions (equal to the native engine), and their
    launch counters stay 0."""
    text, index, table, native = seeded_occ(1, 6000, docs=True, P=16)
    reads = _reads(2, text, ACGT, 12, 300)
    tab, rev, fwd, lens = ranked_rows(table, reads, 512)
    kernels.reset_launch_counts()
    pml, pdoc = (t.numpy() for t in kernels.occ_scan(index, tab, rev, lens,
                                                     "pml", True))
    ptrs, mdoc = kernels.occ_scan(index, tab, rev, lens, "ms", True)
    mslen = kernels.ms_extend(index.text, index.text_bound, fwd, lens,
                              ptrs).numpy()
    wptr, wlen, wdoc = native.query_ms(reads, with_docs=True)
    wpml, wpdoc = native.query_pml(reads, with_docs=True)
    for i, m in enumerate(lens.tolist()):
        assert np.array_equal(pml[i, :m], wpml[i]), i
        assert np.array_equal(pdoc[i, :m], wpdoc[i]), i
        assert np.array_equal(ptrs.numpy()[i, :m], wptr[i]), i
        assert np.array_equal(mdoc.numpy()[i, :m], wdoc[i]), i
        assert np.array_equal(mslen[i, :m], wlen[i]), i
    found, above, below, summ = kernels.occ_classify(index, tab, rev, lens,
                                                     7, 150)
    for i, want in enumerate(wpml):
        res = _host.binmax.classify(want, 150, 7)
        assert bool(found[i]) == (res.status == "FOUND"), i
        assert (int(above[i]), int(below[i]), int(summ[i])) == (
            res.bins_above, res.bins_below, int(res.bin_maxes.sum())), i
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("wrapper", ["occ_scan", "occ_classify"])
def test_wrappers_raise_for_non_cpu_tensors(wrapper):
    """A tensor that is not on the CPU must launch the kernel or raise —
    the plain version never stands in for it."""
    text, index, table, _ = seeded_occ(3, 2000)
    tab, rev, _, lens = ranked_rows(table, _reads(4, text, ACGT, 4, 100), 128)
    args = (index.to("meta"), tab.to("meta"), rev.to("meta"), lens.to("meta"))
    extra = (7, 150) if wrapper == "occ_classify" else ()
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(kernels, wrapper)(*args, *extra)
    assert getattr(kernels, wrapper).launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "device_mix", "mode",
                                 "doc", "samples"])
def test_occ_scan_checks_its_inputs(bad):
    text, index, table, _ = seeded_occ(5, 2000)
    tab, rev, _, lens = ranked_rows(table, _reads(6, text, ACGT, 4, 100), 128)
    mode, use_doc = "pml", False
    if bad == "dtype":
        rev = rev.to(torch.int32)
    elif bad == "shape":
        lens = lens[:-1]
    elif bad == "device_mix":
        index = index.to("meta")
    elif bad == "mode":
        mode = "layered"
    elif bad == "doc":
        use_doc = True     # the index has no doc ids
    else:
        from spumoni_tpu_torch.engine.occblock import OccIndex
        index = OccIndex(index.blocks[:, :index.meta.T0 + index.meta.P]
                         .contiguous(), index.meta._replace(
                             has_samples=False))
        mode = "ms"
    with pytest.raises(ValueError):
        kernels.occ_scan(index, tab, rev, lens, mode, use_doc)


# ---------------------------------------------------------------------------
# on the GPU: kernel == plain version, exactly
# ---------------------------------------------------------------------------

_GPU_CASES = {
    "dna-P128": dict(n=9000),
    "dna-P16": dict(n=9000, P=16),
    "two-docs": dict(n=8000, docs=True),
    "two-docs-P16": dict(n=8000, docs=True, P=16),
    "alpha15": dict(n=9000, alphabet=b"ACDEFGHIKLMNPQ"),
    # the row layouts a run builds when it asks for fewer tables
    "pml-rows": dict(n=9000, samples=False),
    "doc-rows": dict(n=8000, docs=True, samples=False),
    "ms-rows": dict(n=8000, docs=True, doc_rows=False),
}


@needs_cuda
@pytest.mark.parametrize("case", sorted(_GPU_CASES))
def test_occ_kernels_equal_plain_versions_on_gpu(case):
    kw = _GPU_CASES[case]
    alphabet = np.frombuffer(kw.get("alphabet", b"ACGT"), np.uint8)
    text, index, table, native = seeded_occ(8, **kw)
    reads = _reads(9, text, alphabet, 40, 700) + [
        text[50:90].tobytes() + b"W" + text[200:260].tobytes() + b"\xfe",
        text[:4500].tobytes() + b"N" + text[4600:5200].tobytes()]
    index = index.to("cuda")
    tab, rev, fwd, lens = ranked_rows(table, reads, 8192, "cuda")
    kernels.reset_launch_counts()
    m = index.meta
    modes = [("pml", False)] + ([("ms", False)] if m.has_samples else []) \
        + ([("pml", True)] if m.has_doc else []) \
        + ([("ms", True)] if m.has_samples and m.has_doc else [])
    for mode, use_doc in modes:
        got = kernels.occ_scan(index, tab, rev, lens, mode, use_doc)
        torch.cuda.synchronize()
        want = kernels.occ_scan_reference(index, tab, rev, lens, mode,
                                          use_doc)
        for g, w in zip(got, want):
            assert g is None and w is None or torch.equal(g, w), (mode,
                                                                  use_doc)
    if m.has_samples:
        ptrs = kernels.occ_scan(index, tab, rev, lens, "ms")[0]
        mslen = kernels.ms_extend(index.text, index.text_bound, fwd, lens,
                                  ptrs)
        assert torch.equal(mslen, kernels.ms_extend_reference(
            index.text, index.text_bound, fwd, lens, ptrs))
        if "alphabet" not in kw:
            vals = mslen.cpu().numpy()
            for i, w in enumerate(native.query_ms(reads[:-2])[1]):
                assert np.array_equal(vals[i, :len(w)], w), i
    for a, b in zip(kernels.occ_classify(index, tab, rev, lens, 7, 150),
                    kernels.occ_classify_reference(index, tab, rev, lens, 7,
                                                   150)):
        assert torch.equal(a, b)
    assert kernels.occ_scan.launches == len(modes) + m.has_samples
    assert kernels.occ_classify.launches == 1
