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

from spumoni_tpu_torch import _host
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
        res = _host.binmax.classify(want, 150, 7)
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
        for i, w in enumerate(native.query_ms(reads[:-1])[1]):
            assert np.array_equal(vals[i, :len(w)], w), i
    for a, b in zip(kernels.layered_classify(index, rev, lens, 7, 150),
                    kernels.layered_classify_reference(index, rev, lens, 7,
                                                       150)):
        assert torch.equal(a, b)
    assert kernels.layered_scan.launches == len(modes) + 1
    assert kernels.layered_classify.launches == 1
