"""The port's kernel wrappers: CPU tensors take the plain PyTorch versions,
anything else launches the CUDA kernel or raises, and on a GPU the kernels
equal their plain versions exactly.

This file imports neither JAX nor tests/conftest.py fixtures, so it also
runs on a machine with a GPU and no JAX:
    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from spumoni_tpu_torch import _host
from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.blockbits import build_blockbits

# decided at setup time, not at import: the string is evaluated per test
needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="CUDA kernel: needs an NVIDIA GPU (sm_90a) and nvcc")

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _index(seed, n, alphabet=ACGT, repeat=False, **kw):
    rng = np.random.default_rng(seed)
    if repeat:
        unit = rng.choice(alphabet, size=n // 20)
        text = np.concatenate([np.tile(unit, 12), rng.choice(alphabet, n // 4),
                               np.tile(unit, 3)])
    else:
        text = rng.choice(alphabet, size=n)
    raw = _host.build_raw_index(text)
    dense = _host.index_format.build_dense_index(raw)
    native = _host.NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                                     raw.thresholds, raw.samples_start,
                                     raw.samples_last)
    index, table = build_blockbits(dense, **kw)
    return text, index, table, native


def _reads(seed, text, num, max_len):
    """Mutated substrings, random reads, and reads with N and bytes absent
    from the index."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(num):
        m = int(rng.integers(1, max_len))
        if i % 2 == 0:
            st = int(rng.integers(0, len(text) - m))
            rd = text[st:st + m].copy()
            mut = rng.random(m) < 0.08
            rd[mut] = rng.choice(ACGT, size=int(mut.sum()))
        else:
            rd = rng.choice(ACGT, size=m)
        reads.append(rd.tobytes())
    reads += [b"N" * 40, b"NNXY" + text[:120].tobytes() + b"Q",
              text[-90:].tobytes()]
    return reads


def _stage(table, reads, L, device="cpu"):
    """[B, L] reversed rank-mapped rows, lens and the table, as the engine
    stages them."""
    alpha = tuple(sorted({0} | set(b"ACGTN") | set(table.index_chars)
                         | set(b"".join(reads))))
    amap = table.rank_map(alpha)
    rev = np.zeros((len(reads), L), np.uint8)
    for i, rd in enumerate(reads):
        rev[i, :len(rd)] = amap[np.frombuffer(rd, np.uint8)[::-1]]
    lens = np.asarray([len(r) for r in reads], np.int64)
    return (table.table_for_alphabet(alpha).to(device),
            torch.from_numpy(rev).to(device),
            torch.from_numpy(lens).to(device))


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors both wrappers compute the plain versions (equal to
    the native engine), and their launch counters stay 0."""
    text, index, table, native = _index(1, 6000)
    reads = _reads(2, text, 12, 300)
    tab, rev, lens = _stage(table, reads, 512)
    kernels.reset_launch_counts()
    vals = kernels.pml_scan(index, tab, rev, lens).numpy()
    for i, want in enumerate(native.query_pml(reads)):
        assert np.array_equal(vals[i, :len(want)], want), i
        assert not vals[i, len(want):].any(), i
    found, above, below, summ = kernels.pml_classify(index, tab, rev, lens,
                                                     7, 150)
    for i, want in enumerate(native.query_pml(reads)):
        res = _host.binmax.classify(want, 150, 7)
        assert bool(found[i]) == (res.status == "FOUND"), i
        assert (int(above[i]), int(below[i]), int(summ[i])) == (
            res.bins_above, res.bins_below, int(res.bin_maxes.sum())), i
    assert kernels.pml_scan.launches == 0
    assert kernels.pml_classify.launches == 0


@pytest.mark.parametrize("wrapper", ["pml_scan", "pml_classify"])
def test_wrappers_raise_for_non_cpu_tensors(wrapper):
    """A tensor that is not on the CPU must launch the kernel or raise —
    the plain version never stands in for it."""
    text, index, table, _ = _index(3, 2000)
    tab, rev, lens = _stage(table, _reads(4, text, 4, 100), 128)
    index = index.to("meta")
    args = (index, tab.to("meta"), rev.to("meta"), lens.to("meta"))
    extra = (7, 150) if wrapper == "pml_classify" else ()
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(kernels, wrapper)(*args, *extra)
    assert getattr(kernels, wrapper).launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "device_mix",
                                 "contiguity", "table"])
def test_wrappers_check_their_inputs(bad):
    text, index, table, _ = _index(5, 2000)
    tab, rev, lens = _stage(table, _reads(6, text, 4, 100), 128)
    if bad == "dtype":
        rev = rev.to(torch.int32)
    elif bad == "shape":
        lens = lens[:-1]
    elif bad == "device_mix":
        index = index.to("meta")
    elif bad == "contiguity":
        rev = torch.zeros((rev.shape[1], rev.shape[0]), dtype=torch.uint8).T
    else:
        tab = tab[:, :4].contiguous()
    with pytest.raises(ValueError):
        kernels.pml_scan(index, tab, rev, lens)


def test_cuda_device_without_cuda_raises(tmp_path):
    """--device cuda on a machine without CUDA raises; it never computes
    on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from spumoni_tpu_torch import cli
    from spumoni_tpu_torch.pipeline import select_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_device("cuda")
    rng = np.random.default_rng(7)
    genome = rng.choice(ACGT, 3000).tobytes().decode()
    (tmp_path / "g.fa").write_text(f">g\n{genome}\n")
    (tmp_path / "r.fa").write_text(f">r\n{genome[100:400]}\n")
    cli.main(["build", "-r", str(tmp_path / "g.fa"), "-P", "-n",
              "-o", str(tmp_path / "i")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "-r", str(tmp_path / "i"), "-p",
                  str(tmp_path / "r.fa"), "-P", "-n"])
    assert not (tmp_path / "r.fa.pseudo_lengths").exists()


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the build raises (it is never skipped)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(kernels, "_TOOLKIT_NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(kernels, "_SOURCES", ("blockbits_pml.cuh",))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


# ---------------------------------------------------------------------------
# on the GPU: kernel == plain version, exactly
# ---------------------------------------------------------------------------

_LAYOUTS = [dict(P=64, pack=2, wide=False), dict(P=256, pack=2, wide=False),
            dict(P=512, pack=2, wide=True), dict(P=256, pack=4, wide=False),
            dict(P=512, pack=4, wide=True)]


@needs_cuda
@pytest.mark.parametrize("layout", _LAYOUTS,
                         ids=lambda d: "P{P}-pack{pack}-wide{wide}".format(**d))
def test_kernels_equal_plain_versions_on_gpu(layout):
    text, index, table, native = _index(8, 9000, **layout)
    reads = _reads(9, text, 40, 700)
    index = index.to("cuda")
    tab, rev, lens = _stage(table, reads, 1024, "cuda")
    kernels.reset_launch_counts()
    got = kernels.pml_scan(index, tab, rev, lens)
    torch.cuda.synchronize()
    want = kernels.pml_scan_reference(index, tab, rev, lens)
    assert torch.equal(got, want)
    vals = got.cpu().numpy()
    for i, w in enumerate(native.query_pml(reads)):
        assert np.array_equal(vals[i, :len(w)], w), i
    for a, b in zip(kernels.pml_classify(index, tab, rev, lens, 7, 150),
                    kernels.pml_classify_reference(index, tab, rev, lens,
                                                   7, 150)):
        assert torch.equal(a, b)
    assert kernels.pml_scan.launches == 1
    assert kernels.pml_classify.launches == 1


@needs_cuda
def test_kernels_on_repetitive_text_and_alphabet_on_gpu():
    for kw in (dict(repeat=True), dict(alphabet=np.frombuffer(b"ACGTWXY",
                                                              np.uint8))):
        text, index, table, native = _index(10, 8000, **kw)
        reads = _reads(11, text, 24, 500)
        index = index.to("cuda")
        tab, rev, lens = _stage(table, reads, 512, "cuda")
        vals = kernels.pml_scan(index, tab, rev, lens).cpu().numpy()
        for i, w in enumerate(native.query_pml(reads)):
            assert np.array_equal(vals[i, :len(w)], w), (kw, i)
