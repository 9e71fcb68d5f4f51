"""Build, binding and wrappers of the block-bits CUDA kernels, with their
plain PyTorch versions.

  * `pml_scan` (K1): PML lengths of every read, in forward order.
  * `pml_classify` (K2): the same scan with the bin-max classification
    folded in; per-read (found, above, below, sum_maxes).

The kernels live in `csrc/blockbits_pml.cu` behind a plain C interface.
They are compiled with nvcc for sm_90a on first use, into `_build/` next to
this package, keyed by a hash of the sources, and bound with ctypes.

A wrapper runs the plain version (`pml_scan_reference`,
`pml_classify_reference`) only for tensors on the CPU. For CUDA tensors it
launches its kernel, or raises: no failure falls back to the plain version.
Each wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .blockbits import BlockBitsIndex, pml_probe

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_SOURCES = ("blockbits_pml.cu", "blockbits_pml.cuh")
BUILD_DIR = os.path.join(_PKG, "_build")
_TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
#: nvcc's output of the build that produced the loaded library (ptxas -v:
#: registers, shared memory and spills per kernel); empty on a cache hit
build_log = ""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(_TOOLKIT_NVCC):
        nvcc = _TOOLKIT_NVCC
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def build() -> str:
    """Compiles the kernels (once per source hash); returns the .so path."""
    global build_log
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    so_path = os.path.join(BUILD_DIR, f"libblockbits_pml_{h.hexdigest()[:16]}"
                                      ".so")
    if os.path.exists(so_path):
        return so_path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           os.path.join(_CSRC, "blockbits_pml.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    build_log = res.stdout + res.stderr
    os.replace(tmp, so_path)
    return so_path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            head = [p, i64, i32, i32, i32, i64, i64, i64, i32, p, i32, p, p,
                    i64, i64]
            lib.spn_pml_scan.argtypes = head + [p, p]
            lib.spn_pml_scan.restype = i32
            lib.spn_pml_classify.argtypes = head + [i64, i32, p, p, p, p, p]
            lib.spn_pml_classify.restype = i32
            _lib = lib
    return _lib


def _check_inputs(index: BlockBitsIndex, tab: torch.Tensor,
                  reads_rev: torch.Tensor, lens: torch.Tensor):
    """Device, dtype, shape and contiguity checks shared by both wrappers;
    returns the device kind: 'cpu' or 'cuda'."""
    dev = reads_rev.device
    for name, t in (("bblocks", index.bblocks), ("tab", tab),
                    ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, reads on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if reads_rev.dtype != torch.uint8 or reads_rev.dim() != 2:
        raise ValueError("reads_rev must be a [B, L] uint8 tensor")
    if lens.dtype != torch.int64 or tuple(lens.shape) != (reads_rev.shape[0],):
        raise ValueError("lens must be a [B] int64 tensor")
    if tab.dtype != torch.int64 or tab.dim() != 2 or tab.shape[1] != 5 \
            or not 0 < tab.shape[0] <= 256:
        raise ValueError("tab must be an [sq <= 256, 5] int64 tensor")
    if not (reads_rev.is_contiguous() and lens.is_contiguous()
            and tab.is_contiguous() and index.bblocks.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    return dev.type


def _launch_head(index: BlockBitsIndex, tab, reads_rev, lens):
    m = index.meta
    B, L = reads_rev.shape
    return [index.bblocks.data_ptr(), index.bblocks.shape[0], m.P, m.pack,
            int(m.wide), m.n, m.term_pos, m.F_term, m.term_code,
            tab.data_ptr(), tab.shape[0], reads_rev.data_ptr(),
            lens.data_ptr(), B, L]


def _raise_on(rc: int, name: str, index: BlockBitsIndex):
    if rc == -1:
        raise ValueError(f"{name}: no kernel for P={index.meta.P}, "
                         f"pack={index.meta.pack}, wide={index.meta.wide}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def pml_scan(index: BlockBitsIndex, tab: torch.Tensor,
             reads_rev: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """K1. reads_rev: [B, L] uint8 query-rank codes, each read REVERSED and
    left-aligned; lens: [B] int64. Returns [B, L] int32 PML lengths in
    FORWARD order (columns >= lens[b] are 0)."""
    if _check_inputs(index, tab, reads_rev, lens) == "cpu":
        return pml_scan_reference(index, tab, reads_rev, lens)
    out = torch.zeros(reads_rev.shape, dtype=torch.int32,
                      device=reads_rev.device)
    if out.numel() == 0:
        return out
    rc = _library().spn_pml_scan(
        *_launch_head(index, tab, reads_rev, lens), out.data_ptr(),
        torch.cuda.current_stream(reads_rev.device).cuda_stream)
    _raise_on(rc, "pml_scan", index)
    pml_scan.launches += 1
    return out


pml_scan.launches = 0


def pml_classify(index: BlockBitsIndex, tab: torch.Tensor,
                 reads_rev: torch.Tensor, lens: torch.Tensor,
                 max_value_thr: int, bin_width: int):
    """K2. Same inputs as pml_scan; returns per-read (found [B] bool,
    above [B] int32, below [B] int32, sum_maxes [B] int64) of the bin-max
    classification (classify/binmax.py semantics)."""
    if bin_width <= 0:
        raise ValueError("bin_width must be positive")
    if _check_inputs(index, tab, reads_rev, lens) == "cpu":
        return pml_classify_reference(index, tab, reads_rev, lens,
                                      max_value_thr, bin_width)
    B = reads_rev.shape[0]
    dev = reads_rev.device
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    above = torch.zeros(B, dtype=torch.int32, device=dev)
    below = torch.zeros(B, dtype=torch.int32, device=dev)
    summ = torch.zeros(B, dtype=torch.int64, device=dev)
    if B == 0:
        return found, above, below, summ
    rc = _library().spn_pml_classify(
        *_launch_head(index, tab, reads_rev, lens), int(max_value_thr),
        int(bin_width), found.data_ptr(), above.data_ptr(), below.data_ptr(),
        summ.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "pml_classify", index)
    pml_classify.launches += 1
    return found, above, below, summ


pml_classify.launches = 0


def reset_launch_counts() -> None:
    pml_scan.launches = 0
    pml_classify.launches = 0


# ---------------------------------------------------------------------------
# plain versions: Python loops over the [B] step (any device)
# ---------------------------------------------------------------------------

def _scan_steps(index, tab, reads_rev, lens):
    """Yields (t, length) after each step t < max(lens); lanes past their
    own length keep stepping on padding, as the JAX scan does."""
    B = reads_rev.shape[0]
    dev = reads_rev.device
    pos = torch.full((B,), index.meta.n - 1, dtype=torch.int64, device=dev)
    length = torch.zeros(B, dtype=torch.int64, device=dev)
    steps = int(lens.clamp(0, reads_rev.shape[1]).max()) if B else 0
    for t in range(steps):
        pos, is_match = pml_probe(index, tab, pos, reads_rev[:, t])
        length = torch.where(is_match, length + 1, torch.zeros_like(length))
        yield t, length


def pml_scan_reference(index: BlockBitsIndex, tab: torch.Tensor,
                       reads_rev: torch.Tensor,
                       lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1 (query_batch_kernel_v4 + the flip)."""
    B, L = reads_rev.shape
    lens = lens.clamp(0, L)
    out = torch.zeros((B, L), dtype=torch.int32, device=reads_rev.device)
    lanes = torch.arange(B, device=reads_rev.device)
    for t, length in _scan_steps(index, tab, reads_rev, lens):
        act = t < lens
        out[lanes[act], (lens - 1 - t)[act]] = length[act].to(torch.int32)
    return out


def pml_classify_reference(index: BlockBitsIndex, tab: torch.Tensor,
                           reads_rev: torch.Tensor, lens: torch.Tensor,
                           max_value_thr: int, bin_width: int):
    """Plain PyTorch version of K2 (mesh.py::_fused_classify_core)."""
    B, L = reads_rev.shape
    dev = reads_rev.device
    lens = lens.clamp(0, L)
    nbins = torch.clamp(lens // bin_width, min=1)
    neg1 = torch.full((B,), -1, dtype=torch.int64, device=dev)
    prev_b, cur_max = neg1.clone(), neg1.clone()
    above = torch.zeros(B, dtype=torch.int64, device=dev)
    below = torch.zeros_like(above)
    summ = torch.zeros_like(above)
    for t, length in _scan_steps(index, tab, reads_rev, lens):
        fwd = lens - 1 - t
        active = fwd >= 0
        b = torch.minimum(fwd // bin_width, nbins - 1)
        closing = active & (prev_b >= 0) & (b != prev_b)
        above += (closing & (cur_max >= max_value_thr)).long()
        below += (closing & (cur_max < max_value_thr)).long()
        summ += torch.where(closing, cur_max, 0)
        cur_max = torch.where(closing, neg1, cur_max)
        cur_max = torch.where(active, torch.maximum(cur_max, length), cur_max)
        prev_b = torch.where(active, b, prev_b)
    has = lens > 0
    above += (has & (cur_max >= max_value_thr)).long()
    below += (has & (cur_max < max_value_thr)).long()
    summ += torch.where(has, cur_max, 0)
    found = (above > below) & has
    return found, above.to(torch.int32), below.to(torch.int32), summ
