"""Build, binding and wrappers of the port's CUDA kernels, with their
plain PyTorch versions.

  * `pml_scan` (K1): PML lengths of every read, in forward order.
  * `pml_classify` (K2): the same scan with the bin-max classification
    folded in; per-read (found, above, below, sum_maxes).
  * `ms_scan` (K3): the v4-MS / doc scan: MS pointers, PML+doc lengths and
    doc ids, reconstructed from the jump tables in forward order.
  * `ms_extend` (K4): MS lengths from MS pointers by comparison with the
    text (the two-pointer sequential carry).
  * `binmax_values` (K5): bin-max classification of a [B, L] value matrix.
  * `gather_chase` (K6): the dependent gather chase of the
    `scripts/exp_vmem_gather.py` microbenchmark.
  * `layered_scan` (K7): the layered-engine scan (PML, PML+doc, MS,
    MS+doc) over raw bytes, in forward order.
  * `layered_classify` (K8): K7's PML scan with the bin-max classification
    folded in, as K2 does for block-bits.
  * `occ_scan` (K9): the occ-block scan (PML, PML+doc, MS, MS+doc) over
    query-rank codes, in forward order, one-step lag resolved.
  * `occ_classify` (K10): K9's PML scan with the bin-max classification
    folded in.

K1/K2 live in `csrc/blockbits_pml.cu`, K3-K5 in `csrc/blockbits_ms.cu`,
K6 in `csrc/gather_chase.cu`, K7/K8 in `csrc/layered.cu` and K9/K10 in
`csrc/occblock.cu`, each behind a plain C interface (the bin-max carry of
K2, K8 and K10 in `csrc/binmax.cuh`).
K4 takes a text and its bound, so both engines share it. Each
source is compiled with nvcc for sm_90a on first use, all at once, into
`_build/` next to this package, keyed by a hash of the sources, and bound
with ctypes.

A wrapper runs the plain version (`*_reference`) only for tensors on the
CPU. For CUDA tensors it launches its kernel, or raises: no failure falls
back to the plain version. Each wrapper counts its launches in
`.launches` (`launch_counts()` reads them all, `reset_launch_counts()` sets
them to 0).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .blockbits import BlockBitsIndex, ms_probe, pml_probe
from .layered import LayeredIndex, initial_state, layered_step
from .occblock import OccIndex, occ_initial_state, occ_step

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
#: every file the libraries are built from: a change to any rebuilds all
_SOURCES = ("binmax.cuh", "blockbits_pml.cu", "blockbits_pml.cuh",
            "blockbits_ms.cu", "gather_chase.cu", "layered.cu",
            "occblock.cu")
#: library name -> its translation unit
LIBRARIES = {"blockbits_pml": "blockbits_pml.cu",
             "blockbits_ms": "blockbits_ms.cu",
             "gather_chase": "gather_chase.cu",
             "layered": "layered.cu",
             "occblock": "occblock.cu"}
BUILD_DIR = os.path.join(_PKG, "_build")
_TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
#: nvcc's output of the builds that produced the loaded libraries (ptxas
#: -v: registers, shared memory and spills per kernel); empty on a cache hit
build_log = ""


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(_TOOLKIT_NVCC):
        nvcc = _TOOLKIT_NVCC
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def build() -> dict:
    """Compiles every library (once per source hash), one nvcc process
    per source, all started together; returns {name: .so path}."""
    global build_log
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    paths = {name: os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}"
                                           ".so")
             for name in LIBRARIES}
    todo = [name for name, path in paths.items() if not os.path.exists(path)]
    if not todo:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = f"{paths[name]}.tmp{os.getpid()}"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp,
             os.path.join(_CSRC, LIBRARIES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"--- {LIBRARIES[name]}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{LIBRARIES[name]} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[name])
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return paths


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: library -> {entry point: argtypes}; every entry point returns an int
_SIGNATURES = {
    "blockbits_pml": {
        "spn_pml_scan": [_P, _I64, _I32, _I32, _I32, _I64, _I64, _I64, _I32,
                         _P, _I32, _P, _P, _I64, _I64, _P, _P],
        "spn_pml_classify": [_P, _I64, _I32, _I32, _I32, _I64, _I64, _I64,
                             _I32, _P, _I32, _P, _P, _I64, _I64, _I64, _I32,
                             _P, _P, _P, _P, _P]},
    "blockbits_ms": {
        "spn_ms_scan": [_P, _P, _I64, _I32, _I32, _I32, _I64, _I64, _I64,
                        _I32, _I64, _I64, _P, _I32, _P, _P, _I64, _I64, _P,
                        _P, _I32, _P, _P, _P],
        "spn_ms_extend": [_P, _I64, _I64, _P, _P, _P, _I64, _I64, _I32, _P,
                          _P],
        "spn_binmax_values": [_P, _P, _I64, _I64, _I32, _I64, _I32, _P, _P,
                              _P, _P, _P]},
    "gather_chase": {
        "spn_gather_chase": [_P, _P, _I32, _I32, _I32, _P, _P]},
    "layered": {
        "spn_layered_scan": [_P, _P, _I32, _P, _I64, _I64, _I32, _I32, _I64,
                             _I64, _I64, _I64, _P, _P, _I64, _I64, _I32, _P,
                             _P, _P],
        "spn_layered_classify": [_P, _P, _I32, _P, _I64, _I64, _I32, _I32,
                                 _I64, _P, _P, _I64, _I64, _I64, _I32, _P, _P,
                                 _P, _P, _P]},
    "occblock": {
        "spn_occ_scan": [_P, _I64, _I32, _I32, _I32, _I32, _I32, _I32,
                         _I32, _I32, _I32, _P, _I32, _P, _P, _I64, _I64,
                         _I32, _P, _P, _P],
        "spn_occ_classify": [_P, _I64, _I32, _I32, _I32, _I32, _P, _I32,
                             _P, _P, _I64, _I64, _I64, _I32, _P, _P, _P, _P,
                             _P]},
}


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name` of LIBRARIES (built on first use)."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build()[name])
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I32
            _libs[name] = lib
    return _libs[name]


def _check_inputs(rows: torch.Tensor, tab: torch.Tensor,
                  reads_rev: torch.Tensor, lens: torch.Tensor):
    """Device, dtype, shape and contiguity checks of the wrappers that take
    rank-mapped rows and a CharTable table; `rows` is the index's row
    tensor (a BlockBitsIndex's bblocks, an OccIndex's blocks). Returns the
    device kind: 'cpu' or 'cuda'."""
    dev = reads_rev.device
    for name, t in (("index rows", rows), ("tab", tab), ("lens", lens)):
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
            and tab.is_contiguous() and rows.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    return dev.type


def _launch_head(index: BlockBitsIndex, tab, reads_rev, lens):
    m = index.meta
    B, L = reads_rev.shape
    return [index.bblocks.data_ptr(), index.bblocks.shape[0], m.P, m.pack,
            int(m.wide), m.n, m.term_pos, m.F_term, m.term_code,
            tab.data_ptr(), tab.shape[0], reads_rev.data_ptr(),
            lens.data_ptr(), B, L]


def _raise_on(rc: int, name: str, index: BlockBitsIndex = None):
    """Raises for a nonzero entry-point return: -1 is a layout or argument
    the source does not instantiate, anything else a CUDA error."""
    if rc == -1:
        what = ("these arguments" if index is None else
                f"P={index.meta.P}, pack={index.meta.pack}, "
                f"wide={index.meta.wide}")
        raise ValueError(f"{name}: no kernel for {what}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def pml_scan(index: BlockBitsIndex, tab: torch.Tensor,
             reads_rev: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """K1. reads_rev: [B, L] uint8 query-rank codes, each read REVERSED and
    left-aligned; lens: [B] int64. Returns [B, L] int32 PML lengths in
    FORWARD order (columns >= lens[b] are 0)."""
    if _check_inputs(index.bblocks, tab, reads_rev, lens) == "cpu":
        return pml_scan_reference(index, tab, reads_rev, lens)
    out = torch.zeros(reads_rev.shape, dtype=torch.int32,
                      device=reads_rev.device)
    if out.numel() == 0:
        return out
    rc = library("blockbits_pml").spn_pml_scan(
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
    if _check_inputs(index.bblocks, tab, reads_rev, lens) == "cpu":
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
    rc = library("blockbits_pml").spn_pml_classify(
        *_launch_head(index, tab, reads_rev, lens), int(max_value_thr),
        int(bin_width), found.data_ptr(), above.data_ptr(), below.data_ptr(),
        summ.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "pml_classify", index)
    pml_classify.launches += 1
    return found, above, below, summ


pml_classify.launches = 0


_MS_MODES = {("ms", False): 0, ("ms", True): 1, ("pml", True): 2}


def ms_scan(index: BlockBitsIndex, tab: torch.Tensor,
            reads_rev: torch.Tensor, lens: torch.Tensor, mode: str,
            use_doc: bool):
    """K3. Same read inputs as pml_scan; mode 'ms' (with or without doc
    ids) or 'pml' with use_doc. Returns (vals, docs): [B, L] tensors of
    index.meta.pos_dtype in FORWARD order (columns >= lens[b] are 0):
    MS pointers jump_t[jidx] - d, or PML lengths; docs = jump_d[jidx], or
    None without use_doc."""
    kind = _check_inputs(index.bblocks, tab, reads_rev, lens)
    code = _MS_MODES.get((mode, bool(use_doc)))
    if code is None:
        raise ValueError(f"ms_scan: mode={mode!r}, use_doc={use_doc} (plain "
                         f"PML is pml_scan)")
    need = ["msrows"] + (["jump_t"] if mode == "ms" else []) + (
        ["jump_d"] if use_doc else [])
    for name in need:
        t = getattr(index, name)
        if t is None:
            raise ValueError(f"ms_scan: the index has no {name} (build with "
                             f"want_ms / want_doc)")
        if t.device != reads_rev.device:
            raise ValueError(f"{name} is on {t.device}, reads on "
                             f"{reads_rev.device}")
    if kind == "cpu":
        return ms_scan_reference(index, tab, reads_rev, lens, mode, use_doc)
    dev = reads_rev.device
    vals = torch.zeros(reads_rev.shape, dtype=index.meta.pos_dtype,
                       device=dev)
    docs = torch.zeros_like(vals) if use_doc else None
    if vals.numel() == 0:
        return vals, docs
    m = index.meta
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    rc = library("blockbits_ms").spn_ms_scan(
        index.bblocks.data_ptr(), index.msrows.data_ptr(),
        index.bblocks.shape[0], m.P, m.pack, int(m.wide), m.n, m.term_pos,
        m.F_term, m.term_code, m.r, m.term_runidx, tab.data_ptr(),
        tab.shape[0], reads_rev.data_ptr(), lens.data_ptr(),
        reads_rev.shape[0], reads_rev.shape[1], ptr(index.jump_t),
        ptr(index.jump_d), code, vals.data_ptr(), ptr(docs),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ms_scan", index)
    ms_scan.launches += 1
    return vals, docs


ms_scan.launches = 0


def _check_matrix_inputs(name, mats, lens):
    """[B, L] matrices and [B] int64 lens on one device, contiguous;
    returns the device kind."""
    dev = lens.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if lens.dtype != torch.int64 or lens.dim() != 1:
        raise ValueError(f"{name}: lens must be a [B] int64 tensor")
    for label, t, dtypes in mats:
        if t.device != dev:
            raise ValueError(f"{label} is on {t.device}, lens on {dev}")
        if t.dtype not in dtypes or t.dim() != 2 \
                or t.shape[0] != lens.shape[0]:
            raise ValueError(f"{name}: {label} must be a [B, L] tensor of "
                             f"{dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if not lens.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous")
    return dev.type


def ms_extend(text: torch.Tensor, text_bound: int, reads_fwd: torch.Tensor,
              lens: torch.Tensor, ptrs: torch.Tensor) -> torch.Tensor:
    """K4. text: [ntext] uint8, read as 0 past its end up to text_bound
    (the index's `text_bound`); reads_fwd: [B, L] uint8 raw read bytes in
    natural order; ptrs: [B, L] forward MS pointers (int32 / int64, from
    ms_scan or layered_scan). Returns the [B, L] MS lengths in the pointer
    dtype (columns >= lens[b] are 0)."""
    if text is None:
        raise ValueError("ms_extend: the index has no text (build -M)")
    kind = _check_matrix_inputs("ms_extend", (
        ("reads_fwd", reads_fwd, (torch.uint8,)),
        ("ptrs", ptrs, (torch.int32, torch.int64))), lens)
    if reads_fwd.shape != ptrs.shape:
        raise ValueError("ms_extend: reads_fwd and ptrs differ in shape")
    if text.device != lens.device:
        raise ValueError(f"text is on {text.device}, lens on {lens.device}")
    if text.dtype != torch.uint8 or text.dim() != 1 \
            or not text.is_contiguous():
        raise ValueError("ms_extend: text must be a contiguous 1-D uint8 "
                         "tensor")
    if kind == "cpu":
        return ms_extend_reference(text, text_bound, reads_fwd, lens, ptrs)
    out = torch.zeros_like(ptrs)
    if out.numel() == 0:
        return out
    dev = lens.device
    rc = library("blockbits_ms").spn_ms_extend(
        text.data_ptr(), text.shape[0], int(text_bound),
        reads_fwd.data_ptr(), lens.data_ptr(), ptrs.data_ptr(),
        ptrs.shape[0], ptrs.shape[1], int(ptrs.dtype == torch.int64),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ms_extend")
    ms_extend.launches += 1
    return out


ms_extend.launches = 0


def binmax_values(vals: torch.Tensor, lens: torch.Tensor, max_value_thr: int,
                  bin_width: int):
    """K5. Bin-max classification of a natural-order [B, L] int32 / int64
    value matrix (scan_engine.py::binmax_values_kernel): returns per-read
    (found [B] bool, above [B] int32, below [B] int32, sum_maxes [B]
    int64)."""
    if bin_width <= 0:
        raise ValueError("bin_width must be positive")
    kind = _check_matrix_inputs("binmax_values", (
        ("vals", vals, (torch.int32, torch.int64)),), lens)
    if kind == "cpu":
        return binmax_values_reference(vals, lens, max_value_thr, bin_width)
    B = vals.shape[0]
    dev = vals.device
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    above = torch.zeros(B, dtype=torch.int32, device=dev)
    below = torch.zeros(B, dtype=torch.int32, device=dev)
    summ = torch.zeros(B, dtype=torch.int64, device=dev)
    if B == 0:
        return found, above, below, summ
    rc = library("blockbits_ms").spn_binmax_values(
        vals.data_ptr(), lens.data_ptr(), B, vals.shape[1],
        int(vals.dtype == torch.int64), int(max_value_thr), int(bin_width),
        found.data_ptr(), above.data_ptr(), below.data_ptr(),
        summ.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "binmax_values")
    binmax_values.launches += 1
    return found, above, below, summ


binmax_values.launches = 0


def _check_chase(table: torch.Tensor, idx0: torch.Tensor) -> str:
    if table.dim() != 2 or table.dtype not in (torch.int32, torch.uint32):
        raise ValueError("table must be an [R, W] int32 / uint32 tensor")
    if idx0.dtype != torch.int32 or tuple(idx0.shape) != tuple(table.shape):
        raise ValueError("idx0 must be an int32 tensor of the table's shape")
    if idx0.device != table.device:
        raise ValueError(f"idx0 is on {idx0.device}, table on "
                         f"{table.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if not (table.is_contiguous() and idx0.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    rows = table.shape[0]
    if idx0.numel() and not (-rows <= int(idx0.min())
                             and int(idx0.max()) < rows):
        raise ValueError(f"idx0 must lie in [-R, R) = [{-rows}, {rows})")
    return table.device.type


def gather_chase(table: torch.Tensor, idx0: torch.Tensor,
                 steps: int = 64) -> torch.Tensor:
    """K6. table: [R, W] u32 (int32 or uint32 storage); idx0: [R, W] int32
    in [-R, R) (checked: the kernel reads row idx or idx + R). Returns the
    [R, W] int32 indices after `steps` steps of
    idx = rem(abs(int32(table[idx, j]) ^ idx), R)."""
    if _check_chase(table, idx0) == "cpu":
        return gather_chase_reference(table, idx0, steps)
    out = torch.empty_like(idx0)
    rc = library("gather_chase").spn_gather_chase(
        table.data_ptr(), idx0.data_ptr(), table.shape[0], table.shape[1],
        int(steps), out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(rc, "gather_chase")
    gather_chase.launches += 1
    return out


gather_chase.launches = 0

#: the Mode enum of layered.cu and occblock.cu
_SCAN_MODES = {("pml", False): 0, ("pml", True): 1, ("ms", False): 2,
               ("ms", True): 3}


def _scan_mode(name: str, meta, mode: str, use_doc: bool) -> int:
    """The mode code of K7 / K9, after checking that the index (its meta's
    has_samples / has_doc) holds what the mode reads."""
    code = _SCAN_MODES.get((mode, bool(use_doc)))
    if code is None:
        raise ValueError(f"{name}: mode must be 'pml' or 'ms', not {mode!r}")
    if mode == "ms" and not meta.has_samples:
        raise ValueError(f"{name}: MS needs an index with SA samples")
    if use_doc and not meta.has_doc:
        raise ValueError(f"{name}: doc tracking needs an index with doc ids")
    return code


def _check_layered(index: LayeredIndex, reads_rev: torch.Tensor,
                   lens: torch.Tensor) -> str:
    """Device, dtype, shape and contiguity checks of K7 / K8; returns the
    device kind."""
    dev = reads_rev.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("charmeta", index.charmeta), ("fields", index.fields),
                    ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, reads on {dev}")
    if reads_rev.dtype != torch.uint8 or reads_rev.dim() != 2:
        raise ValueError("reads_rev must be a [B, L] uint8 tensor")
    if lens.dtype != torch.int64 or tuple(lens.shape) != (reads_rev.shape[0],):
        raise ValueError("lens must be a [B] int64 tensor")
    if not all(t.is_contiguous() for t in (reads_rev, lens, index.charmeta,
                                           index.fields, *index.levels)):
        raise ValueError("inputs must be contiguous")
    return dev.type


def _layered_head(index: LayeredIndex):
    """[charmeta, levels, D, fields, rows, probe bound, W, wide, n]: the index
    arguments of both entry points. `levels` is a host int64 array, the D
    level pointers then their row counts, which the entry point copies
    into the kernel's parameters."""
    m = index.meta
    levels = (ctypes.c_longlong * (2 * m.depth))(
        *(lv.data_ptr() for lv in index.levels),
        *(lv.shape[0] for lv in index.levels))
    return [index.charmeta.data_ptr(), levels, m.depth,
            index.fields.data_ptr(), index.fields.shape[0], m.probe_bound,
            m.width, int(m.wide), m.n]


def layered_scan(index: LayeredIndex, reads_rev: torch.Tensor,
                 lens: torch.Tensor, mode: str = "pml",
                 use_doc: bool = False):
    """K7. reads_rev: [B, L] uint8 raw read bytes, each read REVERSED and
    left-aligned; lens: [B] int64. Returns (vals, docs): [B, L] tensors of
    index.meta.pos_dtype in FORWARD order (columns >= lens[b] are 0): PML
    lengths, or MS pointers (signed, never clamped); docs the doc ids, or
    None without use_doc."""
    kind = _check_layered(index, reads_rev, lens)
    code = _scan_mode("layered_scan", index.meta, mode, use_doc)
    m = index.meta
    if kind == "cpu":
        return layered_scan_reference(index, reads_rev, lens, mode, use_doc)
    dev = reads_rev.device
    vals = torch.zeros(reads_rev.shape, dtype=m.pos_dtype, device=dev)
    docs = torch.zeros_like(vals) if use_doc else None
    if vals.numel() == 0:
        return vals, docs
    rc = library("layered").spn_layered_scan(
        *_layered_head(index), m.last_run_sample, m.last_run_edoc,
        m.first_run_sdoc, reads_rev.data_ptr(), lens.data_ptr(),
        reads_rev.shape[0], reads_rev.shape[1], code, vals.data_ptr(),
        0 if docs is None else docs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "layered_scan")
    layered_scan.launches += 1
    return vals, docs


layered_scan.launches = 0


def layered_classify(index: LayeredIndex, reads_rev: torch.Tensor,
                     lens: torch.Tensor, max_value_thr: int,
                     bin_width: int):
    """K8. Same inputs as layered_scan; returns per-read (found [B] bool,
    above [B] int32, below [B] int32, sum_maxes [B] int64) of the bin-max
    classification of the PML lengths (classify/binmax.py semantics)."""
    if bin_width <= 0:
        raise ValueError("bin_width must be positive")
    if _check_layered(index, reads_rev, lens) == "cpu":
        return layered_classify_reference(index, reads_rev, lens,
                                          max_value_thr, bin_width)
    B = reads_rev.shape[0]
    dev = reads_rev.device
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    above = torch.zeros(B, dtype=torch.int32, device=dev)
    below = torch.zeros(B, dtype=torch.int32, device=dev)
    summ = torch.zeros(B, dtype=torch.int64, device=dev)
    if B == 0:
        return found, above, below, summ
    rc = library("layered").spn_layered_classify(
        *_layered_head(index), reads_rev.data_ptr(), lens.data_ptr(), B,
        reads_rev.shape[1], int(max_value_thr), int(bin_width),
        found.data_ptr(),
        above.data_ptr(), below.data_ptr(), summ.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "layered_classify")
    layered_classify.launches += 1
    return found, above, below, summ


layered_classify.launches = 0


def _occ_head(index: OccIndex):
    """[blocks, nb, P, W, T0]: the index arguments of both entry points."""
    m = index.meta
    return [index.blocks.data_ptr(), m.nb, m.P, m.width, m.T0]


def occ_scan(index: OccIndex, tab: torch.Tensor, reads_rev: torch.Tensor,
             lens: torch.Tensor, mode: str = "pml", use_doc: bool = False):
    """K9. reads_rev: [B, L] uint8 query-rank codes (tab's alphabet), each
    read REVERSED and left-aligned; lens: [B] int64. Returns (vals, docs):
    [B, L] int32 in FORWARD order (columns >= lens[b] are 0): PML lengths,
    or MS pointers (signed, never clamped); docs the doc ids, or None
    without use_doc. The one-step lag of MS samples and doc ids is
    resolved: column j holds the value of read position j."""
    kind = _check_inputs(index.blocks, tab, reads_rev, lens)
    code = _scan_mode("occ_scan", index.meta, mode, use_doc)
    m = index.meta
    if kind == "cpu":
        return occ_scan_reference(index, tab, reads_rev, lens, mode, use_doc)
    dev = reads_rev.device
    vals = torch.zeros(reads_rev.shape, dtype=torch.int32, device=dev)
    docs = torch.zeros_like(vals) if use_doc else None
    if vals.numel() == 0:
        return vals, docs
    rc = library("occblock").spn_occ_scan(
        *_occ_head(index), m.S0, m.D0, m.n,
        m.last_run_sample, m.last_run_edoc, m.first_run_sdoc,
        tab.data_ptr(), tab.shape[0], reads_rev.data_ptr(), lens.data_ptr(),
        reads_rev.shape[0], reads_rev.shape[1], code, vals.data_ptr(),
        0 if docs is None else docs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "occ_scan")
    occ_scan.launches += 1
    return vals, docs


occ_scan.launches = 0


def occ_classify(index: OccIndex, tab: torch.Tensor, reads_rev: torch.Tensor,
                 lens: torch.Tensor, max_value_thr: int, bin_width: int):
    """K10. Same inputs as occ_scan; returns per-read (found [B] bool,
    above [B] int32, below [B] int32, sum_maxes [B] int64) of the bin-max
    classification of the PML lengths (classify/binmax.py semantics)."""
    if bin_width <= 0:
        raise ValueError("bin_width must be positive")
    if _check_inputs(index.blocks, tab, reads_rev, lens) == "cpu":
        return occ_classify_reference(index, tab, reads_rev, lens,
                                      max_value_thr, bin_width)
    B = reads_rev.shape[0]
    dev = reads_rev.device
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    above = torch.zeros(B, dtype=torch.int32, device=dev)
    below = torch.zeros(B, dtype=torch.int32, device=dev)
    summ = torch.zeros(B, dtype=torch.int64, device=dev)
    if B == 0:
        return found, above, below, summ
    rc = library("occblock").spn_occ_classify(
        *_occ_head(index), index.meta.n,
        tab.data_ptr(), tab.shape[0], reads_rev.data_ptr(), lens.data_ptr(),
        B, reads_rev.shape[1], int(max_value_thr), int(bin_width),
        found.data_ptr(), above.data_ptr(), below.data_ptr(),
        summ.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "occ_classify")
    occ_classify.launches += 1
    return found, above, below, summ


occ_classify.launches = 0

_WRAPPERS = (pml_scan, pml_classify, ms_scan, ms_extend, binmax_values,
             gather_chase, layered_scan, layered_classify, occ_scan,
             occ_classify)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


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
    lens = lens.clamp(0, reads_rev.shape[1])
    return _binmax_fold(_scan_steps(index, tab, reads_rev, lens), lens,
                        max_value_thr, bin_width)


def _binmax_fold(steps, lens: torch.Tensor, max_value_thr: int,
                 bin_width: int):
    """The bin-max carry of K2 / K8 over a right-to-left scan's (t, value)
    steps: a bin closes when the forward position len-1-t crosses into
    another bin; nbins = max(len // bin_width, 1), the short tail merged
    into the last bin. Returns (found, above, below, sum_maxes)."""
    B = lens.shape[0]
    dev = lens.device
    nbins = torch.clamp(lens // bin_width, min=1)
    neg1 = torch.full((B,), -1, dtype=torch.int64, device=dev)
    prev_b, cur_max = neg1.clone(), neg1.clone()
    above = torch.zeros(B, dtype=torch.int64, device=dev)
    below = torch.zeros_like(above)
    summ = torch.zeros_like(above)
    for t, value in steps:
        fwd = lens - 1 - t
        active = fwd >= 0
        b = torch.minimum(fwd // bin_width, nbins - 1)
        closing = active & (prev_b >= 0) & (b != prev_b)
        above += (closing & (cur_max >= max_value_thr)).long()
        below += (closing & (cur_max < max_value_thr)).long()
        summ += torch.where(closing, cur_max, 0)
        cur_max = torch.where(closing, neg1, cur_max)
        cur_max = torch.where(active, torch.maximum(cur_max, value), cur_max)
        prev_b = torch.where(active, b, prev_b)
    has = lens > 0
    above += (has & (cur_max >= max_value_thr)).long()
    below += (has & (cur_max < max_value_thr)).long()
    summ += torch.where(has, cur_max, 0)
    found = (above > below) & has
    return found, above.to(torch.int32), below.to(torch.int32), summ


def ms_scan_reference(index: BlockBitsIndex, tab: torch.Tensor,
                      reads_rev: torch.Tensor, lens: torch.Tensor, mode: str,
                      use_doc: bool):
    """Plain PyTorch version of K3 (query_batch_kernel_v4ms with
    ms_initial_state and the jump-table reconstruction, in forward
    order)."""
    m = index.meta
    B, L = reads_rev.shape
    dev = reads_rev.device
    lens = lens.clamp(0, L)
    vals = torch.zeros((B, L), dtype=m.pos_dtype, device=dev)
    docs = torch.zeros_like(vals) if use_doc else None
    lanes = torch.arange(B, device=dev)
    pos = torch.full((B,), m.n - 1, dtype=torch.int64, device=dev)
    jidx = torch.full((B,), 2 * m.r + 1, dtype=torch.int64, device=dev)
    run = torch.zeros(B, dtype=torch.int64, device=dev)   # d, or length
    steps = int(lens.max()) if B else 0
    for t in range(steps):
        pos, is_match, empty, jjump = ms_probe(index, tab, pos,
                                               reads_rev[:, t])
        if mode == "ms":
            # an absent character resets to EMPTY: jump_t 0, first_run_sdoc
            jidx = torch.where(is_match, jidx,
                               torch.where(empty, 2 * m.r, jjump))
            run = torch.where(is_match, run + 1, 0)
            val = index.jump_t[jidx].long() - run
        else:
            # PML + doc: an absent character keeps the doc
            jidx = torch.where(is_match | empty, jidx, jjump)
            run = torch.where(is_match, run + 1, 0)
            val = run
        act = t < lens
        col = (lens - 1 - t)[act]
        vals[lanes[act], col] = val[act].to(m.pos_dtype)
        if use_doc:
            docs[lanes[act], col] = index.jump_d[jidx][act].to(m.pos_dtype)
    return vals, docs


def ms_extend_reference(text: torch.Tensor, text_bound: int,
                        reads_fwd: torch.Tensor, lens: torch.Tensor,
                        ptrs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: extend_pointers_kernel's two-pointer
    loop (scan_engine.py:1041-1101). Each iteration either extends a lane's
    match by one character or emits its length at i and moves to i + 1,
    keeping max(l - 1, 0) characters (MS are 1-Lipschitz), so a lane takes
    at most 3 L iterations. A position mismatches when its pointer is
    negative (the reference's unsigned underflow) or the text position is
    past text_bound, where text past its end reads as 0."""
    B, L = reads_fwd.shape
    dev = reads_fwd.device
    ntext, nt = int(text.shape[0]), int(text_bound)
    out = torch.zeros_like(ptrs)
    lanes = torch.arange(B, device=dev)
    i = torch.zeros(B, dtype=torch.int64, device=dev)
    l = torch.zeros_like(i)
    while True:
        active = i < lens
        if not bool(active.any()):
            return out
        rch = reads_fwd.gather(1, (i + l).clamp(0, L - 1)[:, None])[:, 0]
        ptr = ptrs.gather(1, i.clamp(0, L - 1)[:, None])[:, 0].long()
        tpos = ptr + l
        in_text = (tpos >= 0) & (tpos < ntext)
        tch = torch.where(in_text, text[tpos.clamp(0, max(ntext - 1, 0))],
                          torch.zeros_like(rch))
        ok = (active & (i + l < lens) & (ptr >= 0) & (tpos >= 0)
              & (tpos < nt) & (rch == tch))
        emit = active & ~ok
        out[lanes[emit], i[emit]] = l[emit].to(out.dtype)
        l = torch.where(active, torch.where(ok, l + 1,
                                            (l - 1).clamp(min=0)), l)
        i = torch.where(emit, i + 1, i)


def _layered_steps(index: LayeredIndex, reads_rev: torch.Tensor,
                   lens: torch.Tensor, mode: str, use_doc: bool):
    """Yields (t, value, doc) after each step t < max(lens) of
    layered_step from the recurrence seed; lanes past their own length keep
    stepping on padding, as the JAX scan does."""
    B = reads_rev.shape[0]
    carry = initial_state(index, B, reads_rev.device)
    steps = int(lens.max()) if B else 0
    for t in range(steps):
        carry = layered_step(index, carry, reads_rev[:, t], mode, use_doc)
        yield t, carry[2] if mode == "ms" else carry[1], carry[3]


def layered_scan_reference(index: LayeredIndex, reads_rev: torch.Tensor,
                           lens: torch.Tensor, mode: str, use_doc: bool):
    """Plain PyTorch version of K7 (query_batch_kernel_v2 + the flip to
    forward order)."""
    B, L = reads_rev.shape
    dev = reads_rev.device
    dt = index.meta.pos_dtype
    lens = lens.clamp(0, L)
    vals = torch.zeros((B, L), dtype=dt, device=dev)
    docs = torch.zeros_like(vals) if use_doc else None
    lanes = torch.arange(B, device=dev)
    for t, val, doc in _layered_steps(index, reads_rev, lens, mode, use_doc):
        act = t < lens
        col = (lens - 1 - t)[act]
        vals[lanes[act], col] = val[act].to(dt)
        if use_doc:
            docs[lanes[act], col] = doc[act].to(dt)
    return vals, docs


def layered_classify_reference(index: LayeredIndex, reads_rev: torch.Tensor,
                               lens: torch.Tensor, max_value_thr: int,
                               bin_width: int):
    """Plain PyTorch version of K8 (mesh.py::_fused_classify_core with the
    layered step)."""
    lens = lens.clamp(0, reads_rev.shape[1])
    steps = ((t, val) for t, val, _ in _layered_steps(index, reads_rev, lens,
                                                      "pml", False))
    return _binmax_fold(steps, lens, max_value_thr, bin_width)


def _occ_steps(index: OccIndex, tab: torch.Tensor, reads_rev: torch.Tensor,
               lens: torch.Tensor, mode: str, use_doc: bool, extra: int):
    """Yields (t, value, doc) after each step t < max(lens) + extra of
    occ_step from the seed; a step past the [B, L] rows reads rank 0 (the
    JAX sentinel column), and lanes past their own length keep stepping on
    padding, as the JAX scan does."""
    B, L = reads_rev.shape
    carry = occ_initial_state(index, B, reads_rev.device)
    pad = torch.zeros(B, dtype=reads_rev.dtype, device=reads_rev.device)
    steps = int(lens.max()) if B else 0
    for t in range(steps + extra):
        qc = reads_rev[:, t] if t < L else pad
        carry, (val, doc) = occ_step(index, tab, carry, qc, mode, use_doc)
        yield t, val, doc


def occ_scan_reference(index: OccIndex, tab: torch.Tensor,
                       reads_rev: torch.Tensor, lens: torch.Tensor, mode: str,
                       use_doc: bool):
    """Plain PyTorch version of K9 (query_batch_kernel_v3 with its
    sentinel step and realignment, then the flip to forward order): an MS
    sample or doc id emitted at step t belongs to read position t - 1."""
    B, L = reads_rev.shape
    dev = reads_rev.device
    lens = lens.clamp(0, L)
    vals = torch.zeros((B, L), dtype=torch.int32, device=dev)
    docs = torch.zeros_like(vals) if use_doc else None
    lanes = torch.arange(B, device=dev)
    lag_v = int(mode == "ms")
    extra = int(mode == "ms" or use_doc)

    def put(out, i, x):
        act = (i >= 0) & (i < lens)
        out[lanes[act], (lens - 1 - i)[act]] = x[act].to(torch.int32)

    for t, val, doc in _occ_steps(index, tab, reads_rev, lens, mode, use_doc,
                                  extra):
        put(vals, t - lag_v, val)
        if use_doc:
            put(docs, t - 1, doc)
    return vals, docs


def occ_classify_reference(index: OccIndex, tab: torch.Tensor,
                           reads_rev: torch.Tensor, lens: torch.Tensor,
                           max_value_thr: int, bin_width: int):
    """Plain PyTorch version of K10 (mesh.py::_fused_classify_core with
    the occ step; PML lengths do not lag)."""
    lens = lens.clamp(0, reads_rev.shape[1])
    steps = ((t, val) for t, val, _ in _occ_steps(index, tab, reads_rev, lens,
                                                  "pml", False, 0))
    return _binmax_fold(steps, lens, max_value_thr, bin_width)


def binmax_values_reference(vals: torch.Tensor, lens: torch.Tensor,
                            max_value_thr: int, bin_width: int):
    """Plain PyTorch version of K5 (binmax_values_kernel): the value max of
    each bin of bin_width positions, the short tail merged into the last
    bin; nbins = max(len // bin_width, 1); below = nbins - above."""
    B, L = vals.shape
    dev = vals.device
    p = torch.arange(L, device=dev)
    nbins = torch.clamp(lens // bin_width, min=1)
    binid = torch.minimum(p[None, :] // bin_width, nbins[:, None] - 1)
    valid = p[None, :] < lens[:, None]
    above = torch.zeros(B, dtype=torch.int64, device=dev)
    summ = torch.zeros(B, dtype=torch.int64, device=dev)
    for j in range(max(1, -(-L // bin_width))):
        mx = torch.where(valid & (binid == j), vals.long(),
                         torch.full_like(vals, -1, dtype=torch.int64)
                         ).max(dim=1).values
        has = mx >= 0
        above += (has & (mx >= max_value_thr)).long()
        summ += torch.where(has, mx, 0)
    below = nbins - above
    found = (above > below) & (lens > 0)
    return found, above.to(torch.int32), below.to(torch.int32), summ


def gather_chase_reference(table: torch.Tensor, idx0: torch.Tensor,
                           steps: int = 64) -> torch.Tensor:
    """Plain PyTorch version of K6 (chase_kernel): jnp.abs wraps on
    INT_MIN, lax.rem truncates, and a negative index reads row idx + R
    (take_along_axis's normalisation)."""
    rows = table.shape[0]
    tab = table.view(torch.int32).long()
    idx = idx0.long()
    for _ in range(steps):
        g = torch.gather(tab, 0, torch.where(idx < 0, idx + rows, idx))
        a = (g ^ idx).abs()
        a = torch.where(a > 2**31 - 1, a - 2**32, a)   # abs(INT_MIN) wraps
        idx = torch.fmod(a, rows)                      # lax.rem: truncated
    return idx.to(torch.int32)
