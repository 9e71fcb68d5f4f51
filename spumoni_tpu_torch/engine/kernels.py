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
  * `unpack2` (K11): the decode of 2-bit staged read rows through a
    4-entry value table, with the exceptions written over their cells.
  * `unpack4` (K12): the decode of 4-bit staged read rows, optionally
    through a 16-entry byte table (rank -> raw byte).
  * `pml_classify_tp` (K13), `layered_classify_tp` (K14), `ms_scan_tp`
    (K15) and `ms_extend_tp` (K16): K2, K8, K3 and K4 over a sharded index
    (`parallel/tp.py`, `run --tp-devices S`), each table read from the
    shard that holds the row.

K1/K2/K13 live in `csrc/blockbits_pml.cu`, K3-K5/K15/K16 in
`csrc/blockbits_ms.cu`, K6 in `csrc/gather_chase.cu`, K7/K8/K14 in
`csrc/layered.cu`, K9/K10 in `csrc/occblock.cu` and K11/K12 in
`csrc/staging.cu`, each behind a plain C interface (the bin-max carry of
K2, K8 and K10 in `csrc/binmax.cuh`, the sharded row source in
`csrc/sharded.cuh`; the steps of K1 and K3 / K15, K7 and K8, and K9,
for a group of threads per read, in `csrc/ms_step.cuh`,
`csrc/layered_step.cuh` and `csrc/occ_step.cuh`, and K4 / K16's group
walk in `csrc/extend_step.cuh`).
K4 takes a text and its bound, so both engines share it.

K1, K3 and K4 take their reads either as a [B, L] matrix with its [B]
lengths, or as the flat rows of a grouped launch with its `Lanes`: every
staged group of a value batch on one device in one launch, the outputs
flat and unpadded in the batch's read order (csrc/lanes.cuh,
ScanEngine.stage). The plain versions run a grouped launch's lanes in
runs of the longest first (`_lane_runs`). Each
source is compiled with nvcc for sm_90a on first use, all at once, into
`_build/` next to this package, keyed by a hash of the sources, and bound
with ctypes.

A wrapper runs the plain version (`*_reference`) only for tensors on the
CPU. For CUDA tensors it launches its kernel, or raises: no failure falls
back to the plain version. Every launch goes through `_launch`, which
runs the entry point with the tensors' device as the current device, on
that device's current stream, and counts it in the wrapper's `.launches`
under a lock (`launch_counts()` reads them all, `reset_launch_counts()`
sets them to 0). K13-K16 also read shards on other cards once
`enable_peer_access` has opened them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.tp import ShardedBlockBits, ShardedLayered, ShardedTable
from .blockbits import BlockBitsIndex, ms_probe, pml_probe
from .layered import LayeredIndex, initial_state, layered_step
from .occblock import OccIndex, occ_initial_state, occ_step

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
#: every file the libraries are built from: a change to any rebuilds all
_SOURCES = ("binmax.cuh", "blockbits_pml.cu", "blockbits_pml.cuh",
            "blockbits_ms.cu", "extend_step.cuh", "gather_chase.cu",
            "lanes.cuh", "layered.cu", "layered_step.cuh", "ms_step.cuh",
            "occ_step.cuh", "occblock.cu", "sharded.cuh", "staging.cu")
#: library name -> its translation unit
LIBRARIES = {"blockbits_pml": "blockbits_pml.cu",
             "blockbits_ms": "blockbits_ms.cu",
             "gather_chase": "gather_chase.cu",
             "layered": "layered.cu",
             "occblock": "occblock.cu",
             "staging": "staging.cu"}
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
_U32, _U64 = ctypes.c_uint, ctypes.c_ulonglong
#: library -> {entry point: argtypes}; every entry point returns an int
_SIGNATURES = {
    "blockbits_pml": {
        "spn_pml_scan": [_P, _I64, _I32, _I32, _I32, _I64, _I64, _I64, _I32,
                         _P, _I32, _P, _P, _P, _P, _I64, _I64, _P, _P],
        "spn_pml_classify": [_P, _I64, _I32, _I32, _I32, _I64, _I64, _I64,
                             _I32, _P, _I32, _P, _P, _I64, _I64, _I64, _I32,
                             _P, _P, _P, _P, _P],
        "spn_pml_classify_tp": [_P, _I32, _I64, _I64, _I32, _I32, _I32,
                                _I64, _I64, _I64, _I32, _P, _I32, _P, _P,
                                _I64, _I64, _I64, _I32, _P, _P, _P, _P,
                                _P]},
    "blockbits_ms": {
        "spn_enable_peer_access": [_I32],
        "spn_ms_scan": [_P, _P, _I64, _I32, _I32, _I32, _I64, _I64, _I64,
                        _I32, _I64, _I64, _P, _I32, _P, _P, _P, _P, _I64,
                        _I64, _P, _P, _I32, _P, _P, _P],
        "spn_ms_extend": [_P, _I64, _I64, _P, _P, _P, _P, _P, _I64, _I64,
                          _I32, _P, _P],
        "spn_ms_scan_tp": [_P, _P, _I32, _I64, _I64, _I32, _I32, _I32, _I64,
                           _I64, _I64, _I32, _I64, _I64, _P, _I32, _P, _P,
                           _I64, _I64, _P, _P, _I64, _I32, _P, _P, _P],
        "spn_ms_extend_tp": [_P, _I32, _I64, _I64, _P, _P, _P, _I64, _I64,
                             _I32, _P, _P],
        "spn_binmax_values": [_P, _P, _I64, _I64, _I32, _I64, _I32, _P, _P,
                              _P, _P, _P]},
    "gather_chase": {
        "spn_gather_chase": [_P, _P, _I32, _I32, _I32, _U32, _I32, _I32,
                             _P, _P]},
    "layered": {
        "spn_layered_scan": [_P, _P, _I32, _P, _I32, _I32, _I64, _I64, _I64,
                             _I64, _P, _P, _I64, _I64, _I32, _P, _P, _P],
        "spn_layered_classify": [_P, _P, _I32, _P, _I32, _I32, _I64, _P, _P,
                                 _I64, _I64, _I64, _I32, _P, _P, _P, _P, _P],
        "spn_layered_classify_tp": [_P, _P, _I32, _P, _I32, _I64, _I32, _I32,
                                    _I64, _P, _P, _I64, _I64, _I64, _I32, _P,
                                    _P, _P, _P, _P]},
    "occblock": {
        "spn_occ_scan": [_P, _I64, _I32, _I32, _I32, _I32, _I32, _I32,
                         _I32, _I32, _I32, _P, _I32, _P, _P, _I64, _I64,
                         _I32, _P, _P, _P],
        "spn_occ_classify": [_P, _I64, _I32, _I32, _I32, _I32, _P, _I32,
                             _P, _P, _I64, _I64, _I64, _I32, _P, _P, _P, _P,
                             _P]},
    "staging": {
        "spn_unpack2": [_P, _P, _I64, _I64, _U32, _P, _I64, _P, _P],
        "spn_unpack4": [_P, _P, _I64, _I64, _U64, _U64, _P, _P]},
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


class Lanes(NamedTuple):
    """The lanes of one grouped launch of K1, K3 or K4 on one device
    (csrc/lanes.cuh; laid out by ScanEngine.stage): lane i reads lens[i]
    symbols of the row that starts rows[i] bytes into the launch's flat
    rows, and writes its values to [offs[i], offs[i] + lens[i]) of a flat
    output of `size` elements. The lanes go longest first; the outputs
    hold each read's values in the batch's read order, with no padding.
    `desc` is the [3, N] int64 (rows, lens, offs) on the launch's device,
    `width` the longest lane, `groups` the staged groups it serves."""
    desc: torch.Tensor
    size: int
    width: int
    groups: int

    @property
    def rows(self) -> torch.Tensor:
        return self.desc[0]

    @property
    def lens(self) -> torch.Tensor:
        return self.desc[1]

    @property
    def offs(self) -> torch.Tensor:
        return self.desc[2]


def _check_lanes(reads: torch.Tensor, lanes: Lanes):
    """A grouped launch's flat rows and descriptors."""
    if reads.dtype != torch.uint8 or reads.dim() != 1:
        raise ValueError("a grouped launch's rows must be a flat uint8 "
                         "tensor")
    d = lanes.desc
    if d.dtype != torch.int64 or d.dim() != 2 or d.shape[0] != 3:
        raise ValueError("lanes.desc must be a [3, N] int64 tensor")


def _lane_args(reads: torch.Tensor, lens) -> list:
    """The entry points' (reads, lens, lane rows, lane offsets, B, L) of a
    [B, L] matrix and its [B] lens (no descriptors: lane b reads row b and
    writes at b * L), or of a grouped launch's flat rows and Lanes (L its
    longest lane)."""
    if isinstance(lens, Lanes):
        return [reads.data_ptr(), lens.lens.data_ptr(), lens.rows.data_ptr(),
                lens.offs.data_ptr(), lens.desc.shape[1], lens.width]
    return [reads.data_ptr(), lens.data_ptr(), None, None, reads.shape[0],
            reads.shape[1]]


def _values_out(reads: torch.Tensor, lens, dtype) -> torch.Tensor:
    """A scan's output: the [B, L] zeros of a matrix, or a grouped launch's
    flat values, every element of which the launch writes."""
    if isinstance(lens, Lanes):
        return torch.empty(lens.size, dtype=dtype, device=reads.device)
    return torch.zeros(reads.shape, dtype=dtype, device=reads.device)


def _check_inputs(rows: torch.Tensor, tab: torch.Tensor,
                  reads_rev: torch.Tensor, lens, grouped: bool = False):
    """Device, dtype, shape and contiguity checks of the wrappers that take
    rank-mapped rows and a CharTable table; `rows` is the index's row
    tensor (a BlockBitsIndex's bblocks, an OccIndex's blocks). With
    `grouped`, lens may be the Lanes of a grouped launch over the flat rows
    reads_rev. Returns the device kind: 'cpu' or 'cuda'."""
    dev = reads_rev.device
    lanes = lens if isinstance(lens, Lanes) else None
    if lanes is not None:
        if not grouped:
            raise ValueError("this kernel takes no grouped launch")
        lens = lanes.desc
    for name, t in (("index rows", rows), ("tab", tab), ("lens", lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, reads on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if lanes is not None:
        _check_lanes(reads_rev, lanes)
    elif reads_rev.dtype != torch.uint8 or reads_rev.dim() != 2:
        raise ValueError("reads_rev must be a [B, L] uint8 tensor")
    elif lens.dtype != torch.int64 \
            or tuple(lens.shape) != (reads_rev.shape[0],):
        raise ValueError("lens must be a [B] int64 tensor")
    if tab.dtype != torch.int64 or tab.dim() != 2 or tab.shape[1] != 5 \
            or not 0 < tab.shape[0] <= 256:
        raise ValueError("tab must be an [sq <= 256, 5] int64 tensor")
    if not (reads_rev.is_contiguous() and lens.is_contiguous()
            and tab.is_contiguous() and rows.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    return dev.type


def _launch_head(index: BlockBitsIndex, tab):
    m = index.meta
    return [index.bblocks.data_ptr(), index.bblocks.shape[0], m.P, m.pack,
            int(m.wide), m.n, m.term_pos, m.F_term, m.term_code,
            tab.data_ptr(), tab.shape[0]]


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


#: guards the wrappers' launch counts: devices may launch from threads
_count_lock = threading.Lock()
#: (device, peer) CUDA device indexes where enable_peer_access let the
#: device's kernels read the peer's memory
_peers: set = set()


def _call(dev: torch.device, lib: str, entry: str, *args) -> int:
    """The one call site of the entry points of LIBRARIES:
    library(lib).entry(*args) with `dev` the calling thread's current
    device. The entry points launch on it, and some read it
    (cudaGetDevice: K4 / K16's shared-memory opt-in, K6's per-device launch
    cache), so a launch for cuda:1 from a thread whose current device is
    cuda:0 would read the wrong card's attributes. Where `dev` is current
    already, no device switch is made."""
    fn = getattr(library(lib), entry)
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _launch(wrapper, lib: str, entry: str, dev: torch.device, *args,
            index: BlockBitsIndex = None) -> None:
    """A kernel's launch: entry(*args, stream) through _call on `dev`'s
    current stream; raises on a nonzero return (_raise_on) and counts the
    launch in `wrapper.launches`, under a lock. `wrapper` is the module's
    wrapper as its callers see it (a timing harness may stand in for it:
    only its `launches` is used)."""
    rc = _call(dev, lib, entry, *args,
               torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, entry[len("spn_"):], index)
    with _count_lock:
        wrapper.launches += 1


def enable_peer_access(devices) -> None:
    """Lets the kernels launched on each CUDA device of `devices` read the
    memory of every other one (cudaDeviceEnablePeerAccess, for K13-K16's
    shards on several cards); raises where a pair has no peer access: the
    shards are never copied to the launching card instead."""
    idx = sorted({torch.device(d).index or 0 for d in devices
                  if torch.device(d).type == "cuda"})
    for a in idx:
        for b in idx:
            if a == b or (a, b) in _peers:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"cuda:{a} cannot read cuda:{b}'s memory (no peer "
                    f"access): a sharded index across cards needs peer "
                    f"access between them (use fewer cards with "
                    f"CUDA_VISIBLE_DEVICES)")
            rc = _call(torch.device("cuda", a), "blockbits_ms",
                       "spn_enable_peer_access", b)
            if rc:
                raise RuntimeError(f"enabling cuda:{a}'s access to "
                                   f"cuda:{b} failed with error {rc}")
            _peers.add((a, b))


def pml_scan(index: BlockBitsIndex, tab: torch.Tensor,
             reads_rev: torch.Tensor, lens) -> torch.Tensor:
    """K1. reads_rev: [B, L] uint8 query-rank codes, each read REVERSED and
    left-aligned; lens: [B] int64. Returns [B, L] int32 PML lengths in
    FORWARD order (columns >= lens[b] are 0). With lens the Lanes of a
    grouped launch, reads_rev is its flat rows, and the lengths come back
    flat (Lanes)."""
    if _check_inputs(index.bblocks, tab, reads_rev, lens, True) == "cpu":
        return pml_scan_reference(index, tab, reads_rev, lens)
    _check_aligned("pml_scan", (("rows", index.bblocks),))
    out = _values_out(reads_rev, lens, torch.int32)
    if out.numel() == 0:
        return out
    _launch(
        pml_scan, "blockbits_pml", "spn_pml_scan", reads_rev.device,
        *_launch_head(index, tab), *_lane_args(reads_rev, lens),
        out.data_ptr(), index=index)
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
    _check_aligned("pml_classify", (("rows", index.bblocks),))
    B = reads_rev.shape[0]
    dev = reads_rev.device
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    above = torch.zeros(B, dtype=torch.int32, device=dev)
    below = torch.zeros(B, dtype=torch.int32, device=dev)
    summ = torch.zeros(B, dtype=torch.int64, device=dev)
    if B == 0:
        return found, above, below, summ
    _launch(
        pml_classify, "blockbits_pml", "spn_pml_classify", dev,
        *_launch_head(index, tab), reads_rev.data_ptr(), lens.data_ptr(),
        B, reads_rev.shape[1], int(max_value_thr),
        int(bin_width), found.data_ptr(), above.data_ptr(), below.data_ptr(),
        summ.data_ptr(), index=index)
    return found, above, below, summ


pml_classify.launches = 0


_MS_MODES = {("ms", False): 0, ("ms", True): 1, ("pml", True): 2}
#: threads per read of K1, K3 / K15, K7 and K9 (kGroup in
#: csrc/blockbits_pml.cu, blockbits_ms.cu, layered.cu and occblock.cu):
#: each step's loads split over 8 lanes, for K3 the fastest group at every
#: lane count the runs launch (PERF.md section 6)
GROUP = 8
#: threads per read of K8 and K14 (kClassifyGroup in csrc/layered.cu):
#: faster than 8 at the 32,768 lanes their runs launch (K8 PERF.md section
#: 6; K14 4.72 against 6.27 ms, time_scan's lclassify_tp family) and at
#: 65,536; 8 are faster only at 8,192, where no run launches them
CLASSIFY_GROUP = 4
#: threads per read of K2 and K13 (kClassifyGroup in
#: csrc/blockbits_pml.cu): faster than 8 at the 32,768 lanes their runs
#: launch (K2 2.45 against 2.92 ms, K13 2.44 against 3.21) and at 65,536;
#: 8 are faster only at 8,192, where no run launches them (PERF.md section
#: 6, time_scan's bbclassify family)
PML_CLASSIFY_GROUP = 4
#: threads per read of K10 (kClassifyGroup in csrc/occblock.cu): faster
#: than 8 at the 32,768 lanes its runs launch (2.43 against 3.52 ms) and at
#: 65,536, as fast at 8,192 (PERF.md section 6, time_scan's occclassify
#: family)
OCC_CLASSIFY_GROUP = 4


def _check_aligned(name, tables):
    """K1 / K2 / K13 / K3 / K15 read rows (and msrows), K7 / K8 / K14 level
    and field rows, K4 / K16 the text with 16-byte loads: every (label,
    tensor) must start 16-byte aligned."""
    for label, t in tables:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} is not 16-byte aligned")


def ms_scan(index: BlockBitsIndex, tab: torch.Tensor,
            reads_rev: torch.Tensor, lens, mode: str, use_doc: bool):
    """K3. Same read inputs as pml_scan, a matrix or a grouped launch's
    flat rows and Lanes; mode 'ms' (with or without doc ids) or 'pml' with
    use_doc. Returns (vals, docs): [B, L] tensors of index.meta.pos_dtype
    in FORWARD order (columns >= lens[b] are 0), or a grouped launch's flat
    values: MS pointers jump_t[jidx] - d, or PML lengths; docs =
    jump_d[jidx], or None without use_doc."""
    kind = _check_inputs(index.bblocks, tab, reads_rev, lens, True)
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
    _check_aligned("ms_scan", (("rows", index.bblocks),
                               ("msrows", index.msrows)))
    vals = _values_out(reads_rev, lens, index.meta.pos_dtype)
    docs = _values_out(reads_rev, lens, vals.dtype) if use_doc else None
    if vals.numel() == 0:
        return vals, docs
    m = index.meta
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    _launch(
        ms_scan, "blockbits_ms", "spn_ms_scan", dev,
        index.bblocks.data_ptr(), index.msrows.data_ptr(),
        index.bblocks.shape[0], m.P, m.pack, int(m.wide), m.n, m.term_pos,
        m.F_term, m.term_code, m.r, m.term_runidx, tab.data_ptr(),
        tab.shape[0], *_lane_args(reads_rev, lens), ptr(index.jump_t),
        ptr(index.jump_d), code, vals.data_ptr(), ptr(docs), index=index)
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
              lens, ptrs: torch.Tensor) -> torch.Tensor:
    """K4. text: [ntext] uint8, read as 0 past its end up to text_bound
    (the index's `text_bound`); reads_fwd: [B, L] uint8 raw read bytes in
    natural order; ptrs: [B, L] forward MS pointers (int32 / int64, from
    ms_scan or layered_scan). Returns the [B, L] MS lengths in the pointer
    dtype (columns >= lens[b] are 0). With lens the Lanes of a grouped
    launch, reads_fwd is its flat forward rows (at the lanes' row offsets)
    and ptrs its flat pointers (ms_scan's grouped output), and the lengths
    come back flat in their place."""
    if text is None:
        raise ValueError("ms_extend: the index has no text (build -M)")
    if isinstance(lens, Lanes):
        kind = _check_grouped_extend(reads_fwd, lens, ptrs)
    else:
        kind = _check_matrix_inputs("ms_extend", (
            ("reads_fwd", reads_fwd, (torch.uint8,)),
            ("ptrs", ptrs, (torch.int32, torch.int64))), lens)
        if reads_fwd.shape != ptrs.shape:
            raise ValueError("ms_extend: reads_fwd and ptrs differ in "
                             "shape")
    dev = ptrs.device
    if text.device != dev:
        raise ValueError(f"text is on {text.device}, ptrs on {dev}")
    if text.dtype != torch.uint8 or text.dim() != 1 \
            or not text.is_contiguous():
        raise ValueError("ms_extend: text must be a contiguous 1-D uint8 "
                         "tensor")
    if kind == "cpu":
        return ms_extend_reference(text, text_bound, reads_fwd, lens, ptrs)
    _check_aligned("ms_extend", (("text", text),))
    grouped = isinstance(lens, Lanes)
    out = torch.empty_like(ptrs) if grouped else torch.zeros_like(ptrs)
    if out.numel() == 0:
        return out
    rd, ln, lane_rows, lane_offs, B, L = _lane_args(reads_fwd, lens)
    _launch(
        ms_extend, "blockbits_ms", "spn_ms_extend", dev,
        text.data_ptr(), text.shape[0], int(text_bound), rd, ln, lane_rows,
        lane_offs, ptrs.data_ptr(), B, L, int(ptrs.dtype == torch.int64),
        out.data_ptr())
    return out


ms_extend.launches = 0


def _check_grouped_extend(reads_fwd: torch.Tensor, lanes: Lanes,
                          ptrs: torch.Tensor) -> str:
    """K4's grouped inputs: flat forward rows, the Lanes and the flat
    pointers, on one device, contiguous; returns the device kind."""
    dev = ptrs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for label, t in (("reads_fwd", reads_fwd), ("lanes", lanes.desc)):
        if t.device != dev:
            raise ValueError(f"{label} is on {t.device}, ptrs on {dev}")
    _check_lanes(reads_fwd, lanes)
    if ptrs.dtype not in (torch.int32, torch.int64) \
            or tuple(ptrs.shape) != (lanes.size,):
        raise ValueError("ms_extend: a grouped launch's ptrs must be its "
                         "flat int32 / int64 values")
    if not (reads_fwd.is_contiguous() and lanes.desc.is_contiguous()
            and ptrs.is_contiguous()):
        raise ValueError("ms_extend: inputs must be contiguous")
    return dev.type


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
    _launch(
        binmax_values, "blockbits_ms", "spn_binmax_values", dev,
        vals.data_ptr(), lens.data_ptr(), B, vals.shape[1],
        int(vals.dtype == torch.int64), int(max_value_thr), int(bin_width),
        found.data_ptr(), above.data_ptr(), below.data_ptr(),
        summ.data_ptr())
    return found, above, below, summ


binmax_values.launches = 0


#: the columns a K6 block holds in shared memory where they fit
#: (csrc/gather_chase.cu's kCols; it also holds 1)
CHASE_COLS = 4
#: the shared memory one block may opt in to on an H100 (227 KB): K6's
#: limit on the CPU too, so that the plain path keeps the kernel's contract
H100_SMEM_OPTIN = 232_448
#: K6's capacity on an H100 and on the CPU: one table column of R rows in a
#: block's shared memory, 4 bytes a row
CHASE_MAX_ROWS = H100_SMEM_OPTIN // 4


def chase_smem(device) -> int:
    """The shared memory (bytes) one K6 block may hold on `device`: a CUDA
    device's opt-in limit, H100_SMEM_OPTIN elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMEM_OPTIN
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def chase_cols(rows: int, device="cpu") -> int:
    """The columns of `rows` rows one K6 block holds in shared memory on
    `device`: CHASE_COLS where they fit chase_smem, else 1, and 0 where
    one column does not fit (past the capacity)."""
    smem = chase_smem(device)
    return next((c for c in (CHASE_COLS, 1) if rows * c * 4 <= smem), 0)


def _chase_magic(rows: int) -> tuple:
    """(magic, shift) of K6's remainder by R = rows (1 <= R <= 2^31): for
    every u in [0, 2^31], q = (umulhi(u, magic) + u) >> shift is u // R,
    so u - q * R is u % R. shift = ceil(log2 R) and magic = ceil(2^(32 +
    shift) / R) - 2^32, in [0, 2^32); umulhi(u, magic) < u, so the sum
    fits 32 bits."""
    shift = (rows - 1).bit_length()
    return -(-(1 << (32 + shift)) // rows) - (1 << 32), shift


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
    if not chase_cols(rows, table.device):
        smem = chase_smem(table.device)
        raise ValueError(f"table has {rows} rows: K6 holds a column of R "
                         f"rows in a block's shared memory, at most "
                         f"R = {smem // 4} ({smem} bytes / 4 bytes)")
    if idx0.numel() and not (-rows <= int(idx0.min())
                             and int(idx0.max()) < rows):
        raise ValueError(f"idx0 must lie in [-R, R) = [{-rows}, {rows})")
    return table.device.type


def _chase_launch(table: torch.Tensor, idx0: torch.Tensor, steps: int,
                  out: torch.Tensor) -> None:
    """K6's launch on inputs _check_chase took, R * W > 0, on the table's
    device's current stream (_launch), with the remainder's multiplier and shift (_chase_magic) and
    the columns a block holds (chase_cols); counted in
    gather_chase.launches. No synchronisation."""
    rows, width = table.shape
    _launch(
        gather_chase, "gather_chase", "spn_gather_chase", table.device,
        table.data_ptr(), idx0.data_ptr(), rows, width, int(steps),
        *_chase_magic(rows), chase_cols(rows, table.device), out.data_ptr())


def gather_chase(table: torch.Tensor, idx0: torch.Tensor,
                 steps: int = 64) -> torch.Tensor:
    """K6. table: [R, W] u32 (int32 or uint32 storage); idx0: [R, W] int32
    in [-R, R) (checked: the kernel reads row idx or idx + R). Returns the
    [R, W] int32 indices after `steps` steps of
    idx = rem(abs(int32(table[idx, j]) ^ idx), R). R is at most the
    kernel's capacity, chase_smem / 4 (CHASE_MAX_ROWS on an H100 and on
    the CPU)."""
    if _check_chase(table, idx0) == "cpu":
        return gather_chase_reference(table, idx0, steps)
    out = torch.empty_like(idx0)
    if out.numel():
        _chase_launch(table, idx0, steps, out)
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
    """[charmeta, levels, D, fields, W, wide, n]: the index arguments of
    both entry points. `levels` is a host int64 array, the D
    level pointers then their row counts, which the entry point copies
    into the kernel's parameters."""
    m = index.meta
    levels = (ctypes.c_longlong * (2 * m.depth))(
        *(lv.data_ptr() for lv in index.levels),
        *(lv.shape[0] for lv in index.levels))
    return [index.charmeta.data_ptr(), levels, m.depth,
            index.fields.data_ptr(), m.width, int(m.wide), m.n]


def layered_tables(index: LayeredIndex) -> list:
    """(label, tensor) of the tables K7 and K8 read with 16-byte loads:
    each level, and the fields."""
    return [(f"level {t}", lv) for t, lv in enumerate(index.levels)] + [
        ("fields", index.fields)]


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
    _check_aligned("layered_scan", layered_tables(index))
    vals = torch.zeros(reads_rev.shape, dtype=m.pos_dtype, device=dev)
    docs = torch.zeros_like(vals) if use_doc else None
    if vals.numel() == 0:
        return vals, docs
    _launch(
        layered_scan, "layered", "spn_layered_scan", dev,
        *_layered_head(index), m.last_run_sample, m.last_run_edoc,
        m.first_run_sdoc, reads_rev.data_ptr(), lens.data_ptr(),
        reads_rev.shape[0], reads_rev.shape[1], code, vals.data_ptr(),
        0 if docs is None else docs.data_ptr())
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
    _check_aligned("layered_classify", layered_tables(index))
    B = reads_rev.shape[0]
    dev = reads_rev.device
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    above = torch.zeros(B, dtype=torch.int32, device=dev)
    below = torch.zeros(B, dtype=torch.int32, device=dev)
    summ = torch.zeros(B, dtype=torch.int64, device=dev)
    if B == 0:
        return found, above, below, summ
    _launch(
        layered_classify, "layered", "spn_layered_classify", dev,
        *_layered_head(index), reads_rev.data_ptr(), lens.data_ptr(), B,
        reads_rev.shape[1], int(max_value_thr), int(bin_width),
        found.data_ptr(),
        above.data_ptr(), below.data_ptr(), summ.data_ptr())
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
    _launch(
        occ_scan, "occblock", "spn_occ_scan", dev,
        *_occ_head(index), m.S0, m.D0, m.n,
        m.last_run_sample, m.last_run_edoc, m.first_run_sdoc,
        tab.data_ptr(), tab.shape[0], reads_rev.data_ptr(), lens.data_ptr(),
        reads_rev.shape[0], reads_rev.shape[1], code, vals.data_ptr(),
        0 if docs is None else docs.data_ptr())
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
    _launch(
        occ_classify, "occblock", "spn_occ_classify", dev,
        *_occ_head(index), index.meta.n,
        tab.data_ptr(), tab.shape[0], reads_rev.data_ptr(), lens.data_ptr(),
        B, reads_rev.shape[1], int(max_value_thr), int(bin_width),
        found.data_ptr(), above.data_ptr(), below.data_ptr(),
        summ.data_ptr())
    return found, above, below, summ


occ_classify.launches = 0


def _check_packed(name: str, packed: torch.Tensor, lens: torch.Tensor) -> str:
    """Device, dtype, shape and contiguity checks of K11 / K12; returns the
    device kind."""
    dev = packed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"{name}: packed must be a [B, W] uint8 tensor")
    if lens.device != dev:
        raise ValueError(f"lens is on {lens.device}, packed on {dev}")
    if lens.dtype != torch.int64 or tuple(lens.shape) != (packed.shape[0],):
        raise ValueError(f"{name}: lens must be a [B] int64 tensor")
    if not (packed.is_contiguous() and lens.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    return dev.type


def _byte_table(name: str, values, size: int) -> tuple:
    values = tuple(int(v) for v in values)
    if len(values) != size or not all(0 <= v < 256 for v in values):
        raise ValueError(f"{name}: the table must hold {size} byte values")
    return values


def _table_word(values) -> int:
    """Byte i of the result is values[i]: the kernels' table arguments."""
    return sum(v << (8 * i) for i, v in enumerate(values))


def _check_decode_out(name: str, out, shape, dev) -> None:
    """K11 / K12's `out`: None, or a contiguous uint8 tensor of the rows'
    shape on the packed rows' device."""
    if out is not None and (out.dtype != torch.uint8
                            or tuple(out.shape) != shape
                            or out.device != dev
                            or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous {list(shape)} "
                         f"uint8 tensor on {dev}")


def unpack2(packed: torch.Tensor, values, exc, lens: torch.Tensor,
            out: torch.Tensor = None):
    """K11. packed: [B, Q] uint8 of 2-bit codes, four per byte with the low
    bits first (native.pack_rows_native with bits=2); values: the 4-entry
    table code -> byte (the ranks of A, C, G, T, or their raw bytes); exc:
    None or a [k, 3] int32 tensor of (row, col, byte) exceptions in any
    order (triples outside [B, 4Q] are dropped); lens: [B] int64. Returns
    the [B, 4Q] uint8 rows: values[code], the exceptions over their cells,
    and 0 at every column >= lens[b]; written into `out` where given (a
    view of a grouped launch's flat rows)."""
    kind = _check_packed("unpack2", packed, lens)
    values = _byte_table("unpack2", values, 4)
    if exc is not None:
        if exc.device != packed.device:
            raise ValueError(f"exc is on {exc.device}, packed on "
                             f"{packed.device}")
        if exc.dtype != torch.int32 or exc.dim() != 2 or exc.shape[1] != 3 \
                or not exc.is_contiguous():
            raise ValueError("unpack2: exc must be a contiguous [k, 3] int32 "
                             "tensor")
    B, Q = packed.shape
    _check_decode_out("unpack2", out, (B, 4 * Q), packed.device)
    if kind == "cpu":
        rows = unpack2_reference(packed, values, exc, lens)
        return rows if out is None else out.copy_(rows)
    if out is None:
        out = torch.empty((B, 4 * Q), dtype=torch.uint8,
                          device=packed.device)
    if out.numel() == 0:
        return out
    k = 0 if exc is None else exc.shape[0]
    _launch(
        unpack2, "staging", "spn_unpack2", packed.device,
        packed.data_ptr(), lens.data_ptr(), B, Q, _table_word(values),
        exc.data_ptr() if k else 0, k, out.data_ptr())
    return out


unpack2.launches = 0


def unpack4(packed: torch.Tensor, lens: torch.Tensor, table=None,
            out: torch.Tensor = None):
    """K12. packed: [B, H] uint8 of nibbles, the low nibble first
    (native.pack_rows_native with bits=4); lens: [B] int64; table: None
    (the nibbles themselves) or 16 bytes, nibble -> byte (an alphabet's
    rank -> raw byte: _decode_alpha). Returns the [B, 2H] uint8 rows, 0 at
    every column >= lens[b]; written into `out` where given."""
    kind = _check_packed("unpack4", packed, lens)
    if table is not None:
        table = _byte_table("unpack4", table, 16)
    B, H = packed.shape
    _check_decode_out("unpack4", out, (B, 2 * H), packed.device)
    if kind == "cpu":
        rows = unpack4_reference(packed, lens, table)
        return rows if out is None else out.copy_(rows)
    if out is None:
        out = torch.empty((B, 2 * H), dtype=torch.uint8,
                          device=packed.device)
    if out.numel() == 0:
        return out
    table = tuple(range(16)) if table is None else table
    _launch(
        unpack4, "staging", "spn_unpack4", packed.device,
        packed.data_ptr(), lens.data_ptr(), B, H, _table_word(table[:8]),
        _table_word(table[8:]), out.data_ptr())
    return out


unpack4.launches = 0


# ---------------------------------------------------------------------------
# the sharded index (parallel/tp.py): K13-K16
# ---------------------------------------------------------------------------

def _check_shards(name: str, tables, dev: torch.device) -> None:
    """Every shard of each (label, ShardedTable or None) contiguous and on
    `dev`, or on a CUDA peer of it whose memory enable_peer_access opened
    to it: the kernels, launched on the reads' device and stream, read
    every shard through its pointer (a ShardedTable holds 1 to MAX_SHARDS
    of them)."""
    for label, table in tables:
        if table is None:
            continue
        for i, t in enumerate(table.shards):
            peer = (dev.type == t.device.type == "cuda"
                    and (dev.index or 0, t.device.index or 0) in _peers)
            if t.device != dev and not peer:
                raise ValueError(f"{name}: shard {i} of {label} is on "
                                 f"{t.device}, reads on {dev}"
                                 + (" (no peer access: "
                                    "kernels.enable_peer_access)"
                                    if t.device.type == dev.type == "cuda"
                                    else ""))
            if not t.is_contiguous():
                raise ValueError(f"{name}: inputs must be contiguous")


def _shard_ptrs(table: ShardedTable):
    """The host array of a table's S shard pointers (the entry points copy
    it into the kernel's row source)."""
    return (ctypes.c_longlong * table.S)(*(t.data_ptr()
                                           for t in table.shards))


def pml_classify_tp(index: ShardedBlockBits, tab: torch.Tensor,
                    reads_rev: torch.Tensor, lens: torch.Tensor,
                    max_value_thr: int, bin_width: int):
    """K13. pml_classify (K2) over a sharded block-bits index
    (parallel/tp.py::shard_blockbits): each row from its shard, blocks
    clamped to the padded row count (zero pad rows), as the JAX sharded
    classifier reads them. Same inputs and outputs as pml_classify."""
    if bin_width <= 0:
        raise ValueError("bin_width must be positive")
    dev = reads_rev.device
    kind = _check_inputs(index.bblocks, tab, reads_rev, lens)
    _check_shards("pml_classify_tp", (("bblocks", index.bblocks),), dev)
    if kind == "cpu":
        return pml_classify_tp_reference(index, tab, reads_rev, lens,
                                         max_value_thr, bin_width)
    _check_aligned("pml_classify_tp", [
        (f"rows shard {i}", t) for i, t in enumerate(index.bblocks.shards)])
    B = reads_rev.shape[0]
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    above = torch.zeros(B, dtype=torch.int32, device=dev)
    below = torch.zeros(B, dtype=torch.int32, device=dev)
    summ = torch.zeros(B, dtype=torch.int64, device=dev)
    if B == 0:
        return found, above, below, summ
    m, rows = index.meta, index.bblocks
    _launch(
        pml_classify_tp, "blockbits_pml", "spn_pml_classify_tp", dev,
        _shard_ptrs(rows), rows.S, rows.rows_per_shard, rows.shape[0], m.P,
        m.pack, int(m.wide), m.n, m.term_pos, m.F_term, m.term_code,
        tab.data_ptr(), tab.shape[0], reads_rev.data_ptr(), lens.data_ptr(),
        B, reads_rev.shape[1], int(max_value_thr), int(bin_width),
        found.data_ptr(), above.data_ptr(), below.data_ptr(),
        summ.data_ptr(), index=index)
    return found, above, below, summ


pml_classify_tp.launches = 0


def layered_tp_tables(index: ShardedLayered) -> list:
    """(label, tensor) of the tables K14 reads with 16-byte loads: each
    level, and each shard of the fields."""
    return [(f"level {t}", lv) for t, lv in enumerate(index.levels)] + [
        (f"fields shard {i}", t) for i, t in enumerate(index.fields.shards)]


def layered_classify_tp(index: ShardedLayered, reads_rev: torch.Tensor,
                        lens: torch.Tensor, max_value_thr: int,
                        bin_width: int):
    """K14. layered_classify (K8) over a sharded layered index
    (parallel/tp.py::shard_layered): each field row from its shard. Same
    inputs and outputs as layered_classify."""
    if bin_width <= 0:
        raise ValueError("bin_width must be positive")
    dev = reads_rev.device
    kind = _check_layered(index, reads_rev, lens)
    _check_shards("layered_classify_tp", (("fields", index.fields),), dev)
    if kind == "cpu":
        return layered_classify_tp_reference(index, reads_rev, lens,
                                             max_value_thr, bin_width)
    _check_aligned("layered_classify_tp", layered_tp_tables(index))
    B = reads_rev.shape[0]
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    above = torch.zeros(B, dtype=torch.int32, device=dev)
    below = torch.zeros(B, dtype=torch.int32, device=dev)
    summ = torch.zeros(B, dtype=torch.int64, device=dev)
    if B == 0:
        return found, above, below, summ
    m, fields = index.meta, index.fields
    levels = (ctypes.c_longlong * (2 * m.depth))(
        *(lv.data_ptr() for lv in index.levels),
        *(lv.shape[0] for lv in index.levels))
    _launch(
        layered_classify_tp, "layered", "spn_layered_classify_tp", dev,
        index.charmeta.data_ptr(), levels, m.depth, _shard_ptrs(fields),
        fields.S, fields.rows_per_shard, m.width, int(m.wide), m.n,
        reads_rev.data_ptr(), lens.data_ptr(), B, reads_rev.shape[1],
        int(max_value_thr), int(bin_width),
        found.data_ptr(), above.data_ptr(), below.data_ptr(),
        summ.data_ptr())
    return found, above, below, summ


layered_classify_tp.launches = 0


def ms_scan_tp(index: ShardedBlockBits, tab: torch.Tensor,
               reads_rev: torch.Tensor, lens: torch.Tensor, mode: str,
               use_doc: bool):
    """K15. ms_scan (K3) over a sharded block-bits MS index
    (parallel/tp.py::shard_blockbits_ms): rows and msrows from their shard,
    blocks clamped to the padded row count, jump_t / jump_d entries from
    theirs. Same inputs, modes and outputs as ms_scan."""
    kind = _check_inputs(index.bblocks, tab, reads_rev, lens)
    code = _MS_MODES.get((mode, bool(use_doc)))
    if code is None:
        raise ValueError(f"ms_scan_tp: mode={mode!r}, use_doc={use_doc} "
                         f"(plain PML has no sharded scan)")
    need = ["msrows"] + (["jump_t"] if mode == "ms" else []) + (
        ["jump_d"] if use_doc else [])
    for name in need:
        if getattr(index, name) is None:
            raise ValueError(f"ms_scan_tp: the index has no {name}")
    dev = reads_rev.device
    _check_shards("ms_scan_tp", [(name, getattr(index, name)) for name in (
        "bblocks", "msrows", "jump_t", "jump_d")], dev)
    if kind == "cpu":
        return ms_scan_tp_reference(index, tab, reads_rev, lens, mode,
                                    use_doc)
    _check_aligned("ms_scan_tp", [
        (f"{label} shard {i}", t) for label, table in (
            ("rows", index.bblocks), ("msrows", index.msrows))
        for i, t in enumerate(table.shards)])
    m = index.meta
    vals = torch.zeros(reads_rev.shape, dtype=m.pos_dtype, device=dev)
    docs = torch.zeros_like(vals) if use_doc else None
    if vals.numel() == 0:
        return vals, docs
    jumps = index.jump_t if index.jump_t is not None else index.jump_d
    rows = index.bblocks
    ptrs = lambda t: None if t is None else _shard_ptrs(t)  # noqa: E731
    _launch(
        ms_scan_tp, "blockbits_ms", "spn_ms_scan_tp", dev,
        _shard_ptrs(rows), _shard_ptrs(index.msrows), rows.S,
        rows.rows_per_shard, rows.shape[0], m.P, m.pack, int(m.wide), m.n,
        m.term_pos, m.F_term, m.term_code, m.r, m.term_runidx,
        tab.data_ptr(), tab.shape[0], reads_rev.data_ptr(), lens.data_ptr(),
        reads_rev.shape[0], reads_rev.shape[1], ptrs(index.jump_t),
        ptrs(index.jump_d), jumps.rows_per_shard, code, vals.data_ptr(),
        0 if docs is None else docs.data_ptr(), index=index)
    return vals, docs


ms_scan_tp.launches = 0


def ms_extend_tp(text: ShardedTable, text_bound: int,
                 reads_fwd: torch.Tensor, lens: torch.Tensor,
                 ptrs: torch.Tensor) -> torch.Tensor:
    """K16. ms_extend (K4) over a sharded text (ShardedBlockBits.text:
    bytes in S shards, zero past the text), read as 0 past its shards up to
    text_bound (the index's `text_bound`). Same reads, pointers and output
    as ms_extend."""
    if text is None:
        raise ValueError("ms_extend_tp: the index has no text (build -M)")
    kind = _check_matrix_inputs("ms_extend_tp", (
        ("reads_fwd", reads_fwd, (torch.uint8,)),
        ("ptrs", ptrs, (torch.int32, torch.int64))), lens)
    if reads_fwd.shape != ptrs.shape:
        raise ValueError("ms_extend_tp: reads_fwd and ptrs differ in shape")
    if text.dtype != torch.uint8 or len(text.shape) != 1:
        raise ValueError("ms_extend_tp: text must be a 1-D uint8 table")
    _check_shards("ms_extend_tp", (("text", text),), lens.device)
    if kind == "cpu":
        return ms_extend_tp_reference(text, text_bound, reads_fwd, lens, ptrs)
    _check_aligned("ms_extend_tp", (("text", t) for t in text.shards))
    if text.rows_per_shard % 16:
        raise ValueError("ms_extend_tp: text shards must hold a multiple of "
                         "16 bytes")
    out = torch.zeros_like(ptrs)
    if out.numel() == 0:
        return out
    _launch(
        ms_extend_tp, "blockbits_ms", "spn_ms_extend_tp", lens.device,
        _shard_ptrs(text), text.S, text.rows_per_shard, int(text_bound),
        reads_fwd.data_ptr(), lens.data_ptr(), ptrs.data_ptr(),
        ptrs.shape[0], ptrs.shape[1], int(ptrs.dtype == torch.int64),
        out.data_ptr())
    return out


ms_extend_tp.launches = 0

_WRAPPERS = (pml_scan, pml_classify, ms_scan, ms_extend, binmax_values,
             gather_chase, layered_scan, layered_classify, occ_scan,
             occ_classify, unpack2, unpack4, pml_classify_tp,
             layered_classify_tp, ms_scan_tp, ms_extend_tp)


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


#: lanes a run of the plain versions of a grouped launch
PLAIN_LANES = 256


def _lane_runs(lanes: Lanes):
    """The plain versions' walk over a grouped launch: (lens [n], row index
    [n, W], output index [n, W], mask [n, W]) of each run of up to
    PLAIN_LANES lanes, W the run's longest lane (the lanes go longest
    first, so a run holds little padding). Past a lane's length the mask
    is False and the indexes repeat its first byte and output."""
    rows, lens, offs = lanes.desc
    for lo in range(0, lanes.desc.shape[1], PLAIN_LANES):
        ln = lens[lo:lo + PLAIN_LANES]
        cols = torch.arange(int(ln.max()), device=ln.device)
        mask = cols < ln[:, None]
        at = torch.where(mask, cols, 0)
        yield (ln, rows[lo:lo + PLAIN_LANES, None] + at,
               offs[lo:lo + PLAIN_LANES, None] + at, mask)


def _run_rows(flat: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor):
    """A run's [n, W] matrix of flat[idx], 0 past each lane's length."""
    return torch.where(mask, flat[idx], torch.zeros((), dtype=flat.dtype))


def pml_scan_reference(index: BlockBitsIndex, tab: torch.Tensor,
                       reads_rev: torch.Tensor, lens) -> torch.Tensor:
    """Plain PyTorch version of K1 (query_batch_kernel_v4 + the flip); a
    grouped launch's lanes in runs (_lane_runs)."""
    if isinstance(lens, Lanes):
        out = torch.empty(lens.size, dtype=torch.int32,
                          device=reads_rev.device)
        for ln, ri, oi, m in _lane_runs(lens):
            out[oi[m]] = pml_scan_reference(
                index, tab, _run_rows(reads_rev, ri, m), ln)[m]
        return out
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
                      reads_rev: torch.Tensor, lens, mode: str,
                      use_doc: bool):
    """Plain PyTorch version of K3 (query_batch_kernel_v4ms with
    ms_initial_state and the jump-table reconstruction, in forward
    order); a grouped launch's lanes in runs (_lane_runs)."""
    m = index.meta
    if isinstance(lens, Lanes):
        vals = torch.empty(lens.size, dtype=m.pos_dtype,
                           device=reads_rev.device)
        docs = torch.empty_like(vals) if use_doc else None
        for ln, ri, oi, mk in _lane_runs(lens):
            v, d = ms_scan_reference(index, tab, _run_rows(reads_rev, ri, mk),
                                     ln, mode, use_doc)
            vals[oi[mk]] = v[mk]
            if use_doc:
                docs[oi[mk]] = d[mk]
        return vals, docs
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
                        reads_fwd: torch.Tensor, lens,
                        ptrs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: extend_pointers_kernel's two-pointer
    loop (scan_engine.py:1041-1101). Each iteration either extends a lane's
    match by one character or emits its length at i and moves to i + 1,
    keeping max(l - 1, 0) characters (MS are 1-Lipschitz), so a lane takes
    at most 3 L iterations. A position mismatches when its pointer is
    negative (the reference's unsigned underflow) or the text position is
    past text_bound, where text past its end reads as 0. A grouped launch's
    lanes go in runs (_lane_runs), each lane's pointers from its output
    offset."""
    if isinstance(lens, Lanes):
        out = torch.empty_like(ptrs)
        for ln, ri, oi, mk in _lane_runs(lens):
            out[oi[mk]] = ms_extend_reference(
                text, text_bound, _run_rows(reads_fwd, ri, mk), ln,
                _run_rows(ptrs, oi, mk))[mk]
        return out
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


def _zero_past(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    cols = torch.arange(rows.shape[1], device=rows.device)
    return rows.masked_fill(cols[None, :] >= lens[:, None], 0)


def unpack2_reference(packed: torch.Tensor, values, exc,
                      lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11 (_unpack2, with 0 past each row's
    length): codes through the table, 0 past lens, then the exceptions."""
    B, Q = packed.shape
    dev = packed.device
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=dev)
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(B, 4 * Q)
    table = torch.tensor(values, dtype=torch.uint8, device=dev)
    out = _zero_past(table[codes.long()], lens)
    if exc is not None and exc.shape[0]:
        e = exc.long()
        ok = ((e[:, 0] >= 0) & (e[:, 0] < B) & (e[:, 1] >= 0)
              & (e[:, 1] < 4 * Q))
        out[e[ok, 0], e[ok, 1]] = e[ok, 2].to(torch.uint8)
    return out


def unpack4_reference(packed: torch.Tensor, lens: torch.Tensor,
                      table=None) -> torch.Tensor:
    """Plain PyTorch version of K12 (_unpack4, then _decode_alpha with a
    table, with 0 past each row's length)."""
    B, H = packed.shape
    nib = torch.stack([packed & 15, packed >> 4], dim=2).reshape(B, 2 * H)
    if table is not None:
        nib = torch.tensor(table, dtype=torch.uint8,
                           device=packed.device)[nib.long()]
    return _zero_past(nib, lens)


def pml_classify_tp_reference(index: ShardedBlockBits, tab: torch.Tensor,
                              reads_rev: torch.Tensor, lens: torch.Tensor,
                              max_value_thr: int, bin_width: int):
    """Plain PyTorch version of K13: K2's plain version over the shard list
    (ShardedTable reads each row from its owner shard, 0 past the padded
    rows; blocks clamp to the padded count), as TpPmlClassifier computes."""
    return pml_classify_reference(index, tab, reads_rev, lens, max_value_thr,
                                  bin_width)


def layered_classify_tp_reference(index: ShardedLayered,
                                  reads_rev: torch.Tensor, lens: torch.Tensor,
                                  max_value_thr: int, bin_width: int):
    """Plain PyTorch version of K14: K8's plain version over the shard
    list."""
    return layered_classify_reference(index, reads_rev, lens, max_value_thr,
                                      bin_width)


def ms_scan_tp_reference(index: ShardedBlockBits, tab: torch.Tensor,
                         reads_rev: torch.Tensor, lens: torch.Tensor,
                         mode: str, use_doc: bool):
    """Plain PyTorch version of K15: K3's plain version over the shard lists
    of the rows, msrows and jump tables (TpMsQuery._query_fn's scan and
    _tp_take_1d)."""
    return ms_scan_reference(index, tab, reads_rev, lens, mode, use_doc)


def ms_extend_tp_reference(text: ShardedTable, text_bound: int,
                           reads_fwd: torch.Tensor, lens: torch.Tensor,
                           ptrs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K16: K4's plain version over the text's
    shard list (bytes past the shards read as 0)."""
    return ms_extend_reference(text, text_bound, reads_fwd, lens, ptrs)


def seeded_packed(seed: int, B: int, L: int, k: int, lens=None):
    """Seeded [B, L/4] 2-bit and [B, L/2] 4-bit packed rows (uint8), k
    exception triples [k, 3] int32 on distinct in-read cells in shuffled
    order (the native packer's order varies too), and [B] int64 lengths
    (`lens`, else seeded with the first row full): K11 / K12's checks in
    the tests and chip_smoke.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(1, L + 1, size=B).astype(np.int64)
        lens[0] = L
    if k > lens.sum():
        raise ValueError(f"{k} exceptions on {lens.sum()} in-read cells")
    packed2 = rng.integers(0, 256, size=(B, L // 4), dtype=np.uint8)
    packed4 = rng.integers(0, 256, size=(B, L // 2), dtype=np.uint8)
    cells = set()
    while len(cells) < k:
        r = int(rng.integers(B))
        cells.add((r, int(rng.integers(lens[r]))))
    exc = np.array([(r, c, int(rng.integers(0, 256)))
                    for r, c in sorted(cells)], np.int32).reshape(-1, 3)
    rng.shuffle(exc)
    return packed2, packed4, exc, lens


def edge_lengths(B: int, L: int) -> np.ndarray:
    """[B] int64 read lengths at K11 / K12's row-end corners, cycled over
    the rows and clipped to [1, L]: L (the first row full, as
    seeded_packed's), 1, ends inside a 16-byte packed vector and at its
    edges (a vector decodes to 64 columns in K11, 32 in K12), mid-row and
    L - 1."""
    ends = [L, 1, 2, 31, 32, 33, 63, 64, 65, 97, L // 2 + 7, L - 1]
    return np.clip(np.resize(ends, B), 1, L).astype(np.int64)


def misaligned(t: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """A contiguous copy of the uint8 tensor `t` that starts `offset` bytes
    past the start of its allocation (a fresh tensor's is 16-byte
    aligned): K11 / K12's rows off the 16-byte boundary in the tests and
    chip_smoke.py."""
    flat = torch.empty(t.numel() + offset, dtype=torch.uint8,
                       device=t.device)
    return flat[offset:].view(t.shape).copy_(t)


#: read lengths of seeded_extend's rows: 0, 1, around each lane group K4 /
#: K16 could take (8, 16, 32) and its doubles, L - 1 and L
_EXTEND_LENGTHS = (0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65)


def seeded_extend(seed: int, L: int, wide: bool = False, B: int = 60,
                  ntext: int = 3000, nt: int = 4096):
    """Seeded inputs of K4 / K16 whose pointers are no MS pointers, as numpy
    arrays: text [ntext] uint8 (ACGT; read as 0 from ntext up to the bound
    nt), reads [B, L] uint8 (0 past each length), lens [B] int64 (0, 1,
    7-9, 15-17, 31-33, 63-65, L - 1, L, then random) and pointers [B, L]
    (int64 with wide, else int32). Rows take turns: a text substring with
    5% of its bytes changed on its diagonal; random pointers in [-3,
    nt + 3]; runs of consecutive pointers, each on the read's diagonal or
    random; a read running off the text's end into 0 bytes (which match
    the text past ntext) with pointers on its diagonal, into [ntext, nt),
    just below nt and past it; an exact substring on its diagonal with
    negative pointers inside the match, at every chunk start of a 32-lane
    group among them."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    text = rng.choice(acgt, ntext)
    padded = np.concatenate([text, np.zeros(L + 64, np.uint8)])
    fixed = [m for m in _EXTEND_LENGTHS if m <= L] + [L - 1, L]
    lens = np.concatenate([fixed, rng.integers(0, L + 1, max(
        B - len(fixed), 0))])[:B].astype(np.int64)
    reads = np.zeros((B, L), np.uint8)
    ptrs = np.zeros((B, L), np.int64)
    for b, m in enumerate(lens.tolist()):
        kind = b % 5
        q = int(rng.integers(0, ntext))
        if kind == 3:   # off the text's end
            q = ntext - int(rng.integers(0, min(m, 64) + 1))
        row = padded[q:q + m].copy()
        diag = q + np.arange(m)
        if kind == 0:
            hit = rng.random(m) < 0.05
            row[hit] = rng.choice(acgt, int(hit.sum()))
            p = diag
        elif kind == 1:
            p = rng.integers(-3, nt + 4, m)
        elif kind == 2:
            p = diag.copy()
            j = 0
            while j < m:
                run = int(rng.integers(1, 41))
                if rng.random() < 0.5:
                    p[j:j + run] = int(rng.integers(-3, nt + 4)) + np.arange(
                        min(run, m - j))
                j += run
        elif kind == 3:
            p = diag.copy()
            far = rng.random(m) < 0.2
            p[far] = rng.integers(ntext, nt + 4, int(far.sum()))
            edge = rng.random(m) < 0.1    # the walk crosses nt, or starts past
            p[edge] = rng.integers(nt - 8, nt + 4, int(edge.sum()))
        else:
            p = diag.copy()
            neg = rng.random(m) < 0.08
            neg[::max(1, -(-m // 32))] = True
            p[neg] = -rng.integers(1, 4, int(neg.sum()))
        reads[b, :m] = row
        ptrs[b, :m] = p
    return text, reads, lens, ptrs.astype(np.int64 if wide else np.int32)


def ms_edge_reads(text: np.ndarray, L: int, terminator: bool = True) -> list:
    """The edge reads of the group scans (K3 / K15, K7, K9) over a DNA
    index text (uint8, longer than L + 600): substrings of every length at
    which a lane group's outputs split (0, 1, G - 1, G and G + 1 for G =
    GROUP), 1,023 and L; a read whose last step jumps (its first byte
    differs from the text's byte before the rest, so the last, partial
    group stores a jump's value); with terminator, block-bits' pack = 2
    terminator query (byte 1) inside a read; and ROADMAP section C's read,
    whose W sorts after every index character (a position past the BWT).
    Lengths past L are left out."""
    G = GROUP
    lengths = sorted({0, 1, G - 1, G, G + 1, 1023, L})
    reads = [text[37:37 + m].tobytes() for m in lengths if m <= L]
    first = next(c for c in b"ACGT" if c != text[499])
    reads.append(bytes([first]) + text[500:700].tobytes())
    if terminator:
        reads.append(text[100:150].tobytes() + b"\x01"
                     + text[200:250].tobytes())
    return reads + [text[100:160].tobytes() + b"W" + text[200:260].tobytes()]


#: read lengths at the corners of the bin-max carry for a bin width of 150:
#: one bin, one with a tail merged into it, and where a second bin opens
BIN_CORNERS = (149, 150, 151, 299, 300, 301)


def classify_edge_reads(text: np.ndarray, L: int) -> list:
    """The edge reads of the classify scans (K2 / K13): ms_edge_reads (with
    the terminator query) and substrings of the BIN_CORNERS lengths that
    fit in L."""
    return ms_edge_reads(text, L) + [text[300:300 + m].tobytes()
                                     for m in BIN_CORNERS if m <= L]
