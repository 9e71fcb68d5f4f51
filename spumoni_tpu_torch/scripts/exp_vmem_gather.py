"""Microbenchmark: a dependent gather chase over a table held on the chip.

    python -m spumoni_tpu_torch.scripts.exp_vmem_gather

The port of scripts/exp_vmem_gather.py, whose Pallas kernel (`run_pallas`
-> `chase_kernel`) asked whether a table held in the TPU's VMEM beats the
XLA row gather from HBM. Here the same chase runs as K6
`kernels.gather_chase` (csrc/gather_chase.cu): per element (i, j) of an
[R, W] index matrix, L dependent steps of

    idx = rem(abs(int32(table[idx, j]) ^ idx), R)

with jnp.abs's wrap on INT_MIN and lax.rem's sign rule; a negative index
reads row idx + R (take_along_axis's normalisation). Chain (i, j) reads
column j alone, so the kernel holds the table in shared memory, column
group by column group (4 columns of R rows a block at the script's R,
155.6 KB), not in L2. `kernels.gather_chase_reference` is the plain
PyTorch version (a torch.gather loop).

The script's own `xla_chase` gathers whole rows by column 0's index, which
is another function: the port is held against `chase_kernel`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..engine import kernels
from ..engine.kernels import gather_chase, gather_chase_reference

R, W = 9728, 128   # table rows x u32 columns: 4.98 MB
L = 64             # dependent steps per call
REPS = 20          # timed kernel calls after the warm-up
#: (rows, width, steps, starts in [-R, R)) at which the GPU tests and
#: chip_smoke.py's phase 3b hold K6 to its plain version, beside the
#: script's shape with the INT_MIN wrap (int_min_inputs): one element; one
#: column, one wave of chains; a width that is no multiple of the kernel's
#: 4 columns a block; the capacity, one column a block; no steps; negative
#: starts
EDGE_SHAPES = ((1, 1, 5, False), (R, 1, L, False), (1000, 130, 17, False),
               (kernels.CHASE_MAX_ROWS, 2, 8, False), (R, W, 0, False),
               (1000, 130, 17, True))
#: the shared-memory banks of an SM, each a 4-byte word a clock
BANKS = 32

def make_inputs(seed: int = 0, device="cpu", rows: int = R,
                width: int = W, negative: bool = False):
    """The script's inputs, with a full-range u32 table: a seeded [rows,
    width] table and one start row per table row broadcast across the
    columns, in [0, rows), or in [-rows, rows) with `negative`."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(rows, width), dtype=np.uint64)
    idx0 = np.broadcast_to(rng.integers(-rows if negative else 0, rows,
                                        size=(rows, 1)), (rows, width))
    return (torch.from_numpy(table.astype(np.uint32).view(np.int32)).to(
                device),
            torch.from_numpy(np.ascontiguousarray(idx0, dtype=np.int32)).to(
                device))


def int_min_inputs(device="cpu"):
    """make_inputs(0) with one INT_MIN wrap: element (5, 7)'s first step
    gives int32(table) ^ idx == INT_MIN, so its index goes negative (R =
    9,728 does not divide 2^31) and reads row idx + R next."""
    table, idx0 = make_inputs(0, device)
    i0 = int(idx0[5, 7])
    table[i0, 7] = np.int32(-2**31) ^ np.int32(i0)
    return table, idx0


def fullest_bank(rows: int, cols: int, warps: int = 20_000,
                 seed: int = 0) -> float:
    """The mean count of words in the fullest of 32 banks when a warp's 32
    lanes read random rows of a block's `cols` columns (kernels.chase_cols)
    as csrc/gather_chase.cu lays them out: `cols` words a row, lane l on
    column l % cols."""
    rng = np.random.default_rng(seed)
    word = rng.integers(0, rows, (warps, 32)) * cols + np.arange(32) % cols
    hits = np.zeros((warps, BANKS), np.int64)
    np.add.at(hits, (np.arange(warps)[:, None], word % BANKS), 1)
    return float(hits.max(axis=1).mean())


def floor(rows: int, width: int, steps: int, device) -> tuple:
    """(floor_ms, its formula with the values put in): K6's shared-memory
    floor on CUDA `device`, rows x width x steps words, a warp's 32 a load,
    each load as many passes as its fullest bank holds words (fullest_bank
    at the device's chase_cols), one pass a clock on each SM, at the
    device's SM count and clock: steps * rows * width / 32 *
    fullest_bank / (SMs * clock)."""
    props = torch.cuda.get_device_properties(device)
    sms, hz = props.multi_processor_count, props.clock_rate * 1e3
    bank = fullest_bank(rows, kernels.chase_cols(rows, device))
    ms = steps * rows * width / 32 * bank / (sms * hz) * 1e3
    return ms, (f"{steps}*{rows}*{width}/32 loads x {bank:.3f} words in "
                f"the fullest bank / ({sms} SMs x {hz / 1e9:.3f} GHz)")


def _time_ms(fn, reps: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def measure() -> dict:
    """K6 vs its plain version on the card at the script's shape: CUDA-
    event ms per wrapper call (REPS calls after a warm-up; each call reads
    idx0's range back to the host), graph_ms (time_scan.graph_time: the
    entry point on inputs checked once, calls replayed from a CUDA graph,
    the card alone), plain ms (the mean of one call before and one after),
    the max |err|, and floor_ms with floor_formula (floor()). Every
    launch is counted in gather_chase.launches, the graph's captured
    calls too; its replays re-run those launches on the card and add
    none."""
    from .time_scan import graph_time

    table, idx0 = make_inputs(0, "cuda")
    plain1 = _time_ms(lambda: gather_chase_reference(table, idx0), 1)
    want = gather_chase_reference(table, idx0)
    got = gather_chase(table, idx0)              # build + warm-up
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    ms = _time_ms(lambda: gather_chase(table, idx0), REPS)
    kernels._check_chase(table, idx0)

    def checked_once():
        out = torch.empty_like(idx0)
        kernels._chase_launch(table, idx0, L, out)
        return out
    method, graph_ms = graph_time(checked_once)
    plain2 = _time_ms(lambda: gather_chase_reference(table, idx0), 1)
    floor_ms, formula = floor(R, W, L, table.device)
    return {"ms": ms, "graph_ms": graph_ms, "graph_method": method,
            "plain_ms": (plain1 + plain2) / 2, "max_abs_err": err,
            "floor_ms": floor_ms, "floor_formula": formula}


def main(argv=None) -> dict:
    """Times K6 against its plain version, prints the result and returns
    measure()'s dict."""
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_vmem_gather: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    res = measure()
    ns = {k: res[k] * 1e6 / (L * R * W) for k in ("ms", "graph_ms",
                                                   "floor_ms")}
    print(f"gather_chase: {res['ms']:.4f} ms a wrapper call for L={L} "
          f"({ns['ms']:.5f} ns/element/step), {res['graph_ms']:.4f} ms on "
          f"the card alone ({res['graph_method']}; {ns['graph_ms']:.5f} "
          f"ns/element/step); floor {res['floor_ms']:.4f} ms "
          f"({ns['floor_ms']:.5f} ns/element/step: "
          f"{res['floor_formula']}); plain {res['plain_ms']:.3f} ms; max "
          f"|err| vs plain {res['max_abs_err']}")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["max_abs_err"] == 0 else 1)
