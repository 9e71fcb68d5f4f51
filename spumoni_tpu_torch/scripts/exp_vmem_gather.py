"""Microbenchmark: a dependent gather chase over an L2-resident table.

    python -m spumoni_tpu_torch.scripts.exp_vmem_gather

The port of scripts/exp_vmem_gather.py, whose Pallas kernel (`run_pallas`
-> `chase_kernel`) asked whether a table held in the TPU's VMEM beats the
XLA row gather from HBM. Here the same chase runs as K6
`kernels.gather_chase` (csrc/gather_chase.cu): per element (i, j) of an
[R, W] index matrix, L dependent steps of

    idx = rem(abs(int32(table[idx, j]) ^ idx), R)

with jnp.abs's wrap on INT_MIN and lax.rem's sign rule; a negative index
reads row idx + R (take_along_axis's normalisation). The table, R x W u32
(4.98 MB), fits the H100's 50 MB L2. `kernels.gather_chase_reference` is
the plain PyTorch version (a torch.gather loop).

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

from ..engine.kernels import gather_chase, gather_chase_reference

R, W = 9728, 128   # table rows x u32 columns: 4.98 MB
L = 64             # dependent steps per call
REPS = 20          # timed kernel calls after the warm-up


def make_inputs(seed: int = 0, device="cpu"):
    """The script's inputs, with a full-range u32 table: a seeded [R, W]
    table and one start row per lane broadcast across the W columns."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(R, W), dtype=np.uint64)
    idx0 = np.broadcast_to(rng.integers(0, R, size=(R, 1)), (R, W))
    return (torch.from_numpy(table.astype(np.uint32).view(np.int32)).to(
                device),
            torch.from_numpy(np.ascontiguousarray(idx0, dtype=np.int32)).to(
                device))


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
    event ms per call (kernel over REPS calls after a warm-up; plain the
    mean of one call before and one after), and the max |err|."""
    table, idx0 = make_inputs(0, "cuda")
    plain1 = _time_ms(lambda: gather_chase_reference(table, idx0), 1)
    want = gather_chase_reference(table, idx0)
    got = gather_chase(table, idx0)              # build + warm-up
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    ms = _time_ms(lambda: gather_chase(table, idx0), REPS)
    plain2 = _time_ms(lambda: gather_chase_reference(table, idx0), 1)
    return {"ms": ms, "plain_ms": (plain1 + plain2) / 2,
            "max_abs_err": err}


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
    ms = res["ms"]
    print(f"gather_chase: {ms:.4f} ms for L={L}, {ms * 1e3 / L:.2f} us/step, "
          f"{ms * 1e6 / L / R:.3f} ns/lane/step (lane = table row, as the "
          f"script counts), {ms * 1e6 / L / (R * W):.4f} ns/element/step; "
          f"plain {res['plain_ms']:.3f} ms; max |err| vs plain "
          f"{res['max_abs_err']}")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["max_abs_err"] == 0 else 1)
