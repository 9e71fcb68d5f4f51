"""K6's plain version against the repo's only Pallas kernel:
gather_chase_reference equals pl.pallas_call(chase_kernel, interpret=True)
from scripts/exp_vmem_gather.py (imported, not edited), exactly, at the
script's shape (R = 9728, W = 128, L = 64) with a full-range u32 table.
Also the kernel's arithmetic that the CPU can check: its remainder by a
host-computed multiplier and shift (kernels._chase_magic), and the
wrapper's capacity check (one column of R rows in a block's shared
memory)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.scripts import exp_vmem_gather as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "exp_vmem_gather_jax", os.path.join(REPO, "scripts",
                                            "exp_vmem_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_chase(script, table, idx0):
    # the script runs without x64 (it does not import spumoni_tpu, which
    # enables it); under x64 lax.rem refuses the kernel's int32 / int64 mix
    with jax.enable_x64(False):
        f = pl.pallas_call(script.chase_kernel, interpret=True,
                           out_shape=jax.ShapeDtypeStruct(
                               (script.R, script.W), jnp.int32))
        return np.asarray(f(jnp.asarray(table.numpy().view(np.uint32)),
                            jnp.asarray(idx0.numpy())))


@pytest.mark.parametrize("int_min", [False, True])
def test_chase_reference_equals_pallas_interpret(script, int_min):
    """Seed 0; with int_min, one lane's first step hits
    int32(table) ^ idx == INT_MIN, where jnp.abs wraps and lax.rem keeps
    the sign, so the index goes negative and reads row idx + R next."""
    assert (port.R, port.W, port.L) == (script.R, script.W, script.L)
    table, idx0 = port.make_inputs(0)
    if int_min:
        i0 = int(idx0[5, 7])
        table[i0, 7] = np.int32(-2**31) ^ np.int32(i0)
    want = _pallas_chase(script, table, idx0)
    got = kernels.gather_chase_reference(table, idx0)
    assert np.array_equal(got.numpy(), want)
    if int_min:
        one = kernels.gather_chase_reference(table, idx0, 1).numpy()
        assert one[5, 7] < 0


def test_wrapper_takes_the_plain_path_on_cpu_only():
    table, idx0 = port.make_inputs(1)
    kernels.reset_launch_counts()
    got = kernels.gather_chase(table[:64], idx0[:64] % 64, 8)
    assert np.array_equal(got.numpy(), kernels.gather_chase_reference(
        table[:64], idx0[:64] % 64, 8).numpy())
    assert kernels.gather_chase.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.gather_chase(table.to("meta"), idx0.to("meta"))
    with pytest.raises(ValueError, match="idx0 must lie"):
        kernels.gather_chase(table[:64], idx0[:64])   # rows up to R - 1 > 63
    assert kernels.gather_chase.launches == 0


#: the remainder's divisors: the named edges (one row, the script's R, the
#: capacity and one under it), primes and powers of two up to the capacity
MAGIC_ROWS = sorted({1, 2, 3, 7, 64, 1000, 9728, 58111, 58112,
                     5, 13, 8191, 9721, 58109,
                     4, 1024, 16384, 32768})


@pytest.mark.parametrize("rows", MAGIC_ROWS)
def test_chase_magic_remainder_equals_rem(rows):
    """K6's remainder, u - R * ((umulhi(u, magic) + u) >> shift) with
    _chase_magic(R)'s multiplier and shift (the kernel adds -R times the
    quotient modulo 2^32: the same value), emulated in uint64, equals
    u % R for every |a| the chase can give: the edges 0, 1, R - 1, R,
    R + 1, 2^31 - 1 and 2^31 (abs(INT_MIN)), and 100,000 seeded draws."""
    magic, shift = kernels._chase_magic(rows)
    assert 0 <= magic < 2**32 and 0 <= shift < 32
    edges = np.array([0, 1, rows - 1, rows, rows + 1, 2**31 - 1, 2**31],
                     np.uint64)
    draws = np.random.default_rng(rows).integers(0, 2**31 + 1, 100_000,
                                                  dtype=np.uint64)
    u = np.concatenate([edges, draws])
    hi = (u * np.uint64(magic)) >> np.uint64(32)          # __umulhi
    total = hi + u
    assert (total < 2**32).all()                          # fits 32 bits
    got = u - np.uint64(rows) * (total >> np.uint64(shift))
    assert np.array_equal(got, u % np.uint64(rows))


def test_chase_capacity_raises_past_one_column_of_shared_memory():
    """K6 holds a column of R rows in a block's shared memory: past
    CHASE_MAX_ROWS = 58,112 the wrapper raises on every device, naming the
    limit, and the plain path still takes R = 58,112 (W = 1, 3 steps)."""
    assert kernels.CHASE_MAX_ROWS == 58_112
    rng = np.random.default_rng(7)
    big = torch.from_numpy(rng.integers(0, 2**32, (58_113, 1),
                                        dtype=np.uint64).astype(np.uint32)
                           .view(np.int32))
    start = torch.from_numpy(rng.integers(-58_112, 58_112, (58_113, 1))
                             .astype(np.int32))
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="at most R = 58112"):
        kernels.gather_chase(big, start, 3)
    table, idx0 = big[:58_112].contiguous(), start[:58_112].contiguous()
    got = kernels.gather_chase(table, idx0, 3)
    assert np.array_equal(got.numpy(), kernels.gather_chase_reference(
        table, idx0, 3).numpy())
    assert (idx0 < 0).any() and got.shape == (58_112, 1)
    assert kernels.gather_chase.launches == 0


@pytest.mark.parametrize("rows,cols", [(1, 4), (9728, 4), (14_528, 4),
                                       (14_529, 1), (58_112, 1),
                                       (58_113, 0)])
def test_chase_cols_chooses_the_columns_a_block_holds(rows, cols):
    """kernels.chase_cols alone chooses K6's column count (the entry point
    takes it): CHASE_COLS columns of R rows where they fit the opt-in
    shared memory (the H100's 232,448 bytes off the card), one column
    past R = 14,528, none past the capacity."""
    assert kernels.chase_smem("cpu") == kernels.H100_SMEM_OPTIN
    assert kernels.chase_cols(rows) == cols
