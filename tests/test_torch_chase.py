"""K6's plain version against the repo's only Pallas kernel:
gather_chase_reference equals pl.pallas_call(chase_kernel, interpret=True)
from scripts/exp_vmem_gather.py (imported, not edited), exactly, at the
script's shape (R = 9728, W = 128, L = 64) with a full-range u32 table."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
