"""The port's fused bias + leaky ReLU against the JAX package's (CPU).

``psld_tpu.ops.fused_leaky_relu`` runs two ways here: its jnp lowering
(``use_pallas=False``) and its Pallas kernels in interpret mode (as
``tests/test_ops.py`` runs them). The port runs its plain versions, which
its CUDA kernels are held to bit for bit on the card (``chip_smoke.py``,
``tests/test_torch_kernels.py``).

Tolerances: the forward and ``dx`` are bit-equal to both JAX paths in
float32 and in bfloat16 (the port rounds the constants and every
intermediate to x's dtype, as JAX's weak typing does; see
``psld_tpu_torch/ops/fused_act.py``). ``dbias`` is a sum over every row:
float32 sums taken in another order agree to 1e-6 of the sum's scale, and
in bfloat16 the result is rounded to bf16 once more, so it agrees to one
bf16 unit (2**-8) of its scale.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from psld_tpu.ops import fused_leaky_relu as j_fused
from psld_tpu_torch.ops import fused_act
from psld_tpu_torch.ops import (fused_leaky_relu, fused_leaky_relu_backward,
                                fused_leaky_relu_plain)

SHAPES = [(2, 4, 4, 6),      # NHWC, C = 6
          (1000, 16),        # rows no multiple of the 512-row tile
          (3, 5, 7, 3)]      # C = 3
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
DBIAS_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, b, g


def _jax(x, b, g, jdt, use_pallas):
    """(y, dx, dbias) of the JAX op as float32 numpy; bias stays f32."""
    def f(a, c):
        return j_fused(a, c, 0.2, 2 ** 0.5, use_pallas)

    xj = jnp.asarray(x, jdt)
    y, vjp = jax.vjp(f, xj, jnp.asarray(b))
    dx, db = vjp(jnp.asarray(g, jdt))
    assert db.dtype == jnp.float32
    return [np.asarray(a.astype(jnp.float32)) for a in (y, dx, db)]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("path", ["jnp", "pallas_interpret"])
def test_forward_and_gradients_match_jax(shape, dt, path):
    x, b, g = _inputs(shape, seed=len(shape) + shape[-1])
    tdt, jdt = DTYPES[dt]
    if path == "jnp":
        want = _jax(x, b, g, jdt, use_pallas=False)
    else:
        with pltpu.force_tpu_interpret_mode():
            want = _jax(x, b, g, jdt, use_pallas=True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = fused_leaky_relu(xt, bt)
    assert y.dtype == tdt and y.shape == shape
    dx, db = torch.autograd.grad(y, (xt, bt), torch.from_numpy(g).to(tdt))
    assert dx.dtype == tdt and db.dtype == torch.float32
    np.testing.assert_array_equal(y.detach().float().numpy(), want[0])
    np.testing.assert_array_equal(dx.float().numpy(), want[1])
    np.testing.assert_allclose(
        db.numpy(), want[2], rtol=0,
        atol=DBIAS_TOL[dt] * float(np.abs(want[2]).max()))


def test_bf16_rounds_like_jax_not_once():
    """The trap the port avoids: with the constants in f32 and one
    rounding at the end, bf16 outputs differ from the JAX package's."""
    x, b, _ = _inputs((4, 8, 8, 6), seed=0)
    xt = torch.from_numpy(x).bfloat16()
    bt = torch.from_numpy(b)
    y = (xt + bt.bfloat16()).float()
    once = (torch.where(y >= 0, y, y * 0.2) * 2 ** 0.5).bfloat16()
    want = _jax(x, b, x, jnp.bfloat16, use_pallas=False)[0]
    assert not np.array_equal(once.float().numpy(), want)
    np.testing.assert_array_equal(
        fused_leaky_relu_plain(xt, bt).float().numpy(), want)


def test_gradient_into_x_only_skips_dbias():
    x, b, g = _inputs((2, 3, 3, 8), seed=1)
    xt = torch.from_numpy(x).requires_grad_()
    (dx,) = torch.autograd.grad(fused_leaky_relu(xt, torch.from_numpy(b)),
                                xt, torch.from_numpy(g))
    want, _ = fused_leaky_relu_backward(torch.from_numpy(x),
                                        torch.from_numpy(b),
                                        torch.from_numpy(g))
    assert torch.equal(dx, want)
    assert fused_leaky_relu_backward(torch.from_numpy(x), torch.from_numpy(b),
                                     torch.from_numpy(g),
                                     need_dbias=False)[1] is None


def test_cpu_runs_no_kernel_and_other_devices_raise():
    x, b, _ = _inputs((2, 4), seed=2)
    n = fused_leaky_relu.launches
    fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b))
    assert fused_leaky_relu.launches == n
    with pytest.raises(ValueError, match="no path for device"):
        fused_leaky_relu(torch.empty(2, 4, device="meta"),
                         torch.empty(4, device="meta"))
    assert fused_act._rounded(0.2, torch.bfloat16) == 0.2001953125
    assert fused_act._rounded(2 ** 0.5, torch.bfloat16) == 1.4140625
