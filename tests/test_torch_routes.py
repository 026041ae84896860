"""The shapes the hand kernels refuse, on the CPU: the predicates that
route them (``ops.group_norm_fits``, ``ops.group_norm_split_fits``,
``ops.attention_fits``) agree with the kernels' own checks, and the model
layers at such shapes match the JAX package, whose dispatchers run their
jnp chains there (``psld_tpu/ops/group_norm.py::fused_group_norm_act``,
``psld_tpu/ops/attention.py::fused_attention``).

On the CPU the port always runs its plain versions, so the layer cases
pin what the route on the card computes; the card tests
(``tests/test_torch_kernels.py``, ``*_routes_past_*``) pin that the card
takes that route and launches no kernel there.

Tolerances: forward rtol 1e-5, atol 1e-5 in float32 (the same arithmetic
summed in another order by XLA and PyTorch), 1e-2 in bfloat16 (one
rounding to the output dtype); input gradients within 1e-4 of their
largest magnitude.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.models import layers as JL
from psld_tpu.ops import group_norm as jgn
from psld_tpu_torch import ops
from psld_tpu_torch.interop.from_flax import load_flax_params
from psld_tpu_torch.models.layers import AttnBlock, GroupNormAct
from psld_tpu_torch.ops import group_norm as tgn
from test_torch_ncsnpp import jit_o0

# the module: the package exports its function under the same name
tattn = importlib.import_module("psld_tpu_torch.ops.attention")

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _accepts(fn) -> bool:
    try:
        fn()
    except ValueError:
        return False
    return True


def _gn_checks(shape, dtype, groups) -> bool:
    """Whether the fused kernels' checks take an x of ``shape``: the
    argument check of both ops, then both planners."""
    x = torch.empty(shape, dtype=dtype)
    hw = shape[1] * shape[2] if len(shape) == 4 else 1

    def run():
        tgn._check_kernel_args("group_norm_act", x, None, None, groups)
        tgn.plan_forward(hw, shape[-1], groups, dtype, shape[0])
        tgn.plan_backward(hw, shape[-1], groups, dtype)

    return _accepts(run)


GN_GRID = [(b, c, g) for b in (1, 3) for c, gs in (
    (3, (1, 3)), (4, (1, 2)), (8, (2, 3)), (12, (3, 4)), (16, (4,)),
    (40, (10, 7)), (96, (24, 32)), (129, (3, 32)), (384, (32,)),
    (1024, (32, 1)), (1025, (5,)), (2048, (32,))) for g in gs]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_group_norm_fits_agrees_with_the_kernels_checks(dtype):
    for b, c, g in GN_GRID:
        shape = (b, 4, 3, c)
        assert ops.group_norm_fits(shape, dtype, g) == _gn_checks(
            shape, dtype, g), (shape, g)
    # not 4D
    assert not ops.group_norm_fits((4, 3, 8), dtype, 2)
    assert not _gn_checks((4, 3, 8), dtype, 2)
    # the layers' widths: bf16 C = 4 and 12 have no 16-byte slice
    want = {4: dtype == torch.float32, 12: dtype == torch.float32,
            2048: False}
    for c, fits in want.items():
        assert ops.group_norm_fits((2, 4, 4, c), dtype, min(c // 4, 32)) \
            == fits, c


def test_group_norm_split_fits_agrees_with_the_split_checks():
    for dtype in DTYPES:
        for b, c, g in GN_GRID + [(65535, 4, 1), (65536, 4, 1)]:
            x = torch.empty((b, 1, 1, c), dtype=dtype)
            checked = _accepts(lambda: tgn._split_kernel_args(
                "group_norm_split_stats", x, None, None, g))
            assert tgn.group_norm_split_fits(x.shape, dtype, g) == checked, \
                (b, c, g, dtype)
    # the split entries take the scalar widths the fused kernels refuse
    assert tgn.group_norm_split_fits((2, 4, 4, 12), torch.bfloat16, 3)
    assert not tgn.group_norm_split_fits((2, 4, 4, 2048), torch.float32, 32)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_attention_fits_agrees_with_the_kernels_checks(dtype):
    for shape in [(2, 1, 8), (2, 256, 512), (2, 257, 64), (2, 1024, 256),
                  (2, 16, 12), (2, 16, 4), (2, 16, 520), (2, 16, 8),
                  (65535, 2, 8), (65536, 2, 8), (2, 0, 8), (2, 16, 16, 8)]:
        q = torch.empty(shape, dtype=dtype)
        checked = _accepts(lambda: tattn._check_kernel_args(q, q, q))
        assert ops.attention_fits(shape, dtype) == checked, shape
        assert ops.attention_fits(shape, dtype) == (
            dtype != torch.float16 and len(shape) == 3
            and 1 <= shape[1] <= 256 and 8 <= shape[2] <= 512
            and shape[2] % 8 == 0 and shape[0] <= 65535), shape


def _draw(tree, seed):
    """A flax param tree's shapes filled from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2 + (
            1.0 if len(s.shape) == 1 else 0.0)).astype(np.float32), tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_attn_block_past_the_kernels_tokens_matches_jax():
    """The port's ``AttnBlock`` at N = 1,024 tokens (32 x 32, C = 16;
    the attention kernel takes N <= 256) against the JAX package's, whose
    ``fused_attention`` takes its einsum route there, on the same weights
    through the converter: forward within 1e-5 (f32), the input gradient
    within 1e-4 of its scale."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 16)).astype(np.float32)
    ct = rng.standard_normal((2, 32, 32, 16)).astype(np.float32)
    jmod = JL.AttnBlock(init_scale=0.1)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros(x.shape))
    params = _draw(shapes, 1)

    def fwd_and_vjp(a, c):
        out, vjp = jax.vjp(lambda v: jmod.apply(params, v), a)
        return out, vjp(c)[0]

    want, want_dx = jit_o0(fwd_and_vjp, jnp.asarray(x), jnp.asarray(ct))
    mod = load_flax_params(AttnBlock(16, init_scale=0.1), params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = mod(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(ct).permute(
        0, 3, 1, 2))
    _close(y.detach().permute(0, 2, 3, 1), want, 1e-5)
    dx = dx.permute(0, 2, 3, 1).numpy()
    assert float(np.abs(dx - np.asarray(want_dx)).max()) <= 1e-4 * float(
        np.abs(np.asarray(want_dx)).max())


@pytest.mark.parametrize("act", ["swish", "none"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_group_norm_act_past_the_kernels_width_matches_jax(monkeypatch, act,
                                                           dtype):
    """``GroupNormAct`` at C = 2,048 (the kernels take C <= 1,024) against
    the JAX package's ``fused_group_norm_act`` (its jnp chain there), with
    ``gn_bf16`` off: forward within 1e-5 (f32) or 1e-2 (bf16); in f32 the
    input gradient within 1e-4 of its scale."""
    monkeypatch.setenv("PSLD_GN_BF16", "0")
    jdt, tdt, tol = {"f32": (jnp.float32, torch.float32, 1e-5),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}[dtype]
    rng = np.random.default_rng(2)
    c = 2048
    x = (rng.standard_normal((2, 2, 3, c)) * 2 + 0.5).astype(np.float32)
    ct = rng.standard_normal((2, 2, 3, c)).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.1 + 1).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    mod = GroupNormAct(c, act=act)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = mod.forward_nhwc(xt)
    assert y.dtype == tdt and not ops.group_norm_fits(y.shape, tdt, 32)

    def fwd_and_vjp(a, c):
        out, vjp = jax.vjp(lambda v: jgn.fused_group_norm_act(
            v, jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6, act), a)
        return out, vjp(c.astype(out.dtype))[0]

    want, want_dx = jit_o0(fwd_and_vjp, jnp.asarray(x).astype(jdt),
                           jnp.asarray(ct))
    _close(y.detach().float(), jnp.asarray(want, jnp.float32), tol)
    if dtype == "f32":
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
        want_dx = np.asarray(want_dx)
        assert float(np.abs(dx.numpy() - want_dx).max()) <= 1e-4 * float(
            np.abs(want_dx).max())
