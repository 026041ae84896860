"""The port's plain ops against the JAX package (CPU).

GroupNorm+act and attention are held against both forms of the JAX
function: its jnp reference and its Pallas kernel run in interpret mode.
On a CPU tensor the port's op runs its plain PyTorch version, so these
tests pin that version; ``chip_smoke.py`` holds the CUDA kernels against
it on the card.

Tolerances: f32 1e-5 (the same f32 arithmetic, summed in another order).
bf16 with the f32 chain: 1e-2 relative, one bf16 rounding of equal f32
values that may fall on either side of a rounding boundary. bf16 with
``gn_bf16`` (the chain itself in bf16): 3e-2, a few bf16 roundings that
XLA and PyTorch place differently.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from psld_tpu.config import ConfigDict
from psld_tpu.ops import attention as jattn
from psld_tpu.ops import group_norm as jgn
from psld_tpu.ops import upfirdn as jfir
from psld_tpu_torch import knobs
from psld_tpu_torch import ops as tops
from psld_tpu_torch.ops import upfirdn as tfir
from test_torch_ncsnpp import jit_o0

ACTS = ["none", "swish", "silu", "relu", "elu", "lrelu"]


def rand(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _j(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _gn_inputs(c):
    x = rand((2, 4, 4, c), 1, scale=2.0, shift=0.5)
    return x, rand((c,), 2) + 1.0, rand((c,), 3)


_JAX_GN = {}


def _jax_gn(dt, c, gn16):
    """{act: (reference, interpret-mode Pallas kernel)} for one (dtype, C,
    gn_bf16): one jitted program covers every activation, and the results
    are kept for the other parametrized cases of the file. The kernel
    ignores gn_bf16, so it runs only in the gn_bf16=0 program, and
    gn_bf16 changes nothing for f32 inputs, which share that program."""
    if dt == "f32":
        gn16 = "0"
    key = (dt, c, gn16)
    if key not in _JAX_GN:
        x, scale, bias = _gn_inputs(c)
        g = min(c // 4, 32)

        def every_act(x_, s_, b_):
            return {a: (jgn.group_norm_act_reference(x_, s_, b_, g, 1e-6, a),
                        None if gn16 == "1" else jgn.fused_group_norm_act(
                            x_, s_, b_, g, 1e-6, a, force=True))
                    for a in ACTS}

        with pltpu.force_tpu_interpret_mode():
            out = jit_o0(every_act, _j(x, DTYPES[dt][0]), jnp.asarray(scale),
                         jnp.asarray(bias))
        _JAX_GN[key] = {a: (_np(r), None if k is None else _np(k))
                        for a, (r, k) in out.items()}
    return _JAX_GN[key]


@pytest.mark.parametrize("c", [128, 384])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_group_norm_act_matches_jax(monkeypatch, act, dt, c):
    jdt, tdt, tol = DTYPES[dt]
    g = min(c // 4, 32)
    x, scale, bias = _gn_inputs(c)
    for gn16, gtol in (("1", 3e-2 if dt == "bf16" else tol), ("0", tol)):
        # both packages read gn_bf16 from the environment at call (JAX:
        # trace) time
        monkeypatch.setenv("PSLD_GN_BF16", gn16)
        want, kern = _jax_gn(dt, c, gn16)[act]
        got = tops.group_norm_act(_t(x, tdt), torch.from_numpy(scale),
                                  torch.from_numpy(bias), g, 1e-6, act)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), want, rtol=gtol, atol=gtol,
                                   err_msg=f"reference, gn_bf16={gn16}")
    # the Pallas kernel ignores gn_bf16: its chain is f32, like the
    # port's plain version with gn_bf16 off
    np.testing.assert_allclose(_np(got), kern, rtol=tol, atol=tol,
                               err_msg="Pallas kernel (interpret mode)")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 128), (2, 256, 256)])
def test_attention_matches_jax(shape, dt):
    jdt, tdt, tol = DTYPES[dt]
    q, k, v = (rand(shape, s) for s in (10, 11, 12))
    scale = float(shape[-1]) ** -0.5
    got = tops.attention(*(_t(a, tdt) for a in (q, k, v)), scale)
    assert got.dtype == tdt and got.shape == shape
    jq, jk, jv = (_j(a, jdt) for a in (q, k, v))
    want = _np(jattn.fused_attention(jq, jk, jv, scale, force=False))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    with pltpu.force_tpu_interpret_mode():
        kern = _np(jattn.fused_attention(jq, jk, jv, scale, force=True))
    np.testing.assert_allclose(_np(got), kern, rtol=tol, atol=tol)


def test_gn_bf16_is_latched_from_the_config_and_env_overrides(monkeypatch):
    monkeypatch.setattr(knobs, "_gn_bf16", None)
    monkeypatch.delenv("PSLD_GN_BF16", raising=False)
    assert not knobs.gn_bf16()
    knobs.configure(ConfigDict({"model": {"score_fn": {"gn_bf16": True}}}))
    assert knobs.gn_bf16()
    knobs.configure(ConfigDict({"model": {"score_fn": {}}}))
    assert knobs.gn_bf16()  # an unset key leaves the latched value
    monkeypatch.setenv("PSLD_GN_BF16", "0")
    assert not knobs.gn_bf16()


def test_wrappers_take_the_plain_version_on_cpu_only():
    """A CPU tensor runs the plain version and counts no launch; a tensor
    on another device is refused, never computed some other way."""
    x = _t(rand((2, 4, 4, 32), 20), torch.float32)
    s, b = torch.ones(32), torch.zeros(32)
    n_gn, n_at = tops.group_norm_act.launches, tops.attention.launches
    torch.testing.assert_close(
        tops.group_norm_act(x, s, b, 8, 1e-6, "swish"),
        tops.group_norm_act_plain(x, s, b, 8, 1e-6, "swish"),
        rtol=0, atol=0)
    q = x.reshape(2, 16, 32)
    torch.testing.assert_close(tops.attention(q, q, q, 0.5),
                               tops.attention_plain(q, q, q, 0.5),
                               rtol=0, atol=0)
    assert (tops.group_norm_act.launches, tops.attention.launches) == \
        (n_gn, n_at)
    meta = torch.empty((2, 4, 4, 32), device="meta")
    with pytest.raises(ValueError):
        tops.group_norm_act(meta, s, b, 8)
    with pytest.raises(ValueError):
        tops.attention(meta.reshape(2, 16, 32), meta.reshape(2, 16, 32),
                       meta.reshape(2, 16, 32), 0.5)


FIR_CASES = [
    # (k, up, down, pad)
    ([1, 3, 3, 1], 2, 1, (2, 1)),
    ([1, 3, 3, 1], 1, 2, (1, 1)),
    ([1, 3, 3, 1], 1, 1, (2, 2)),
    ([1, 1], 2, 1, (1, 0)),
    ([1, 2, 1], 2, 1, (1, 1)),
    ([1, 3, 3, 1], 1, 1, (-1, 2)),
]


@pytest.mark.parametrize("k,up,down,pad", FIR_CASES)
def test_upfirdn2d_matches_jax(k, up, down, pad):
    x = rand((2, 8, 8, 5), 30)
    kern = jfir.setup_kernel(k)
    want = np.asarray(jfir.upfirdn2d(jnp.asarray(x), jnp.asarray(kern),
                                     up=up, down=down, pad=pad))
    got = tfir.upfirdn2d(torch.from_numpy(x), kern, up=up, down=down,
                         pad=pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [None, [1, 3, 3, 1]])
def test_fir_resampling_matches_jax(k):
    x = rand((2, 8, 8, 6), 31)
    w = rand((3, 3, 6, 4), 32)  # HWIO, the JAX layout
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (tfir.upsample_2d(tx, k), jfir.upsample_2d(jx, k)),
        (tfir.downsample_2d(tx, k), jfir.downsample_2d(jx, k)),
        (tfir.upsample_conv_2d(tx, w_oihw, k),
         jfir.upsample_conv_2d(jx, jnp.asarray(w), k)),
        (tfir.conv_downsample_2d(tx, w_oihw, k),
         jfir.conv_downsample_2d(jx, jnp.asarray(w), k)),
        (tfir.naive_upsample_2d(tx), jfir.naive_upsample_2d(jx)),
        (tfir.naive_downsample_2d(tx), jfir.naive_downsample_2d(jx)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_upsample_output_is_channels_last():
    """The NHWC public ops keep NHWC memory end to end."""
    x = torch.from_numpy(rand((2, 8, 8, 6), 33))
    y = tfir.upsample_2d(x, [1, 3, 3, 1])
    assert y.is_contiguous()


# -- gradients ----------------------------------------------------------------
# On the CPU the port's ops differentiate their plain versions; held here
# to jax.grad through the JAX package's custom VJPs (Pallas forward in
# interpret mode, backward through the jnp chain). f32: rtol 1e-5 of the
# gradient's scale, the same f32 arithmetic summed in another order.

def _grad_close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("act", ["none", "swish", "relu", "elu", "lrelu"])
def test_group_norm_act_gradients_match_jax(monkeypatch, act):
    monkeypatch.setenv("PSLD_GN_BF16", "0")
    c = 128
    g = min(c // 4, 32)
    x, scale, bias = _gn_inputs(c)
    ct = rand(x.shape, 4)

    def f(x_, s_, b_):
        y = jgn.fused_group_norm_act(x_, s_, b_, g, 1e-6, act, force=True)
        return jnp.sum(y * jnp.asarray(ct))

    with pltpu.force_tpu_interpret_mode():
        want = jit_o0(jax.grad(f, argnums=(0, 1, 2)), jnp.asarray(x),
                      jnp.asarray(scale), jnp.asarray(bias))
    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    got = tops.group_norm_act_backward(*args, torch.from_numpy(ct), g, 1e-6,
                                       act)
    leaves = [a.clone().requires_grad_() for a in args]
    auto = torch.autograd.grad(
        tops.group_norm_act(*leaves, g, 1e-6, act), leaves,
        torch.from_numpy(ct))
    for a, b_, w in zip(got, auto, want):
        _grad_close(a, w, 1e-5)
        _grad_close(b_, w, 1e-5)


def test_group_norm_act_gradient_bf16_follows_gn_bf16(monkeypatch):
    """bf16 input: the gradient of the bf16-rounded chain (gn_bf16 on) and
    of the f32 chain (off) against the JAX package's, 3e-2 and 1e-2 of the
    gradient's scale as for the forward."""
    c, g = 128, 32
    x, scale, bias = _gn_inputs(c)
    ct = rand(x.shape, 4)
    for gn16, tol in (("1", 3e-2), ("0", 1e-2)):
        monkeypatch.setenv("PSLD_GN_BF16", gn16)

        def f(x_):
            y = jgn.group_norm_act_reference(
                x_, jnp.asarray(scale), jnp.asarray(bias), g, 1e-6, "swish")
            return jnp.sum(y.astype(jnp.float32) * jnp.asarray(ct))

        want = jit_o0(jax.grad(f), _j(x, jnp.bfloat16))
        dx, _, _ = tops.group_norm_act_backward(
            _t(x, torch.bfloat16), torch.from_numpy(scale),
            torch.from_numpy(bias), _t(ct, torch.bfloat16), g, 1e-6, "swish")
        assert dx.dtype == torch.bfloat16
        _grad_close(dx, _np(want), tol)


@pytest.mark.parametrize("shape", [(2, 64, 128), (2, 256, 64)])
def test_attention_gradients_match_jax(shape):
    q, k, v = (rand(shape, s) for s in (10, 11, 12))
    ct = rand(shape, 13)
    scale = float(shape[-1]) ** -0.5

    def f(q_, k_, v_):
        return jnp.sum(jattn.fused_attention(q_, k_, v_, scale, force=True)
                       * jnp.asarray(ct))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (q, k, v)))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    chain = tops.attention_backward(*args, scale, torch.from_numpy(ct))
    leaves = [a.clone().requires_grad_() for a in args]
    auto = torch.autograd.grad(tops.attention(*leaves, scale), leaves,
                               torch.from_numpy(ct))
    for a, b_, w in zip(chain, auto, want):
        _grad_close(a, w, 1e-5)
        _grad_close(b_, w, 1e-5)
