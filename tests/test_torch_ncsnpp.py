"""The port's NCSN++ against the JAX package's, on converted weights (CPU).

Every parameter is drawn from a seeded numpy normal (shapes from
``jax.eval_shape``), not from either package's init: ``init_scale=0``
zero-inits the output conv, which would hide a mismatch upstream of it.

Tolerances, relative to the output's largest magnitude:

* float32: 1e-4. The same f32 arithmetic through ~30 layers, with
  convolutions and GroupNorm sums taken in another order by XLA and by
  PyTorch's CPU kernels.
* bfloat16 (the sampler's ``evaluation.bf16`` network): 3e-2. Every layer
  rounds its output to bf16 (8 significant bits, 4e-3 relative); the two
  frameworks place a few of those roundings differently, and the
  differences add up through ~30 layers (about 1e-2 on this input).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.models.ncsnpp import NCSNpp as JNCSNpp
from psld_tpu_torch.eval.generate import make_score_fn
from psld_tpu_torch.interop.from_flax import (flax_to_state_dict,
                                              load_flax_params)
from psld_tpu_torch.models.ncsnpp import NCSNpp

# the flagship option set (psld_tpu/eval/bench.py) at reduced size
FLAGSHIP_TINY = dict(image_size=16, in_ch=6, out_ch=6, nf=16, ch_mult=(2, 2),
                     num_res_blocks=1, attn_resolutions=(8,), dropout=0.15,
                     fir=True, embedding_type="fourier",
                     progressive_input="residual")

# further rows of the tests/test_ncsnpp.py matrix, several options to a
# row: between them the rows take every resampling path (FIR and naive,
# with and without a conv, up and down), both block types, both time
# embeddings and every progressive mode
VARIANTS = {
    "flagship": {},
    "ddpm_positional": dict(resblock_type="ddpm", fir=False,
                            embedding_type="positional",
                            progressive_input="none"),
    "ddpm_fir_output_skip_input_skip_cat": dict(
        resblock_type="ddpm", progressive="output_skip",
        progressive_input="input_skip", progressive_combine="cat"),
    "biggan_naive_positional_residual_input_skip_sum": dict(
        fir=False, embedding_type="positional", progressive="residual",
        progressive_input="input_skip", progressive_combine="sum"),
}

FLAGSHIP_FULL = dict(image_size=32, in_ch=6, out_ch=6, nf=128,
                     ch_mult=(2, 2, 2), num_res_blocks=8,
                     attn_resolutions=(16,), dropout=0.15, fir=True,
                     embedding_type="fourier", progressive_input="residual")


def random_flax_params(net, kw, seed, scale=0.25):
    """A flax param tree for ``net`` with every leaf N(0, scale^2)."""
    s, c = kw["image_size"], kw["in_ch"]
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, s, s, c), jnp.float32),
                            jnp.full((1,), 0.5, jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
        shapes)


def jit_o0(fn, *args):
    """``jax.jit(fn)(*args)``, compiled at XLA's lowest backend
    optimization level: these programs run once, and that halves their
    CPU compile time."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled(*args)


_PAIRS = {}


def tiny_pair(variant="flagship"):
    """(JAX net, flax params, port net with those params), built once per
    variant for the whole test process."""
    if variant not in _PAIRS:
        kw = {**FLAGSHIP_TINY, **VARIANTS[variant]}
        jnet = JNCSNpp(**kw)
        params = random_flax_params(jnet, kw, seed=1)
        net = load_flax_params(NCSNpp(**kw), params).eval()
        _PAIRS[variant] = (jnet, params, net)
    return _PAIRS[variant]


def inputs(b=2, s=16, c=6, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, s, c)).astype(np.float32)
    t = np.linspace(0.1, 0.9, b).astype(np.float32)
    return x, t


def assert_close_to_scale(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    jnet, params, net = tiny_pair(variant)
    x, t = inputs()
    want = jit_o0(jnet.apply, params, jnp.asarray(x), jnp.asarray(t))
    with torch.inference_mode():
        got = net(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (2, 16, 16, 6) and got.dtype == torch.float32
    assert got.is_contiguous()  # NHWC out, from channels_last inside
    assert_close_to_scale(got.numpy(), want, 1e-4)


def test_bf16_score_fn_matches_jax():
    """``evaluation.bf16``: bf16 weights and input, f32 time embedding
    (flax promotes an f32 input with bf16 weights), f32 output."""
    jnet, params, net = tiny_pair()
    x, t = inputs()
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                 params)
    want = jit_o0(lambda p, z, tt: jnet.apply(
        p, z.astype(jnp.bfloat16), tt).astype(jnp.float32),
        p16, jnp.asarray(x), jnp.asarray(t))
    with torch.inference_mode():
        got = make_score_fn(net, bf16=True)(torch.from_numpy(x),
                                            torch.from_numpy(t))
    assert got.dtype == torch.float32
    assert_close_to_scale(got.numpy(), want, 3e-2)


def test_flagship_param_count():
    """The full flagship, built on the meta device (no memory), has the
    JAX package's 97,627,910 parameters."""
    with torch.device("meta"):
        net = NCSNpp(**FLAGSHIP_FULL)
    assert sum(p.numel() for p in net.parameters()) == 97_627_910
    n_gn = sum(1 for n, _ in net.named_modules()
               if n.rsplit(".", 1)[-1].startswith("GroupNormAct_"))
    n_attn = sum(1 for n, _ in net.named_modules()
                 if n.rsplit(".", 1)[-1].startswith("AttnBlock_"))
    assert (n_gn, n_attn) == (125, 10)


def test_converter_is_strict_both_ways():
    _, params, net = tiny_pair()
    inner = params["params"]
    sd = flax_to_state_dict(inner, net)  # the unwrapped tree maps too
    assert set(sd) == set(net.state_dict())
    conv = inner["Conv_0"]["kernel"]
    assert tuple(sd["Conv_0.weight"].shape) == (conv.shape[3], conv.shape[2],
                                               conv.shape[0], conv.shape[1])

    extra = {**inner, "Extra_0": {"bias": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="no such parameter"):
        flax_to_state_dict(extra, net)
    missing = {k: v for k, v in inner.items() if k != "Conv_0"}
    with pytest.raises(KeyError, match="no flax leaf"):
        flax_to_state_dict(missing, net)
    wrong = {**inner, "Conv_0": {**inner["Conv_0"],
                                 "bias": np.zeros(5, np.float32)}}
    with pytest.raises(ValueError, match="flax shape"):
        flax_to_state_dict(wrong, net)


def test_train_mode_is_refused():
    _, _, net = tiny_pair()
    x, t = inputs()
    with pytest.raises(NotImplementedError, match="training slice"):
        net(torch.from_numpy(x), torch.from_numpy(t), train=True)
