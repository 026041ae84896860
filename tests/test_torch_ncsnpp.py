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

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
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


def compile_o0(fn, *args):
    """``fn`` (jitted or not) compiled once for the shapes of ``args`` at
    XLA's lowest backend optimization level: these programs run a few
    times, and that halves their CPU compile time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def jit_o0(fn, *args):
    """``jax.jit(fn)(*args)``, compiled by :func:`compile_o0`."""
    return compile_o0(fn, *args)(*args)


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
    """Train mode with a hash dropout and no seed words is refused, as is
    a seed list that does not match the sites; with ``save_mask`` a
    train-mode forward drops from the generator it is given."""
    _, params, net = tiny_pair()
    x, t = (torch.from_numpy(a) for a in inputs())
    hashed = load_flax_params(
        NCSNpp(**FLAGSHIP_TINY, dropout_impl="hw"), params)
    assert hashed.dropout_sites == 10
    with pytest.raises(ValueError, match="needs dropout_seeds"):
        hashed(x, t, train=True)
    with pytest.raises(ValueError, match="only 9 seeds"):
        hashed(x, t, train=True, dropout_seeds=[(1, 2)] * 9)
    with pytest.raises(ValueError, match="11 dropout seeds for 10 sites"):
        hashed(x, t, train=True, dropout_seeds=[(1, 2)] * 11)
    with torch.no_grad():
        a, b = (net(x, t, train=True,
                    generator=torch.Generator().manual_seed(s))
                for s in (0, 0))
        c = net(x, t, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, net(x, t))


@pytest.mark.parametrize("impl", ["hw_inline", "hw"])
def test_train_mode_hash_dropout_matches_jax(monkeypatch, impl):
    """A train-mode forward with the counter-hash dropout against the JAX
    package's, on the same seed words per site. The JAX side runs eagerly
    with ``psld_tpu.ops.hw_dropout`` wrapped to record each site's words
    in call order; the port is handed that list. Tolerance as for the
    eval-mode forward: 1e-4 of the output's scale."""
    import psld_tpu.ops as jops

    jnet = JNCSNpp(**FLAGSHIP_TINY, dropout_impl=impl)
    _, params, _ = tiny_pair()
    x, t = inputs()
    seeds, real = [], jops.hw_dropout

    def recording(x_, seed, rate, use_pallas=None):
        seeds.append(tuple(int(w) for w in np.asarray(seed)))
        return real(x_, seed, rate, False)

    monkeypatch.setattr(jops, "hw_dropout", recording)
    want = jnet.apply(params, jnp.asarray(x), jnp.asarray(t), train=True,
                      rngs={"dropout": jax.random.PRNGKey(7)})
    net = load_flax_params(NCSNpp(**FLAGSHIP_TINY, dropout_impl=impl), params)
    assert len(seeds) == net.dropout_sites == 10
    assert len(set(seeds)) == 10  # every site its own words
    got = net(torch.from_numpy(x), torch.from_numpy(t), train=True,
              dropout_seeds=seeds)
    assert_close_to_scale(got.detach().numpy(), want, 1e-4)
    # and it is not the eval-mode output
    with torch.no_grad():
        ev = net(torch.from_numpy(x), torch.from_numpy(t))
    assert float((got.detach() - ev).abs().max()) > 1e-3 * float(
        ev.abs().max())


def test_default_init_follows_the_jax_initializers():
    """``init_parameters``: a weight of each kind (plain conv, a block's
    last conv with ``init_scale`` 0, NIN, the attention's last NIN, a
    Dense) is uniform within the bound of the JAX package's
    ``default_init`` for that layer and spread over most of it; biases 0,
    GroupNorm scale 1, Fourier W ~ N(0, 16^2)."""
    from psld_tpu.models.layers import default_init
    from psld_tpu_torch.models.layers import init_parameters

    net = init_parameters(NCSNpp(**FLAGSHIP_TINY),
                          torch.Generator().manual_seed(0))
    sd = net.state_dict()
    for key, scale in [("Conv_0.weight", 1.0),
                       ("ResnetBlockBigGAN_0.Conv_1.weight", 0.0),
                       ("AttnBlock_0.NIN_0.Dense_0.weight", 0.1),
                       ("AttnBlock_0.NIN_3.Dense_0.weight", 0.0),
                       ("ResnetBlockBigGAN_0.Dense_0.weight", 1.0)]:
        p = sd[key]
        shape = tuple(p.shape[2:]) + (p.shape[1], p.shape[0])  # HWIO / IO
        want = np.asarray(default_init(scale)(jax.random.PRNGKey(0), shape,
                                              jnp.float32))
        # two uniform draws of one bound: maxima within 25% (>= 500 values)
        ratio = float(p.abs().max()) / float(np.abs(want).max())
        assert 0.75 < ratio < 1.33, (key, ratio)
    for key, p in sd.items():
        if key.endswith("bias"):
            assert not p.any(), key
        elif key.endswith("scale"):
            assert torch.equal(p, torch.ones_like(p)), key
    w = sd["GaussianFourierProjection_0.W"]
    assert abs(float(w.std()) / 16.0 - 1.0) < 0.5
