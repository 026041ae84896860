"""The port's NCSNv1/v2 component library against the JAX package's, on the
CPU: every class of ``models/normalization.py`` and
``models/legacy_layers.py``, ``get_normalization``'s branches and errors,
and ``utils/legacy.py``.

Inputs come from ``np.random.default_rng``; each flax param tree is made
once per test module (shapes from ``jax.eval_shape`` of the flax init,
values drawn from a seeded numpy generator: the inits' zero biases and
betas would hide a mismatch) and reaches the port through
``interop/from_flax.py``, strictly. Conditional classes take labels ``y``.

Tolerances: forward rtol 1e-5, atol 1e-5 (float32, the same arithmetic
summed in another order by XLA and PyTorch); input gradients within 1e-4
of their largest magnitude; ``utils/legacy`` exactly, with equal dtypes.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from psld_tpu.config import ConfigDict as JConfigDict
from psld_tpu.models import legacy_layers as JL
from psld_tpu.models import normalization as JN
from psld_tpu.utils import legacy as jlegacy
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.interop.from_flax import (flax_to_state_dict,
                                              load_flax_params)
from psld_tpu_torch.models import legacy_layers as L
from psld_tpu_torch.models import normalization as N
from psld_tpu_torch.utils import legacy

K = 3             # classes
C = 16            # channels
SHAPE = (8, 8)    # the output size of the multi-input blocks


def _cfg(cls, norm):
    return cls({"model": {"normalization": norm, "num_classes": K}})


# case -> (JAX module, port module, inputs); inputs: "x" (2, 8, 8, C),
# "x7" (2, 7, 7, C) (adjust_padding halves 8 rows), "xy" x and labels,
# "xs" two inputs (C at 8x8, 8 at 4x4), "xs1" one input, "xsy" two
# inputs and labels
CASES = {
    # normalization.py
    "InstanceNorm2d": (JN.InstanceNorm2d(), N.InstanceNorm2d(C), "x"),
    "VarianceNorm2d": (JN.VarianceNorm2d(C), N.VarianceNorm2d(C), "x"),
    "NoneNorm2d": (JN.NoneNorm2d(), N.NoneNorm2d(C), "x"),
    "InstanceNorm2dPlus": (JN.InstanceNorm2dPlus(C),
                           N.InstanceNorm2dPlus(C), "x"),
    "InstanceNorm2dPlus_nobias": (JN.InstanceNorm2dPlus(C, bias=False),
                                  N.InstanceNorm2dPlus(C, bias=False), "x"),
    **{f"{name}{tag}": (getattr(JN, name)(C, K, bias=bias),
                        getattr(N, name)(C, K, bias=bias), "xy")
       for name in ("ConditionalBatchNorm2d", "ConditionalInstanceNorm2d",
                    "ConditionalNoneNorm2d", "ConditionalInstanceNorm2dPlus")
       for tag, bias in (("", True), ("_nobias", False))},
    "ConditionalVarianceNorm2d": (JN.ConditionalVarianceNorm2d(C, K),
                                  N.ConditionalVarianceNorm2d(C, K), "xy"),
    # legacy_layers.py
    "CRPBlock_max": (JL.CRPBlock(C, 2), L.CRPBlock(C, 2), "x"),
    "CRPBlock_avg": (JL.CRPBlock(C, 2, maxpool=False),
                     L.CRPBlock(C, 2, maxpool=False), "x"),
    "CondCRPBlock": (JL.CondCRPBlock(C, 2, K), L.CondCRPBlock(C, 2, K), "xy"),
    "RCUBlock": (JL.RCUBlock(C, 2, 2), L.RCUBlock(C, 2, 2), "x"),
    "CondRCUBlock": (JL.CondRCUBlock(C, 2, 2, K), L.CondRCUBlock(C, 2, 2, K),
                     "xy"),
    "MSFBlock": (JL.MSFBlock(12), L.MSFBlock([C, 8], 12), "xs"),
    "CondMSFBlock": (JL.CondMSFBlock(12, K), L.CondMSFBlock([C, 8], 12, K),
                     "xsy"),
    "RefineBlock_end_avg": (JL.RefineBlock(12, end=True, maxpool=False),
                            L.RefineBlock([C, 8], 12, end=True,
                                          maxpool=False), "xs"),
    "RefineBlock_one_input": (JL.RefineBlock(C, start=True),
                              L.RefineBlock([C], C, start=True), "xs1"),
    "CondRefineBlock": (JL.CondRefineBlock(12, K, end=True),
                        L.CondRefineBlock([C, 8], 12, K, end=True), "xsy"),
    "ConvMeanPool": (JL.ConvMeanPool(12), L.ConvMeanPool(C, 12), "x"),
    "ConvMeanPool_1x1_nobias": (JL.ConvMeanPool(12, 1, biases=False),
                                L.ConvMeanPool(C, 12, 1, biases=False), "x"),
    "ConvMeanPool_adjust_padding": (
        JL.ConvMeanPool(12, adjust_padding=True),
        L.ConvMeanPool(C, 12, adjust_padding=True), "x7"),
    "MeanPoolConv": (JL.MeanPoolConv(12), L.MeanPoolConv(C, 12), "x"),
    "UpsampleConv": (JL.UpsampleConv(12), L.UpsampleConv(C, 12), "x"),
    "ResidualBlock": (JL.ResidualBlock(C), L.ResidualBlock(C, C), "x"),
    "ResidualBlock_widen": (JL.ResidualBlock(24), L.ResidualBlock(C, 24),
                            "x"),
    "ResidualBlock_dilation2": (JL.ResidualBlock(24, dilation=2),
                                L.ResidualBlock(C, 24, dilation=2), "x"),
    "ResidualBlock_down": (JL.ResidualBlock(24, "down"),
                           L.ResidualBlock(C, 24, "down"), "x"),
    "ResidualBlock_down_dilation2": (
        JL.ResidualBlock(24, "down", dilation=2),
        L.ResidualBlock(C, 24, "down", dilation=2), "x"),
    "ResidualBlock_down_adjust_padding_GroupNorm": (
        JL.ResidualBlock(24, "down", adjust_padding=True,
                         normalization=JN.get_normalization(
                             _cfg(JConfigDict, "GroupNorm"))),
        L.ResidualBlock(C, 24, "down", adjust_padding=True,
                        normalization=N.get_normalization(
                            _cfg(ConfigDict, "GroupNorm"))), "x7"),
    "ResidualBlock_InstanceNorm++": (
        JL.ResidualBlock(24, normalization=JN.InstanceNorm2dPlus),
        L.ResidualBlock(C, 24, normalization=N.InstanceNorm2dPlus), "x"),
    "ConditionalResidualBlock": (JL.ConditionalResidualBlock(C, K),
                                 L.ConditionalResidualBlock(C, C, K), "xy"),
    "ConditionalResidualBlock_dilation2": (
        JL.ConditionalResidualBlock(24, K, dilation=2),
        L.ConditionalResidualBlock(C, 24, K, dilation=2), "xy"),
    "ConditionalResidualBlock_down": (
        JL.ConditionalResidualBlock(24, K, "down"),
        L.ConditionalResidualBlock(C, 24, K, "down"), "xy"),
    "ConditionalResidualBlock_down_dilation2_relu": (
        JL.ConditionalResidualBlock(24, K, "down", act=jax.nn.relu,
                                    dilation=2),
        L.ConditionalResidualBlock(C, 24, K, "down", act=F.relu,
                                   dilation=2), "xy"),
}
# the input gradient is checked through these
GRAD_CASES = ("ResidualBlock_dilation2", "ConditionalResidualBlock_down",
              "CondRefineBlock")


def _inputs(kind: str, seed: int):
    """(JAX args, port args): numpy NHWC inputs, the port's NCHW in
    ``channels_last`` memory."""
    rng = np.random.default_rng(seed)

    def x(h, c=C):
        return rng.standard_normal((2, h, h, c)).astype(np.float32)

    y = np.array([0, 2])
    args = {"x": lambda: (x(8),), "x7": lambda: (x(7),),
            "xy": lambda: (x(8), y), "xs": lambda: ([x(8), x(4, 8)], SHAPE),
            "xs1": lambda: ([x(8)], SHAPE),
            "xsy": lambda: ([x(8), x(4, 8)], y, SHAPE)}[kind]()
    return args, tuple(_port(a) for a in args)


def _port(a):
    if isinstance(a, list):
        return [_port(v) for v in a]
    if isinstance(a, np.ndarray) and a.ndim == 4:
        return torch.from_numpy(a.transpose(0, 3, 1, 2)).contiguous(
            memory_format=torch.channels_last)
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a)
    return a


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _draw(path, leaf, rng):
    """A random leaf: a kernel N(0, 1/fan-in), a bias 0.1 N(0, 1), every
    gain or table 1 + 0.1 N(0, 1)."""
    name = path[-1].key
    if name == "kernel":
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    if name == "bias":
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)


def _random_params(jmod, jargs, seed: int):
    """A flax param tree for ``jmod`` on ``jargs``: shapes from
    ``jax.eval_shape`` of its init (a trailing output shape is static),
    leaves from :func:`_draw`."""
    static = jargs[-1:] if isinstance(jargs[-1], tuple) else ()
    arrays = jargs[:len(jargs) - len(static)]
    shapes = jax.eval_shape(lambda k, *a: jmod.init(k, *a, *static),
                            jax.random.PRNGKey(0), *arrays)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(lambda p, a: _draw(p, a, rng),
                                            shapes)


@pytest.fixture(scope="module")
def flax_params():
    """case -> its flax param tree (numpy leaves), made once a module."""
    made = {}

    def get(case):
        if case not in made:
            jmod, _, kind = CASES[case]
            made[case] = _random_params(jmod, _inputs(kind, 0)[0],
                                        sum(map(ord, case)))
        return made[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case, flax_params):
    jmod, pmod, kind = CASES[case]
    jargs, targs = _inputs(kind, 1)
    params = flax_params(case)
    load_flax_params(pmod, params)
    want = np.asarray(jmod.apply(params, *jargs))
    with torch.no_grad():
        got = _nhwc(pmod(*targs))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_input_gradient_matches_jax(case, flax_params):
    """The cotangent pulled back into every input (x, or each of xs)."""
    jmod, pmod, kind = CASES[case]
    jargs, targs = _inputs(kind, 2)
    params = flax_params(case)
    load_flax_params(pmod, params)
    multi = kind[:2] == "xs"
    xs = jargs[0]
    rest = jargs[1:]

    def f(xs):
        return jmod.apply(params, xs, *rest)

    out_shape = jax.eval_shape(f, xs).shape
    ct = np.random.default_rng(3).standard_normal(out_shape).astype(
        np.float32)
    # one program at XLA's lowest optimization level: the eager VJP
    # compiles every transposed op on its own, several times slower
    run = jax.jit(lambda xs, ct: jax.vjp(f, xs)[1](ct)[0]).lower(
        xs, ct).compile(compiler_options={"xla_backend_optimization_level": 0})
    want = run(xs, ct)
    leaves = [t.requires_grad_() for t in (targs[0] if multi
                                           else [targs[0]])]
    out = pmod(leaves if multi else leaves[0], *targs[1:])
    got = torch.autograd.grad(out, leaves, _port(ct))
    for g, w in zip(got, want if multi else [want], strict=True):
        w = np.asarray(w)
        err = np.abs(_nhwc(g) - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (case, err)


def test_upsample_conv_scrambles_channels_as_the_reference():
    """Before its conv, output channel k of each 2x2 cell (di, dj) reads
    input channel (4k + 2 di + dj) mod C (an identity 1x1 conv shows it)."""
    c = 6
    mod = L.UpsampleConv(c, c, kernel_size=1, biases=False)
    with torch.no_grad():
        mod.conv.weight.copy_(torch.eye(c)[:, :, None, None])
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, c, 3, 5)).astype(np.float32))
    with torch.no_grad():
        up = mod(x)
    for k in range(c):
        for di in range(2):
            for dj in range(2):
                assert torch.equal(up[:, k, di::2, dj::2],
                                   x[:, (4 * k + 2 * di + dj) % c])


NORMS = ("InstanceNorm", "InstanceNorm++", "VarianceNorm", "GroupNorm")


@pytest.mark.parametrize("conditional,norm",
                         [(False, n) for n in NORMS]
                         + [(True, "InstanceNorm++")])
def test_get_normalization_matches_jax(conditional, norm):
    """Each branch's factory, given the channel count, against the JAX
    one's module on the same input and params."""
    jmod = JN.get_normalization(_cfg(JConfigDict, norm), conditional)(
        features=C)
    pmod = N.get_normalization(_cfg(ConfigDict, norm), conditional)(
        features=C)
    assert not (norm == "GroupNorm") or isinstance(pmod, N.GroupNormAct)
    jargs, targs = _inputs("xy" if conditional else "x", 5)
    params = _random_params(jmod, jargs, 6)
    load_flax_params(pmod, params)
    with torch.no_grad():
        got = _nhwc(pmod(*targs))
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, *jargs)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("conditional,norm,error", [
    (True, "GroupNorm", NotImplementedError),
    (True, "VarianceNorm", NotImplementedError),
    (False, "BatchNorm", ValueError),
])
def test_get_normalization_raises_where_jax_raises(conditional, norm, error):
    with pytest.raises(error):
        JN.get_normalization(_cfg(JConfigDict, norm), conditional)
    with pytest.raises(error, match=norm):
        N.get_normalization(_cfg(ConfigDict, norm), conditional)


@pytest.mark.parametrize("cond", [False, True])
def test_invalid_resample_raises_as_jax(cond):
    x = np.zeros((1, 4, 4, 4), np.float32)
    y = np.zeros(1, np.int32)
    jmod = JL.ConditionalResidualBlock(4, K, "up") if cond \
        else JL.ResidualBlock(4, "up")
    with pytest.raises(ValueError, match="invalid resample"):
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                       *((x, y) if cond else (x,)))
    with pytest.raises(ValueError, match="invalid resample"):
        if cond:
            L.ConditionalResidualBlock(4, 4, K, "up")
        else:
            L.ResidualBlock(4, 4, "up")


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_strict_conversion_raises_on_a_missing_or_extra_leaf(
        fault, flax_params):
    params = jax.tree_util.tree_map(np.asarray,
                                    flax_params("CondRefineBlock"))
    params = {k: dict(v) for k, v in params["params"].items()}
    if fault == "missing":
        params["CondRCUBlock_0"] = {
            k: v for k, v in params["CondRCUBlock_0"].items()
            if k != "Conv_1"}
    else:
        params["CondMSFBlock_0"]["Conv_9"] = {
            "kernel": np.zeros((3, 3, 8, 12), np.float32)}
    with pytest.raises(KeyError):
        flax_to_state_dict({"params": params}, CASES["CondRefineBlock"][1])


@pytest.mark.parametrize("args", [(0.01, 50.0, 232), (0.01, 1.0, 10),
                                  (1e-3, 348.0, 1086)])
def test_get_sigmas_is_the_jax_packages(args):
    got, want = legacy.get_sigmas(*args), jlegacy.get_sigmas(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [(), (0.1, 20.0, 1000), (0.5, 5.0, 37)])
def test_get_ddpm_params_is_the_jax_packages(args):
    got, want = legacy.get_ddpm_params(*args), jlegacy.get_ddpm_params(*args)
    assert got.keys() == want.keys()
    for k in want:
        assert type(got[k]) is type(want[k]), k
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


WIDE = 512  # enough draws for the init statistics


@pytest.mark.parametrize("name", ["VarianceNorm2d", "InstanceNorm2dPlus",
                                  "ConditionalInstanceNorm2dPlus",
                                  "ConditionalInstanceNorm2d",
                                  "ConditionalVarianceNorm2d", "Conv"])
def test_inits_follow_the_jax_ones_in_distribution(name):
    """N(1, 0.02) gains, uniform [0, 1) class gains with zero biases,
    ``[N(1, 0.02) x 2, 0]`` for the conditional InstanceNorm++, and
    lecun-normal conv kernels (times ``init_scale``, 0 -> 1e-10)."""
    torch.manual_seed(0)
    if name == "Conv":
        w = L.ncsn_conv3x3(WIDE, 8).weight.detach()
        assert abs(float(w.std()) * np.sqrt(9 * WIDE) - 1.0) < 0.05
        assert float(w.abs().max()) <= 2 / np.sqrt(9 * WIDE) / L._TRUNC_STD
        tiny = L.ncsn_conv3x3(8, 8, init_scale=0).weight.detach()
        assert 0 < float(tiny.abs().max()) < 1e-9
        assert float(L.ncsn_conv1x1(8, 8).bias.detach().abs().max()) == 0
        return
    mod = getattr(N, name)(*((WIDE,) if "Conditional" not in name
                             else (WIDE, 50)))
    sd = mod.state_dict()

    def normal(t):
        assert abs(float(t.mean()) - 1) < 5e-3
        assert abs(float(t.std()) - 0.02) < 5e-3

    if name in ("VarianceNorm2d", "InstanceNorm2dPlus"):
        normal(sd["alpha"])
        if "gamma" in sd:
            normal(sd["gamma"])
            assert float(sd["beta"].abs().max()) == 0
        return
    table = sd["_ClassEmbed_0.embedding"]
    if name == "ConditionalVarianceNorm2d":
        normal(table)
    elif name == "ConditionalInstanceNorm2dPlus":
        normal(table[:, :2 * WIDE])
        assert float(table[:, 2 * WIDE:].abs().max()) == 0
    else:
        gain = table[:, :WIDE]
        assert 0 <= float(gain.min()) and float(gain.max()) < 1
        assert abs(float(gain.mean()) - 0.5) < 0.01
        assert float(table[:, WIDE:].abs().max()) == 0
