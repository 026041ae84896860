"""The port's counter-hash dropout against the JAX package (CPU).

The mask is a counter hash of (seed words, NHWC position), so the port's
plain version must give the JAX package's bits exactly: every comparison
here is bit for bit (``np.array_equal``), against both forms of the JAX
function, its jnp lowering (``use_pallas=False``) and its Pallas kernel in
interpret mode. On a CPU tensor the port's op runs its plain version;
``chip_smoke.py`` holds the Triton kernel to it on the card.
"""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from psld_tpu.ops.dropout import hw_dropout
from psld_tpu_torch import ops as tops
from psld_tpu_torch.ops import dropout as tdrop

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SEEDS = {"2w": [123456789, 4000000000], "4w": [1, 2, 0xFFFFFFFF, 7]}


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax(x, jdt, seed, rate, use_pallas):
    with pltpu.force_tpu_interpret_mode():
        out = hw_dropout(jnp.asarray(x).astype(jdt),
                         jnp.asarray(seed, dtype=jnp.uint32), rate,
                         use_pallas)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("seed", sorted(SEEDS))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape,rate", [
    ((2, 8, 8, 32), 0.15),   # a multiple of 128: the Pallas kernel's case
    ((3, 5, 7, 3), 0.15),    # not a multiple of 128: its jnp lowering
    ((2, 4, 4, 16), 0.5),
    ((1, 1, 1, 1), 0.9),
])
def test_hash_dropout_matches_jax_bit_for_bit(shape, rate, dt, seed):
    jdt, tdt = DTYPES[dt]
    x = rand(shape, 1)
    got = tops.hash_dropout(torch.from_numpy(x).to(tdt), SEEDS[seed], rate)
    assert got.dtype == tdt and got.shape == shape
    got = got.float().numpy()
    assert np.array_equal(got, _jax(x, jdt, SEEDS[seed], rate, False))
    assert np.array_equal(got, _jax(x, jdt, SEEDS[seed], rate, True))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_hash_dropout_backward_remasks_the_cotangent(dt):
    """d/dx = mask / (1 - rate), recomputed from the seed alone: the
    gradient equals the JAX package's and the op applied to the
    cotangent."""
    jdt, tdt = DTYPES[dt]
    x, g = rand((2, 4, 4, 32), 2), rand((2, 4, 4, 32), 3)
    seed = SEEDS["2w"]
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    gt = torch.from_numpy(g).to(tdt)
    y = tops.hash_dropout(xt, seed, 0.15)
    # nothing but the seed is saved: no tensor hangs on the graph
    assert y.grad_fn.saved_tensors == ()
    (dx,) = torch.autograd.grad(y, xt, gt)
    assert torch.equal(dx, tops.hash_dropout(gt, seed, 0.15))
    _, pull = jax.vjp(lambda a: hw_dropout(
        a, jnp.asarray(seed, dtype=jnp.uint32), 0.15, False),
        jnp.asarray(x).astype(jdt))
    (want,) = pull(jnp.asarray(g).astype(jdt))
    assert np.array_equal(dx.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_hash_dropout_rate_edges():
    x = torch.from_numpy(rand((2, 3, 4), 4))
    assert tops.hash_dropout(x, [1, 2], 0.0) is x
    assert torch.equal(tops.hash_dropout(x, [1, 2], 1.0),
                       torch.zeros_like(x))
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="rate"):
            tops.hash_dropout(x, [1, 2], bad)
    with pytest.raises(ValueError, match="uint32"):
        tops.hash_dropout(x, [1, 2 ** 32], 0.5)
    with pytest.raises(ValueError, match="elem_off"):
        tops.hash_dropout(x, [1, 2], 0.5, elem_off=2 ** 32)


def test_threshold_and_fold_seed_match_jax():
    from psld_tpu.ops import dropout as jdrop

    for rate in (0.0, 1e-10, 0.15, 0.5, 1.0 - 2.0 ** -33, 1.0):
        assert tdrop.threshold(rate) == jdrop._threshold(rate)
    assert tdrop.threshold(1.0) == 2 ** 32 - 1
    for words in ([5], [5, 6], [5, 6, 7], [5, 6, 7, 8]):
        s0, s1 = jdrop._fold_seed(jnp.asarray(words, dtype=jnp.uint32))
        assert tdrop.fold_seed(words) == (int(s0), int(s1))
        assert tdrop.fold_seed(torch.tensor(words)) == (int(s0), int(s1))


def test_hash_dropout_hashes_the_nhwc_memory_offset():
    """An NCHW-logical channels_last tensor (the layout inside the port's
    network) gets the mask of its NHWC view; a layout that is not dense in
    that order is refused; ``elem_off`` shifts the positions, so a slice
    at its offset draws the whole tensor's mask."""
    x = torch.from_numpy(rand((2, 4, 4, 8), 5))
    want = tops.hash_dropout(x, [5, 6], 0.5)
    inner = x.permute(0, 3, 1, 2)  # NCHW-logical, channels_last memory
    got = tops.hash_dropout(inner, [5, 6], 0.5)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.permute(0, 2, 3, 1), want)
    with pytest.raises(ValueError, match="dense in NHWC"):
        tops.hash_dropout(x.permute(0, 2, 1, 3), [5, 6], 0.5)
    with pytest.raises(ValueError, match="dense in NHWC"):
        tops.hash_dropout(x[..., :5], [5, 6], 0.5)
    half = x[1:]
    assert torch.equal(
        tops.hash_dropout(half, [5, 6], 0.5, elem_off=x[0].numel()), want[1:])


def test_hash_dropout_keeps_the_expected_share():
    x = torch.ones(2 ** 16)
    for rate in (0.15, 0.5):
        kept = (tops.hash_dropout(x, [11, 12], rate) != 0).float().mean()
        sigma = (rate * (1 - rate) / x.numel()) ** 0.5
        assert abs(float(kept) - (1 - rate)) < 4 * sigma


def test_hash_dropout_takes_the_plain_version_on_cpu_only():
    x = torch.from_numpy(rand((2, 4, 4, 8), 6))
    n = tops.hash_dropout.launches
    assert torch.equal(tops.hash_dropout(x, [1, 2], 0.3),
                       tops.hash_dropout_plain(x, [1, 2], 0.3))
    assert tops.hash_dropout.launches == n
    with pytest.raises(ValueError, match="no path for device"):
        tops.hash_dropout(torch.empty((2, 4, 4, 8), device="meta"), [1, 2],
                          0.3)
