"""The hand-written kernels against their plain versions, on the card.

``chip_smoke.py`` holds both kernels to their plain versions at the
flagship's shapes; these tests cover the edges it does not reach: ragged
pixel tiles, widths that are not powers of two, one group per program,
N and C at their limits, and the inputs the wrappers refuse. They need a
CUDA device (the CUDA source is built for sm_90a) and skip without one:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels.py

Tolerances: f32 1e-5 (the same f32 arithmetic, summed in another order);
bf16 1e-2 (one rounding of equal f32 values to the output dtype, which
may fall on either side of a rounding boundary).
"""

import numpy as np
import pytest
import torch

from psld_tpu_torch import ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain attention's f32 einsums in full f32, not TF32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    # the plain GroupNorm's f32 chain, as the kernel computes it
    monkeypatch.setenv("PSLD_GN_BF16", "0")
    return torch.device("cuda")


def rand(shape, seed, dtype, device, scale=1.0, shift=0.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale + shift
    return torch.from_numpy(a.astype(np.float32)).to(device, dtype)


def assert_close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape,groups", [
    ((3, 5, 7, 40), 10),     # ragged pixel tile, 20-channel slices
    ((2, 4, 4, 384), 32),    # 12-channel groups in 24-channel slices
    ((2, 3, 3, 1024), 32),   # one 32-channel group per program
    ((1, 1, 1, 64), 16),     # a single pixel
])
def test_group_norm_act_kernel_matches_plain(card, shape, groups, dtype):
    x = rand(shape, 0, dtype, card, scale=2.0, shift=0.5)
    c = shape[-1]
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    for act in ("none", "swish", "relu", "elu", "lrelu"):
        n = ops.group_norm_act.launches
        got = ops.group_norm_act(x, scale, bias, groups, 1e-6, act)
        assert ops.group_norm_act.launches == n + 1
        assert got.dtype == dtype and got.shape == shape
        want = ops.group_norm_act_plain(x, scale, bias, groups, 1e-6, act)
        assert_close(got, want, TOL[dtype])


def test_group_norm_act_kernel_refuses_what_it_does_not_take(card):
    x = rand((2, 4, 4, 32), 0, torch.float32, card)
    s, b = torch.ones(32, device=card), torch.zeros(32, device=card)
    for bad in (x.double(), x.half(), x.permute(0, 2, 1, 3), x[..., :30]):
        with pytest.raises(ValueError):
            ops.group_norm_act(bad, s, b, 8)
    with pytest.raises(ValueError):
        ops.group_norm_act(x, s.cpu(), b, 8)


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", [(3, 16, 40), (2, 100, 136), (1, 256, 512),
                                   (2, 1, 8), (5, 65, 64)])
def test_attention_kernel_matches_plain(card, shape, dtype):
    q, k, v = (rand(shape, s, dtype, card) for s in (3, 4, 5))
    scale = float(shape[-1]) ** -0.5
    n = ops.attention.launches
    got = ops.attention(q, k, v, scale)
    assert ops.attention.launches == n + 1
    assert got.dtype == dtype and got.shape == shape
    assert_close(got, ops.attention_plain(q, k, v, scale), TOL[dtype])


def test_attention_kernel_refuses_what_it_does_not_take(card):
    def qkv(shape, dtype=torch.float32):
        return [rand(shape, 0, dtype, card)] * 3

    for args in (qkv((2, 257, 64)), qkv((2, 16, 12)), qkv((2, 16, 520)),
                 qkv((2, 16, 64), torch.float64),
                 qkv((2, 16, 64), torch.float16),
                 [t.transpose(1, 2) for t in qkv((2, 64, 64))]):
        with pytest.raises(ValueError):
            ops.attention(*args, 0.125)
