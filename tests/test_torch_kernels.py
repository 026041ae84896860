"""The hand-written kernels against their plain versions, on the card.

``chip_smoke.py`` holds the kernels to their plain versions at the
flagship's shapes; these tests cover the edges it does not reach: ragged
pixel tiles, widths that are not powers of two (C=320 is the AFHQ width),
one group per program, N and C at their limits, odd sizes and offsets for
the dropout hash, finite differences for the GroupNorm backward, the
guidance classifier's shapes (GroupNorm at H*W = 16, attention over N =
16 tokens) and a gradient into the input alone, attention at token
counts that fill no key tile and widths that are no multiple of 16, the
GroupNorm backward over a cluster of blocks at H*W = 1024, one capture
and replay of each redesigned kernel in a CUDA graph, rows and channels of the
fused bias + leaky ReLU that fit no vector width, the GroupNorm kernels
under ``gn_bf16`` against the plain version's bf16 chain, the GroupNorm
variant of the legacy normalizers at its edge widths, the strided
dropout at ragged image slices, the split GroupNorm stats at widths
with and without whole 16-byte pieces (bit-equal from launch to launch,
one kernel a call), the split apply at the edges of its plan (the
scalar path, a piece over two groups, one pixel row, a partial last
tile, one tile and many a batch element), and the inputs the wrappers
refuse (a misaligned x among them). They need a
CUDA device (the CUDA source is built for sm_90a) and skip without one:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels.py

Tolerances: f32 1e-5 (the same f32 arithmetic, summed in another order);
bf16 1e-2 (one rounding of equal f32 values to the output dtype, which
may fall on either side of a rounding boundary). Under ``gn_bf16`` the
GroupNorm forward is held bit for bit on at least ``GN_BF16_EQUAL`` of
the elements and to the bf16 tolerance on the rest (a sum in another
order can move a group's mean or rstd across a bf16 rounding boundary),
its backward to 1e-2 of each gradient's scale. The dropout and fused
bias + leaky ReLU kernels are held bit for bit.
"""

import numpy as np
import pytest
import torch

from psld_tpu_torch import ops

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
GN_BF16_EQUAL = 0.99
ACTS = ("none", "swish", "relu", "elu", "lrelu")


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
    # contiguous, but 4 bytes past a 16-byte boundary
    off = torch.zeros(1 + x.numel(), device=card)[1:].view(x.shape)
    for bad in (x.double(), x.half(), x.permute(0, 2, 1, 3), x[..., :30],
                off):
        with pytest.raises(ValueError):
            ops.group_norm_act(bad, s, b, 8)
    with pytest.raises(ValueError):
        ops.group_norm_act(x, s.cpu(), b, 8)


GN_BF16_SHAPES = [
    ((4, 32, 32, 256), 32),  # the flagship's H*W = 1024, C = 256
    ((4, 8, 8, 512), 32),    # its H*W = 64, C = 512
    ((3, 5, 7, 40), 10),     # ragged pixel tile, 20-channel slices
]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,groups", GN_BF16_SHAPES)
def test_group_norm_act_kernel_follows_gn_bf16(card, monkeypatch, shape,
                                               groups, act):
    """Under gn_bf16 a bf16 x runs the plain version's bf16 chain: at
    least GN_BF16_EQUAL of the elements bit-equal, the rest within the
    bf16 tolerance. The share tells the chains apart: the plain f32 chain
    against the plain bf16 chain falls below it."""
    x = rand(shape, 0, torch.bfloat16, card, 2.0, 0.5)
    c = shape[-1]
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    f32_chain = ops.group_norm_act_plain(x, scale, bias, groups, 1e-6, act)
    monkeypatch.setenv("PSLD_GN_BF16", "1")
    got = ops.group_norm_act(x, scale, bias, groups, 1e-6, act)
    want = ops.group_norm_act_plain(x, scale, bias, groups, 1e-6, act)
    assert_close(got, want, TOL[torch.bfloat16])
    assert float((got == want).float().mean()) >= GN_BF16_EQUAL
    assert float((f32_chain == want).float().mean()) < GN_BF16_EQUAL


def test_group_norm_act_kernel_replays_from_a_cuda_graph(card, monkeypatch):
    shape = (4, 32, 32, 256)
    x = rand(shape, 0, torch.bfloat16, card, 2.0, 0.5)
    scale = rand((256,), 2, torch.bfloat16, card, 0.1, 1.0)
    bias = rand((256,), 3, torch.bfloat16, card, 0.1)
    for on in ("0", "1"):
        monkeypatch.setenv("PSLD_GN_BF16", on)
        n = ops.group_norm_act.launches
        got = _graph_replay(lambda: ops.group_norm_act(
            x, scale, bias, 32, 1e-6, "swish"))
        assert ops.group_norm_act.launches == n + 2
        assert torch.equal(got, ops.group_norm_act(x, scale, bias, 32, 1e-6,
                                                   "swish"))


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", [(3, 16, 40), (2, 100, 136), (1, 256, 512),
                                   (2, 1, 8), (5, 65, 64),
                                   (64, 16, 256)])  # the classifier's middle
def test_attention_kernel_matches_plain(card, shape, dtype):
    q, k, v = (rand(shape, s, dtype, card) for s in (3, 4, 5))
    scale = float(shape[-1]) ** -0.5
    n = ops.attention.launches
    got = ops.attention(q, k, v, scale)
    assert ops.attention.launches == n + 1
    assert got.dtype == dtype and got.shape == shape
    assert_close(got, ops.attention_plain(q, k, v, scale), TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("c", [8, 24, 136, 320, 512])
@pytest.mark.parametrize("n", [1, 16, 65, 100, 255, 256])
def test_attention_kernel_ragged_tokens_and_widths(card, n, c, dtype):
    """Token counts that fill no key tile (keys past N must score -inf,
    not 0) and widths that are no multiple of 16 (zero channels pad the
    tensor-core k-steps)."""
    shape = (2, n, c)
    q, k, v = (rand(shape, s, dtype, card, scale=2.0) for s in (6, 7, 8))
    scale = float(c) ** -0.5
    got = ops.attention(q, k, v, scale)
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


GN_BWD_SHAPES = [
    ((3, 5, 7, 40), 10),     # ragged pixel tile, 20-channel slices
    ((2, 4, 4, 256), 32),    # the classifier's 4x4 level: H*W = 16
    ((2, 16, 16, 128), 32),  # the classifier's C = 128 at H*W = 256
    ((2, 16, 16, 320), 32),  # the AFHQ width: 10-channel groups
    ((1, 8, 8, 256), 32),    # B=1, H*W=64
    ((2, 3, 3, 1024), 32),   # one 32-channel group per program
    ((1, 1, 1, 64), 16),     # a single pixel: every variance is 0
    ((2, 32, 32, 256), 32),  # H*W = 1024 over a cluster of blocks
    ((2, 32, 32, 320), 32),  # the AFHQ width at H*W = 1024
]


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape,groups", GN_BWD_SHAPES)
def test_group_norm_act_backward_kernel_matches_plain(card, shape, groups,
                                                      dtype):
    """dx, dscale, dbias against autograd through the plain version, for
    every activation. f32: 1e-4 of each gradient's scale (sums over up to
    H*W*B terms in another order, through rstd up to 1e3 at the
    single-pixel shape); bf16: 2e-2 of scale (one rounding of dx, and
    inputs that are themselves bf16)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    x = rand(shape, 0, dtype, card, scale=2.0, shift=0.5)
    g = rand(shape, 3, dtype, card)
    c = shape[-1]
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    for act in ("none", "swish", "relu", "elu", "lrelu"):
        n = ops.group_norm_act_backward.launches
        got = ops.group_norm_act_backward(x, scale, bias, g, groups, 1e-6,
                                          act)
        assert ops.group_norm_act_backward.launches == n + 1
        want = ops.group_norm_act_backward_plain(x, scale, bias, g, groups,
                                                 1e-6, act)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape
            ref = float(w.float().abs().max()) + 1e-6
            err = float((a.float() - w.float()).abs().max())
            assert err <= tol * ref, (act, err, ref)


# CelebA-HQ's 256 x 256 level at C = 256, batch 72: 1.21e9 elements,
# 2.42e9 bytes in bf16, past 2**31, where a byte offset held in a 32-bit
# int would wrap (a sampling batch of 64 is 2**31 bytes exactly)
HUGE = (72, 256, 256, 256)
HUGE_CHUNK = 8  # batch elements a plain version's call takes


def test_kernels_past_two_to_the_31_bytes(card):
    """The GroupNorm forward and backward and the dropout kernels on a
    bf16 tensor of 2**31 bytes, against their plain versions, which run
    ``HUGE_CHUNK`` batch elements at a time (GroupNorm normalizes each
    batch element alone; dropout is held with each chunk's element
    offset; dscale and dbias are the chunks' sums): the tolerances of the
    tests above, dropout bit for bit."""
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(HUGE, generator=gen, device=card,
                    dtype=torch.bfloat16) * 2 + 0.5
    g = torch.randn(HUGE, generator=gen, device=card, dtype=torch.bfloat16)
    c, groups = HUGE[-1], 32
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    assert x.numel() * x.element_size() > 2 ** 31
    y = ops.group_norm_act(x, scale, bias, groups, 1e-6, "swish")
    dx, ds, db = ops.group_norm_act_backward(x, scale, bias, g, groups, 1e-6,
                                             "swish")
    seed = (12345, 678910)
    drop = ops.hash_dropout(x, seed, 0.2)
    torch.cuda.synchronize()
    sums = [torch.zeros_like(scale), torch.zeros_like(bias)]
    dx_err = dx_ref = 0.0
    per = HUGE_CHUNK * x[0].numel()
    for i in range(0, HUGE[0], HUGE_CHUNK):
        sl = slice(i, i + HUGE_CHUNK)
        want = ops.group_norm_act_plain(x[sl], scale, bias, groups, 1e-6,
                                        "swish")
        assert_close(y[sl], want, TOL[torch.bfloat16])
        wdx, wds, wdb = ops.group_norm_act_backward_plain(
            x[sl], scale, bias, g[sl], groups, 1e-6, "swish")
        dx_err = max(dx_err, float((dx[sl].float() - wdx.float()).abs()
                                   .max()))
        dx_ref = max(dx_ref, float(wdx.float().abs().max()))
        sums[0] += wds
        sums[1] += wdb
        assert torch.equal(drop[sl], ops.hash_dropout_plain(
            x[sl], seed, 0.2, elem_off=(i // HUGE_CHUNK) * per))
    assert dx_err <= 2e-2 * dx_ref, (dx_err, dx_ref)
    for got, want in zip((ds, db), sums):
        ref = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2e-2 * ref


@pytest.mark.parametrize("gn16", [False, True], ids=["f32chain", "gn_bf16"])
@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape,groups",
                         [((3, 32, 32, 128), 32)] + GN_BWD_SHAPES)
def test_group_norm_act_backward_kernel_input_gradient_alone(
        card, monkeypatch, shape, groups, dtype, gn16):
    """need_params=False (classifier guidance, the likelihood's
    divergence) gives dx alone, equal to the full call's dx, and within
    the tolerance of autograd through the plain version at every edge
    shape, under gn_bf16 too (bf16 only: an f32 x runs the f32 chain
    whatever it says)."""
    monkeypatch.setenv("PSLD_GN_BF16", "1" if gn16 else "0")
    c = shape[-1]
    x = rand(shape, 0, dtype, card, scale=2.0, shift=0.5)
    g = rand(shape, 3, dtype, card)
    scale = rand((c,), 1, dtype, card, 0.1, 1.0)
    bias = rand((c,), 2, dtype, card, 0.1)
    n = ops.group_norm_act_backward.launches
    dx, ds, db = ops.group_norm_act_backward(x, scale, bias, g, groups,
                                             1e-6, "swish", need_params=False)
    assert ops.group_norm_act_backward.launches == n + 1
    assert ds is None and db is None
    full = ops.group_norm_act_backward(x, scale, bias, g, groups, 1e-6,
                                       "swish")
    want = ops.group_norm_act_backward_plain(x, scale, bias, g, groups, 1e-6,
                                             "swish")
    torch.cuda.synchronize()
    assert torch.equal(dx, full[0])
    tol = 1e-4 if dtype == torch.float32 else (1e-2 if gn16 else 2e-2)
    ref = float(want[0].float().abs().max()) + 1e-6
    assert float((dx.float() - want[0].float()).abs().max()) <= tol * ref


def _graph_replay(fn):
    """fn()'s outputs from one capture into a CUDA graph and a replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # builds and loads outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def test_attention_kernel_replays_from_a_cuda_graph(card):
    q, k, v = (rand((4, 256, 256), s, torch.bfloat16, card) for s in (0, 1, 2))
    got = _graph_replay(lambda: ops.attention(q, k, v, 0.0625))
    assert torch.equal(got, ops.attention(q, k, v, 0.0625))


def test_group_norm_act_backward_kernel_replays_from_a_cuda_graph(card):
    shape = (4, 32, 32, 256)
    x = rand(shape, 0, torch.bfloat16, card, 2.0, 0.5)
    g = rand(shape, 1, torch.bfloat16, card)
    scale = rand((256,), 2, torch.bfloat16, card, 0.1, 1.0)
    bias = rand((256,), 3, torch.bfloat16, card, 0.1)
    got = _graph_replay(lambda: ops.group_norm_act_backward(
        x, scale, bias, g, 32, 1e-6, "swish"))
    want = ops.group_norm_act_backward(x, scale, bias, g, 32, 1e-6, "swish")
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_group_norm_act_autograd_goes_through_both_kernels(card):
    """``group_norm_act`` on a CUDA tensor that requires grad: forward and
    backward each launch their kernel once, and the gradients match
    central finite differences of the plain version, summed in float64
    (step 1e-2, tolerance 2e-2 of the gradient's scale)."""
    x = rand((2, 4, 4, 32), 0, torch.float32, card, 2.0, 0.5).requires_grad_()
    scale = rand((32,), 1, torch.float32, card, 0.1, 1.0).requires_grad_()
    bias = rand((32,), 2, torch.float32, card, 0.1).requires_grad_()
    ct = rand((2, 4, 4, 32), 3, torch.float32, card)
    n_f, n_b = ops.group_norm_act.launches, \
        ops.group_norm_act_backward.launches
    y = ops.group_norm_act(x, scale, bias, 8, 1e-6, "swish")
    dx, dscale, dbias = torch.autograd.grad(y, (x, scale, bias), ct)
    assert ops.group_norm_act.launches == n_f + 1
    assert ops.group_norm_act_backward.launches == n_b + 1

    def f(x_, s_, b_):
        return float((ops.group_norm_act_plain(
            x_, s_, b_, 8, 1e-6, "swish").double() * ct.double()).sum())

    h = 1e-2
    with torch.no_grad():
        for got, which, idx in ((dx, 0, (1, 2, 3, 5)), (dx, 0, (0, 0, 1, 17)),
                                (dscale, 1, (7,)), (dbias, 2, (30,))):
            args = [x.detach().clone(), scale.detach().clone(),
                    bias.detach().clone()]
            args[which][idx] += h
            up = f(*args)
            args[which][idx] -= 2 * h
            fd = (up - f(*args)) / (2 * h)
            ref = float(got.abs().max())
            assert abs(float(got[idx]) - fd) <= 2e-2 * ref, (which, idx)


@pytest.mark.parametrize("shape,groups", GN_BF16_SHAPES + [
    ((2, 4, 4, 256), 32),    # the classifier's 4x4 level: H*W = 16
    ((2, 32, 32, 384), 32),  # 12-channel groups
])
def test_group_norm_act_backward_kernel_follows_gn_bf16(card, monkeypatch,
                                                        shape, groups):
    """Under gn_bf16 the backward kernel differentiates the bf16 chain:
    dx, dscale and dbias within 1e-2 of each gradient's scale of autograd
    through the plain version's bf16 chain, for every activation. At the
    kink of relu and leaky relu the two can take z's sign apart (where a
    group's mean or rstd rounds the other way), and such an element's dx
    differs by its whole size: there at most 1e-3 of dx may lie outside."""
    monkeypatch.setenv("PSLD_GN_BF16", "1")
    x = rand(shape, 0, torch.bfloat16, card, 2.0, 0.5)
    g = rand(shape, 3, torch.bfloat16, card)
    c = shape[-1]
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    for act in ACTS:
        got = ops.group_norm_act_backward(x, scale, bias, g, groups, 1e-6,
                                          act)
        want = ops.group_norm_act_backward_plain(x, scale, bias, g, groups,
                                                 1e-6, act)
        torch.cuda.synchronize()
        for a, w, name in zip(got, want, ("dx", "dscale", "dbias")):
            assert a.dtype == w.dtype and a.shape == w.shape
            ref = float(w.float().abs().max()) + 1e-6
            diff = (a.float() - w.float()).abs()
            if name == "dx" and act in ("relu", "lrelu"):
                assert float((diff > 1e-2 * ref).float().mean()) <= 1e-3
            else:
                assert float(diff.max()) <= 1e-2 * ref, (act, name)


def test_group_norm_act_backward_kernel_refuses_what_it_does_not_take(card):
    x = rand((2, 4, 4, 32), 0, torch.float32, card)
    s, b = torch.ones(32, device=card), torch.zeros(32, device=card)
    off = torch.zeros(1 + x.numel(), device=card)[1:].view(x.shape)
    for bad_g in (x.bfloat16(), x.permute(0, 2, 1, 3), x[:1], off):
        with pytest.raises(ValueError):
            ops.group_norm_act_backward(x, s, b, bad_g, 8)
    with pytest.raises(ValueError):
        ops.group_norm_act_backward(x.double(), s, b, x.double(), 8)


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape,off", [
    ((1, 1, 1, 1), 0), ((3, 5, 7, 3), 0), ((2, 16, 16, 320), 12345),
    ((1, 8, 8, 256), 2 ** 32 - 1000),  # positions wrap mod 2**32
    ((4099,), 77),
])
def test_hash_dropout_kernel_matches_plain_bit_for_bit(card, shape, off,
                                                       dtype):
    x = rand(shape, 0, dtype, card)
    for seed, rate in (([123456789, 4000000000], 0.15), ([1, 1], 0.5),
                       ([1, 2, 0xFFFFFFFF, 7], 0.9)):
        n = ops.hash_dropout.launches
        got = ops.hash_dropout(x, seed, rate, elem_off=off)
        assert ops.hash_dropout.launches == n + 1
        want = ops.hash_dropout_plain(x, seed, rate, elem_off=off)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape,row", [
    ((2, 4, 4, 3), 1),      # 48 positions a row: offsets 48, 96, 144
    ((3, 5, 7, 3), 2),      # 105 a row: the first row of 128 part-filled
    ((4, 8, 8, 256), 2),    # a rank's rows at the flagship's widths
    ((6, 1, 1, 129), 5),    # shorter than the part-filled first row
])
def test_hash_dropout_kernel_at_a_ranks_row_offset(card, shape, row, dtype):
    """A rank's rows of a batch, dropped at their flat offset ``row *
    H*W*C`` (``elem_off``, rarely a multiple of 128 here), are the whole
    batch's dropout rows, bit for bit, forward and backward."""
    x = rand(shape, 3, dtype, card)
    seed, rate = [987654321, 12345], 0.15
    whole = ops.hash_dropout(x, seed, rate)
    off = row * x[0].numel()
    part = x[row:].detach().clone().requires_grad_()
    got = ops.hash_dropout(part, seed, rate, elem_off=off)
    assert torch.equal(got, whole[row:])
    assert torch.equal(got, ops.hash_dropout_plain(part.detach(), seed, rate,
                                                   elem_off=off))
    ct = rand(part.shape, 4, dtype, card)
    (dx,) = torch.autograd.grad(got, part, ct)
    assert torch.equal(dx, ops.hash_dropout_plain(ct, seed, rate,
                                                  elem_off=off))


@pytest.mark.parametrize("n,off", [(1, 127), (100, 29), (129, 1),
                                   (4099, 2 ** 32 - 5), (300, 128 * 7 + 100)])
def test_hash_dropout_kernel_at_offsets_within_a_row(card, n, off):
    """Flat tensors whose first element sits mid-row (offset mod 128 not
    0), shorter and longer than the rest of that row, and wrapping mod
    2**32."""
    x = rand((n,), 6, torch.float32, card)
    got = ops.hash_dropout(x, [1, 2], 0.5, elem_off=off)
    assert torch.equal(got, ops.hash_dropout_plain(x, [1, 2], 0.5,
                                                   elem_off=off))


def test_hash_dropout_kernel_backward_and_layouts(card):
    x = rand((2, 4, 4, 8), 0, torch.float32, card).requires_grad_()
    inner = x.permute(0, 3, 1, 2)  # NCHW-logical, channels_last memory
    n = ops.hash_dropout.launches
    y = ops.hash_dropout(inner, [5, 6], 0.5)
    ct = rand((2, 8, 4, 4), 1, torch.float32, card)  # NCHW-contiguous
    (dx,) = torch.autograd.grad(y, x, ct)
    assert ops.hash_dropout.launches == n + 2
    want = ops.hash_dropout_plain(
        ct.permute(0, 2, 3, 1).contiguous(), [5, 6], 0.5)
    torch.cuda.synchronize()
    assert torch.equal(dx, want)
    with pytest.raises(ValueError):
        ops.hash_dropout(x.detach().permute(0, 2, 1, 3), [5, 6], 0.5)
    with pytest.raises(ValueError):
        ops.hash_dropout(x.detach().double(), [5, 6], 0.5)


def test_gradient_into_the_input_alone_goes_through_the_kernels(card):
    """Classifier guidance differentiates with respect to the input only:
    the weights do not require grad. GroupNorm's backward kernel still
    runs (and skips the sums over the batch), attention's gradient chain
    runs, and dx matches the plain version's autograd."""
    x = rand((2, 4, 4, 256), 0, torch.float32, card, 2.0, 0.5)
    scale = rand((256,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((256,), 2, torch.float32, card, 0.1)
    w = rand((256, 3 * 256), 3, torch.float32, card, 0.05)
    ct = rand((2, 16, 256), 4, torch.float32, card)

    def f(xx, gn, attn):
        h = gn(xx, scale, bias, 32, 1e-6, "swish").reshape(2, 16, 256)
        q, k, v = (h @ w).split(256, dim=-1)
        return attn(q.contiguous(), k.contiguous(), v.contiguous(),
                    256 ** -0.5)

    n_b, n_a = ops.group_norm_act_backward.launches, ops.attention.launches
    xg = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(f(xg, ops.group_norm_act, ops.attention),
                                 xg, ct)
    assert ops.group_norm_act_backward.launches == n_b + 1
    assert ops.attention.launches == n_a + 1
    xp = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        f(xp, ops.group_norm_act_plain, ops.attention_plain), xp, ct)
    torch.cuda.synchronize()
    ref = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * ref


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", [(1000, 6), (3, 5, 7, 3), (513, 8),
                                   (2, 4, 4, 512), (1, 1), (7, 1000)])
def test_fused_leaky_relu_kernels_match_plain_bit_for_bit(card, shape,
                                                          dtype):
    x = rand(shape, 0, dtype, card, scale=3.0)
    bias = rand(shape[-1:], 1, torch.float32, card)
    g = rand(shape, 2, dtype, card)
    n_f, n_b = ops.fused_leaky_relu.launches, \
        ops.fused_leaky_relu_backward.launches
    got = ops.fused_leaky_relu(x, bias)
    dx, db = ops.fused_leaky_relu_backward(x, bias, g)
    assert ops.fused_leaky_relu.launches == n_f + 1
    assert ops.fused_leaky_relu_backward.launches == n_b + 1
    want = ops.fused_leaky_relu_plain(x, bias)
    wdx, wdb = ops.fused_leaky_relu_backward_plain(x, bias, g)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(dx, wdx)
    assert db.dtype == torch.float32 and torch.equal(db, wdb)


def test_fused_leaky_relu_unaligned_and_autograd(card):
    """A view that starts off a 16-byte boundary takes the one-element
    path; autograd launches the backward kernel and skips dbias when the
    bias needs no gradient."""
    base = rand((1 + 64 * 16,), 0, torch.bfloat16, card)
    x = base[1:].view(64, 16)
    assert x.data_ptr() % 16
    bias = rand((16,), 1, torch.float32, card)
    assert torch.equal(ops.fused_leaky_relu(x, bias),
                       ops.fused_leaky_relu_plain(x, bias))
    xg = x.detach().clone().requires_grad_()
    n_b = ops.fused_leaky_relu_backward.launches
    ct = rand((64, 16), 2, torch.bfloat16, card)
    (dx,) = torch.autograd.grad(ops.fused_leaky_relu(xg, bias), xg, ct)
    assert ops.fused_leaky_relu_backward.launches == n_b + 1
    assert torch.equal(dx, ops.fused_leaky_relu_backward_plain(
        x, bias, ct)[0])


def test_fused_leaky_relu_kernel_refuses_what_it_does_not_take(card):
    x = rand((4, 8), 0, torch.float32, card)
    b = torch.zeros(8, device=card)
    for bad_x, bad_b in ((x.double(), b), (x.half(), b), (x.t(), b),
                         (x, b[:4]), (x, b.cpu())):
        with pytest.raises(ValueError):
            ops.fused_leaky_relu(bad_x, bad_b)
    with pytest.raises(ValueError):
        ops.fused_leaky_relu_backward(x, b, x.bfloat16())


@pytest.mark.parametrize("impl", ["hw", "save_mask"])
def test_remat_recomputes_the_same_dropout_on_the_card(card, monkeypatch,
                                                       impl):
    """Per-resblock ``remat`` on the card: the hash kernel takes its
    site's seed words again, the saved-mask dropout replays its CUDA
    (Philox) generator; output and gradients equal those without remat,
    bit for bit (cuDNN held to its deterministic algorithms), and the
    resblocks' GroupNorm kernels launch again in the recompute."""
    from psld_tpu_torch.models.ncsnpp import NCSNpp

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)

    kw = dict(image_size=16, in_ch=6, out_ch=6, nf=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(8,), dropout=0.3,
              dropout_impl=impl)
    out = {}
    for remat in (False, True):
        torch.manual_seed(0)
        net = NCSNpp(**kw, remat=remat).to(card)
        with torch.no_grad():
            for p in net.parameters():
                p.normal_().mul_(0.1)
        x = rand((2, 16, 16, 6), 5, torch.float32, card)
        t = torch.tensor([0.3, 0.7], device=card)
        gen = torch.Generator(device=card).manual_seed(7)
        seeds = [(i, 2 * i + 1) for i in range(net.dropout_sites)]
        n = ops.group_norm_act.launches
        y = net(x, t, train=True, dropout_seeds=seeds, generator=gen)
        grads = torch.autograd.grad(y.square().sum(), list(net.parameters()))
        torch.cuda.synchronize()
        out[remat] = (y, grads, ops.group_norm_act.launches - n)
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][2] > out[False][2]
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["hw", "save_mask"])
def test_a_ranks_dropout_is_the_global_batchs_on_the_card(card, monkeypatch,
                                                          impl):
    """A forward of rows 2..3 of a batch of 4 under ``batch_shard = (1,
    2)`` drops as the forward of the whole batch does on those rows: the
    hash kernel at the rows' offset, the saved mask drawn at the global
    shape from the card's (Philox) generator and sliced, and the same
    again in the ``remat`` recompute; output and gradients bit for bit
    against the rank's forward without remat (cuDNN deterministic)."""
    from psld_tpu_torch.models.ncsnpp import NCSNpp

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    kw = dict(image_size=16, in_ch=6, out_ch=6, nf=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(8,), dropout=0.3,
              dropout_impl=impl)
    x = rand((4, 16, 16, 6), 5, torch.float32, card)
    t = torch.tensor([0.3, 0.7, 0.2, 0.9], device=card)
    out = {}
    for remat, rows, shard in ((False, slice(0, 4), (0, 1)),
                               (False, slice(2, 4), (1, 2)),
                               (True, slice(2, 4), (1, 2))):
        torch.manual_seed(0)
        net = NCSNpp(**kw, remat=remat).to(card)
        with torch.no_grad():
            for p in net.parameters():
                p.normal_().mul_(0.1)
        gen = torch.Generator(device=card).manual_seed(7)
        seeds = [(i, 2 * i + 1) for i in range(net.dropout_sites)]
        y = net(x[rows], t[rows], train=True, dropout_seeds=seeds,
                generator=gen, batch_shard=shard)
        grads = torch.autograd.grad(y.square().sum(), list(net.parameters()))
        torch.cuda.synchronize()
        out[(remat, shard)] = (y, grads)
    whole = out[(False, (0, 1))][0]
    part, part_grads = out[(False, (1, 2))]
    # the rows agree to the last bits a different batch gives cuDNN
    torch.testing.assert_close(part, whole[2:], rtol=1e-4, atol=1e-5)
    rem, rem_grads = out[(True, (1, 2))]
    assert torch.equal(rem, part)
    for a, b in zip(rem_grads, part_grads):
        assert torch.equal(a, b)


# -- the split entry points of spatial parallelism ---------------------------
@pytest.mark.parametrize("dtype,gn16", [(torch.float32, False),
                                        (torch.bfloat16, False),
                                        (torch.bfloat16, True)],
                         ids=["f32", "bf16", "gn_bf16"])
@pytest.mark.parametrize("shape,groups", [
    ((3, 5, 7, 40), 10),     # ragged: 35 pixels, no whole chunk of 64
    ((2, 4, 4, 384), 32),    # 16 pixels, channels past one pass of 256
    ((2, 3, 3, 1024), 32),   # C at its limit
    ((1, 65, 2, 96), 24),    # 130 pixels: three chunks, the last of 2
])
def test_group_norm_split_entries_match_plain(card, monkeypatch, shape,
                                              groups, dtype, gn16):
    """Each split entry (stats, apply, partials, dx) against its plain
    version on the same inputs, and two shards' sums added against the
    whole map's fused kernel: stats and (P1, P2) to 1e-5 of their scale
    (f32 sums in another order), y and dx to the dtype's tolerance
    (bf16 and gn_bf16: 1e-2 of the scale)."""
    from psld_tpu_torch.ops import group_norm as gn

    monkeypatch.setenv("PSLD_GN_BF16", "1" if gn16 else "0")
    x = rand(shape, 0, dtype, card, scale=2.0, shift=0.5)
    g = rand(shape, 5, dtype, card)
    c = shape[-1]
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    count = float(shape[1] * shape[2] * (c // groups))

    def close(got, want, tol):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * max(float(want.float().abs().max()), 1e-30), err

    tol = TOL[dtype] if dtype == torch.float32 and not gn16 else 1e-2
    n = [getattr(gn, f).launches for f in (
        "group_norm_split_stats", "group_norm_split_apply",
        "group_norm_split_partials", "group_norm_split_dx")]
    sums = gn.group_norm_split_stats(x, groups)
    close(sums, gn.group_norm_split_stats_plain(x, groups), 1e-5)
    for act in ACTS:
        y = gn.group_norm_split_apply(x, scale, bias, sums, count, groups,
                                      1e-6, act)
        close(y, gn.group_norm_split_apply_plain(x, scale, bias, sums, count,
                                                 groups, 1e-6, act), tol)
        p, ds, db = gn.group_norm_split_partials(x, g, scale, bias, sums,
                                                 count, groups, 1e-6, act)
        wp, wds, wdb = gn.group_norm_split_partials_plain(
            x, g, scale, bias, sums, count, groups, 1e-6, act)
        for got, want in ((p, wp), (ds, wds), (db, wdb)):
            close(got, want, 1e-5 if dtype == torch.float32 else 1e-2)
        dx = gn.group_norm_split_dx(x, g, scale, bias, sums, p, count,
                                    groups, 1e-6, act)
        close(dx, gn.group_norm_split_dx_plain(x, g, scale, bias, sums, wp,
                                               count, groups, 1e-6, act),
              tol)
    assert [getattr(gn, f).launches for f in (
        "group_norm_split_stats", "group_norm_split_apply",
        "group_norm_split_partials", "group_norm_split_dx")] == [
        n[0] + 1, n[1] + 5, n[2] + 5, n[3] + 5]
    # two half-height shards against the whole map's fused kernel
    if shape[1] % 2 == 0:
        h = shape[1] // 2
        halves = [x[:, :h].contiguous(), x[:, h:].contiguous()]
        total = sum(gn.group_norm_split_stats(v, groups) for v in halves)
        y = torch.cat([gn.group_norm_split_apply(
            v, scale, bias, total, count, groups, 1e-6, "swish")
            for v in halves], 1)
        close(y, ops.group_norm_act(x, scale, bias, groups, 1e-6, "swish"),
              tol)


def test_group_norm_split_entries_past_two_to_the_31_bytes(card):
    """Stats and apply on a bf16 tensor of 2**31 bytes against their plain
    versions ``HUGE_CHUNK`` batch elements at a time."""
    from psld_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(HUGE, generator=gen, device=card,
                    dtype=torch.bfloat16) * 2 + 0.5
    c, groups = HUGE[-1], 32
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    count = float(HUGE[1] * HUGE[2] * (c // groups))
    sums = gn.group_norm_split_stats(x, groups)
    y = gn.group_norm_split_apply(x, scale, bias, sums, count, groups, 1e-6,
                                  "swish")
    torch.cuda.synchronize()
    for i in range(0, HUGE[0], HUGE_CHUNK):
        sl = slice(i, i + HUGE_CHUNK)
        want = gn.group_norm_split_stats_plain(x[sl], groups)
        err = float((sums[sl] - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
        assert_close(y[sl], gn.group_norm_split_apply_plain(
            x[sl], scale, bias, sums[sl], count, groups, 1e-6, "swish"),
            TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape,spatial_n,row", [
    ((2, 8, 4, 3), 2, 1),       # 48-element slices, mid-row offsets
    ((3, 4, 7, 5), 4, 0),       # 35: each slice starts mid-row
    ((4, 16, 16, 256), 2, 2),   # a rank's half images at a real width
    ((2, 4, 4, 129), 4, 1),     # one row of 516 elements a slice
])
def test_hash_dropout_kernel_on_height_slices(card, shape, spatial_n, row,
                                              dtype):
    """The strided launch (``image = (L, Gi)``) on a rank's rows and
    height slice is the whole tensor's dropout sliced and its plain
    version, bit for bit, forward and backward; one launch each way."""
    x = rand(shape, 3, dtype, card)
    seed, rate = [987654321, 12345], 0.2
    whole = ops.hash_dropout(x, seed, rate)
    h = shape[1] // spatial_n
    for s in range(spatial_n):
        part = x[row:, s * h:(s + 1) * h].contiguous().requires_grad_()
        local = part[0].numel()
        off = row * x[0].numel() + s * local
        image = (local, x[0].numel())
        n = ops.hash_dropout.launches
        got = ops.hash_dropout(part, seed, rate, elem_off=off, image=image)
        assert ops.hash_dropout.launches == n + 1
        assert torch.equal(got, whole[row:, s * h:(s + 1) * h])
        assert torch.equal(got, ops.hash_dropout_plain(
            part.detach(), seed, rate, elem_off=off, image=image))
        ct = rand(part.shape, 4, dtype, card)
        (dx,) = torch.autograd.grad(got, part, ct)
        assert torch.equal(dx, ops.hash_dropout_plain(
            ct, seed, rate, elem_off=off, image=image))


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("images,whole,start,local,base", [
    (4, 1024, 0, 384, 0),            # elem_off % 128 == 0, Gi of whole rows
    (4, 1000, 1, 300, 0),            # elem_off % 128 == 1, ragged Gi
    (3, 1024, 127, 500, 128 * 9),    # elem_off % 128 == 127, one lead
    (5, 333, 10, 50, 7),             # L below 128 and no multiple of it
    (6, 256, 64, 100, 384),          # L below 128 over whole-row images
    (1, 4096, 1000, 2000, 5),        # one image
    (6, 512, 100, 300, 2 ** 32 - 1500),  # positions wrap past 2**32
], ids=["off0", "off1", "off127", "short", "short_rows", "one_image",
        "wrap"])
def test_hash_dropout_strided_launch_edges(card, images, whole, start, local,
                                           base, dtype):
    """The strided launch (``image = (L, Gi)``) on the slice [start, start
    + L) of each of ``images`` runs of Gi positions from ``base``: the
    whole tensor's mask sliced and the plain version, bit for bit,
    forward and backward, one launch each way."""
    x = rand((images, whole), 7, dtype, card)
    seed, rate = [31337, 4000000007], 0.3
    want_whole = ops.hash_dropout(x, seed, rate, elem_off=base)
    part = x[:, start:start + local].contiguous().requires_grad_()
    off = (base + start) & 0xFFFFFFFF
    image = (local, whole)
    n = ops.hash_dropout.launches
    got = ops.hash_dropout(part, seed, rate, elem_off=off, image=image)
    assert ops.hash_dropout.launches == n + 1
    assert torch.equal(got, want_whole[:, start:start + local])
    assert torch.equal(got, ops.hash_dropout_plain(
        part.detach(), seed, rate, elem_off=off, image=image))
    ct = rand(part.shape, 8, dtype, card)
    (dx,) = torch.autograd.grad(got, part, ct)
    assert ops.hash_dropout.launches == n + 2
    assert torch.equal(dx, ops.hash_dropout_plain(
        ct, seed, rate, elem_off=off, image=image))


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("c,groups", [(3, 1), (12, 4), (129, 3), (256, 32),
                                      (1024, 32)])
def test_group_norm_split_stats_kernel_edges(card, c, groups, dtype):
    """The split stats at widths with and without whole 16-byte pieces
    (C = 3, 12 and 129 take the scalar path in bf16), over 1 to 32,768
    pixels: within 1e-5 of the plain sums' scale (f32 sums in another
    order), two launches bit-equal (the chunks' partials are added in a
    fixed order), one counted launch a call."""
    from psld_tpu_torch.ops import group_norm as gn

    for b, hw in ((2, 1), (3, 7), (2, 64), (1, 100), (8, 2048),
                  (2, 32768)):
        x = rand((b, hw, 1, c), hw, dtype, card, scale=2.0, shift=0.5)
        n = gn.group_norm_split_stats.launches
        got = gn.group_norm_split_stats(x, groups)
        again = gn.group_norm_split_stats(x, groups)
        assert gn.group_norm_split_stats.launches == n + 2
        want = gn.group_norm_split_stats_plain(x, groups)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (b, hw, err)
        assert torch.equal(got, again), (b, hw)


@pytest.mark.parametrize("hw", [8, 32768], ids=["one_chunk", "chunks"])
def test_group_norm_split_stats_is_one_kernel_launch(card, hw):
    """One call of the split stats runs one kernel on the card (the
    chunks' partials are folded by the launch's last block), whether the
    planner gives one chunk a batch element or many; a CUDA graph of it
    replays to the same sums."""
    from torch.profiler import ProfilerActivity, profile

    from psld_tpu_torch.ops import group_norm as gn

    x = rand((8, hw, 1, 256), 0, torch.bfloat16, card)
    want = gn.group_norm_split_stats(x, 32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gn.group_norm_split_stats(x, 32)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    assert len(kernels) == 1 and "gn_split_stats" in kernels[0], kernels
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gn.group_norm_split_stats(x, 32)  # the counts' buffer, off capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = gn.group_norm_split_stats(x, 32)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


# -- the GroupNorm variant of the legacy normalizers -------------------------
@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("size", [8, 32])
@pytest.mark.parametrize("c", [4, 12, 256, 1024])
def test_legacy_group_norm_variant_matches_plain(card, c, size, dtype):
    """``models.normalization.GroupNorm`` (GroupNorm(min(C // 4, 32)), eps
    1e-6, no activation; ``get_normalization``'s ``GroupNorm``) on an
    NCHW ``channels_last`` input at its edge widths, C = 4 (one group of
    4), 12, 256 and 1024 (the kernels' limit): its forward and its
    gradient each launch their kernel once and match
    ``group_norm_act_plain`` and autograd through it (forward to the
    dtype's tolerance, gradients to 1e-4 / 2e-2 of their scale). In bf16
    at C = 4 and 12 no slice of whole groups is a multiple of 16 bytes:
    the kernels take no slice there: the variant runs the plain version
    (``ops.group_norm_fits``), matches it and launches no kernel."""
    from psld_tpu_torch.models.normalization import GroupNorm

    mod = GroupNorm(c).to(card)
    with torch.no_grad():
        mod.scale.copy_(rand((c,), 1, torch.float32, card, 0.1, 1.0))
        mod.bias.copy_(rand((c,), 2, torch.float32, card, 0.1))
    x = rand((2, size, size, c), 0, dtype, card, 2.0, 0.5)
    g = rand((2, size, size, c), 3, dtype, card)
    x_in = x.permute(0, 3, 1, 2).detach().requires_grad_()
    assert x_in.is_contiguous(memory_format=torch.channels_last)
    routed = dtype == torch.bfloat16 and c in (4, 12)
    assert ops.group_norm_fits(x.shape, dtype, min(c // 4, 32)) != routed
    n_f, n_b = ops.group_norm_act.launches, \
        ops.group_norm_act_backward.launches
    y = mod(x_in)
    dx, dscale, dbias = torch.autograd.grad(
        y, (x_in, mod.scale, mod.bias), g.permute(0, 3, 1, 2))
    assert ops.group_norm_act.launches == n_f + (not routed)
    assert ops.group_norm_act_backward.launches == n_b + (not routed)
    groups = min(c // 4, 32)
    assert_close(y.permute(0, 2, 3, 1), ops.group_norm_act_plain(
        x, mod.scale, mod.bias, groups, 1e-6, "none"), TOL[dtype])
    want = ops.group_norm_act_backward_plain(x, mod.scale, mod.bias, g,
                                             groups, 1e-6, "none")
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.cuda.synchronize()
    for got, w in zip((dx.permute(0, 2, 3, 1), dscale, dbias), want):
        ref = float(w.float().abs().max()) + 1e-6
        assert float((got.float() - w.float()).abs().max()) <= tol * ref


@pytest.mark.parametrize("block", ["CondCRPBlock", "CRPBlock_avg"])
def test_legacy_average_pooling_gradient_on_channels_last(card, block):
    """The CRP blocks' 5x5 average pooling on a ``channels_last`` CUDA
    input: the input gradient matches the CPU's (PyTorch's CUDA average
    pooling pulls a wrong one back into such an input where its windows
    overlap, so the blocks pool NCHW memory), to 1e-4 of its scale."""
    import torch.nn.functional as F

    from psld_tpu_torch.models import legacy_layers as L

    torch.manual_seed(0)
    mod = L.CondCRPBlock(16, 2, 3, act=F.elu) if block == "CondCRPBlock" \
        else L.CRPBlock(16, 2, F.elu, maxpool=False)
    x = rand((2, 16, 8, 8), 0, torch.float32, "cpu").contiguous(
        memory_format=torch.channels_last)
    y = torch.tensor([0, 2])
    ct = rand((2, 16, 8, 8), 1, torch.float32, "cpu")
    grads = []
    for dev in ("cpu", card):
        m = mod.to(dev)
        xi = x.to(dev).detach().requires_grad_()
        out = m(xi, y.to(dev)) if block == "CondCRPBlock" else m(xi)
        grads.append(torch.autograd.grad(out, xi, ct.to(dev))[0].cpu())
    want = grads[0]
    assert float((grads[1] - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


# -- shapes the kernels refuse: the layers route them to the plain versions -
def _launches():
    from psld_tpu_torch.ops import group_norm as gn

    return [f.launches for f in (
        ops.group_norm_act, ops.group_norm_act_backward, ops.attention,
        gn.group_norm_split_stats, gn.group_norm_split_apply,
        gn.group_norm_split_partials, gn.group_norm_split_dx)]


def _grads_close(got, want, tol, floor=0.0):
    """Each of ``got`` within ``tol`` of its counterpart's scale, the
    scale floored at ``floor`` of the largest of ``want``'s."""
    torch.cuda.synchronize()
    top = max(float(b.detach().float().abs().max()) for b in want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        err = float((a.detach().float().cpu() - b.detach().float().cpu())
                    .abs().max())
        assert err <= tol * max(float(b.detach().float().abs().max()),
                                floor * top), err


def test_attn_block_routes_past_the_kernels_tokens(card):
    """An ``AttnBlock`` at N = 1,024 tokens (32 x 32, C = 256; the
    attention kernel takes N <= 256): forward and gradients into x and
    every parameter equal the CPU's (the plain chain) to 1e-4 of their
    scale, f32, floored at 1e-3 of the largest gradient's (the keys'
    bias has a gradient of 0 up to rounding: softmax ignores a shift
    common to every key); its GroupNorm (C = 256) launches the GN kernels
    once each way, attention launches nothing."""
    from psld_tpu_torch.models.layers import AttnBlock

    torch.manual_seed(0)
    mod = AttnBlock(256, init_scale=0.1)
    x = rand((2, 256, 32, 32), 0, torch.float32, "cpu")
    ct = rand((2, 256, 32, 32), 1, torch.float32, "cpu")
    assert not ops.attention_fits((2, 1024, 256), torch.float32)
    out = []
    for dev in ("cpu", card):
        m = mod.to(dev)
        xi = x.to(dev).requires_grad_()
        n = _launches()
        y = m(xi)
        grads = torch.autograd.grad(y, [xi, *m.parameters()], ct.to(dev))
        torch.cuda.synchronize()
        if dev != "cpu":
            d = [a - b for a, b in zip(_launches(), n)]
            assert d == [1, 1, 0, 0, 0, 0, 0], d
        out.append([y.detach().cpu(), *(t.cpu() for t in grads)])
    _grads_close(out[1][:1], out[0][:1], 1e-4)
    _grads_close(out[1][1:], out[0][1:], 1e-4, floor=1e-3)


@pytest.mark.parametrize("c,dtype", [(2048, torch.float32),
                                     (2048, torch.bfloat16),
                                     (12, torch.bfloat16)],
                         ids=["2048-f32", "2048-bf16", "12-bf16"])
def test_group_norm_act_routes_past_the_kernels_widths(card, c, dtype):
    """A ``GroupNormAct`` (swish) at C = 2,048 (past the kernels' 1,024)
    and at bf16 C = 12 (no slice of whole groups a multiple of 16 bytes):
    forward and gradients equal ``group_norm_act_plain`` and autograd
    through it on the same inputs to the dtype's tolerance (gradients:
    1e-4 / 2e-2 of their scale), and no kernel launches."""
    from psld_tpu_torch.models.layers import GroupNormAct

    mod = GroupNormAct(c, act="swish").to(card)
    groups = mod.num_groups
    with torch.no_grad():
        mod.scale.copy_(rand((c,), 1, torch.float32, card, 0.1, 1.0))
        mod.bias.copy_(rand((c,), 2, torch.float32, card, 0.1))
    x = rand((2, 6, 5, c), 0, dtype, card, 2.0, 0.5)
    g = rand((2, 6, 5, c), 3, dtype, card)
    assert not ops.group_norm_fits(x.shape, dtype, groups)
    xi = x.clone().requires_grad_()
    n = _launches()
    y = mod.forward_nhwc(xi)
    grads = torch.autograd.grad(y, (xi, mod.scale, mod.bias), g)
    assert _launches() == n
    assert_close(y, ops.group_norm_act_plain(x, mod.scale, mod.bias, groups,
                                             1e-6, "swish"), TOL[dtype])
    _grads_close(grads, ops.group_norm_act_backward_plain(
        x, mod.scale, mod.bias, g, groups, 1e-6, "swish"),
        1e-4 if dtype == torch.float32 else 2e-2)


def test_group_norm_act_split_routes_past_the_kernels_width(card,
                                                            monkeypatch):
    """``group_norm_act_split`` at C = 2,048 on the top half of a map, in
    one process with the spatial group's all-reduces faked (they add the
    bottom half's stats, then its (P1, P2)): the plain split pieces run,
    no kernel launches, and y and dx equal the whole map's plain version
    on those rows, dscale and dbias with the bottom half's added, to 1e-5
    of their scale (f32)."""
    from psld_tpu_torch.ops import group_norm as gn
    from psld_tpu_torch.parallel import distributed

    c, groups = 2048, 32
    x = rand((2, 8, 4, c), 0, torch.float32, card, 2.0, 0.5)
    g = rand((2, 8, 4, c), 3, torch.float32, card)
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    count = float(8 * 4 * (c // groups))
    top, bottom = x[:, :4].contiguous(), x[:, 4:].contiguous()
    g_top, g_bottom = g[:, :4].contiguous(), g[:, 4:].contiguous()
    sums = gn.group_norm_split_stats_plain(x, groups)
    p_b, ds_b, db_b = gn.group_norm_split_partials_plain(
        bottom, g_bottom, scale, bias, sums, count, groups, 1e-6, "swish")
    adds = [gn.group_norm_split_stats_plain(bottom, groups), p_b]
    monkeypatch.setattr(distributed, "all_reduce_",
                        lambda t, group=None: t.add_(adds.pop(0)))
    monkeypatch.setattr(distributed, "spatial_info", lambda: (0, 2, 0, 1))
    assert not gn.group_norm_split_fits(top.shape, top.dtype, groups)
    leaves = [t.clone().requires_grad_() for t in (top, scale, bias)]
    n = _launches()
    y = gn.group_norm_act_split(*leaves, groups, 1e-6, "swish")
    dx, ds, db = torch.autograd.grad(y, leaves, g_top)
    assert _launches() == n and not adds
    dx_w, ds_w, db_w = ops.group_norm_act_backward_plain(
        x, scale, bias, g, groups, 1e-6, "swish")
    _grads_close([y, dx, ds + ds_b, db + db_b],
                 [ops.group_norm_act_plain(x, scale, bias, groups, 1e-6,
                                           "swish")[:, :4], dx_w[:, :4],
                  ds_w, db_w], 1e-5)


# -- the split backward entries at their edges --------------------------------
@pytest.mark.parametrize("dtype,gn16", [(torch.float32, False),
                                        (torch.bfloat16, False),
                                        (torch.bfloat16, True)],
                         ids=["f32", "bf16", "gn_bf16"])
@pytest.mark.parametrize("b,hw,c,groups", [
    (1, 7, 12, 4),        # B = 1, one block; bf16 C = 12: the scalar path
    (2, 8, 256, 32),      # a block a batch element, the batch fold
    (1, 5000, 96, 24),    # B = 1 over chunks: the chunk fold writes dscale
    (3, 4099, 40, 10),    # rows no multiple of the plan's, ragged chunk
    (2, 3001, 129, 3),    # C no multiple of a piece, over chunks
    (64, 64, 128, 32),    # a large batch
    (2, 300, 1024, 32),   # C at its limit, over chunks
])
def test_group_norm_split_backward_kernel_edges(card, monkeypatch, b, hw, c,
                                                groups, dtype, gn16):
    """``group_norm_split_partials`` and ``group_norm_split_dx`` at the
    edges of their plans, for all five activations: (P1, P2), dscale and
    dbias within 1e-5 of their plain versions' scale in f32 (sums in
    another order) and 1e-2 in bf16; dx within the dtype's tolerance of
    its scale (1e-2 in bf16 and under gn_bf16); two launches of each bit
    for bit equal (every fold in a fixed order); one counted launch a
    call."""
    from psld_tpu_torch.ops import group_norm as gn

    monkeypatch.setenv("PSLD_GN_BF16", "1" if gn16 else "0")
    x = rand((b, hw, 1, c), hw, dtype, card, scale=2.0, shift=0.5)
    g = rand((b, hw, 1, c), hw + 1, dtype, card)
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    count = float(2 * hw * (c // groups))  # a shard of two
    sums = gn.group_norm_split_stats_plain(x, groups) * 2.0
    tol = 1e-5 if dtype == torch.float32 else 1e-2

    def close(got, want, t):
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= t * max(float(want.float().abs().max()), 1e-30), err

    for act in ACTS:
        n = (gn.group_norm_split_partials.launches,
             gn.group_norm_split_dx.launches)
        args = (x, g, scale, bias, sums, count, groups, 1e-6, act)
        got = gn.group_norm_split_partials(*args)
        again = gn.group_norm_split_partials(*args)
        want = gn.group_norm_split_partials_plain(*args)
        for a, a2, w in zip(got, again, want):
            assert torch.equal(a, a2)
            close(a, w, tol)
        p = want[0] * 2.0
        dx = gn.group_norm_split_dx(x, g, scale, bias, sums, p, count,
                                    groups, 1e-6, act)
        dx2 = gn.group_norm_split_dx(x, g, scale, bias, sums, p, count,
                                     groups, 1e-6, act)
        assert (gn.group_norm_split_partials.launches,
                gn.group_norm_split_dx.launches) == (n[0] + 2, n[1] + 2)
        assert torch.equal(dx, dx2)
        close(dx, gn.group_norm_split_dx_plain(x, g, scale, bias, sums, p,
                                               count, groups, 1e-6, act),
              tol)


# -- the split apply at its edges --------------------------------------------
@pytest.mark.parametrize("dtype,gn16", [(torch.float32, False),
                                        (torch.bfloat16, False),
                                        (torch.bfloat16, True)],
                         ids=["f32", "bf16", "gn_bf16"])
@pytest.mark.parametrize("b,h,w,c,groups", [
    (1, 7, 1, 12, 4),       # B = 1, one tile; bf16 C = 12: the scalar path
    (2, 3001, 1, 129, 3),   # the scalar path (both dtypes) over tiles
    (8, 1, 16, 128, 32),    # one pixel row; a piece spans two groups
    (3, 4099, 1, 40, 10),   # many tiles, the last one partial
    (1, 32768, 1, 128, 32),  # B = 1: the most tiles a batch element
    (300, 16, 1, 256, 32),  # B past the planner's blocks: one tile each
    (2, 300, 1, 1024, 32),  # C at its limit
])
def test_group_norm_split_apply_kernel_edges(card, monkeypatch, b, h, w, c,
                                             groups, dtype, gn16):
    """``group_norm_split_apply`` at the edges of its plan, for all five
    activations: within the dtype's tolerance of its plain version's
    scale (1e-2 in bf16 and under gn_bf16), bit-equal to it on at least
    ``GN_BF16_EQUAL`` of the elements under gn_bf16, two launches bit
    for bit equal, one counted launch a call."""
    from psld_tpu_torch.ops import group_norm as gn

    monkeypatch.setenv("PSLD_GN_BF16", "1" if gn16 else "0")
    x = rand((b, h, w, c), h * w, dtype, card, scale=2.0, shift=0.5)
    scale = rand((c,), 1, torch.float32, card, 0.1, 1.0)
    bias = rand((c,), 2, torch.float32, card, 0.1)
    count = float(2 * h * w * (c // groups))  # a shard of two
    sums = gn.group_norm_split_stats_plain(x, groups) * 2.0
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for act in ACTS:
        n = gn.group_norm_split_apply.launches
        args = (x, scale, bias, sums, count, groups, 1e-6, act)
        y = gn.group_norm_split_apply(*args)
        again = gn.group_norm_split_apply(*args)
        want = gn.group_norm_split_apply_plain(*args)
        torch.cuda.synchronize()
        assert gn.group_norm_split_apply.launches == n + 2
        assert y.dtype == want.dtype and y.shape == want.shape
        assert torch.equal(y, again)
        err = float((y.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max()), (act, err)
        if gn16:
            share = float((y == want).float().mean())
            assert share >= GN_BF16_EQUAL, (act, share)


@pytest.mark.parametrize("hw", [8, 32768], ids=["one_tile", "tiles"])
def test_group_norm_split_apply_is_one_kernel_launch(card, hw):
    """One split-apply call is one kernel on the card, seen by
    ``torch.profiler`` in a process of its own
    (``chip_smoke.split_kernels``), whether the planner gives one tile a
    batch element or many; a CUDA graph of it replays to the same bits."""
    import chip_smoke
    from psld_tpu_torch.ops import group_norm as gn

    ran = chip_smoke.split_kernels(["apply"], [(8, hw, 1, 256, 32)])
    assert len(ran) == 1 and "gn_split_apply" in ran[0], ran
    x = rand((8, hw, 1, 256), 0, torch.bfloat16, card)
    scale = rand((256,), 2, torch.float32, card, 0.1, 1.0)
    bias = rand((256,), 3, torch.float32, card, 0.1)
    args = (x, scale, bias, gn.group_norm_split_stats(x, 32),
            float(hw * 8), 32, 1e-6, "swish")
    want = gn.group_norm_split_apply(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gn.group_norm_split_apply(*args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = gn.group_norm_split_apply(*args)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("hw", [256, 32768])
def test_group_norm_split_partials_is_one_kernel_launch(card, hw):
    """One split-partials call is one kernel on the card (the chunks' and
    the batch elements' partials are folded by the launch's last blocks),
    seen by ``torch.profiler`` in a process of its own
    (``chip_smoke.split_kernels``), whether the planner gives one chunk a
    batch element or many; a CUDA graph of it replays to the same sums."""
    import chip_smoke
    from psld_tpu_torch.ops import group_norm as gn

    ran = chip_smoke.split_kernels(["partials"], [(8, hw, 1, 256, 32)])
    assert len(ran) == 1 and "gn_split_partials" in ran[0], ran
    x = rand((8, hw, 1, 256), 0, torch.bfloat16, card)
    g = rand((8, hw, 1, 256), 1, torch.bfloat16, card)
    scale = rand((256,), 2, torch.float32, card, 0.1, 1.0)
    bias = rand((256,), 3, torch.float32, card, 0.1)
    sums = gn.group_norm_split_stats(x, 32)
    args = (x, g, scale, bias, sums, float(hw * 8), 32, 1e-6, "swish")
    want = gn.group_norm_split_partials(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gn.group_norm_split_partials(*args)  # the counts, off capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = gn.group_norm_split_partials(*args)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for a, w in zip(out, want):
        assert torch.equal(a, w)
