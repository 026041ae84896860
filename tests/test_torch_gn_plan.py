"""The GroupNorm kernels' host planners (``plan_forward``,
``plan_backward``): for every (H*W, C, G, dtype) that ``chip_smoke.py``
drives and that the shipped configs' networks give at H*W <= 32 x 32,
the planned slice is whole groups, tiles every channel, is a multiple of
16 bytes, and a block stays within the 227 KB of shared memory it may
have and holds all its pixel rows. Above 32 x 32 (CelebA-HQ's 256 x 256)
the plan may hold part of a run and still stays within 227 KB. The card
tests' ragged shapes are placed too. Runs on the CPU: it imports the
port alone."""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import pytest
import torch

import chip_smoke
from psld_tpu_torch.config import compose
from psld_tpu_torch.ops.group_norm import plan_backward, plan_forward

SMEM_MAX = 227 * 1024
CONFIGS = ["cifar10/cifar10_psld", "cifar10/cifar10_vpsde",
           "celeba64/celeba64_psld", "celeba64/celeba64_vpsde",
           "afhqv2/afhqv2128_psld", "celebahq/celebahq256_psld"]


def _config_shapes():
    """(H*W, C) of every GroupNorm an NCSN++ of a shipped config can run:
    each level's resolution with each width a block there takes (its own,
    the level below's, and the sums of two that a skip concatenation
    gives)."""
    shapes = set()
    for name in CONFIGS:
        diff = compose([f"+dataset={name}"]).dataset.diffusion
        size, fn = diff.data.image_size, diff.model.score_fn
        widths = [fn.nf * m for m in fn.ch_mult]
        for lvl in range(len(widths)):
            near = widths[max(0, lvl - 1):lvl + 2]
            cs = set(near) | {a + b for a in near for b in near}
            for c in cs:
                shapes.add(((size >> lvl) ** 2, c))
    return sorted(shapes)


def _check(hw, c, dtype, whole_run, planner=plan_backward):
    groups = min(c // 4, 32)
    plan = planner(hw, c, groups, dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    s, cg = plan["slice"], c // groups
    assert s % cg == 0 and c % s == 0 and s * elem % 16 == 0, plan
    assert plan["cluster"] in (1, 2, 4, 8) and plan["smem"] <= SMEM_MAX
    rows = -(-hw // plan["cluster"])
    assert 0 < plan["resident"] <= rows
    if whole_run:
        assert plan["resident"] == rows, (hw, c, dtype, plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_backward_plan_places_every_shape(dtype):
    smoke = {(hw, c) for hw, c, _ in chip_smoke.GN_CALLS
             + chip_smoke.CLF_GN_CALLS}
    configs = _config_shapes()
    assert (1024, 256) in configs and (65536, 128) in configs
    for hw, c in sorted(smoke | set(configs)):
        _check(hw, c, dtype, whole_run=hw <= 1024)
    for hw in (1, 7, 35, 1024):  # the card tests' odd sizes
        for c, groups in ((40, 10), (320, 32), (1024, 32), (64, 16)):
            plan = plan_backward(hw, c, groups, dtype)
            assert plan["smem"] <= SMEM_MAX and c % plan["slice"] == 0
    with pytest.raises(ValueError):  # 3 bf16 channels: 6 bytes
        plan_backward(16, 12, 4, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_forward_plan_places_every_shape(dtype):
    smoke = {(hw, c) for hw, c, _ in chip_smoke.GN_CALLS
             + chip_smoke.CLF_GN_CALLS}
    elem = torch.empty((), dtype=dtype).element_size()
    for hw, c in sorted(smoke | set(_config_shapes())):
        _check(hw, c, dtype, whole_run=hw <= 1024, planner=plan_forward)
        plan = plan_forward(hw, c, min(c // 4, 32), dtype)
        # at most one 128-byte line of a row; one block where a third of
        # an SM's shared memory holds the run
        assert plan["slice"] * elem <= 128, (hw, c, plan)
        if hw <= 1024:
            assert plan["cluster"] in (1, 2) and plan["smem"] <= SMEM_MAX // 3
    # the card tests' ragged shapes: 20-channel slices of C = 40, 12-channel
    # groups, one group a slice, a single pixel
    for hw in (1, 7, 9, 16, 35, 1024):
        for c, groups in ((40, 10), (384, 32), (1024, 32), (64, 16)):
            plan = plan_forward(hw, c, groups, dtype)
            s = plan["slice"]
            assert s % (c // groups) == 0 and c % s == 0
            assert s * elem % 16 == 0 and plan["smem"] <= SMEM_MAX
            assert plan["resident"] == -(-hw // plan["cluster"])
    # given the batch, a block's slice wider than 64 bytes leaves at least
    # 512 work items (batch elements x slices), and the run stays whole;
    # maps of up to 64 pixels take a warp a work item (threads 32)
    for batch, calls in ((64, chip_smoke.GN_CALLS), (128, chip_smoke.GN_CALLS),
                         (32, chip_smoke.CLF_GN_CALLS)):
        for hw, c, _ in calls:
            plan = plan_forward(hw, c, min(c // 4, 32), dtype, batch)
            s = plan["slice"]
            assert (plan["threads"] == 32) == (hw <= 64), (hw, c, plan)
            assert plan["threads"] == 32 or s * elem <= 64 \
                or batch * c // s >= 512, (hw, c, plan)
            assert plan["resident"] * plan["cluster"] >= hw
    with pytest.raises(ValueError):  # 3 bf16 channels: 6 bytes
        plan_forward(16, 12, 4, torch.bfloat16)
