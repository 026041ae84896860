from psld_tpu_torch.losses.score import PSLDScoreLoss  # noqa: F401
