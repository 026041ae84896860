from psld_tpu_torch.models.ncsnpp import NCSNpp  # noqa: F401
