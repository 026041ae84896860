from psld_tpu_torch.losses.score import (  # noqa: F401
    PSLDScoreLoss,
    PSLDTimeCELoss,
    ScoreLoss,
)
