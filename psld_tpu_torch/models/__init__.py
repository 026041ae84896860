from psld_tpu_torch.models.ncsnpp import (  # noqa: F401
    NCSNpp,
    NCSNppClassifier,
)
