from psld_tpu_torch.data.datasets import (  # noqa: F401
    ArrayDataset,
    CIFAR10Dataset,
    InpaintDataset,
    SDELatentDataset,
    SyntheticDataset,
)
