from psld_tpu_torch.data.datasets import (  # noqa: F401
    AFHQv2Dataset,
    ArrayDataset,
    CelebADataset,
    CelebAHQDataset,
    CIFAR10Dataset,
    InpaintDataset,
    SDELatentDataset,
    SyntheticDataset,
)
