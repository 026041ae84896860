from psld_tpu_torch.data.datasets import SDELatentDataset  # noqa: F401
