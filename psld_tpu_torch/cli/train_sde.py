"""Unconditional score-model training entry point of the port.

    python -m psld_tpu_torch.cli.train_sde +dataset=cifar10/cifar10_psld \\
        dataset.diffusion.data.root=... \\
        dataset.diffusion.training.results_dir=...

Runs on ``cuda`` unless ``+dataset.diffusion.training.device=cpu``.
"""

from psld_tpu_torch.cli._common import bootstrap


def main(argv=None):
    """Train as the config says; returns ``(state, stats)`` of
    ``train.loop.train_sde``: the final TrainState and one dict per
    optimizer step."""
    cfg = bootstrap(argv)
    from psld_tpu_torch.train.loop import train_sde

    return train_sde(cfg.dataset.diffusion)


if __name__ == "__main__":
    main()
