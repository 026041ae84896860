"""Unconditional sampling entry point of the port.

    python -m psld_tpu_torch.cli.sample +dataset=cifar10/cifar10_psld \\
        dataset.diffusion.data.root=/unused \\
        dataset.diffusion.evaluation.chkpt_path=ckpt.pt \\
        dataset.diffusion.evaluation.save_path=out
"""

from psld_tpu_torch.cli._common import bootstrap


def main(argv=None) -> list:
    """Sample as the config says; returns one dict of stats per batch
    (see ``eval.generate.sample``)."""
    cfg = bootstrap(argv)
    from psld_tpu_torch.eval.generate import sample

    return sample(cfg.dataset.diffusion)


if __name__ == "__main__":
    main()
