"""Inpainting entry point of the port.

    python -m psld_tpu_torch.cli.inpaint +dataset=cifar10/cifar10_psld \\
        dataset.diffusion.data.root=... \\
        dataset.diffusion.evaluation.chkpt_path=score.pt \\
        dataset.diffusion.evaluation.save_path=out

Masks are MNIST digits read from ``data.root``, or squares where MNIST is
absent. Runs on ``cuda`` unless ``+dataset.diffusion.evaluation.device=cpu``.
"""

from psld_tpu_torch.cli._common import bootstrap


def main(argv=None) -> list:
    """Inpaint as the config says; returns one dict of stats per batch
    (see ``eval.generate.inpaint``)."""
    cfg = bootstrap(argv)
    from psld_tpu_torch.eval.generate import inpaint

    return inpaint(cfg.dataset.diffusion)


if __name__ == "__main__":
    main()
