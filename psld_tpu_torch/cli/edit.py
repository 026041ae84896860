"""SDEdit-style editing entry point of the port.

    python -m psld_tpu_torch.cli.edit +dataset=cifar10/cifar10_psld \\
        dataset.diffusion.data.root=... \\
        dataset.diffusion.evaluation.chkpt_path=score.pt \\
        dataset.diffusion.evaluation.save_path=out \\
        +dataset.diffusion.evaluation.sampler.edit_t0=0.4

Runs on ``cuda`` unless ``+dataset.diffusion.evaluation.device=cpu``.
"""

from psld_tpu_torch.cli._common import bootstrap


def main(argv=None) -> list:
    """Edit as the config says; returns one dict of stats per batch (see
    ``eval.generate.edit``)."""
    cfg = bootstrap(argv)
    from psld_tpu_torch.eval.generate import edit

    return edit(cfg.dataset.diffusion)


if __name__ == "__main__":
    main()
