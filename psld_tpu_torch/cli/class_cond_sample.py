"""Classifier-guided sampling entry point of the port.

    python -m psld_tpu_torch.cli.class_cond_sample \\
        +dataset=cifar10/cifar10_psld dataset.diffusion.data.root=/unused \\
        dataset.diffusion.evaluation.sampler.name=cc_em_sde \\
        dataset.diffusion.evaluation.chkpt_path=score.pt \\
        dataset.diffusion.evaluation.save_path=out \\
        dataset.clf.data.root=/unused dataset.clf.model.clf_fn.n_cls=10 \\
        dataset.clf.evaluation.chkpt_path=clf.pt \\
        dataset.clf.evaluation.label_to_sample=all

Runs on ``cuda`` unless ``+dataset.diffusion.evaluation.device=cpu``.
"""

from psld_tpu_torch.cli._common import bootstrap


def main(argv=None) -> list:
    """Sample as the config says; returns one dict of stats per batch
    (see ``eval.generate.class_cond_sample``)."""
    cfg = bootstrap(argv)
    from psld_tpu_torch.eval.generate import class_cond_sample

    return class_cond_sample(cfg.dataset)


if __name__ == "__main__":
    main()
