"""Noise-conditional classifier training entry point of the port.

    python -m psld_tpu_torch.cli.train_clf +dataset=cifar10/cifar10_psld \\
        dataset.clf.data.root=... dataset.clf.model.clf_fn.n_cls=10 \\
        dataset.clf.training.results_dir=...

Runs on ``cuda`` unless ``+dataset.clf.training.device=cpu``.
"""

from psld_tpu_torch.cli._common import bootstrap


def main(argv=None):
    """Train as the config says; returns ``(state, stats)`` of
    ``train.loop.train_clf``: the final TrainState and one dict per
    optimizer step."""
    cfg = bootstrap(argv)
    from psld_tpu_torch.train.loop import train_clf

    return train_clf(cfg.dataset)


if __name__ == "__main__":
    main()
