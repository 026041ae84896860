"""Export a checkpoint of the port to a reference (mandt-lab/PSLD) PyTorch
Lightning checkpoint, loadable by the reference's own tooling (wrapper.py:31
``score_fn.`` / ``ema_score_fn.`` prefixes, clf_wrapper.py ``clf_fn.``).

Usage::

    python -m psld_tpu_torch.cli.export_checkpoint SRC.pt OUT.ckpt \\
        +dataset=cifar10/cifar10_psld <model overrides matching the ckpt>
    python -m psld_tpu_torch.cli.export_checkpoint SRC.pt OUT.ckpt --clf \\
        +dataset=cifar10/cifar10_psld <clf model overrides>

The model overrides must reproduce the architecture the checkpoint was
trained with (the module walk is config-derived). The Lightning file
carries the checkpoint's step as ``global_step``; a classifier's
``params`` are exported (its EMA is never updated).
"""

from __future__ import annotations

from psld_tpu_torch.cli.convert_checkpoint import parse


def main(argv=None) -> str:
    """Export as the arguments say; returns the written file's path."""
    src, out, is_clf, overrides = parse(argv, __doc__)

    from psld_tpu_torch.cli._common import bootstrap

    cfg = bootstrap(overrides)

    import torch

    from psld_tpu_torch.train import torch_export

    state = torch.load(src, map_location="cpu", weights_only=True)
    if not is_clf:
        sd = torch_export.export_score_state_dict(
            state["params"], state["ema_params"], cfg.dataset.diffusion)
    else:
        sd = torch_export.export_clf_state_dict(state["params"],
                                                cfg.dataset.clf)
    torch_export.save_lightning_checkpoint(out, sd,
                                           step=int(state.get("step", 0)))
    print(out)
    return out


if __name__ == "__main__":
    main()
