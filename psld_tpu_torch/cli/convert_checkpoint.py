"""Convert a reference (mandt-lab/PSLD) PyTorch Lightning checkpoint into
a checkpoint of the port, usable as ``evaluation.chkpt_path`` or
``training.restore_path``.

Usage::

    python -m psld_tpu_torch.cli.convert_checkpoint SRC.ckpt OUT.pt \\
        +dataset=cifar10/cifar10_psld <model overrides matching the ckpt>
    python -m psld_tpu_torch.cli.convert_checkpoint SRC.ckpt OUT.pt --clf \\
        +dataset=cifar10/cifar10_psld <clf model overrides>

The model overrides must reproduce the architecture the checkpoint was
trained with (the same keys as the reference's own sampling scripts). The
converted checkpoint carries ``params`` and ``ema_params`` from the
checkpoint (a classifier's ``params`` in both), a fresh optimizer state
and step 0. ``OUT`` gets the suffix ``.pt`` when it lacks one.
"""

from __future__ import annotations

import os
import re
import sys

# a Hydra-style override is `key=value` / `+key=value` with a dotted
# identifier key; checkpoint PATHS can legitimately contain `=` (Lightning
# names like `...-epoch=0999.ckpt`, the port's `...-epoch=0042-...pt`), so
# an `=`-bearing arg still counts as positional when it points at an
# existing file or carries a checkpoint extension (Lightning's DEFAULT
# filename `epoch=0-step=999.ckpt` would otherwise parse as an override)
_OVERRIDE = re.compile(r"^\+?[\w.]+=")


def _split_args(argv):
    def is_positional(a):
        if not _OVERRIDE.match(a):
            return True
        return os.path.exists(a) or a.endswith((".ckpt", ".pt", ".pth"))

    positional = [a for a in argv if is_positional(a)]
    overrides = [a for a in argv if not is_positional(a)]
    return positional, overrides


def parse(argv, doc: str):
    """(source, output, is_clf, overrides) of a conversion's arguments."""
    argv = list(sys.argv[1:] if argv is None else argv)
    is_clf = "--clf" in argv
    if is_clf:
        argv.remove("--clf")
    positional, overrides = _split_args(argv)
    if len(positional) != 2:
        raise SystemExit(doc)
    src, out = positional
    return src, out, is_clf, overrides


def main(argv=None) -> str:
    """Convert as the arguments say; returns the written checkpoint's
    path."""
    src, out, is_clf, overrides = parse(argv, __doc__)

    from psld_tpu_torch.cli._common import bootstrap

    cfg = bootstrap(overrides)

    from psld_tpu_torch.train import checkpoint as ckpt
    from psld_tpu_torch.train import torch_import
    from psld_tpu_torch.train.state import TrainState, make_optimizer

    if not is_clf:
        dcfg = cfg.dataset.diffusion
        params, ema_params = torch_import.convert_score_checkpoint(src, dcfg)
        optimizer = make_optimizer(dcfg.training.optimizer)
    else:
        ccfg = cfg.dataset.clf
        params = ema_params = torch_import.convert_clf_checkpoint(src, ccfg)
        optimizer = make_optimizer(ccfg.training.optimizer)
    state = TrainState(step=0, params=params, ema_params=ema_params,
                       opt_state=optimizer.init(params))

    name = os.path.basename(out)
    if name.endswith(ckpt.SUFFIX):
        name = name[:-len(ckpt.SUFFIX)]
    path = ckpt.save_checkpoint(os.path.dirname(os.path.abspath(out)), name,
                                state)
    print(path)
    return path


if __name__ == "__main__":
    main()
