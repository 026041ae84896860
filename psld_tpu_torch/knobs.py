"""Op-level knobs, config-keyed and env-overridable (``psld_tpu/knobs.py``).

==================  =======================================  ===============
config key          meaning in the port                      env override
==================  =======================================  ===============
model.score_fn.     GroupNorm normalize/act chain of the     PSLD_GN_BF16
  gn_bf16           PLAIN version in the input dtype for
                    bf16 inputs (moment sums stay f32). The
                    Triton kernel always runs the chain in
                    f32, as the TPU kernel did.
model.score_fn.     accepted, no effect: on CUDA the port    --
  fused_gn          always runs its GroupNorm kernel
model.score_fn.     accepted, no effect: the attention       --
  pad_attn          kernel takes any C that is a multiple
                    of 8, so there is no lane padding
==================  =======================================  ===============

``configure(config)`` latches ``gn_bf16`` process-globally when a model is
built from a config, as in the JAX package; ``PSLD_GN_BF16=1/0``
overrides it.
"""

from __future__ import annotations

import os

# None = not configured yet (default off)
_gn_bf16: bool | None = None


def configure(config) -> None:
    """Latch the knobs from a diffusion config subtree; the last model
    built wins."""
    global _gn_bf16
    value = config.model.score_fn.get("gn_bf16")
    if value is not None:
        _gn_bf16 = bool(value)


def gn_bf16() -> bool:
    env = os.environ.get("PSLD_GN_BF16", "")
    if env != "":
        return env == "1"
    return bool(_gn_bf16)
