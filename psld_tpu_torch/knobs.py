"""Op-level knobs, config-keyed and env-overridable (``psld_tpu/knobs.py``).

==================  =======================================  ===============
config key          meaning in the port                      env override
==================  =======================================  ===============
model.score_fn.     GroupNorm normalize/affine/act chain in  PSLD_GN_BF16
  gn_bf16           bf16 for bf16 inputs, with the JAX
                    package's rounding points (moment sums
                    stay f32), in the plain version and, on
                    CUDA, in both GroupNorm kernels (forward
                    and backward), read at every call. A
                    deliberate difference: the JAX
                    package's TPU kernel (fused_gn=true)
                    ignores gn_bf16 and runs f32; its jnp
                    chain and its VJP honour it, and the
                    port's kernels are its only card path.
model.score_fn.     resblock dropout: hw and hw_inline =     --
  dropout_impl      the counter-hash kernel, save_mask and
                    remat = a saved Bernoulli mask; see
                    ``models.layers.DropoutSites``
model.score_fn.     accepted, no effect: on CUDA the port    --
  fused_gn          always runs its GroupNorm kernels
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


def _model_fn(config):
    """``model.score_fn`` of a diffusion subtree, ``model.clf_fn`` of a
    classifier subtree."""
    return config.model.get("score_fn") or config.model.get("clf_fn")


def configure(config) -> None:
    """Latch the knobs from a diffusion or classifier config subtree; the
    last model built wins."""
    global _gn_bf16
    value = _model_fn(config).get("gn_bf16")
    if value is not None:
        _gn_bf16 = bool(value)


def gn_bf16() -> bool:
    env = os.environ.get("PSLD_GN_BF16", "")
    if env != "":
        return env == "1"
    return bool(_gn_bf16)


def resolved(config=None) -> dict:
    """The effective knob values (``PSLD_GN_BF16`` applied), for a run's
    metadata: ``gn_bf16`` takes effect on every GroupNorm of a bf16
    network, on the CPU and, through both GroupNorm kernels, on CUDA.
    With a config, also the model-threaded ``dropout_impl``."""
    from psld_tpu_torch.models.layers import resolve_dropout_impl

    out = {"gn_bf16": gn_bf16()}
    if config is not None:
        sf = _model_fn(config)
        out["dropout_impl"] = resolve_dropout_impl(
            str(sf.get("dropout_impl", "save_mask")))
    return out
