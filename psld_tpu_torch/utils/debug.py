"""Debug-mode numerics guards (``psld_tpu/utils/debug.py``).

The reference's covariance factorizations raise ``ValueError("Numerical
precision error.")`` on a NaN (reference main/models/sde/psld.py:167-171,
180-185, 200-205, 214-219). Checking every call would read a flag back
from the device each time, so the check runs only when
``PSLD_DEBUG_NUMERICS`` is set; unset, :func:`check_finite` returns
before it touches a tensor, and nothing waits for the device. The JAX
package compiles the same guard into its programs with ``checkify`` and
discharges it after a dispatch (its ``checked_call``); eager PyTorch
raises at the check itself, so the port has no counterpart of that
wrapper.
"""

from __future__ import annotations

import os

import torch

_ENV_FLAG = "PSLD_DEBUG_NUMERICS"


def numerics_debug_enabled() -> bool:
    """True when PSLD_DEBUG_NUMERICS is set to a truthy value."""
    return os.environ.get(_ENV_FLAG, "").strip() not in ("", "0", "false")


def check_finite(name: str, *tensors) -> None:
    """Raise ``ValueError("Numerical precision error. (<name>)")`` when a
    value of ``tensors`` is not finite and debug mode is on (one read of
    the device); a no-op that reads nothing when it is off."""
    if not numerics_debug_enabled():
        return
    ok = all(bool(torch.isfinite(t).all()) for t in tensors)
    if not ok:
        raise ValueError(f"Numerical precision error. ({name})")
