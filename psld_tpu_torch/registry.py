"""String-keyed component registry of the port (``psld_tpu/registry.py``).

The port keeps its own table: both packages register the same names
(``psld``, ``ncsnpp``, ``em_sde``), and a process that imports both must
not mix them up.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_MODULES: Dict[str, Dict[str, Any]] = {}


def register_module(category: str, name: str | None = None) -> Callable:
    """Class/function decorator registering ``obj`` under
    ``category``/``name``. A duplicate name for a different object raises;
    registering the same object again is a no-op."""

    def _register(obj):
        local_name = obj.__name__ if name is None else name
        cat = _MODULES.setdefault(category, {})
        existing = cat.get(local_name)
        if existing is not None and existing is not obj:
            raise ValueError(
                f"Already registered module `{local_name}` in category "
                f"`{category}`")
        cat[local_name] = obj
        return obj

    return _register


def get_module(category: str, name: str) -> Any:
    module = _MODULES.get(category, {}).get(name)
    if module is None:
        known = sorted(_MODULES.get(category, {}))
        raise ValueError(
            f"No module named `{name}` in category `{category}`; "
            f"known: {known}")
    return module

