"""Minimal Hydra-compatible configuration system of the port.

The port's own copy of ``psld_tpu/config.py`` (only ``yaml`` is needed)
and, under ``psld_tpu_torch/configs``, of the JAX package's YAML tree:
the port imports nothing of the JAX package. ``tests/test_torch_config.py``
holds every composed tree equal to the JAX package's, so the two copies
cannot drift.

  * YAML config groups under ``psld_tpu_torch/configs`` selected with
    ``+dataset=cifar10/cifar10_psld``,
  * dotted-path CLI overrides ``dataset.diffusion.training.batch_size=16``,
  * ``+key=val`` to add keys that do not exist yet,
  * ``???`` markers for mandatory fields -- touching one raises.

Values are parsed with ``yaml.safe_load`` so ``[2,2,2]``, ``true``, ``1e-4``
and quoted strings all behave like OmegaConf.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterable, Mapping

import yaml

MISSING = "???"

_CONFIG_ROOT = os.path.join(os.path.dirname(__file__), "configs")


class MissingMandatoryValue(RuntimeError):
    pass


class ConfigDict:
    """Attribute- and item-access view over a nested dict, OmegaConf-style."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    # -- access ------------------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            value = self._data[key]
        except KeyError:
            raise AttributeError(f"Missing config key: {key}") from None
        if value == MISSING:
            raise MissingMandatoryValue(f"Mandatory config value not set: {key}")
        return value

    def __getitem__(self, key: str) -> Any:
        return self.__getattr__(key)

    def get(self, key: str, default: Any = None) -> Any:
        value = self._data.get(key, default)
        return default if value == MISSING else value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self) -> Iterable[str]:
        return self._data.keys()

    def items(self):
        return self._data.items()

    # -- mutation ----------------------------------------------------------
    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    # -- conversion ----------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, ConfigDict) else copy.deepcopy(v)
        return out

    def __repr__(self) -> str:
        return f"ConfigDict({self.to_dict()!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, ConfigDict):
            return self.to_dict() == other.to_dict()
        return NotImplemented


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, Mapping):
        return ConfigDict(value)
    return value


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    # strip shell-escaped quoting
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "'\"":
        return raw[1:-1]
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def _set_dotted(cfg: ConfigDict, path: str, value: Any, allow_new: bool) -> None:
    keys = path.split(".")
    node = cfg
    for key in keys[:-1]:
        if key not in node:
            if not allow_new:
                raise KeyError(
                    f"Override path `{path}` not in config (use +{path}=... to add)"
                )
            node[key] = ConfigDict()
        node = node[key] if node._data[key] != MISSING else node  # pragma: no cover
        if not isinstance(node, ConfigDict):
            raise KeyError(f"Override path `{path}` crosses a leaf at `{key}`")
    leaf = keys[-1]
    if leaf not in node and not allow_new:
        raise KeyError(f"Override key `{path}` not in config (use +{path}=... to add)")
    node[leaf] = value


def load_yaml(path: str) -> ConfigDict:
    with open(path) as f:
        return ConfigDict(yaml.safe_load(f))


def compose(argv: list[str], config_root: str | None = None) -> ConfigDict:
    """Build a config from Hydra-style CLI arguments.

    ``+dataset=cifar10/cifar10_psld`` loads
    ``<config_root>/dataset/cifar10/cifar10_psld.yaml`` under the ``dataset``
    key; every other ``a.b.c=v`` argument is an override (``+a.b.c=v`` adds a
    new key).
    """
    root = config_root or _CONFIG_ROOT
    cfg = ConfigDict()
    overrides: list[tuple[str, Any, bool]] = []
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"Cannot parse CLI argument: {arg!r}")
        key, raw = arg.split("=", 1)
        allow_new = key.startswith("+")
        key = key[1:] if allow_new else key
        value = _parse_value(raw)
        if allow_new and "/" in str(value) and "." not in key and key not in cfg:
            candidate = os.path.join(root, key, f"{value}.yaml")
            if not os.path.exists(candidate):
                raise FileNotFoundError(
                    f"Config group `+{key}={value}` not found: {candidate}"
                )
            cfg[key] = load_yaml(candidate)
            continue
        overrides.append((key, value, allow_new))
    for key, value, allow_new in overrides:
        _set_dotted(cfg, key, value, allow_new)
    return cfg


def validate_no_missing(cfg: ConfigDict, prefix: str = "") -> list[str]:
    """Return dotted paths of all `???` leaves still unset."""
    missing = []
    for k, v in cfg.items():
        path = f"{prefix}{k}"
        if isinstance(v, ConfigDict):
            missing.extend(validate_no_missing(v, prefix=path + "."))
        elif v == MISSING:
            missing.append(path)
    return missing
