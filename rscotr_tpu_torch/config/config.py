"""``Config``: the composed config with attribute access (PyTorch
counterpart of rscotr_tpu/config/config.py, with its surface).

It reads files with the port's own reader (``utils/config.py``: ``_base_``
chains, ``_delete_``, ``{{_base_.x}}`` and ``${a.b}`` references), so
``Config.fromfile(path).to_dict()`` is ``utils.config.load_cfg(path)``.
On top it keeps the JAX class's surface: ``fromfile``, ``fromdict``,
``filename``, ``to_dict``, ``copy``, ``merge_from_dict``, ``dump`` and the
mapping methods, values as ``ConfigDict`` (a dict with attribute access).
A config's ``custom_imports`` stay in the tree and are not run: they name
the reference's model modules, and the registries of ``config.registry``
are filled when this package is imported.
"""

from __future__ import annotations

import copy
import os
import pprint
from typing import Any, Dict, Optional

from rscotr_tpu_torch.utils.config import _load
from rscotr_tpu_torch.utils.config import \
    merge_from_dict as _merge_from_dict
from rscotr_tpu_torch.utils.config import replace_cfg_vals

RESERVED_KEYS = ("filename", "text")


class ConfigDict(dict):
    """A dict with attribute access; a missing name raises AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"'ConfigDict' object has no attribute '{name}'") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    def copy(self) -> "ConfigDict":
        return copy.deepcopy(self)


def _to_config_dict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _to_plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_plain(v) for v in obj)
    return obj


class Config:
    """Composed configuration with attribute access: ``Config.fromfile``
    composes a file's ``_base_`` chain; the result behaves as a
    ``ConfigDict`` plus ``filename``, ``dump`` and ``merge_from_dict``."""

    def __init__(self, cfg_dict: Optional[dict] = None,
                 filename: Optional[str] = None):
        cfg_dict = cfg_dict or {}
        for k in RESERVED_KEYS:
            if k in cfg_dict:
                raise KeyError(f"'{k}' is reserved")
        object.__setattr__(self, "_cfg_dict", _to_config_dict(cfg_dict))
        object.__setattr__(self, "_filename", filename)

    @staticmethod
    def fromfile(path: str, resolve_vars: bool = True) -> "Config":
        tree = _load(path)
        if resolve_vars:
            tree = replace_cfg_vals(tree)
        return Config(tree, filename=os.path.abspath(path))

    @staticmethod
    def fromdict(d: dict) -> "Config":
        return Config(copy.deepcopy(d))

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = _to_config_dict(value)

    def __getitem__(self, key):
        return self._cfg_dict[key]

    def __setitem__(self, key, value):
        self._cfg_dict[key] = _to_config_dict(value)

    def __contains__(self, key):
        return key in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __len__(self):
        return len(self._cfg_dict)

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def pop(self, key, *default):
        return self._cfg_dict.pop(key, *default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def values(self):
        return self._cfg_dict.values()

    def setdefault(self, key, default=None):
        return self._cfg_dict.setdefault(key, _to_config_dict(default))

    def to_dict(self) -> dict:
        return _to_plain(self._cfg_dict)

    def copy(self) -> "Config":
        return Config(self.to_dict(), filename=self._filename)

    def __repr__(self):
        return f"Config(file={self._filename}): {dict(self._cfg_dict)!r}"

    def merge_from_dict(self, options: Dict[str, Any],
                        allow_list_keys: bool = True) -> None:
        """Merge dotted-key options, e.g. ``{"model.backbone.depth": 50}``;
        a digit key indexes into a list."""
        merged = _merge_from_dict(_to_plain(self._cfg_dict), options,
                                  allow_list_keys=allow_list_keys)
        object.__setattr__(self, "_cfg_dict", _to_config_dict(merged))

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """The config as a Python-literal file (or its text, without
        ``path``)."""
        text = "".join(f"{k} = {pprint.pformat(_to_plain(v), width=88)}\n"
                       for k, v in self._cfg_dict.items())
        if path is None:
            return text
        with open(path, "w") as f:
            f.write(text)
        return None
