"""String-keyed component registries of the port (PyTorch counterpart of
rscotr_tpu/config/registry.py, written out again here because the port
imports nothing of the JAX package): ``DATASETS``, ``PIPELINES``,
``HOOKS`` and ``STRATEGIES`` map the configs' ``type`` names to the port's
classes. The model parts are built by ``models.build`` without a registry.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional


class Registry:
    """Names to classes. A child registry (``parent=``) is searched from its
    parent, and the parent's names from the child, as JAX's."""

    def __init__(self, name: str, parent: Optional["Registry"] = None):
        self.name = name
        self._modules: Dict[str, Any] = {}
        self.parent = parent
        self.children: Dict[str, "Registry"] = {}
        if parent is not None:
            parent.children[name] = self

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def __len__(self) -> int:
        return len(self._modules)

    def keys(self):
        return self._modules.keys()

    def get(self, key: str) -> Any:
        if key in self._modules:
            return self._modules[key]
        for child in self.children.values():
            if key in child._modules:
                return child._modules[key]
        if self.parent is not None and key in self.parent._modules:
            return self.parent._modules[key]
        raise KeyError(f"'{key}' not registered in registry "
                       f"'{self.name}' (known: {sorted(self._modules)})")

    def register_module(self, name: Optional[str] = None,
                        module: Optional[Any] = None) -> Callable:
        """A decorator, or with ``module`` a direct registration."""
        def add(obj):
            key = name or obj.__name__
            if key in self._modules:
                raise KeyError(f"'{key}' already registered in "
                               f"'{self.name}'")
            self._modules[key] = obj
            return obj
        if module is not None:
            return add(module)
        return add

    def build(self, cfg: dict, **default_args: Any) -> Any:
        """Instantiate from ``{"type": Name, **kwargs}``."""
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(f"registry build needs a dict with 'type', "
                            f"got {cfg!r}")
        cfg = copy.deepcopy(dict(cfg))
        obj_cls = self.get(cfg.pop("type"))
        for k, v in default_args.items():
            cfg.setdefault(k, v)
        return obj_cls(**cfg)


DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
HOOKS = Registry("hooks")
STRATEGIES = Registry("strategies")
