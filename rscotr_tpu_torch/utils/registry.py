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
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Any] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def get(self, key: str) -> Any:
        if key not in self._modules:
            raise KeyError(f"'{key}' not registered in registry "
                           f"'{self.name}' (known: {sorted(self._modules)})")
        return self._modules[key]

    def register_module(self, name: Optional[str] = None) -> Callable:
        def deco(cls):
            key = name or cls.__name__
            if key in self._modules:
                raise KeyError(f"'{key}' already registered in "
                               f"'{self.name}'")
            self._modules[key] = cls
            return cls
        return deco

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
