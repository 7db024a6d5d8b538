"""Config reader of the port.

Reads the reference-shaped Python config files under ``configs/``: runs a
file, composes its ``_base_`` chain (later bases and the child deep-merged
over earlier ones; a dict holding ``_delete_=True`` replaces the base
subtree) and returns the composed dict or its ``model`` part. This is the
subset of rscotr_tpu.config's loader that the port uses. The port carries
its own because ``chip_smoke.py``, which drives the port on a machine without JAX,
imports nothing of the JAX package, and because that loader imports
``rscotr_tpu.models`` (and so jax) for a config with ``custom_imports``.
"""

from __future__ import annotations

import copy
import os
import runpy
import types


def _merge(base: dict, child: dict) -> dict:
    out = dict(base)
    for key, val in child.items():
        if key == "_delete_":
            continue
        if isinstance(val, dict):
            if val.get("_delete_", False):
                out[key] = {k: v for k, v in val.items() if k != "_delete_"}
            elif isinstance(out.get(key), dict):
                out[key] = _merge(out[key], val)
            else:
                out[key] = val
        else:
            out[key] = val
    return out


def _load(path: str) -> dict:
    ns = runpy.run_path(path)
    cfg = {k: v for k, v in ns.items() if not k.startswith("__") and
           not isinstance(v, (types.ModuleType, types.FunctionType, type))}
    bases = cfg.pop("_base_", [])
    merged: dict = {}
    for b in [bases] if isinstance(bases, str) else bases:
        merged = _merge(merged, _load(os.path.join(os.path.dirname(path), b)))
    return _merge(merged, cfg)


def load_cfg(path: str) -> dict:
    """The whole composed config of a file (``model``, ``data``,
    ``optimizer``, ``lr_config``, ...)."""
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"config file not found: {path}")
    return copy.deepcopy(_load(path))


def load_model_cfg(path: str) -> dict:
    """The composed ``model`` dict of a config file."""
    return load_cfg(path)["model"]
