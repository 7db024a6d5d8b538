"""Config reader of the port (PyTorch counterpart of
rscotr_tpu/config/config.py, written out again here because the port
imports nothing of the JAX package).

Reads the reference-shaped Python config files under ``configs/``: composes
a file's ``_base_`` chain (later bases and the child deep-merged over
earlier ones; a dict holding ``_delete_=True`` replaces the base subtree),
resolves the child's ``{{_base_.x.y}}`` references against the composed
bases before it runs, then the ``${a.b}`` string references against the
whole tree (mmcv ``replace_cfg_vals``), and returns the composed dict or
its ``model`` part. ``merge_from_dict`` and ``DictAction`` apply dotted
``--cfg-options`` overrides. Unlike the JAX reader this one returns plain
dicts and does not run a config's ``custom_imports`` (which name the JAX
package's model modules).
"""

from __future__ import annotations

import argparse
import ast
import copy
import os
import re
import types
from typing import Any, Dict

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"
_BASE_REF_RE = re.compile(r"\{\{\s*_base_\.([\w.]+)\s*\}\}")
_VAR_REF_RE = re.compile(r"\$\{([\w.]+)\}")


def deep_merge(base: dict, child: dict, allow_list_keys: bool = False
               ) -> dict:
    """Merge ``child`` over ``base``. A child dict holding ``_delete_:
    True`` replaces the base subtree. With ``allow_list_keys``, digit-string
    keys index into a base list (``merge_from_dict``, as mmcv)."""
    if not isinstance(base, dict):
        return copy.deepcopy(child)
    out = copy.deepcopy(base)
    for key, val in child.items():
        if key == DELETE_KEY:
            continue
        if (allow_list_keys and isinstance(val, dict)
                and isinstance(out.get(key), list)
                and all(isinstance(k, str) and k.isdigit() for k in val)):
            lst = out[key]
            for k, v in val.items():
                idx = int(k)
                if idx >= len(lst):
                    raise KeyError(f"index {idx} out of range for list of "
                                   f"length {len(lst)} at key '{key}'")
                lst[idx] = deep_merge(lst[idx], v, allow_list_keys) \
                    if isinstance(v, dict) else copy.deepcopy(v)
            continue
        if isinstance(val, dict):
            if val.get(DELETE_KEY, False):
                out[key] = copy.deepcopy(
                    {k: v for k, v in val.items() if k != DELETE_KEY})
            elif isinstance(out.get(key), dict):
                out[key] = deep_merge(out[key], val, allow_list_keys)
            else:
                out[key] = copy.deepcopy(val)
        else:
            out[key] = copy.deepcopy(val)
    return out


def _get_dotted(tree: dict, dotted: str) -> Any:
    cur: Any = tree
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _exec_pyfile(path: str, base_vars: dict) -> dict:
    """Run a config file with each ``{{_base_.x.y}}`` replaced by a lookup
    into the composed bases."""
    with open(path) as f:
        text = _BASE_REF_RE.sub(lambda m: f'_base_ref_("{m.group(1)}")',
                                f.read())
    ns: Dict[str, Any] = {
        "__file__": path, "os": os,
        "_base_ref_": lambda dotted: copy.deepcopy(
            _get_dotted(base_vars, dotted))}
    exec(compile(text, path, "exec"), ns)
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and k not in ("_base_ref_", "os")
            and not isinstance(v, (types.ModuleType, types.FunctionType,
                                   type))}


def _base_paths(path: str):
    """The file's ``_base_`` entries, read without running the file (its
    ``{{...}}`` references need the bases first)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == BASE_KEY):
            val = ast.literal_eval(node.value)
            return [val] if isinstance(val, str) else list(val)
    return []


def _load(path: str) -> dict:
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"config file not found: {path}")
    if not path.endswith(".py"):
        raise ValueError(f"unsupported config format: {path}")
    base_vars: dict = {}
    for b in _base_paths(path):
        base_vars = deep_merge(base_vars,
                               _load(os.path.join(os.path.dirname(path), b)))
    child = _exec_pyfile(path, base_vars)
    child.pop(BASE_KEY, None)
    return deep_merge(base_vars, child)


def replace_cfg_vals(tree: dict) -> dict:
    """Resolve ``${a.b.c}`` references in string values against the tree:
    a whole-string reference takes the value itself, an embedded one its
    ``str``; an unknown one stays as written."""

    def resolve(obj: Any) -> Any:
        if isinstance(obj, str):
            m = _VAR_REF_RE.fullmatch(obj)
            if m is not None:
                try:
                    return copy.deepcopy(_get_dotted(tree, m.group(1)))
                except (KeyError, TypeError):
                    return obj

            def sub(mm):
                try:
                    return str(_get_dotted(tree, mm.group(1)))
                except (KeyError, TypeError):
                    return mm.group(0)

            return _VAR_REF_RE.sub(sub, obj)
        if isinstance(obj, dict):
            return {k: resolve(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(resolve(v) for v in obj)
        return obj

    return resolve(tree)


def load_cfg(path: str) -> dict:
    """The whole composed config of a file (``model``, ``data``,
    ``optimizer``, ``lr_config``, ...)."""
    return replace_cfg_vals(_load(path))


def load_model_cfg(path: str) -> dict:
    """The composed ``model`` dict of a config file."""
    return load_cfg(path)["model"]


def merge_from_dict(cfg: dict, options: Dict[str, Any],
                    allow_list_keys: bool = True) -> dict:
    """``cfg`` with dotted-key overrides merged in, e.g.
    ``{"model.backbone.depth": 50}``; a digit key indexes into a list
    (``Config.merge_from_dict``)."""
    nested: dict = {}
    for full_key, v in options.items():
        d = nested
        parts = full_key.split(".")
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        d[parts[-1]] = v
    return deep_merge(cfg, nested, allow_list_keys=allow_list_keys)


def parse_cfg_option_value(raw: str) -> Any:
    """A CLI override value: a Python literal, true / false / none / null,
    a comma-separated list, else the string."""
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        pass
    low = raw.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("none", "null"):
        return None
    if "," in raw:
        return [parse_cfg_option_value(x) for x in raw.split(",") if x != ""]
    return raw


class DictAction(argparse.Action):
    """argparse action for ``--cfg-options a.b=1 c=2,3``: collects the
    pairs into a dict of parsed values."""

    def __call__(self, parser, namespace, values, option_string=None):
        opts = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, _, val = kv.partition("=")
            opts[key] = parse_cfg_option_value(val)
        setattr(namespace, self.dest, opts)

    @staticmethod
    def action():
        """This class, for the JAX package's usage
        ``action=DictAction.action()``."""
        return DictAction
