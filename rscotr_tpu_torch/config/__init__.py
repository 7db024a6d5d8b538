"""The config path of the JAX package (``rscotr_tpu.config``) in the port:
``Config`` and ``ConfigDict`` (``config.py``) over the port's reader
``utils/config.py``, whose ``DictAction``, ``deep_merge``,
``parse_cfg_option_value`` and ``replace_cfg_vals`` are re-exported, and
the ten registries (``registry.py``)."""

from rscotr_tpu_torch.config.config import Config, ConfigDict
from rscotr_tpu_torch.config.registry import (BACKBONES, DATASETS, HEADS,
                                              HOOKS, MODELS, NECKS,
                                              OPTIMIZER_BUILDERS, PIPELINES,
                                              STRATEGIES, TRANSFORMERS,
                                              Registry)
from rscotr_tpu_torch.utils.config import (DictAction, deep_merge,
                                           parse_cfg_option_value,
                                           replace_cfg_vals)

__all__ = [
    "Config", "ConfigDict", "DictAction", "deep_merge",
    "parse_cfg_option_value", "replace_cfg_vals", "Registry",
    "MODELS", "BACKBONES", "NECKS", "HEADS", "TRANSFORMERS", "DATASETS",
    "PIPELINES", "STRATEGIES", "HOOKS", "OPTIMIZER_BUILDERS",
]
