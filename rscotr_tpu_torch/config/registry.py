"""The ten registries of the JAX package's ``rscotr_tpu.config`` in the
port (PyTorch counterpart of rscotr_tpu/config/registry.py).

``DATASETS``, ``PIPELINES``, ``HOOKS`` and ``STRATEGIES`` are the port's
own objects of ``utils/registry.py``, filled as their modules import
(``data``, ``engine.hooks``). ``MODELS``, ``BACKBONES``, ``NECKS``,
``HEADS``, ``TRANSFORMERS`` and ``OPTIMIZER_BUILDERS`` hold the port's
classes under the JAX names: ``MTL``, ``DINO``, ``RSCoTrSeg``;
``SwinTransformer``, ``ResNet``; ``ChannelMapper``; ``DINOHead``,
``Mask2FormerHead``, ``SlvlClsHead``, ``MlvlClsHead``. ``TRANSFORMERS``
and ``OPTIMIZER_BUILDERS`` are empty, as JAX's are. No name of a JAX
registry lacks a port class. ``models.build_model`` keeps its own dispatch
on ``type``: these registries are for lookup.
"""

from __future__ import annotations

from rscotr_tpu_torch.models.backbones.resnet import ResNet
from rscotr_tpu_torch.models.backbones.swin import SwinTransformer
from rscotr_tpu_torch.models.dino import DINO
from rscotr_tpu_torch.models.heads.cls_heads import MlvlClsHead, SlvlClsHead
from rscotr_tpu_torch.models.heads.dino_head import DINOHead
from rscotr_tpu_torch.models.heads.mask2former_head import Mask2FormerHead
from rscotr_tpu_torch.models.mtl import MTL
from rscotr_tpu_torch.models.necks.channel_mapper import ChannelMapper
from rscotr_tpu_torch.models.rscotr_seg import RSCoTrSeg
from rscotr_tpu_torch.utils.registry import (DATASETS, HOOKS, PIPELINES,
                                             STRATEGIES, Registry)

MODELS = Registry("models")
BACKBONES = Registry("backbones", parent=MODELS)
NECKS = Registry("necks", parent=MODELS)
HEADS = Registry("heads", parent=MODELS)
TRANSFORMERS = Registry("transformers", parent=MODELS)
OPTIMIZER_BUILDERS = Registry("optimizer_builders")

for _reg, _classes in ((MODELS, (MTL, DINO, RSCoTrSeg)),
                       (BACKBONES, (SwinTransformer, ResNet)),
                       (NECKS, (ChannelMapper,)),
                       (HEADS, (DINOHead, Mask2FormerHead, SlvlClsHead,
                                MlvlClsHead))):
    for _cls in _classes:
        _reg.register_module(module=_cls)

__all__ = ["Registry", "MODELS", "BACKBONES", "NECKS", "HEADS",
           "TRANSFORMERS", "DATASETS", "PIPELINES", "STRATEGIES", "HOOKS",
           "OPTIMIZER_BUILDERS"]
