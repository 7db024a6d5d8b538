"""Stage spans of the serving path, and every trace record of the port
with what reads it.

``span(name)`` is a ``torch._C._profiler._RecordFunctionFast``: a host
range (a kineto ``cpu_op``) that a running ``torch.profiler`` records on
the clock of its device trace, and that costs about a microsecond to
enter and leave when none runs. It is not ``torch.profiler.record_function``,
whose user annotation the profiler also copies onto the device timeline,
where a reader that takes every device event as work would count it as
busy time. While ``torch.compile`` or ``torch.export`` traces, ``span``
is a null context: an exported program carries no spans.

Spans sit at stage boundaries only; those of one request nest on the
host thread under its request span. Each, what it covers, and what reads
it (``bench_h100/metrics/``, on a traced run):

- ``rscotr.request.cls`` / ``rscotr.request.det``: the whole call of
  ``infer_cls`` / ``infer_det``. ``host_syncs.infer`` counts the host's
  stream, device and event synchronisations inside; every metric below is
  a mean over these requests.
- ``rscotr.input``: the pixels and ``img_hw`` to the device, normalised
  (every entry, seg's too): ``input_ms.infer``.
- ``rscotr.backbone``: Swin or ResNet-50: ``backbone_idle_ms.infer``.
- ``rscotr.neck`` (ChannelMapper), ``rscotr.cls_head`` (the cls head),
  ``rscotr.det.embed`` (masks, positional encodings, flattening): no metric
  of their own; a traced run's ``breakdown.idle_gaps`` names them.
- ``rscotr.encoder``: the shared encoder: ``encoder_idle_ms.infer``.
- ``rscotr.det.select`` (two-stage proposals and top-k),
  ``rscotr.det.decoder`` (the decoder and its branches) and
  ``rscotr.det.boxes`` (``dino_get_bboxes``): ``dethead_idle_ms.infer``.

The ``*_idle_ms.infer`` metrics put each device-idle interval down to the
innermost span the host is in: a stage's self time, without its children.

Launch counters, function attributes counted per call on the card:
``ms_deform_attn.launches`` / ``vec_launches`` (K1),
``ms_deform_attn_bwd.launches`` / ``vec_launches`` / ``ordered_launches``
(K1b), ``window_attention.launches`` / ``tc_launches`` (K2),
``window_attention_bwd.launches`` / ``tc_launches`` / ``ordered_launches``
(K2b), ``scatter_add_mm.launches`` / ``vec_launches`` (K3'),
``ws_fwd.launches`` / ``vec_launches`` (K4) and ``ws_bwd.launches`` /
``vec_launches`` (K5). The serve driver of ``bench_h100`` prints the K1
and K2 counts of its window; ``chip_smoke.py`` and the kernel tests read
the rest.
"""

from __future__ import annotations

import contextlib

import torch

REQUEST_CLS = "rscotr.request.cls"
REQUEST_DET = "rscotr.request.det"
INPUT = "rscotr.input"
BACKBONE = "rscotr.backbone"
NECK = "rscotr.neck"
CLS_HEAD = "rscotr.cls_head"
DET_EMBED = "rscotr.det.embed"
ENCODER = "rscotr.encoder"
DET_SELECT = "rscotr.det.select"
DET_DECODER = "rscotr.det.decoder"
DET_BOXES = "rscotr.det.boxes"


def span(name: str):
    """A host span ``name`` for a ``with`` block; a null context while
    ``torch.compile`` or ``torch.export`` traces."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return contextlib.nullcontext()
    return torch._C._profiler._RecordFunctionFast(name)
