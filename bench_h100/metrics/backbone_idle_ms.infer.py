"""Device-idle ms a traced request while the host's innermost program
span is ``rscotr.backbone`` (Swin or ResNet-50)."""

from bench_h100 import spans


def read(run):
    return spans.stage_idle_ms(run, ("rscotr.backbone",))
