"""Device-idle ms a traced request while the host's innermost program
span is one of the DINO head's after the encoder: ``rscotr.det.select``
(two-stage selection), ``rscotr.det.decoder`` or ``rscotr.det.boxes``."""

from bench_h100 import spans

STAGES = ("rscotr.det.select", "rscotr.det.decoder", "rscotr.det.boxes")


def read(run):
    return spans.stage_idle_ms(run, STAGES)
