"""Device-idle ms a traced request while the host's innermost program
span is ``rscotr.seg.semantic`` (upsampling, sigmoid, the class product
and the argmax)."""

from bench_h100 import spans


def read(run):
    return spans.stage_idle_ms(run, ("rscotr.seg.semantic",))
