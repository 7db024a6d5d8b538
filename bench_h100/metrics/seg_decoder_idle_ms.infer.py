"""Device-idle ms a traced request while the host's innermost program
span is ``rscotr.seg.decoder`` (the queries, the masked-attention layers
and every prediction head)."""

from bench_h100 import spans


def read(run):
    return spans.stage_idle_ms(run, ("rscotr.seg.decoder",))
