"""Device-idle ms a traced request while the host's innermost program
span is ``rscotr.encoder`` (the shared MSDA encoder)."""

from bench_h100 import spans


def read(run):
    return spans.stage_idle_ms(run, ("rscotr.encoder",))
