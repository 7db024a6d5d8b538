"""Device-idle ms a traced request while the host's innermost program
span is ``rscotr.seg.pixel_decoder`` (input convs, FPN, mask feature) or
the ``rscotr.encoder`` inside it."""

from bench_h100 import spans


def read(run):
    return spans.stage_idle_ms(run, ("rscotr.seg.pixel_decoder",
                                     "rscotr.encoder"))
