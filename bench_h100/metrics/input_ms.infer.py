"""Host ms a traced request spends inside the program's ``rscotr.input``
span: the pixels and ``img_hw`` to the card, normalised."""

from bench_h100 import spans


def read(run):
    return spans.input_ms(run)
