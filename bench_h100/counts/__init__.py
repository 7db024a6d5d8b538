"""Operations and bytes computed from shapes alone, and the card's peaks.

Frozen here so that a change to the program cannot move the yardstick:
the kernel formulas follow ``rscotr_tpu_torch/ops/flops.py`` and the byte
bounds ``chip_smoke.py`` (inputs and outputs once, at 3.35 TB/s); the peak
table follows ``rscotr_tpu_torch/tools/benchmark.py``'s ``peak_flops``.
"""
