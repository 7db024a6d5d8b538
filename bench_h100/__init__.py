"""The benchmark of ``rscotr_tpu_torch`` on one NVIDIA H100: one command
runs one cell once and prints one JSON line (see README.md)."""
