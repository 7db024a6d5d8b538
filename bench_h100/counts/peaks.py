"""Published peaks of the cards the benchmark runs on (dense, no
sparsity), keyed by a lower-case substring of the device's name."""

from __future__ import annotations

from typing import Optional

# NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 on the tensor cores,
# 3.35 TB/s of HBM3
PEAK_FLOPS = {"h100": 989e12}
PEAK_BYTES_S = {"h100": 3.35e12}


def _lookup(table, device_name: str) -> Optional[float]:
    name = device_name.lower()
    for key, val in table.items():
        if key in name:
            return val
    return None


def flops(device_name: str) -> Optional[float]:
    return _lookup(PEAK_FLOPS, device_name)


def bytes_s(device_name: str) -> Optional[float]:
    return _lookup(PEAK_BYTES_S, device_name)
