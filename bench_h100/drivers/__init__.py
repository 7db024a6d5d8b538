"""Drivers: one per kind of entry a cell drives (``driver`` in the
cell's workload file)."""
