"""The port's version (the JAX package's ``rscotr_tpu/version.py``)."""

__version__ = "0.1.0"
