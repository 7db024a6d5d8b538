"""Logging of the port (PyTorch counterpart of ``get_root_logger`` in
rscotr_tpu/utils/logging.py): one named logger, to stdout and, when the
first call names one, to a log file."""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

_LOGGERS: Dict[str, logging.Logger] = {}


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO,
                    name: str = "rscotr_tpu_torch") -> logging.Logger:
    """The logger ``name``, made on its first call (later calls return it
    as it is, as mmcv's does)."""
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    logger.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file, "a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[name] = logger
    return logger
