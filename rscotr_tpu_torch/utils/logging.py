"""Logging of the port (PyTorch counterpart of rscotr_tpu/utils/logging.py):
one named logger, to stdout and to a log file; the metric sink the log
hook writes; and the environment report the train tool logs first.

Metrics go to JSONL always and to TensorBoard when
``torch.utils.tensorboard`` imports (no hard dependency).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

_LOGGERS: Dict[str, logging.Logger] = {}


def _rank() -> int:
    try:
        import torch.distributed as dist
    except ImportError:
        return 0
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO,
                    name: str = "rscotr_tpu_torch") -> logging.Logger:
    """The logger ``name``, made on its first call. A call that names a
    log file the logger does not write yet moves its file handler there
    (a process that evaluates, then trains, logs the training to the
    run's ``train.log``); other calls return it as it is. On a rank other
    than 0 of a process group it logs errors only, to no file."""
    logger = _LOGGERS.get(name)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if logger is None:
        logger = logging.getLogger(name)
        logger.setLevel(log_level)
        logger.propagate = False
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        _LOGGERS[name] = logger
    if _rank() != 0:
        # mmcv's rule: ranks other than 0 log errors only, to no file
        logger.setLevel(logging.ERROR)
        return logger
    if log_file is not None:
        path = os.path.abspath(log_file)
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path, "a")
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricsSink:
    """Writes scalar metrics to ``log_dir/metrics.jsonl`` (one JSON object
    a call, flushed) and to TensorBoard under ``log_dir/tb`` when a writer
    imports."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, filename)
        self._file = open(self._path, "a")
        self._tb = None
        try:  # optional: the tensorboard package may be absent
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
        except ImportError:
            self._tb = None

    def log_scalars(self, step: int, scalars: Dict[str, Any]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k in ("step", "time") or not isinstance(v, float):
                    continue
                self._tb.add_scalar(k, v, global_step=step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()


def collect_env() -> Dict[str, str]:
    """Python, platform, torch, CUDA and the card (in place of the JAX
    package's jax and flax entries)."""
    import platform

    import numpy as np
    import torch

    info = {
        "python": sys.version.replace("\n", " "),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "torch_cuda": str(torch.version.cuda),
        "numpy": np.__version__,
        "cuda_available": str(torch.cuda.is_available()),
    }
    if torch.cuda.is_available():
        info["devices"] = ", ".join(
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count()))
        info["cudnn"] = str(torch.backends.cudnn.version())
    return info
