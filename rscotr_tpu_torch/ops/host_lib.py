"""Build and load the port's host C++ libraries (no device code).

The sources in ``rscotr_tpu_torch/csrc/host/*.cpp`` expose plain C functions
for ``ctypes``: the COCO AP / seg confusion core (``coco_eval.cpp``,
``evaluation/native.py``) and the JPEG / PNG decoder (``image_core.cpp``,
``data/native_image.py``). Each is compiled at first use with
``g++ -O3 -fPIC -std=c++17 -shared`` into ``build/rscotr_tpu_torch/``, the
kernel library's directory, under a name that carries a hash of its source,
flags and libraries, so an edited source never loads a stale build. No
``-march=native``: the library may run on another host than the one that
built it. Nothing is built when this module is imported.

A library that does not build (no compiler, a missing header such as
``jpeglib.h``) is reported by ``HostLibrary.status()`` with the compiler's
last lines; its callers then take their numpy / PIL paths, as the JAX
package's do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

from rscotr_tpu_torch.ops.kernel_lib import BUILD_DIR, Build

HOST_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
# the compiler's lines kept in a failed build's reason
_REASON_LINES = 6


class HostBuildError(RuntimeError):
    """``g++`` is missing or refused the source."""


def build(source: str, libs: Sequence[str] = ()) -> Build:
    """Compile ``csrc/host/{source}`` into a shared library (cached by
    content), linked with ``libs`` (e.g. ``("-ljpeg", "-lpng")``)."""
    src = HOST_CSRC / source
    digest = hashlib.sha256(" ".join(CXX_FLAGS + tuple(libs)).encode())
    digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, False, 0.0, "")
    cxx = shutil.which("g++")
    if cxx is None:
        raise HostBuildError("g++ not found on PATH")
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(src), *libs]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        last = "\n".join(log.strip().splitlines()[-_REASON_LINES:])
        raise HostBuildError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                             f"{last}")
    os.replace(tmp, out)
    return Build(out, True, time.perf_counter() - t0, log)


@dataclasses.dataclass(frozen=True)
class Status:
    """Whether a host library built and loaded; ``reason`` is the compiler's
    last lines (or the loader's error) when it did not. True when it did."""
    ok: bool
    reason: str = ""
    build: Optional[Build] = None

    def __bool__(self) -> bool:
        return self.ok


class HostLibrary:
    """One host library, built and bound on the first ``load()`` in the
    process (under a lock: loader threads may ask at once). A failed build
    is remembered and not retried."""

    def __init__(self, source: str, libs: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.source, self.libs, self._bind = source, tuple(libs), bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._status: Optional[Status] = None

    def load(self) -> Optional[ctypes.CDLL]:
        """The bound library, or None when it does not build here."""
        with self._lock:
            if self._status is None:
                try:
                    info = build(self.source, self.libs)
                    lib = ctypes.CDLL(str(info.path))
                    self._bind(lib)
                except (HostBuildError, OSError,
                        subprocess.TimeoutExpired) as e:
                    self._status = Status(False, str(e))
                else:
                    self._lib, self._status = lib, Status(True, "", info)
            return self._lib

    def status(self) -> Status:
        """Build (at first call) and say whether the library is there."""
        self.load()
        return self._status
