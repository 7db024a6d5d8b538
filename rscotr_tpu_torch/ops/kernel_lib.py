"""Build and bind the port's hand-written CUDA kernels.

The sources in ``rscotr_tpu_torch/csrc/*.cu`` expose plain C functions. At
first use each is compiled with its own ``nvcc`` for ``sm_90a`` (all started
together) and the objects are linked into one shared library under
``build/rscotr_tpu_torch/`` (its name carries a hash of the sources and
flags, so an edited source never loads a stale build), bound with
``ctypes``. Nothing is built or imported when this module is imported:
``load()`` runs on the first CUDA launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rscotr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The two bodies of a kernel that has them (K1, K1b, K4, K5, K3'): a lane per
# channel with 2- or 4-byte accesses, and a vector body in which a lane owns
# 4 consecutive channels (8- or 16-byte accesses).
BODY_LANE, BODY_VEC = 0, 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@dataclasses.dataclass(frozen=True)
class Build:
    """One ``build()``: the library, whether nvcc ran, its time and output."""
    path: Path
    compiled: bool
    seconds: float
    log: str


_LIB = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of rscotr_tpu_torch are built on the machine with the card")
    return nvcc


def build() -> Build:
    """Compile csrc/*.cu into one shared library (cached by content)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out = BUILD_DIR / f"librscotr_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, False, 0.0, "")
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = "", []
    for cmd, proc in procs:
        out_text = proc.communicate()[0]
        log += out_text
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out_text}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return Build(out, True, time.perf_counter() - t0, log)


def load() -> ctypes.CDLL:
    """The bound kernel library (built on first call in this process)."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(build().path)
    return _LIB


def _bind(path: Path) -> ctypes.CDLL:
    """Load the library made by ``build`` and declare its C functions."""
    lib = ctypes.CDLL(str(path))
    lib.msda_fwd.argtypes = [_P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                             _I, _I, ctypes.POINTER(ctypes.c_int), _I, _P]
    lib.msda_fwd.restype = _I
    lib.window_attn_fwd.argtypes = [
        _P, _P, _P, _I, ctypes.POINTER(ctypes.c_longlong), _P, _P, _P,
        _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
    lib.window_attn_fwd.restype = _I
    lib.msda_bwd.argtypes = [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I,
                             ctypes.POINTER(ctypes.c_int), _I, _P]
    lib.msda_bwd.restype = _I
    lib.scatter_add.argtypes = [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.scatter_add.restype = _I
    lib.window_attn_bwd.argtypes = [
        _P, _P, _P, _I, ctypes.POINTER(ctypes.c_longlong), _P, _P, _P,
        _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
    lib.window_attn_bwd.restype = _I
    lib.ws_fwd.argtypes = [_P, _P, _I, _P, _L, _I, _I, _I, _P]
    lib.ws_fwd.restype = _I
    lib.ws_bwd.argtypes = [_P, _P, _I, _P, _P, _P, _L, _I, _I, _I, _P]
    lib.ws_bwd.restype = _I
    lib.weighted_gather.argtypes = [_P, _I, _P, _P, _I, _I, _P, _I, _I,
                                    _I, _I, _P]
    lib.weighted_gather.restype = _I
    return lib


def take_body(name: str, body, pick: int, what: str) -> int:
    """The body a launch takes: ``pick`` unless the caller asks for the
    lane body; the vector body is never forced where ``pick`` refuses it
    (``what``: the shape the pick was made for, for the message)."""
    if body is None:
        return pick
    if body not in (BODY_LANE, pick):
        raise ValueError(f"{name}: body {body} does not take {what} at these "
                         "base addresses")
    return body


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
