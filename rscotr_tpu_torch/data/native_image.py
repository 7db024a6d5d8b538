"""ctypes binding of the native image-decode core (counterpart of
rscotr_tpu/data/native_image.py; its C++ is the port's own copy,
``csrc/host/image_core.cpp``, linked with ``-ljpeg -lpng``).

JPEG / PNG bytes decode to RGB8 with the GIL released for the C call, so
the loader threads decode in parallel. The library is built at first use by
``ops/host_lib.py``. ``imdecode`` returns None when the library is
unavailable (no ``jpeglib.h`` / ``png.h`` on the host: ``available()`` says
so, with the compiler's lines) or the bytes are not a JPEG / PNG it decodes;
``LoadImageFromFile`` then decodes with PIL.

Opt-out: set RSCOTR_NO_NATIVE_IMDECODE=1.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from rscotr_tpu_torch.ops.host_lib import HostLibrary, Status


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.imdecode_dims.restype = ctypes.c_int
    lib.imdecode_dims.argtypes = [u8p, ctypes.c_int64, i32p, i32p]
    lib.imdecode_rgb.restype = ctypes.c_int
    lib.imdecode_rgb.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]


LIBRARY = HostLibrary("image_core.cpp", ("-ljpeg", "-lpng"), _bind)


def available() -> Status:
    """Whether the decoder built here (truthy), else why not."""
    return LIBRARY.status()


def imdecode(data: bytes) -> Optional[np.ndarray]:
    """Decode JPEG / PNG bytes to an (H, W, 3) RGB uint8 array, or None if
    the library is unavailable, opted out of, or the bytes are not
    decodable."""
    if os.environ.get("RSCOTR_NO_NATIVE_IMDECODE"):
        return None
    lib = LIBRARY.load()
    if lib is None or not data:
        return None
    buf = np.frombuffer(data, np.uint8)
    bufp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    w = ctypes.c_int32(0)
    h = ctypes.c_int32(0)
    if lib.imdecode_dims(bufp, len(data), ctypes.byref(w),
                         ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.imdecode_rgb(bufp, len(data),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          out.size)
    return out if rc == 0 else None


def imread(path: str) -> Optional[np.ndarray]:
    """Native file read + decode; None -> the caller decodes with PIL."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return imdecode(data)
