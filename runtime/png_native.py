"""ctypes binding for the native PNG codec (runtime/cpp/png_codec.cc).

Build with `make -C runtime/cpp` (produces runtime/libstereo_runtime.so).
`stereo_matchin_tpu.io.png` falls back to its numpy + zlib codec when the
library is absent.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libstereo_runtime.so")


def _load():
    if not os.path.exists(_LIB_PATH):
        raise ImportError(
            f"native runtime not built: {_LIB_PATH} (run `make -C runtime/cpp`)"
        )
    lib = ctypes.CDLL(_LIB_PATH)
    lib.stereo_png_decode_rgba.restype = ctypes.c_int
    lib.stereo_png_decode_rgba.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.c_uint),
    ]
    lib.stereo_png_encode_rgba.restype = ctypes.c_int
    lib.stereo_png_encode_rgba.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_uint,
        ctypes.c_uint,
    ]
    lib.stereo_free.restype = None
    lib.stereo_free.argtypes = [ctypes.c_void_p]
    return lib


_lib = _load()


def decode_rgba(path: str) -> np.ndarray:
    """Decode a PNG to an (H, W, 4) uint8 array."""
    buf = ctypes.POINTER(ctypes.c_ubyte)()
    w = ctypes.c_uint()
    h = ctypes.c_uint()
    rc = _lib.stereo_png_decode_rgba(path.encode(), ctypes.byref(buf),
                                     ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"stereo_png_decode_rgba({path!r}) failed with code {rc}")
    try:
        n = int(w.value) * int(h.value) * 4
        arr = np.ctypeslib.as_array(buf, shape=(n,)).reshape(
            int(h.value), int(w.value), 4).copy()
    finally:
        _lib.stereo_free(buf)
    return arr


def encode_rgba(path: str, rgba: np.ndarray) -> None:
    """Encode an (H, W, 4) uint8 array as PNG."""
    arr = np.ascontiguousarray(rgba, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) uint8, got {arr.shape}")
    h, w = arr.shape[:2]
    rc = _lib.stereo_png_encode_rgba(
        path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_uint(w), ctypes.c_uint(h))
    if rc != 0:
        raise IOError(f"stereo_png_encode_rgba({path!r}) failed with code {rc}")
