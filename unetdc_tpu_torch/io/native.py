"""Native image IO: a ctypes wrapper over `libfastio` (native/fastio.cpp)
with the PIL codecs of `io/images.py` as fallback; port of the JAX
package's `io/native.py`.

libfastio decodes PNG/JPEG straight into packed RGB (16-bit PNGs keep
their high byte, palettes expand, alpha is stripped) and writes masks as
filter-NONE, level-1 PNGs. The library is built from the tracked source at
first use (`utils/native_build.py`: g++ with libpng, libjpeg and zlib,
into `unetdc_tpu_torch/_build/native/`). Where it does not build or load,
every entry point uses PIL instead, as the JAX module does;
`native_available()` says which codec runs.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from unetdc_tpu_torch.io import images as pil
from unetdc_tpu_torch.utils import native_build

_U8P = ctypes.POINTER(ctypes.c_ubyte)
_IP = ctypes.POINTER(ctypes.c_int)


@native_build.once
def _load() -> Optional[ctypes.CDLL]:
    lib = native_build.load("fastio", libs=("-lpng", "-ljpeg", "-lz"))
    if lib is None:
        return None
    for name, args in [
        ("decode_png_rgb", [ctypes.c_char_p, _IP, _IP, _U8P]),
        ("decode_jpeg_rgb", [ctypes.c_char_p, _IP, _IP, _U8P]),
        ("encode_png_gray",
         [ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
        ("encode_png_rgb",
         [ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    """True when libfastio built and loaded (else PIL does the IO)."""
    return _load() is not None


def decode_rgb(path) -> np.ndarray:
    """Decode a PNG/JPEG file to (H, W, 3) uint8 RGB (other formats, and
    files libfastio refuses, through PIL)."""
    path = str(path)
    lib = _load()
    suffix = os.path.splitext(path)[1].lower()
    if lib is None or suffix not in (".png", ".jpg", ".jpeg"):
        return pil.decode_rgb(path)
    fn = lib.decode_png_rgb if suffix == ".png" else lib.decode_jpeg_rgb
    w, h = ctypes.c_int(), ctypes.c_int()
    pathb = path.encode()
    if fn(pathb, ctypes.byref(w), ctypes.byref(h), None) != 0:
        return pil.decode_rgb(path)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if fn(pathb, ctypes.byref(w), ctypes.byref(h),
          out.ctypes.data_as(_U8P)) != 0:
        return pil.decode_rgb(path)
    return out


def _encode(name: str, fallback, path, img: np.ndarray, level: int) -> None:
    lib = _load()
    if lib is not None and getattr(lib, name)(
            str(path).encode(), img.ctypes.data_as(_U8P), img.shape[0],
            img.shape[1], level) == 0:
        return
    fallback(path, img, level)


def encode_png_gray(path, img: np.ndarray, level: int = 1) -> None:
    """Write an (H, W) uint8 array as a grayscale PNG (fast settings)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"encode_png_gray takes (H, W), got {img.shape}")
    _encode("encode_png_gray", pil.encode_png_gray, path, img, level)


def encode_png_rgb(path, img: np.ndarray, level: int = 1) -> None:
    """Write an (H, W, 3) uint8 array as an RGB PNG (fast settings)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png_rgb takes (H, W, 3), got {img.shape}")
    _encode("encode_png_rgb", pil.encode_png_rgb, path, img, level)
