"""Image decode/encode with PIL: the fallback of `io/native.py` where
libfastio does not build or load, with the same 16-bit rule."""

from __future__ import annotations

import numpy as np
from PIL import Image


def decode_rgb(path) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB.

    16-bit images keep their high byte (as cv2.imread and libpng's
    strip_16 do); PIL's own I->RGB conversion would clip values > 255."""
    im = Image.open(str(path))
    if im.mode in ("I;16", "I;16B", "I;16L", "I"):
        a = np.asarray(im, dtype=np.uint32)
        im = Image.fromarray((a >> 8).astype(np.uint8))
    return np.array(im.convert("RGB"))


def encode_png_gray(path, img: np.ndarray, level: int = 1) -> None:
    """Write an (H, W) uint8 array as a grayscale PNG (fast settings)."""
    Image.fromarray(np.ascontiguousarray(img, np.uint8)).save(
        str(path), compress_level=level)


def encode_png_rgb(path, img: np.ndarray, level: int = 1) -> None:
    """Write an (H, W, 3) uint8 array as an RGB PNG (fast settings)."""
    Image.fromarray(np.ascontiguousarray(img, np.uint8)).save(
        str(path), compress_level=level)
