"""cv2-exact uint8 INTER_LINEAR resize.

Every cv2.resize call of the reference passes the interpolation flag as the
third positional argument (`dst`), so cv2 uses its default INTER_LINEAR
everywhere; the golden outputs are bilinear. This is the port of the JAX
package's `ops/resize.py::resize_linear_u8_cv2exact`: 11-bit fixed-point
coefficients with the SIMD path's intermediate truncations, in int32,

    row = a0 * s[x0] + a1 * s[x1]
    out = (((b0 * (row0 >> 4)) >> 16) + ((b1 * (row1 >> 4)) >> 16) + 2) >> 2

with the source taps picked by `index_select` (the TPU version used one-hot
matmuls). The trainer and its test phase also use the JAX package's true
INTER_NEAREST (`resize_nearest`) and float-weight uint8 INTER_LINEAR
(`resize_linear_u8`); the library uses the float `resize_linear`,
`resize_area` (cv2 INTER_AREA) and `resize_mask_linear_round` (the
reference's mask upscale, which is the cv2-exact uint8 resize).

The float resizes are two products with per-axis weight matrices, as in
the JAX package (which computes them outside any Pallas kernel). Each
output is a sum of at most two nonzero products per axis for
INTER_LINEAR, so a library product rounds it as XLA's does up to the
order of those two terms (within an ulp or two).

Each resize uploads its coefficient tables from host memory, and each such
upload blocks the host until the device's queue drains: a `sync` span of
`utils/profiling.py` while tracing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from unetdc_tpu_torch.utils.profiling import sync


def _coeffs_fixed(src: int, dst: int):
    """cv2 INTER_LINEAR source indices + 11-bit fixed-point coefficients."""
    x0s = np.empty(dst, np.int32)
    a1 = np.empty(dst, np.int32)
    scale = src / dst
    for d in range(dst):
        sx = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(sx))
        a1[d] = int(np.rint((sx - x0) * 2048.0))
        x0s[d] = x0
    x0c = np.clip(x0s, 0, src - 1)
    x1c = np.clip(x0s + 1, 0, src - 1)
    return x0c, x1c, 2048 - a1, a1


def resize_linear_u8_cv2exact(img: torch.Tensor, out_hw: Tuple[int, int]
                              ) -> torch.Tensor:
    """(..., h, w) uint8 -> (..., oh, ow) uint8, bit-exact with this cv2
    build on the pipeline's paths (0/1 masks at any size, resizes to 512).
    A scale-1 resize is exactly the identity in cv2's fixed point and is
    returned as is."""
    oh, ow = out_hw
    h, w = img.shape[-2:]
    if (oh, ow) == (h, w):
        return img
    dev = img.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with sync("resize_tables", 8):
        x0c, x1c, ax0, ax1 = (t(a) for a in _coeffs_fixed(w, ow))
        y0c, y1c, by0, by1 = (t(a) for a in _coeffs_fixed(h, oh))
    s = img.to(torch.int32)
    row = (s.index_select(-1, x0c.long()) * ax0
           + s.index_select(-1, x1c.long()) * ax1)        # (..., h, ow) < 2^20
    r0 = row.index_select(-2, y0c.long()) >> 4
    r1 = row.index_select(-2, y1c.long()) >> 4
    out = (((by0[:, None] * r0) >> 16) + ((by1[:, None] * r1) >> 16) + 2) >> 2
    return out.to(torch.uint8)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2 INTER_NEAREST source index per dst pixel: floor(d * src/dst)."""
    idx = np.floor(np.arange(dst) * (src / dst)).astype(np.int64)
    return np.clip(idx, 0, src - 1)


def resize_nearest(img: torch.Tensor, out_hw: Tuple[int, int],
                   dims: Tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """True cv2 INTER_NEAREST resize of the two dims `dims` (default the
    last two) to (oh, ow)."""
    oh, ow = out_hw
    dy, dx = dims
    h, w = img.shape[dy], img.shape[dx]
    with sync("resize_tables", 2):
        iy = torch.from_numpy(_nearest_index(h, oh)).to(img.device)
        ix = torch.from_numpy(_nearest_index(w, ow)).to(img.device)
    return img.index_select(dy, iy).index_select(dx, ix)


def _linear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear weight matrix, cv2 INTER_LINEAR convention
    (half-pixel centres, edge clamp) with 11-bit quantized weights."""
    w = np.zeros((dst, src), np.float32)
    scale = src / dst
    for d in range(dst):
        sx = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(sx))
        fq = np.rint((sx - x0) * 2048.0) / 2048.0
        w[d, min(max(x0, 0), src - 1)] += 1.0 - fq
        w[d, min(max(x0 + 1, 0), src - 1)] += fq
    return w


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) box-average weight matrix (cv2 INTER_AREA downscale):
    dst pixel d covers the source span [d*s, (d+1)*s), weighted by the
    fractional overlap."""
    w = np.zeros((dst, src), np.float32)
    s = src / dst
    for d in range(dst):
        lo, hi = d * s, (d + 1) * s
        for i in range(int(np.floor(lo)), min(int(np.ceil(hi)), src)):
            overlap = min(hi, i + 1) - max(lo, i)
            if overlap > 0:
                w[d, i] = overlap / s
    return w


def _apply_sep(img: torch.Tensor, wy: np.ndarray, wx: np.ndarray
               ) -> torch.Tensor:
    """Per-axis weight matrices applied to (H, W) or (H, W, C), float32."""
    with sync("resize_tables", 2):
        wy = torch.from_numpy(wy).to(img.device)
        wx = torch.from_numpy(wx).to(img.device)
    x = img.to(torch.float32)
    if x.dim() == 2:
        return wy @ x @ wx.T
    return torch.einsum("ew,dwc->dec", wx, torch.einsum("dh,hwc->dwc", wy, x))


def resize_linear(img: torch.Tensor, out_hw: Tuple[int, int]
                  ) -> torch.Tensor:
    """cv2 INTER_LINEAR resize of (H, W) or (H, W, C) to (oh, ow), float32
    out (no rounding)."""
    oh, ow = out_hw
    h, w = img.shape[:2]
    return _apply_sep(img, _linear_weights(h, oh), _linear_weights(w, ow))


def resize_area(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_AREA (box-average) downscale of (H, W) or (H, W, C),
    float32 out; an axis that grows is resized bilinearly, as OpenCV
    does."""
    oh, ow = out_hw
    h, w = img.shape[:2]
    wy = _area_weights(h, oh) if oh <= h else _linear_weights(h, oh)
    wx = _area_weights(w, ow) if ow <= w else _linear_weights(w, ow)
    return _apply_sep(img, wy, wx)


def resize_mask_linear_round(mask: torch.Tensor, out_hw: Tuple[int, int]
                             ) -> torch.Tensor:
    """Resize a 0/1 mask as the reference does: uint8 bilinear through
    cv2's fixed-point kernel -> 0/1 uint8."""
    return resize_linear_u8_cv2exact(mask.to(torch.uint8), tuple(out_hw))


def resize_linear_u8(img: torch.Tensor, out_hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """INTER_LINEAR resize of (H, W) or (H, W, C) to uint8, the JAX
    package's `resize_linear_u8`: two f32 weight-matrix products (rows,
    then columns) and floor(v + 0.5). It may differ from cv2 by 1 at exact
    fixed-point rounding ties."""
    y = resize_linear(img, out_hw)
    return torch.clamp(torch.floor(y + 0.5), 0, 255).to(torch.uint8)
