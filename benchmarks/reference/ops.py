"""Plain reference versions of the image operations around the model, as
the reference repository's scripts perform them with OpenCV, SciPy and
scikit-image (utils/data_loader.py, quantify_droplets_batch.py,
algorithms.py), written from those libraries' documented arithmetic:

- `rolling_ball`: a grey opening with cv2.getStructuringElement(
  MORPH_ELLIPSE, (k, k)) (borders never shrink or grow the result), a
  saturating subtraction, then cv2.normalize(NORM_MINMAX) to 0..255 with
  round-half-even;
- `resize_u8`: cv2.resize INTER_LINEAR on uint8, in cv2's 11-bit fixed
  point (the coefficients and the truncations of its vector path), as it
  runs for the scales the pipelines use (halving, doubling);
- `resize_float`: cv2.resize INTER_LINEAR on float32 (half-pixel centres,
  edge clamp, unquantised weights);
- `resize_nearest`: cv2 INTER_NEAREST;
- `droplet_table`: skimage.measure.label (4-connectivity, labels in raster
  order of first pixel) and regionprops' area, equivalent diameter and
  centroid, computed here with scipy.ndimage.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def ellipse_rows(ksize: int):
    """[(dy, lo, hi)]: row dy of cv2's MORPH_ELLIPSE element of size ksize
    spans columns -lo..hi around the anchor (ksize // 2); cv2 clips each
    row to the element's box, so an even size is one shorter on the right
    and at the bottom."""
    r = ksize // 2
    rows = []
    for i in range(ksize):
        dy = i - r
        dx = int(np.rint(r * math.sqrt(max(r * r - dy * dy, 0) / (r * r))))
        rows.append((dy, min(dx, r), min(dx, ksize - 1 - r)))
    return rows


def _morph(x: torch.Tensor, ksize: int, erode: bool) -> torch.Tensor:
    """cv2.erode / cv2.dilate of (N, H, W) float32 with the ellipse; the
    padding is +inf for erosion and -inf for dilation."""
    sign = -1.0 if erode else 1.0
    y = sign * x
    h, w = y.shape[-2:]
    flat = y.reshape(-1, 1, w)
    horiz = {}
    for _, lo, hi in ellipse_rows(ksize):
        if (lo, hi) not in horiz:
            padded = F.pad(flat, (lo, hi), value=-math.inf)
            horiz[(lo, hi)] = F.max_pool1d(padded, lo + hi + 1, 1).reshape(
                y.shape)
    out = torch.full_like(y, -math.inf)
    for dy, lo, hi in ellipse_rows(ksize):
        src = horiz[(lo, hi)]
        # out[y] = max(out[y], src[y + dy]), -inf where y + dy is outside
        a, b = max(0, -dy), min(h, h - dy)
        if a < b:
            out[..., a:b, :] = torch.maximum(out[..., a:b, :],
                                             src[..., a + dy:b + dy, :])
    return sign * out


def rolling_ball(planes_u8: torch.Tensor, radius: int = 50) -> torch.Tensor:
    """(N, H, W) uint8 -> background-corrected uint8."""
    x = planes_u8.to(torch.float32)
    opened = _morph(_morph(x, radius, True), radius, False)
    corr = torch.clamp(x - opened, min=0.0)
    mn = corr.amin((-2, -1), keepdim=True)
    span = corr.amax((-2, -1), keepdim=True) - mn
    scale = torch.where(span > 0, 255.0 / span, torch.zeros_like(span))
    return torch.clamp(torch.round((corr - mn) * scale), 0, 255).to(
        torch.uint8)


def _taps(src: int, dst: int):
    x0, a1 = [], []
    for d in range(dst):
        sx = (d + 0.5) * (src / dst) - 0.5
        f = math.floor(sx)
        x0.append(f)
        a1.append(int(np.rint((sx - f) * 2048.0)))
    x0 = np.array(x0)
    return (np.clip(x0, 0, src - 1), np.clip(x0 + 1, 0, src - 1),
            2048 - np.array(a1), np.array(a1))


def resize_u8(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_LINEAR of (..., h, w) uint8 to (..., oh, ow) uint8."""
    h, w = img.shape[-2:]
    if (h, w) == tuple(out_hw):
        return img.clone()
    dev = img.device
    ix0, ix1, ax0, ax1 = (torch.as_tensor(a, device=dev)
                          for a in _taps(w, out_hw[1]))
    iy0, iy1, by0, by1 = (torch.as_tensor(a, device=dev)
                          for a in _taps(h, out_hw[0]))
    s = img.to(torch.int64)
    row = s[..., ix0] * ax0 + s[..., ix1] * ax1
    r0 = row[..., iy0, :] >> 4
    r1 = row[..., iy1, :] >> 4
    out = (((by0[:, None] * r0) >> 16) + ((by1[:, None] * r1) >> 16) + 2) >> 2
    return out.to(torch.uint8)


def _weights(src: int, dst: int, dev) -> torch.Tensor:
    """(dst, src) float INTER_LINEAR weights: cv2's float path keeps the
    fraction unquantised."""
    w = torch.zeros(dst, src, dtype=torch.float64)
    for d in range(dst):
        sx = (d + 0.5) * (src / dst) - 0.5
        f = math.floor(sx)
        fx = sx - f
        w[d, min(max(f, 0), src - 1)] += 1.0 - fx
        w[d, min(max(f + 1, 0), src - 1)] += fx
    return w.to(dev, torch.float32)


def resize_float(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_LINEAR of (H, W, C) float32 to (oh, ow, C) float32."""
    h, w = img.shape[:2]
    wy = _weights(h, out_hw[0], img.device)
    wx = _weights(w, out_hw[1], img.device)
    return torch.einsum("yh,hwc,xw->yxc", wy, img.to(torch.float32), wx)


def resize_nearest(img: torch.Tensor, out_hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """cv2 INTER_NEAREST of the last two dims."""
    h, w = img.shape[-2:]
    iy = np.minimum(np.floor(np.arange(out_hw[0]) * (h / out_hw[0])),
                    h - 1).astype(np.int64)
    ix = np.minimum(np.floor(np.arange(out_hw[1]) * (w / out_hw[1])),
                    w - 1).astype(np.int64)
    return img[..., torch.as_tensor(iy, device=img.device), :][
        ..., torch.as_tensor(ix, device=img.device)]


def droplet_table(mask: np.ndarray) -> np.ndarray:
    """(n, 5) float64 rows [label, area, equivalent_diameter, centroid-0,
    centroid-1] of the 4-connected components of a 0/1 mask, labels in
    raster order of each component's first pixel."""
    from scipy import ndimage

    labels, n = ndimage.label(mask > 0)
    if n == 0:
        return np.zeros((0, 5))
    flat = labels.ravel()
    yy, xx = np.indices(mask.shape)
    area = np.bincount(flat, minlength=n + 1)[1:].astype(np.int64)
    sy = np.bincount(flat, weights=yy.ravel().astype(np.float64),
                     minlength=n + 1)[1:]
    sx = np.bincount(flat, weights=xx.ravel().astype(np.float64),
                     minlength=n + 1)[1:]
    return np.stack([np.arange(1, n + 1, dtype=np.float64),
                     area.astype(np.float64),
                     np.sqrt(4.0 * area / np.pi), sy / area, sx / area], 1)
