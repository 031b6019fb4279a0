"""Grayscale morphology with cv2 semantics, batched over leading dims.

Port of the JAX package's `ops/morphology.py` (reference
utils/data_loader.py rolling-ball opening with a MORPH_ELLIPSE element).
Erosion with a convex footprint is a chain of horizontal shifted mins
(each row run of the footprint nests in the next wider one, so each width
is one more shift) followed by vertical shifted mins, one per footprint
row. Borders follow cv2's defaults: erosion pads +inf, dilation pads -inf,
so image borders never shrink or grow artificially. All values are float32
copies of uint8 data, so min/max are exact.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def ellipse_kernel(ksize: int) -> np.ndarray:
    """Elliptical structuring element, bit-exact with
    cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize)):
    half-axes r = c = ksize // 2; row i covers columns [c-dx, c+dx] with
    dx = round_half_even(c * sqrt(max(r^2 - dy^2, 0) / r^2)), dy = i - r."""
    r = c = ksize // 2
    kern = np.zeros((ksize, ksize), np.uint8)
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(ksize):
        dy = i - r
        if abs(dy) > r:
            continue
        dx = int(np.rint(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
        j1, j2 = max(c - dx, 0), min(c + dx + 1, ksize)
        kern[i, j1:j2] = 1
    return kern


def _footprint_rows(kernel: np.ndarray) -> List[Tuple[int, int, int]]:
    """[(row, j1, j2)] runs of the non-empty kernel rows (each row must be
    one contiguous run, true for ellipses and boxes)."""
    rows = []
    for i in range(kernel.shape[0]):
        nz = np.flatnonzero(kernel[i])
        if nz.size == 0:
            continue
        j1, j2 = int(nz[0]), int(nz[-1]) + 1
        if not np.all(kernel[i, j1:j2]):
            raise ValueError("footprint rows must be contiguous")
        rows.append((i, j1, j2))
    return rows


def shift(x: torch.Tensor, d: int, dim: int, fill: float) -> torch.Tensor:
    """out[..., i, ...] = x[..., i + d, ...] along `dim`, `fill` outside."""
    if d == 0:
        return x
    n = x.shape[dim]
    out = torch.full_like(x, fill)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(dim, 0, n - d).copy_(x.narrow(dim, d, n - d))
    else:
        out.narrow(dim, -d, n + d).copy_(x.narrow(dim, 0, n + d))
    return out


def _morph(img: torch.Tensor, kernel: np.ndarray, is_erode: bool
           ) -> torch.Tensor:
    """cv2.erode / cv2.dilate with anchor k//2 on the last two dims (cv2
    applies the kernel unflipped for both)."""
    k = np.asarray(kernel)
    ay, ax = k.shape[0] // 2, k.shape[1] // 2
    x = img.to(torch.float32)
    fill = float("inf") if is_erode else float("-inf")
    comb = torch.minimum if is_erode else torch.maximum
    runs = {}
    for i, j1, j2 in _footprint_rows(k):
        runs.setdefault((ax - j1, (j2 - 1) - ax), []).append(i)
    pairs = sorted(runs)
    nested = (all(lo >= 0 and hi >= 0 for lo, hi in pairs)
              and all(a[0] <= b[0] and a[1] <= b[1]
                      for a, b in zip(pairs, pairs[1:])))
    if not nested:
        raise ValueError("footprint row runs must nest around the anchor")
    horiz = {}
    cur, clo, chi = x, 0, 0
    for lo, hi in pairs:
        while clo < lo:
            clo += 1
            cur = comb(cur, shift(x, -clo, -1, fill))
        while chi < hi:
            chi += 1
            cur = comb(cur, shift(x, chi, -1, fill))
        horiz[(lo, hi)] = cur
    out = None
    for key, row_ids in runs.items():
        for i in row_ids:
            s = shift(horiz[key], i - ay, -2, fill)
            out = s if out is None else comb(out, s)
    return out


def erode(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Grayscale erosion, cv2.erode semantics (float32 out)."""
    return _morph(img, kernel, True)


def dilate(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Grayscale dilation, cv2.dilate semantics (float32 out)."""
    return _morph(img, kernel, False)


def morph_open(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Opening = erode then dilate (cv2.MORPH_OPEN)."""
    return dilate(erode(img, kernel), kernel)


def morph_close(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Closing = dilate then erode (cv2.MORPH_CLOSE)."""
    return erode(dilate(img, kernel), kernel)


def binary_dilation3x3(mask: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.binary_dilation with a 3x3 square -> bool."""
    return dilate(mask.to(torch.float32), np.ones((3, 3), np.uint8)) > 0.5
