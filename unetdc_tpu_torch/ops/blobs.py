"""Blob detection: the LoG, DoG and DoH scale-space detectors; port of the
JAX package's `ops/blobs.py` (algorithms.py blobs_detection, which wraps
skimage's blob_log / blob_dog / blob_doh).

The response cubes run on the device with the separable Gaussian filters
of `ops/filters.py` (the JAX package's tap-chain rounding); peak
extraction and overlap pruning run on the host (numpy copies of the JAX
package's host code). Outputs are (n, 3) float arrays of (y, x, sigma or
radius) rows with skimage's conventions: blob_log and blob_dog give sigma
in column 2 (blobs_detection multiplies by sqrt(2)); blob_doh gives the
detection sigma as the radius.

`_doh_cube_approx` (the SURF box-filter Hessian) builds a float32
integral image with two cumsums. Above 2^24 its sums round by the order
of summation, and its box sums are differences of those large sums, so
the order decides the response: the cumsums follow XLA's CPU order
(`ops/threshold.py::cumsum_xla_cpu`), and the Hessian terms round as XLA
compiles them on the CPU: `mid - 3*side` and `dxx*dyy - (...)` as fused
multiply-adds (an exact product, one rounding: taken in float64 and
rounded once), and `0.81 * dxy * dxy` with the constants folded into
`Y * f32(0.81 * w) * dxy`. The same bits come out on the CPU and the card.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from unetdc_tpu_torch.device import resolve_device
from unetdc_tpu_torch.ops.filters import (gaussian_derivative_scipy,
                                          scipy_gaussian_kernel,
                                          separable_taps)
from unetdc_tpu_torch.ops.threshold import cumsum_xla_cpu


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 scalar the JAX package multiplies by, on like's device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _log_cube(image: torch.Tensor, sigmas: Sequence[float]) -> torch.Tensor:
    """-sigma^2 * Laplacian of Gaussian per scale (scipy's gaussian_laplace:
    order-2 derivative filters along each axis, summed) -> (S, H, W)."""
    img = image.to(torch.float32)
    return torch.stack([
        -(gaussian_derivative_scipy(img, s, 2, 0)
          + gaussian_derivative_scipy(img, s, 0, 2)) * _f32(s ** 2, img)
        for s in sigmas])


def _dog_cube(image: torch.Tensor, sigmas: Sequence[float]) -> torch.Tensor:
    """Scale-normalised differences of scipy Gaussians -> (S - 1, H, W)."""
    img = image.to(torch.float32)
    ks = [scipy_gaussian_kernel(s) for s in sigmas]
    gs = [separable_taps(img, k, k, reflect101=False) for k in ks]
    return torch.stack([
        (gs[i] - gs[i + 1]) * _f32(sigmas[i] / (sigmas[i + 1] - sigmas[i])
                                   if sigmas[i + 1] > sigmas[i] else 1.0, img)
        for i in range(len(sigmas) - 1)])


def _doh_cube(image: torch.Tensor, sigmas: Sequence[float]) -> torch.Tensor:
    """sigma^4 * determinant of the Gaussian Hessian (the exact operator;
    `_doh_cube_approx` is skimage's box-filter family) -> (S, H, W)."""
    img = image.to(torch.float32)
    layers = []
    for s in sigmas:
        dyy = gaussian_derivative_scipy(img, s, 2, 0)
        dxx = gaussian_derivative_scipy(img, s, 0, 2)
        dxy = gaussian_derivative_scipy(img, s, 1, 1)
        layers.append((dxx * dyy - dxy ** 2) * _f32(s ** 4, img))
    return torch.stack(layers)


def _surf_geometry(sigma: float):
    """Box-filter geometry of the SURF Hessian approximation at `sigma`:
    filter size 3*sigma, half-width (size-1)//2, lobe size//3."""
    size = int(3.0 * sigma)
    return size, (size - 1) // 2, size // 3


def _doh_cube_approx(image: torch.Tensor, sigmas: Sequence[float]
                     ) -> torch.Tensor:
    """SURF integral-image box-filter approximation of the Hessian
    determinant (skimage's _hessian_det_appx family): det = dxx*dyy -
    0.81*dxy^2, box sums over an edge-extended float32 integral image."""
    img = image.to(torch.float32)
    h, w = img.shape
    dev = img.device
    S = cumsum_xla_cpu(cumsum_xla_cpu(img.T).T)
    layers = []
    for s in sigmas:
        size, s2, s3 = _surf_geometry(s)
        pad = size + 2
        iy = torch.arange(-pad, h + pad, device=dev).clamp(0, h - 1)
        ix = torch.arange(-pad, w + pad, device=dev).clamp(0, w - 1)
        P = S.index_select(0, iy).index_select(1, ix)
        w_i = 1.0 / (size * size)

        def corner(dr, dc):
            return P[pad + dr:pad + dr + h, pad + dc:pad + dc + w]

        def integ(r0, c0, rl, cl):
            ans = (corner(r0, c0) + corner(r0 + rl, c0 + cl)
                   - corner(r0, c0 + cl) - corner(r0 + rl, c0))
            return ans.clamp_min(0.0)

        def second(mid, side):  # fma(-3, side, mid) * w
            return (mid.double() - 3.0 * side.double()).float() * w_i

        tl = integ(-s3, -s3, s3, s3)
        br = integ(1, 1, s3, s3)
        bl = integ(1, -s3, s3, s3)
        tr = integ(-s3, 1, s3, s3)
        cross = bl + tr - tl - br
        dxy = cross * w_i
        dxx = second(integ(-s3 + 1, -s2, 2 * s3 - 1, size),
                     integ(-s3 + 1, -(s3 // 2), 2 * s3 - 1, s3))
        dyy = second(integ(-s2, -s3 + 1, size, 2 * s3 - 1),
                     integ(-(s3 // 2), -s3 + 1, s3, 2 * s3 - 1))
        c = float(np.float32(0.81) * np.float32(w_i))
        layers.append((dxx.double() * dyy.double()
                       - (cross * c * dxy).double()).float())
    return torch.stack(layers)


def _local_maxima_3d(cube: np.ndarray, threshold: float) -> np.ndarray:
    """(scale, y, x) rows of the cube's points that are >= their 3x3x3
    neighbourhood and above `threshold`."""
    S, H, W = cube.shape
    pad = np.pad(cube, 1, mode="constant", constant_values=-np.inf)
    is_max = np.ones((S, H, W), bool)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == dy == dx == 0:
                    continue
                is_max &= cube >= pad[1 + ds:1 + ds + S, 1 + dy:1 + dy + H,
                                      1 + dx:1 + dx + W]
    is_max &= cube > threshold
    return np.argwhere(is_max)


def _disk_overlap_fraction(d: float, r1: float, r2: float) -> float:
    """Intersection area of two disks over the smaller disk's area
    (skimage._blob_overlap)."""
    if d > r1 + r2:
        return 0.0
    if d <= abs(r1 - r2):
        return 1.0
    ratio1 = max(-1.0, min(1.0, (d * d + r1 * r1 - r2 * r2) / (2 * d * r1)))
    ratio2 = max(-1.0, min(1.0, (d * d + r2 * r2 - r1 * r1) / (2 * d * r2)))
    a = (r1 * r1 * math.acos(ratio1) + r2 * r2 * math.acos(ratio2)
         - 0.5 * math.sqrt(abs((-d + r1 + r2) * (d + r1 - r2)
                               * (d - r1 + r2) * (d + r1 + r2))))
    return a / (math.pi * min(r1, r2) ** 2)


def _prune_overlap(blobs: np.ndarray, overlap: float = 0.5) -> np.ndarray:
    """skimage._prune_blobs: of every pair whose disk overlap exceeds
    `overlap`, drop the smaller (radius sigma*sqrt(2))."""
    if len(blobs) == 0:
        return blobs[:, :3] if blobs.ndim == 2 else blobs
    blobs = blobs.copy()
    n = len(blobs)
    for i in range(n):
        for j in range(i + 1, n):
            if blobs[i, 2] == 0 or blobs[j, 2] == 0:
                continue
            r1 = blobs[i, 2] * math.sqrt(2)
            r2 = blobs[j, 2] * math.sqrt(2)
            d = math.hypot(blobs[i, 0] - blobs[j, 0],
                           blobs[i, 1] - blobs[j, 1])
            if _disk_overlap_fraction(d, r1, r2) > overlap:
                if blobs[i, 2] > blobs[j, 2]:
                    blobs[j, 2] = 0
                else:
                    blobs[i, 2] = 0
    return blobs[blobs[:, 2] > 0][:, :3]


def _detect(cube_fn, image, sigmas, threshold, device) -> np.ndarray:
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(image, np.float32)).to(dev)
    cube = cube_fn(x, sigmas).cpu().numpy()
    peaks = _local_maxima_3d(cube, threshold)
    rows = [(y, x, sigmas[s], cube[s, y, x]) for s, y, x in peaks]
    return _prune_overlap(np.array(rows).reshape(-1, 4))


def blob_log(image, min_sigma=1.0, max_sigma=50.0, num_sigma=10,
             threshold=0.2, *, device="cuda") -> np.ndarray:
    sigmas = tuple(np.linspace(min_sigma, max_sigma, int(max(num_sigma, 1))))
    return _detect(_log_cube, image, sigmas, threshold, device)


def blob_dog(image, min_sigma=1.0, max_sigma=50.0, sigma_ratio=1.6,
             threshold=0.2, *, device="cuda") -> np.ndarray:
    sigmas = [float(min_sigma)]
    while sigmas[-1] < max_sigma:
        sigmas.append(sigmas[-1] * sigma_ratio)
    if len(sigmas) < 2:  # min_sigma >= max_sigma: DoG needs two scales
        sigmas.append(sigmas[-1] * sigma_ratio)
    return _detect(_dog_cube, image, tuple(sigmas), threshold, device)


def blob_doh(image, min_sigma=1.0, max_sigma=30.0, num_sigma=10,
             threshold=0.01, approximate: bool = False, *, device="cuda"
             ) -> np.ndarray:
    """DoH detector: the exact Gaussian-Hessian determinant, or with
    `approximate` the SURF box-filter response of skimage's family."""
    sigmas = tuple(np.linspace(min_sigma, max_sigma, int(max(num_sigma, 1))))
    fn = _doh_cube_approx if approximate else _doh_cube
    return _detect(fn, image, sigmas, threshold, device)


def blobs_detection(image, algo_index: int, min_radius: int,
                    max_radius: int, *, device="cuda"
                    ) -> Optional[np.ndarray]:
    """algorithms.py blobs_detection: 1 LoG, 2 DoG, 3 DoH, with the
    radius <-> sigma conversion; None for any other index."""
    sq2 = math.sqrt(2)
    if algo_index == 1:
        blobs = blob_log(image, min_sigma=min_radius / sq2,
                         max_sigma=max_radius / sq2,
                         num_sigma=max_radius - min_radius + 1, threshold=.2,
                         device=device)
        if len(blobs):
            blobs[:, 2] *= sq2
        return blobs
    if algo_index == 2:
        blobs = blob_dog(image, min_sigma=min_radius / sq2,
                         max_sigma=max_radius / sq2, threshold=.2,
                         device=device)
        if len(blobs):
            blobs[:, 2] *= sq2
        return blobs
    if algo_index == 3:
        return blob_doh(image, min_sigma=min_radius, max_sigma=max_radius,
                        num_sigma=max_radius - min_radius + 1, threshold=.01,
                        device=device)
    return None


def blobs_mask(image, blobs_list) -> np.ndarray:
    """algorithms.py blobs_mask: filled circles at the (y, x, r) rows."""
    out = np.zeros(np.asarray(image).shape[:2], bool)
    h, w = out.shape
    yy, xx = np.mgrid[:h, :w]
    for blob in blobs_list:
        y, x = int(blob[0] + 0.5), int(blob[1] + 0.5)
        r = int(math.ceil(blob[2]))
        out |= (yy - y) ** 2 + (xx - x) ** 2 <= r ** 2
    return out


def return_blobs_algorithms():
    """algorithms.py return_blobs_algorithms."""
    return ["None", "LoG", "DoG", "DoH"]
