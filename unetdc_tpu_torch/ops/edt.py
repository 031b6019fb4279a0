"""Exact Euclidean distance transform, marker watershed and peak finding
on the device; port of the JAX package's `ops/edt.py`.

- `distance_transform_edt_sq`: the separable squared EDT (Felzenszwalb &
  Huttenlocher), each 1D pass d2[i] = min_j ((i - j)^2 + f[j]) evaluated
  as a min-plus product against the constant (i - j)^2 matrix, in chunks
  of output rows that bound the (chunk, n, W) broadcast at 4M elements.
  Squared distances are integers in float32, so the result is exact.
- `watershed_device`: the minimax (pass-value) marker watershed,
  relaxed to its fixpoint by 4-neighbour sweeps. The fixpoint is unique
  and a sweep after it changes nothing, so the host tests whether the
  last sweep changed anything only once every `_CHECK_EVERY` sweeps.
- `peak_local_max_device`: window maxima by `max_pool2d`, a stable sort
  (intensity descending, raster order among ties), then the greedy
  min_distance suppression over the at most `max_peaks` sorted candidates,
  on the host after one copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unetdc_tpu_torch.ops.connected_components import _shift2d
from unetdc_tpu_torch.ops.watershed import greedy_spacing

_CHUNK_ELEMS = 4194304
_CHECK_EVERY = 16


def _minplus_pass(f: torch.Tensor) -> torch.Tensor:
    """d2[i, x] = min_j ((i - j)^2 + f[j, x]) for f of shape (n, W)."""
    n, w = f.shape
    i = torch.arange(n, dtype=torch.int32, device=f.device)
    d = ((i[:, None] - i[None, :]).to(torch.float32)) ** 2
    chunk = max(1, min(n, _CHUNK_ELEMS // (n * w) + 1, 64))
    return torch.cat([(d[s:s + chunk, :, None] + f[None]).amin(1)
                      for s in range(0, n, chunk)])


def distance_transform_edt_sq(mask: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distance of each foreground pixel of an
    (H, W) mask to the nearest background pixel (scipy's
    distance_transform_edt, squared), float32."""
    h, w = mask.shape
    big = float((h + w) ** 2 + 1)
    f = torch.where(mask.to(torch.bool), big, 0.0).to(torch.float32)
    g = _minplus_pass(f)
    d2 = _minplus_pass(g.T.contiguous()).T
    return d2.clamp_max(big)


def distance_transform_edt(mask: torch.Tensor) -> torch.Tensor:
    """sqrt of the exact squared EDT, float32."""
    return torch.sqrt(distance_transform_edt_sq(mask))


def watershed_device(height: torch.Tensor, markers: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Marker watershed as the minimax path problem: each pixel of `mask`
    takes the marker whose path to it has the smallest maximum height,
    ties broken by fewest steps, then by the lowest marker id (the JAX
    package's deterministic relaxation; see its docstring for where this
    differs from the host flood's FIFO order).

    Args: integer `height` (floods ascending), int32 `markers` (0 = none),
    bool `mask`. Returns int32 labels (0 outside the mask or unreached).
    """
    big = 2 ** 30
    m = mask.to(torch.bool)
    h = height.to(torch.int32)
    is_marker = m & (markers > 0)
    lab0 = torch.where(is_marker, markers.to(torch.int32), 0)
    cost = torch.where(is_marker, h, big)
    dist = torch.where(is_marker, 0, big).to(torch.int32)
    lab = lab0

    def sweep(cost, dist, lab):
        bc, bd, bl = cost, dist, lab
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nc = torch.maximum(_shift2d(cost, dy, dx, big), h)
            nd = (_shift2d(dist, dy, dx, big) + 1).clamp_max(big)
            nl = _shift2d(lab, dy, dx, 0)
            better = (nl > 0) & ((nc < bc) | ((nc == bc) & (nd < bd))
                                 | ((nc == bc) & (nd == bd)
                                    & ((nl < bl) | (bl == 0))))
            bc = torch.where(better, nc, bc)
            bd = torch.where(better, nd, bd)
            bl = torch.where(better, nl, bl)
        bc = torch.where(is_marker, h, torch.where(m, bc, big))
        bd = torch.where(is_marker, 0, torch.where(m, bd, big))
        bl = torch.where(is_marker, lab0, torch.where(m, bl, 0))
        return bc, bd, bl.to(torch.int32)

    while True:
        for _ in range(_CHECK_EVERY - 1):
            cost, dist, lab = sweep(cost, dist, lab)
        prev = (cost, dist, lab)
        cost, dist, lab = sweep(cost, dist, lab)
        if all(torch.equal(a, b) for a, b in zip(prev, (cost, dist, lab))):
            return lab


def peak_local_max_device(image: torch.Tensor, labels_mask: torch.Tensor,
                          min_distance: int = 3, max_peaks: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local maxima of an (H, W) image within a (2*min_distance+1)^2
    window, restricted to labels_mask > 0 and image > 0, in intensity
    order (raster order among equal intensities), greedily suppressed at
    Chebyshev distance < min_distance (skimage peak_local_max semantics).

    Returns (coords (n, 2) int32, valid (n,) bool) on the image's device,
    n = min(max_peaks, H*W): the first max_peaks candidates in priority
    order and whether each survives the suppression."""
    h, w = image.shape
    size = 2 * min_distance + 1
    img = image.to(torch.float32)
    neg_inf = -3.4e38
    maxf = F.max_pool2d(img[None, None], size, stride=1,
                        padding=min_distance)[0, 0]
    cand = (img == maxf) & (labels_mask > 0) & (img > 0)
    primary = torch.where(cand, -img, -neg_inf).reshape(-1)
    key, order = torch.sort(primary, stable=True)
    top = order[:max_peaks]
    ok = key[:max_peaks] < -neg_inf / 2
    coords = torch.stack([top // w, top % w], -1).to(torch.int32)
    host = coords.cpu().numpy()
    okh = ok.cpu().numpy()
    take = np.zeros(len(okh), bool)
    take[okh] = greedy_spacing(host[okh], (h, w), min_distance)
    return coords, torch.from_numpy(take).to(image.device)
