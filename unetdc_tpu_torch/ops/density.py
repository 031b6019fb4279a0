"""Density and concentric-ring ("target") heatmaps; port of the JAX
package's `ops/density.py`, batched: every map is (B, H, W) and every
per-image scalar (B,).

- Box sums of 0/1 and integer fields are exact: an int64 integral image
  (the JAX package's float32 `reduce_window` is exact there too, every sum
  being an integer below 2^24).
- Ring ids follow the JAX package's float32 arithmetic on the CPU as its
  heatmap engines run it (batched under `vmap`), where XLA compiles
  `jnp.linspace(0, max_d, nb + 1)` to `max_d * f32(i * f32(1/nb))` (the
  division by nb folded into a reciprocal) and `dx**2 + dy**2` to a fused
  multiply-add (dx**2 fused, dy**2 rounded) at full image sizes. A
  distance that is the square root of an integer can sit exactly on a
  bound, so these roundings decide its ring.
- Ring sums are exact integer sums, cast to float32 as the JAX package's
  float32 segment sums of integers are.
"""

from __future__ import annotations

import numpy as np
import torch

from unetdc_tpu_torch.ops.filters import scipy_gaussian_kernel, separable_taps


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of the integer field x (B, H, W) over the k x k window clipped
    at the borders (zero padding, anchor (k-1)//2), as float32."""
    b, h, w = x.shape
    half = (k - 1) // 2
    ii = torch.zeros(b, h + 1, w + 1, dtype=torch.int64, device=x.device)
    ii[:, 1:, 1:] = x.long().cumsum(1).cumsum(2)
    y0 = (torch.arange(h, device=x.device) - half).clamp(0, h)
    y1 = (torch.arange(h, device=x.device) - half + k).clamp(0, h)
    x0 = (torch.arange(w, device=x.device) - half).clamp(0, w)
    x1 = (torch.arange(w, device=x.device) - half + k).clamp(0, w)
    rows1, rows0 = ii[:, y1], ii[:, y0]
    s = (rows1[:, :, x1] - rows1[:, :, x0] - rows0[:, :, x1]
         + rows0[:, :, x0])
    return s.to(torch.float32)


def _int_field(centroid_size_image: torch.Tensor) -> torch.Tensor:
    """The centroid-size image holds integer areas in float32."""
    return centroid_size_image.round().long()


def density_maps(mask_thresh: torch.Tensor, mask_contour: torch.Tensor,
                 centroid_size_image: torch.Tensor, kernel_size: int):
    """algorithms.py density_maps, vectorised: (percentage, count,
    count_per_10k, mean_size) float32 maps."""
    th = _box_sum(mask_thresh > 0, kernel_size)
    cont = _box_sum(mask_contour > 0, kernel_size)
    centroids = _box_sum(centroid_size_image > 0, kernel_size)
    sizes = _box_sum(_int_field(centroid_size_image), kernel_size)
    inside = mask_contour > 0
    cont_pos = cont > 0
    pct = torch.where(inside & cont_pos, th / cont.clamp_min(1.0) * 100.0,
                      0.0)
    per10k = torch.where(inside & cont_pos,
                         centroids / cont.clamp_min(1.0) * 10000.0, 0.0)
    count = torch.where(inside, centroids, 0.0)
    mean_size = torch.where(inside & (centroids > 0),
                            sizes / centroids.clamp_min(1.0), 0.0)
    return pct, count, per10k, mean_size


def density_map(mask_thresh: torch.Tensor, mask_contour: torch.Tensor,
                kernel_size: int) -> torch.Tensor:
    """algorithms.py density_map: the percentage field only."""
    th = _box_sum(mask_thresh > 0, kernel_size)
    cont = _box_sum(mask_contour > 0, kernel_size)
    inside = (mask_contour > 0) & (cont > 0)
    return torch.where(inside, th / cont.clamp_min(1.0) * 100.0, 0.0)


def _dist(ys: torch.Tensor, xs: torch.Tensor, cy: torch.Tensor,
          cx: torch.Tensor) -> torch.Tensor:
    """float32 sqrt((xs - cx)**2 + (ys - cy)**2) with dx**2 fused into the
    add (module docstring): the float64 sum of an exact square and a
    float32 one, rounded once. The square root is taken in float64 and
    rounded to float32, which is the correctly rounded float32 root (the
    CPU's vectorised float32 sqrt is not always)."""
    dx = (xs - cx).double()
    dy2 = ((ys - cy) ** 2).double()
    return (dx * dx + dy2).float().double().sqrt().float()


def _bounds(max_d: torch.Tensor, nb_layers: int) -> torch.Tensor:
    """(B, nb + 1) ring bounds, jnp.linspace(0, max_d, nb + 1) as XLA on the
    CPU computes it in the batched engines (module docstring)."""
    rec = float(np.float32(1.0) / np.float32(nb_layers))
    step = torch.arange(nb_layers, dtype=torch.float32,
                        device=max_d.device) * rec
    return torch.cat([max_d[:, None] * step, max_d[:, None]], 1)


def _ring_index(mask_contour: torch.Tensor, centroid_y: torch.Tensor,
                centroid_x: torch.Tensor, nb_layers: int):
    """Per-pixel ring id in [0, nb) for contour pixels, -1 outside or for
    d == 0 / d > max_d: ring i holds bounds[i] < d <= bounds[i+1]. Returns
    (rid (B,H,W) int64, d, max_d (B,), bounds (B, nb+1))."""
    b, h, w = mask_contour.shape
    dev = mask_contour.device
    inside = mask_contour > 0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    d = _dist(yy, xx, centroid_y.float()[:, None, None],
              centroid_x.float()[:, None, None])
    max_d = torch.where(inside, d, -torch.inf).amax((1, 2)).clamp_min(0.0)
    bounds = _bounds(max_d, nb_layers)
    rid = torch.searchsorted(bounds, d.reshape(b, -1)).reshape(b, h, w) - 1
    ok = inside & (d > 0) & (d <= max_d[:, None, None])
    rid = torch.where(ok, rid, -1).clamp(-1, nb_layers - 1)
    return rid, d, max_d, bounds


def _ring_sums(field: torch.Tensor, seg: torch.Tensor, nb_layers: int
               ) -> torch.Tensor:
    """(B, nb) float32 of exact per-ring sums of the integer field."""
    b = field.shape[0]
    out = torch.zeros(b, nb_layers + 1, dtype=torch.int64,
                      device=field.device)
    out.scatter_add_(1, seg, field.reshape(b, -1).long())
    return out[:, :nb_layers].to(torch.float32)


def _paint(values: torch.Tensor, rid: torch.Tensor, nb_layers: int
           ) -> torch.Tensor:
    """values (B, nb) onto the ring pixels; 0 elsewhere."""
    b = values.shape[0]
    table = torch.cat([values, values.new_zeros(b, 1)], 1)
    idx = torch.where(rid >= 0, rid, nb_layers).reshape(b, -1)
    return torch.gather(table, 1, idx).reshape(rid.shape)


def get_targets(mask_thresh: torch.Tensor, mask_contour: torch.Tensor,
                centroid_size_image: torch.Tensor, nb_layers: int,
                centroid_y: torch.Tensor, centroid_x: torch.Tensor):
    """algorithms.py get_targets: per-ring density %, blob count, count per
    10k px and mean size painted onto the ring pixels."""
    rid, _, _, _ = _ring_index(mask_contour, centroid_y, centroid_x,
                               nb_layers)
    b = rid.shape[0]
    seg = torch.where(rid >= 0, rid, nb_layers).reshape(b, -1)
    th = _ring_sums(mask_thresh > 0, seg, nb_layers)
    cont = _ring_sums(mask_contour > 0, seg, nb_layers)
    cen = _ring_sums(centroid_size_image > 0, seg, nb_layers)
    size = _ring_sums(_int_field(centroid_size_image), seg, nb_layers)
    density = torch.where(cont > 0, th / cont.clamp_min(1.0) * 100.0, 0.0)
    per10k = torch.where(cont > 0, cen / cont.clamp_min(1.0) * 10000.0, 0.0)
    mean_size = torch.where(cen > 0, size / cen.clamp_min(1.0), 0.0)
    return tuple(_paint(v, rid, nb_layers)
                 for v in (density, cen, per10k, mean_size))


def get_target(mask_thresh: torch.Tensor, mask_contour: torch.Tensor,
               nb_layers: int, centroid_y: torch.Tensor,
               centroid_x: torch.Tensor) -> torch.Tensor:
    """algorithms.py get_target: the density % ring map only."""
    zero = torch.zeros(mask_thresh.shape, dtype=torch.float32,
                       device=mask_thresh.device)
    return get_targets(mask_thresh, mask_contour, zero, nb_layers,
                       centroid_y, centroid_x)[0]


def radial_centroid_count_map(mask_contour: torch.Tensor,
                              centroid_ys: torch.Tensor,
                              centroid_xs: torch.Tensor,
                              centroid_valid: torch.Tensor, nb_layers: int,
                              centroid_y: torch.Tensor,
                              centroid_x: torch.Tensor) -> torch.Tensor:
    """quantify_pipline.py get_targets: count droplet centroids (B, L) per
    concentric ring and paint each ring's count on its ROI pixels."""
    rid, _, max_d, bounds = _ring_index(mask_contour, centroid_y,
                                        centroid_x, nb_layers)
    dc = _dist(centroid_ys, centroid_xs, centroid_y.float()[:, None],
               centroid_x.float()[:, None])
    crid = torch.searchsorted(bounds, dc) - 1
    ok = centroid_valid & (dc > 0) & (dc <= max_d[:, None]) & (crid >= 0) \
        & (crid < nb_layers)
    counts = torch.zeros(dc.shape[0], nb_layers + 1, dtype=torch.int64,
                         device=dc.device)
    counts.scatter_add_(1, torch.where(ok, crid, nb_layers), ok.long())
    return _paint(counts[:, :nb_layers].to(torch.float32), rid, nb_layers)


def gaussian_density_map(mask_thresh: torch.Tensor,
                         mask_contour: torch.Tensor, kernel_size: int = 21
                         ) -> torch.Tensor:
    """quantify_pipline.py: gaussian(mask, k/6) / (gaussian(roi, k/6) +
    1e-5) * 100, scipy 'reflect' edges."""
    k = scipy_gaussian_kernel(kernel_size / 6)
    num = separable_taps(mask_thresh.to(torch.float32), k, k, False)
    den = separable_taps(mask_contour.to(torch.float32), k, k, False)
    return num / (den + 1e-5) * 100.0


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def min_max_mean_sd_density(d_map, mask_contour):
    """algorithms.py min_max_mean_sd_density of one map (3-decimal
    rounding, on the host; tensors on any device or arrays)."""
    vals = _host(d_map)[_host(mask_contour) > 0]
    return (round(float(vals.min()), 3), round(float(vals.max()), 3),
            round(float(vals.mean()), 3), round(float(vals.std()), 3))


def min_max_mean_median_density(d_map, mask_contour):
    """algorithms.py min_max_mean_median_density of one map (host)."""
    m = _host(mask_contour) > 0
    if m.sum() == 0:
        return 0, 0, 0, 0
    vals = _host(d_map)[m]
    return (round(float(vals.min()), 3), round(float(vals.max()), 3),
            round(float(vals.mean()), 3), round(float(np.median(vals)), 3))
