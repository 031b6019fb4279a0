"""ROI contouring of the BlobInspector family; port of the JAX package's
`ops/contours.py`, batched over (B, H, W)."""

from __future__ import annotations

import numpy as np
import torch

from unetdc_tpu_torch.ops.connected_components import (_propagate_counted,
                                                       component_areas,
                                                       label_batch)
from unetdc_tpu_torch.ops.morphology import dilate


def _border(h: int, w: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy == 0) | (yy == h - 1) | (xx == 0) | (xx == w - 1)


def contour_scan(image: torch.Tensor, threshold) -> torch.Tensor:
    """algorithms.py contour_scan: from each of the four edges, clear the
    pixels of each scanline up to the first one above the threshold. A
    pixel survives iff every directional prefix up to it (inclusive) holds
    a pixel > threshold."""
    above = image > threshold

    def seen(dim: int, reverse: bool) -> torch.Tensor:
        a = above.flip(dim) if reverse else above
        acc = torch.cumsum(a, dim, dtype=torch.int32) > 0
        return acc.flip(dim) if reverse else acc

    return (seen(-2, False) & seen(-2, True) & seen(-1, False)
            & seen(-1, True))


def contour_spreading(image: torch.Tensor, threshold,
                      connectivity: int = 1) -> torch.Tensor:
    """algorithms.py contour_spreading_4/_8: flood the background (<=
    threshold) from the border; keep every pixel it does not reach. The
    flood is a min-propagation of a 0 seed over the background."""
    h, w = image.shape[-2:]
    bg = image <= threshold
    seed = torch.where(_border(h, w, image.device) & bg, 0, 1).to(
        torch.int32).expand_as(bg).contiguous()
    reached, _ = _propagate_counted(seed, bg, 1, connectivity, True)
    return ~(bg & (reached == 0))


def contour_spreading_4(image, threshold):
    return contour_spreading(image, threshold, connectivity=1)


def contour_spreading_8(image, threshold):
    return contour_spreading(image, threshold, connectivity=2)


def contour_shrinking_box(image: torch.Tensor, threshold) -> torch.Tensor:
    """algorithms.py contour_shrinking_box: grow the border background
    inward one box ring at a time (the outer set takes the background of
    the next ring that touches its 3x3 dilation); an image stops when a
    ring adds nothing or the box closes. One host sync per ring."""
    b, h, w = image.shape
    dev = image.device
    bg = image <= threshold
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    outer = _border(h, w, dev) & bg
    active = torch.ones(b, dtype=torch.bool, device=dev)
    step = 1
    while bool(active.any()) and w - 2 * step > 1 and h - 2 * step > 1:
        outside = ((yy < step) | (yy >= h - step) | (xx < step)
                   | (xx >= w - step))
        grow = (dilate(outer.to(torch.float32), np.ones((3, 3), np.uint8))
                > 0.5) & outside & bg
        grow &= active[:, None, None]
        outer = outer | grow
        active &= grow.flatten(1).any(1)
        step += 1
    return ~outer


def remove_objects(contour_mask: torch.Tensor, min_size,
                   num_segments: int = 4096) -> torch.Tensor:
    """algorithms.py remove_objects: drop the 8-connected components
    smaller than min_size -> bool. Labels at or past num_segments count no
    area and take the keep flag of label num_segments - 1, as the JAX
    package's fixed-size segment sum does."""
    lab, _ = label_batch(contour_mask, connectivity=2)
    areas = component_areas(lab, num_segments)
    keep = areas >= min_size
    keep[:, 0] = False
    idx = lab.clamp(0, num_segments - 1).long().flatten(1)
    return torch.gather(keep, 1, idx).reshape(lab.shape)


def calculate_contours_centroid(mask: torch.Tensor):
    """algorithms.py calculate_contours_centroid: the float32 mean of the
    True coordinates (the integer sums converted to float32 and divided,
    as the JAX package divides int32 sums), image centre if empty ->
    (cy, cx) float32 (B,)."""
    h, w = mask.shape[-2:]
    m = (mask > 0).long()
    n = m.sum((-2, -1))
    dev = mask.device
    sy = (m * torch.arange(h, device=dev)[:, None]).sum((-2, -1))
    sx = (m * torch.arange(w, device=dev)).sum((-2, -1))
    nf = n.clamp_min(1).to(torch.float32)
    cy = torch.where(n > 0, sy.to(torch.float32) / nf, h / 2)
    cx = torch.where(n > 0, sx.to(torch.float32) / nf, w / 2)
    return cy.to(torch.float32), cx.to(torch.float32)
