"""Region properties by one scatter-sum over the label image; port of the
JAX package's `ops/regionprops.py` (the device counterpart of
skimage.measure.regionprops_table with properties label, area,
equivalent_diameter and centroid).

Areas and coordinate sums are exact int32 (guarded below). The float32
centroids and diameters are for device users; host reports divide the
integer sums in float64.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def regionprops_table(labels: torch.Tensor, max_labels: int
                      ) -> Dict[str, torch.Tensor]:
    """Per-component properties of an (H, W) label image (0 = background,
    components 1..n; labels above max_labels are dropped).

    Returns (max_labels,) tensors for labels 1..max_labels: 'label',
    'area', 'sum-0', 'sum-1' (int32), 'equivalent_diameter',
    'centroid-0' (row), 'centroid-1' (col) (float32). Entries with
    area 0 are padding."""
    h, w = labels.shape
    if h * w * max(h - 1, w - 1) >= 2 ** 31:
        raise ValueError(
            f"labels image {h}x{w} exceeds the exact-int32 coordinate-sum "
            "bound (~1290px sides); use ops.connected_components."
            "quantify_mask, which switches to a hi/lo coordinate split")
    dev = labels.device
    cap = max_labels + 1
    flat = labels.reshape(-1).long()
    flat = torch.where((flat >= 0) & (flat < cap), flat, cap)
    pix = torch.arange(h * w, dtype=torch.int64, device=dev)
    feats = torch.stack([torch.ones_like(pix), pix // w, pix % w], -1)
    sums = torch.zeros(cap + 1, 3, dtype=torch.int64, device=dev)
    sums.scatter_add_(0, flat[:, None].expand(-1, 3), feats)
    sums = sums[1:cap].to(torch.int32)
    area = sums[:, 0]
    areaf = area.to(torch.float32)
    safe = areaf.clamp_min(1.0)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds differently
    pi = torch.full_like(areaf, math.pi)
    return {
        "label": torch.arange(1, cap, dtype=torch.int32, device=dev),
        "area": area,
        "sum-0": sums[:, 1],
        "sum-1": sums[:, 2],
        "equivalent_diameter": torch.sqrt(4.0 * areaf / pi),
        "centroid-0": sums[:, 1].to(torch.float32) / safe,
        "centroid-1": sums[:, 2].to(torch.float32) / safe,
    }


def centroid_size_image(labels: torch.Tensor, max_labels: int
                        ) -> torch.Tensor:
    """(H, W) float32 image holding each component's area at its centroid
    rounded half up (algorithms.py calculate_centroids_sizes_image). Where
    two centroids round to one pixel the higher label wins, as in the JAX
    package's in-order scatter on the CPU."""
    props = regionprops_table(labels, max_labels)
    h, w = labels.shape
    area = props["area"]
    valid = area > 0
    cy = torch.floor(props["centroid-0"] + 0.5).long().clamp(0, h - 1)
    cx = torch.floor(props["centroid-1"] + 0.5).long().clamp(0, w - 1)
    pos = torch.where(valid, cy * w + cx, h * w)
    slot = torch.arange(1, max_labels + 1, device=labels.device)
    winner = torch.zeros(h * w + 1, dtype=torch.int64, device=labels.device)
    winner.scatter_reduce_(0, pos, slot, "amax")
    table = torch.cat([area.new_zeros(1), area]).to(torch.float32)
    img = torch.where(winner > 0, table[winner], 0.0)
    return img[:-1].reshape(h, w)
