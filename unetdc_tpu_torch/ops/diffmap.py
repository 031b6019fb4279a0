"""Difference maps, overlays and color-region counting — the test-phase
visualizations of the reference trainer (train_DC_focal.py:42-131); port of
the JAX package's `ops/diffmap.py`, on the port's labeling."""

from __future__ import annotations

import torch

from unetdc_tpu_torch.ops.connected_components import label_batch

YELLOW = (255, 255, 0)   # TP
GREEN = (0, 255, 0)      # FP (only predicted)
RED = (255, 0, 0)        # FN (only true)


def create_difference_map(true_mask: torch.Tensor, pred_mask: torch.Tensor
                          ) -> torch.Tensor:
    """(H, W) binary masks -> (H, W, 3) uint8 RGB: yellow=TP, red=FN,
    green=FP, black=TN (train_DC_focal.py:42-77)."""
    t = true_mask > 0
    p = pred_mask > 0
    out = torch.zeros(t.shape + (3,), dtype=torch.uint8, device=t.device)
    for sel, color in ((t & p, YELLOW), (p & ~t, GREEN), (t & ~p, RED)):
        out = torch.where(sel[..., None],
                          torch.tensor(color, dtype=torch.uint8,
                                       device=t.device), out)
    return out


def overlay_difference(original_img: torch.Tensor, diff_map: torch.Tensor
                       ) -> torch.Tensor:
    """Non-black diff pixels replace the original (train_DC_focal.py:78-86)."""
    non_black = (diff_map != 0).any(dim=-1, keepdim=True)
    return torch.where(non_black, diff_map, original_img)


def count_color_regions(diff_map_rgb: torch.Tensor) -> dict:
    """Count 8-connected blobs per diff color (train_DC_focal.py:92-131:
    thresholded channel masks + cv2.connectedComponentsWithStats
    connectivity=8). Returns python ints."""
    r, g, b = (diff_map_rgb[..., i].to(torch.int32) for i in range(3))
    masks = {
        "yellow_blobs": (r > 200) & (g > 200) & (b < 50),   # TP
        "red_blobs": (r > 200) & (g < 50) & (b < 50),       # FN
        "green_blobs": (r < 50) & (g > 200) & (b < 50),     # FP
        "black_blobs": (r < 50) & (g < 50) & (b < 50),      # TN
    }
    return {k: int(label_batch(m[None].to(torch.uint8), connectivity=2)[1][0])
            for k, m in masks.items()}
