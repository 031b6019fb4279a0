"""Rolling-ball background correction (reference utils/data_loader.py):
per channel, a morphological opening with
cv2.getStructuringElement(MORPH_ELLIPSE, (radius, radius)) (the cv2
argument is the kernel size), a saturating subtract of the background, then
NORM_MINMAX to [0, 255]. Port of the JAX package's `ops/rolling_ball.py`.
"""

from __future__ import annotations

import torch

from unetdc_tpu_torch.ops.morphology import ellipse_kernel, morph_open


def normalize_minmax_u8(x: torch.Tensor) -> torch.Tensor:
    """cv2.normalize(..., 0, 255, NORM_MINMAX) over the last two dims of
    uint8-domain data, in the JAX package's f32 operation order:
    (x - min) * (255 / span) (scale 0 when span == 0), round half to even,
    clip."""
    xf = x.to(torch.float32)
    mn = xf.amin(dim=(-2, -1), keepdim=True)
    mx = xf.amax(dim=(-2, -1), keepdim=True)
    span = mx - mn
    scale = torch.where(span > 1e-12, 255.0 / span, torch.zeros_like(span))
    y = (xf - mn) * scale
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def rolling_ball_correction(planes: torch.Tensor, radius: int = 50
                            ) -> torch.Tensor:
    """Background-correct uint8 image planes (..., H, W) independently."""
    kernel = ellipse_kernel(radius)
    background = morph_open(planes, kernel)
    corrected = torch.clamp(planes.to(torch.float32) - background, min=0.0)
    return normalize_minmax_u8(corrected)


def rolling_ball_correction_rgb(image: torch.Tensor, radius: int = 50
                                ) -> torch.Tensor:
    """(..., H, W, C) uint8 -> same, each channel corrected on its own."""
    planes = image.movedim(-1, -3)
    return rolling_ball_correction(planes, radius).movedim(-3, -1)
