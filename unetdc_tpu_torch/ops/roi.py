"""ROI-mask ops of the heatmap pipelines; port of the JAX package's
`ops/roi.py` (reference quantify_pipline.py: gray -> 15x15 Gaussian blur
-> Otsu -> 15x15 box close and open; image-moments centroid), batched over
the leading dims.

`gray_of` also takes a channel-equal batch uploaded as (B,H,W): since
4899 + 9617 + 1868 = 16384, `rgb2gray_cv2` of three equal channels is the
channel itself.
"""

from __future__ import annotations

import numpy as np
import torch

from unetdc_tpu_torch.ops.filters import gaussian_blur
from unetdc_tpu_torch.ops.morphology import morph_close, morph_open
from unetdc_tpu_torch.ops.threshold import otsu_threshold


def rgb2gray_cv2(img_rgb_u8: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(RGB2GRAY) fixed point: (R*4899 + G*9617 + B*1868 +
    8192) >> 14, uint8."""
    c = img_rgb_u8.to(torch.int32)
    return ((c[..., 0] * 4899 + c[..., 1] * 9617 + c[..., 2] * 1868
             + (1 << 13)) >> 14).to(torch.uint8)


def gray_of(imgs_u8: torch.Tensor) -> torch.Tensor:
    """(B,H,W,3) RGB -> its cv2 gray; a (B,H,W) grayscale upload is its own
    gray (the engine's upload of a channel-equal batch)."""
    return imgs_u8 if imgs_u8.dim() == 3 else rgb2gray_cv2(imgs_u8)


def generate_roi_mask_gray(gray_u8: torch.Tensor, blur_kernel: int = 15
                           ) -> torch.Tensor:
    """ROI of gray images over the last two dims -> uint8 0/1."""
    blurred = torch.clamp(torch.round(gaussian_blur(gray_u8, blur_kernel,
                                                    0.0)), 0, 255
                          ).to(torch.uint8)
    t = otsu_threshold(blurred)
    mask = (blurred.long() > t[..., None, None]).to(torch.float32) * 255.0
    kern = np.ones((15, 15), np.uint8)
    mask = morph_open(morph_close(mask, kern), kern)
    return (mask > 0).to(torch.uint8)


def generate_roi_mask(img_rgb_u8: torch.Tensor, blur_kernel: int = 15
                      ) -> torch.Tensor:
    """quantify_pipline.py's ROI mask of RGB images (..., H, W, 3) -> uint8
    0/1 (..., H, W)."""
    return generate_roi_mask_gray(rgb2gray_cv2(img_rgb_u8), blur_kernel)


def moments_centroid(mask: torch.Tensor):
    """cv2.moments centroid with the reference's int() truncation and the
    image-centre fallback, over the last two dims -> (cy, cx) int64."""
    h, w = mask.shape[-2:]
    m = (mask > 0).long()
    m00 = m.sum((-2, -1))
    dev = mask.device
    m10 = (m * torch.arange(w, device=dev)).sum((-2, -1))
    m01 = (m * torch.arange(h, device=dev)[:, None]).sum((-2, -1))
    safe = m00.clamp_min(1)
    cx = torch.where(m00 > 0, torch.div(m10, safe, rounding_mode="floor"),
                     w // 2)
    cy = torch.where(m00 > 0, torch.div(m01, safe, rounding_mode="floor"),
                     h // 2)
    return cy, cx
