"""Thresholding ops: Otsu (cv2.THRESH_OTSU) and two-threshold hysteresis
segmentation; port of the JAX package's `ops/threshold.py`, batched over
the leading dims.

Otsu's class sums are cumulative sums of 256 float32 bins. XLA on the CPU
computes a cumsum longer than 16 as a blocked scan: sequential sums within
blocks of 16, the same scan (recursively) of the block totals, and each
block's exclusive prefix added to it. `cumsum_xla_cpu` makes exactly those
float32 additions, so the thresholds are the JAX package's on the CPU and
the same on the card (a library scan sums in another order, and a near-tie
can then pick another threshold). The blob detectors' integral image uses
it too.
"""

from __future__ import annotations

import torch

from unetdc_tpu_torch.ops.morphology import binary_dilation3x3


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 running sum along the last dim."""
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k] = out[..., k - 1] + x[..., k]
    return out


def cumsum_xla_cpu(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive float32 cumsum along the last dim in XLA's CPU order: up
    to `base` long, a sequential sum; longer, zero-padded to blocks of
    `base`, summed sequentially within each block, and each block's
    exclusive prefix (this scan of the block totals) added."""
    n = x.shape[-1]
    if n <= base:
        return _seq_cumsum(x)
    padded = -(-n // base) * base
    xp = torch.nn.functional.pad(x, (0, padded - n))
    blocks = _seq_cumsum(xp.reshape(*x.shape[:-1], padded // base, base))
    totals = cumsum_xla_cpu(blocks[..., -1], base)
    excl = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]],
                     -1)
    out = blocks + excl[..., None]
    return out.reshape(*x.shape[:-1], padded)[..., :n]


def otsu_threshold(img_u8: torch.Tensor) -> torch.Tensor:
    """Otsu threshold of each uint8 image over the last two dims (cv2's
    getThreshVal_Otsu_8u: maximise q1*q2*(mu1-mu2)^2 over t in 0..255,
    skipping near-empty classes, first maximum wins) -> int64 (...,) t;
    binarise with img > t."""
    lead = img_u8.shape[:-2]
    flat = img_u8.reshape(-1, img_u8.shape[-2] * img_u8.shape[-1]).long()
    n = flat.shape[1]
    hist = torch.zeros(flat.shape[0], 256, dtype=torch.int64,
                       device=img_u8.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    p = hist.to(torch.float32) / n
    i = torch.arange(256, dtype=torch.float32, device=img_u8.device)
    omega = cumsum_xla_cpu(p)
    mu_t = cumsum_xla_cpu(p * i)
    mu_total = mu_t[:, -1:]
    q1, q2 = omega, 1.0 - omega
    valid = (q1 > 1e-7) & (q2 > 1e-7)
    mu1 = torch.where(valid, mu_t / q1.clamp_min(1e-12), 0.0)
    mu2 = torch.where(valid, (mu_total - mu_t) / q2.clamp_min(1e-12), 0.0)
    sigma = torch.where(valid, q1 * q2 * (mu1 - mu2) ** 2, -torch.inf)
    # first maximum: the smallest t whose sigma equals the row's max
    t = torch.where(sigma == sigma.amax(1, keepdim=True), i, 256.0
                    ).amin(1).long()
    return t.reshape(lead)


def otsu_binarize(img_u8: torch.Tensor) -> torch.Tensor:
    """cv2.threshold(img, 0, 255, THRESH_BINARY + THRESH_OTSU) -> bool
    (img > t), per image over the last two dims."""
    t = otsu_threshold(img_u8)
    return img_u8.long() > t[..., None, None]


def segmentation_two_thresholds(image: torch.Tensor, thresh1,
                                thresh2) -> torch.Tensor:
    """dilate3x3(img >= thresh1) & (img >= thresh2)."""
    return binary_dilation3x3(image >= thresh1) & (image >= thresh2)
