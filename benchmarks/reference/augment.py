"""Plain reference of the training augmentation: the reference trainer's
albumentations pipeline (train_DC_focal.py:183-190): HorizontalFlip(0.5),
VerticalFlip(0.2), RandomRotate90(0.5), RandomBrightnessContrast(0.2,
limits +-0.2: img * (1 + c) + b, clipped to [0, 1]) and
ElasticTransform(alpha=1, sigma=50, p=0.3: a displacement of
gaussian-filtered uniform noise, bilinear remap of the image and nearest
of the mask, reflect-101 borders).

The random draws are the traffic's: they come from the run's seed through
a CPU `torch.Generator`, in the order the measured trainer documents
(`data/augment.py`): per batch a generator seeded from the epoch's, then
per sample hflip, vflip, rot90 and its k, brightness/contrast and its two
values, elastic, and the two noise fields of the displacement on a coarse
grid of stride s (blurred by sigma / s, upsampled bilinearly). This file
redraws them itself and applies them with its own arithmetic.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

SIGMA = 50.0
ALPHA = 1.0


def field_stride(hw: Tuple[int, int]) -> int:
    return min(max(1, min(hw) // 64), max(1, int(SIGMA // 6)))


def batch_generators(seed: int, epoch: int, n_batches: int):
    """One generator per batch, derived from the epoch's generator."""
    gen = torch.Generator().manual_seed(seed * 1000 + epoch)
    return [torch.Generator().manual_seed(
        int(torch.randint(0, 2 ** 62, (), generator=gen)))
        for _ in range(n_batches)]


def draw(gen: torch.Generator, batch: int, hw: Tuple[int, int]):
    s = field_stride(hw)
    ns = (-(-hw[0] // s), -(-hw[1] // s))
    out = []

    def u():
        return float(torch.rand((), generator=gen))

    for _ in range(batch):
        d = {"hflip": u() < 0.5, "vflip": u() < 0.2}
        do_rot = u() < 0.5
        k = int(torch.randint(0, 4, (), generator=gen))
        d["rot_k"] = k if do_rot else 0
        d["bc"] = u() < 0.2
        d["contrast"] = 1.0 + (u() * 0.4 - 0.2)
        d["brightness"] = u() * 0.4 - 0.2
        d["elastic"] = u() < 0.3
        d["noise_x"] = torch.rand(ns, generator=gen) * 2 - 1
        d["noise_y"] = torch.rand(ns, generator=gen) * 2 - 1
        out.append(d)
    return out


def _displacement(noise: torch.Tensor, hw, dev) -> torch.Tensor:
    from scipy.ndimage import gaussian_filter

    s = field_stride(hw)
    d = gaussian_filter(noise.numpy().astype(np.float64), SIGMA / s,
                        mode="reflect", truncate=4.0) * ALPHA
    d = torch.from_numpy(d.astype(np.float32)).to(dev)
    if s > 1:
        d = F.interpolate(d[None, None], scale_factor=s, mode="bilinear",
                          align_corners=False)[0, 0]
    return d[:hw[0], :hw[1]]


def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    i = i.abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _remap(img: torch.Tensor, dy, dx, nearest: bool) -> torch.Tensor:
    """(H, W[, C]) sampled at (y + dy, x + dx), reflect-101 borders.
    The displacement stays under one pixel (alpha = 1)."""
    h, w = img.shape[:2]
    eps = 1e-6
    dy = dy.clamp(-1 + eps, 1 - eps)
    dx = dx.clamp(-1 + eps, 1 - eps)
    ys = torch.arange(h, device=img.device, dtype=torch.float32)[:, None] + dy
    xs = torch.arange(w, device=img.device, dtype=torch.float32)[None, :] + dx

    def at(yi, xi):
        return img[_reflect101(yi, h), _reflect101(xi, w)]

    if nearest:
        return at(torch.round(ys).long(), torch.round(xs).long())
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    y0, x0 = y0.long(), x0.long()
    if img.dim() == 3:
        fy, fx = fy[..., None], fx[..., None]
    return (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
            + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)


def apply(img: torch.Tensor, mask: torch.Tensor, d: dict):
    """One sample: img (H, W, 3) float32 in [0, 1], mask (H, W)."""
    if d["hflip"]:
        img, mask = img.flip(1), mask.flip(1)
    if d["vflip"]:
        img, mask = img.flip(0), mask.flip(0)
    if d["rot_k"]:
        img = torch.rot90(img, d["rot_k"], (0, 1))
        mask = torch.rot90(mask, d["rot_k"], (0, 1))
    if d["bc"]:
        img = torch.clamp(img * d["contrast"] + d["brightness"], 0.0, 1.0)
    if d["elastic"]:
        hw = tuple(mask.shape)
        dy = _displacement(d["noise_y"], hw, img.device)
        dx = _displacement(d["noise_x"], hw, img.device)
        img = _remap(img, dy, dx, nearest=False)
        mask = _remap(mask, dy, dx, nearest=True)
    return img, mask
