"""Training pairs from a seed: a mid-grey noisy RGB field with bright
droplets, and the droplets' mask (255 inside), as the repository's
epoch-wall tool draws its synthetic set (a noise floor, then disks added
within their bounding boxes). Every seed draws the same number of
droplets per image from the same radius range; the seed moves them.

Parameters (a traffic file's "pairs" object): n, height, width,
droplets (per image), radius [lo, hi], floor, noise, brightness.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from traffic.droplet_images import rng_for


def draw_pair(rng: np.random.Generator, p: Dict):
    h, w = int(p["height"]), int(p["width"])
    img = (p["floor"] + rng.random((h, w, 3), dtype=np.float32)
           * p["noise"]).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    lo, hi = p["radius"]
    for _ in range(int(p["droplets"])):
        r = int(rng.integers(lo, hi + 1))
        cy, cx = int(rng.integers(r, h - r)), int(rng.integers(r, w - r))
        win = np.s_[cy - r:cy + r + 1, cx - r:cx + r + 1]
        yy, xx = np.mgrid[win]
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        sub = img[win]
        sub[disk] = np.minimum(sub[disk].astype(np.int32) + p["brightness"],
                               255).astype(np.uint8)
        mask[win][disk] = 255
    return img, mask


def write_pairs(out_dir: str, p: Dict, seed: int):
    """images/ and masks/ PNGs (sample000.png, ...) under out_dir; returns
    (image_dir, mask_dir, names)."""
    from PIL import Image

    img_dir = os.path.join(out_dir, "images")
    mask_dir = os.path.join(out_dir, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    names = []
    for i in range(int(p["n"])):
        img, mask = draw_pair(rng_for(seed, 1000 + i), p)
        name = f"sample{i:03d}.png"
        Image.fromarray(img).save(os.path.join(img_dir, name),
                                  compress_level=1)
        Image.fromarray(mask).save(os.path.join(mask_dir, name),
                                   compress_level=1)
        names.append(name)
    return img_dir, mask_dir, names
