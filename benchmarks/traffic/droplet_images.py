"""Microscopy-like droplet images from a seed, with their drawn droplets.

The field is uniform noise in [0, noise) with bright disks (+brightness,
saturating) on it, as the repository's synthetic blob images are drawn,
with the droplet count and the droplet area as parameters. Every image
has all three channels equal, as the reference's real data does.

As in the reference's example rows (292 droplets covering 37,660 px, 11
covering 36,420 px), an image's droplets cover about the same total area
whatever their number: an image of c droplets has droplet areas spread
evenly over [a/2, 3a/2], a = total_area_px / c, clipped to area_px.

So that the seed changes where the droplets lie and not how much work a
set holds, the droplet counts of a set of n images are the fixed ladder
round(linspace(lo, hi, n)), given to the images in a seeded order, each
image's areas are that fixed ladder, shuffled, and droplets never touch
(`draw_image`); only positions, order and noise come from the seed.

Parameters (a traffic file's "images" object): n, height, width,
droplets [lo, hi], total_area_px, area_px [lo, hi], noise, brightness.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), stream]))


def draw_image(rng: np.random.Generator, h: int, w: int, n_drops: int,
               areas: np.ndarray, noise: int, brightness: int
               ) -> Tuple[np.ndarray, List[Tuple[int, int, float]]]:
    """(H, W) uint8 plane and its droplets [(cy, cx, r)]. Droplets do not
    touch: each sits in a cell of its own of a grid whose cells hold the
    largest droplet and a 2-pixel margin, cells and offsets drawn from the
    seed. So every seed's image has the same components, and the work of
    labelling them does not depend on the seed."""
    img = (rng.random((h, w), dtype=np.float32) * noise).astype(np.uint8)
    radii = np.sqrt(rng.permutation(areas)[:n_drops] / np.pi)
    cell = 2 * int(np.ceil(radii.max())) + 6
    gy, gx = h // cell, w // cell
    if gy * gx < n_drops:
        raise ValueError(f"{n_drops} droplets of radius {radii.max():.1f} "
                         f"do not fit apart in {h}x{w}")
    drops = []
    for c, r in zip(rng.choice(gy * gx, n_drops, replace=False), radii):
        m = int(np.ceil(r)) + 2
        y0, x0 = (c // gx) * cell, (c % gx) * cell
        cy = y0 + int(rng.integers(m, cell - m))
        cx = x0 + int(rng.integers(m, cell - m))
        win = np.s_[cy - m:cy + m + 1, cx - m:cx + m + 1]
        yy, xx = np.mgrid[win]
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        sub = img[win]
        sub[disk] = np.minimum(sub[disk].astype(np.int32) + brightness,
                               255).astype(np.uint8)
        drops.append((cy, cx, float(r)))
    return img, drops


def make_images(p: Dict, seed: int):
    """[(H, W, 3) uint8 image], [droplets of each image]."""
    n = int(p["n"])
    lo, hi = p["droplets"]
    counts = np.rint(np.linspace(lo, hi, n)).astype(int)
    counts = rng_for(seed, 0).permutation(counts)
    imgs, drops = [], []
    for i in range(n):
        rng = rng_for(seed, 1 + i)
        a = p["total_area_px"] / counts[i]
        areas = np.clip(np.linspace(a / 2, 3 * a / 2, counts[i]),
                        p["area_px"][0], p["area_px"][1])
        plane, d = draw_image(rng, int(p["height"]), int(p["width"]),
                              int(counts[i]), areas, int(p["noise"]),
                              int(p["brightness"]))
        imgs.append(np.repeat(plane[:, :, None], 3, axis=2))
        drops.append(d)
    return imgs, drops


def write_folder(folder, p: Dict, seed: int, threads: int = 4):
    """Write make_images' images as img000.png ... into folder; returns
    the droplets of each image."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from PIL import Image

    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    imgs, drops = make_images(p, seed)

    def save(i):
        Image.fromarray(imgs[i]).save(folder / f"img{i:03d}.png",
                                      compress_level=1)

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(save, range(len(imgs))))
    return drops
