"""Bit-depth conversion and the true (skimage-style) rolling ball; port of
the JAX package's `ops/bitdepth.py` (algorithms.py convert_to_8_bits and
rolling_ball).

The rolling ball is a non-flat grayscale erosion by the ball's height
function followed by the matching dilation, over its ~pi*r^2 taps
(31,417 at r = 100). The JAX package streams the taps one by one through
`lax.scan`; one launch per tap would cost 60k+ launches an image here, so
the taps go in groups instead: all taps of one row offset dy are windows
of one padded row slab (`unfold`), added to their heights and reduced by
min (max) in one op, chunked to bound the temporary. Each tap's `x + h`
rounds the same whatever the grouping, and min and max do not depend on
order, so the result is bit-equal to the scan.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unetdc_tpu_torch.device import resolve_device

# skimage rgb2gray / rgba2rgb luminance weights
_GRAY_W = (0.2125, 0.7154, 0.0721)
_BIG = 3.4e38
_CHUNK_ELEMS = 1 << 26


def convert_to_8_bits(image) -> np.ndarray:
    """algorithms.py convert_to_8_bits: rgba -> rgb (over white) -> gray
    (skimage weights), then rescale (0, max) to (0, 255) and truncate to
    uint8 (host numpy, as in the JAX package)."""
    img = np.asarray(image, np.float64)
    if img.ndim == 3 and img.shape[-1] == 4:
        alpha = img[..., 3:4]
        if alpha.max() > 1:
            alpha = alpha / 255.0
            rgb = img[..., :3] / 255.0
        else:
            rgb = img[..., :3]
        img = (1 - alpha) * 1.0 + alpha * rgb
        img = img @ np.asarray(_GRAY_W)
    elif img.ndim == 3 and img.shape[-1] == 3:
        img = img @ np.asarray(_GRAY_W)
    mx = img.max()
    if mx > 0:
        img = img / mx * 255.0
    return img.astype(np.uint8)


def _ball_kernel(radius: int) -> np.ndarray:
    """skimage.restoration.rolling_ball's default kernel: the sphere of the
    given radius; NaN outside its support, else the distance down to the
    sphere's surface."""
    d = np.arange(-radius, radius + 1, dtype=np.float64)
    yy, xx = np.meshgrid(d, d, indexing="ij")
    s = radius ** 2 - yy ** 2 - xx ** 2
    kernel = np.full_like(s, np.nan)
    inside = s >= 0
    kernel[inside] = radius - np.sqrt(s[inside])
    return kernel


def _ball_pass(x: torch.Tensor, kernel: np.ndarray, erode: bool
               ) -> torch.Tensor:
    """min_q [x(p+q) + k(q)] (erode) or max_q [x(p+q) - k(q)] over the
    ball's taps q, on the last two dims of x (float32)."""
    r = kernel.shape[0] // 2
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    fill = _BIG if erode else -_BIG
    xp = F.pad(x.reshape(-1, h, w), (r, r, r, r), value=fill)
    acc = torch.full_like(x.reshape(-1, h, w), fill)
    per_tap = xp.shape[0] * h * w
    step = max(1, _CHUNK_ELEMS // per_tap)
    for dy in range(-r, r + 1):
        row = kernel[dy + r]
        dxs = np.flatnonzero(~np.isnan(row))          # one contiguous run
        hts = torch.from_numpy(row[dxs].astype(np.float32)).to(x.device)
        if not erode:
            hts = -hts
        # window j of the slab starts at column j: tap dx = j - r
        win = xp[:, r + dy:r + dy + h].unfold(-1, w, 1)   # (B, h, 2r+1, w)
        for c in range(0, len(dxs), step):
            j = slice(int(dxs[c]), int(dxs[min(c + step, len(dxs)) - 1]) + 1)
            t = win[:, :, j] + hts[c:c + step, None]
            acc = torch.minimum(acc, t.amin(2)) if erode else \
                torch.maximum(acc, t.amax(2))
    return acc.reshape(*lead, h, w)


def rolling_ball_skimage(image: torch.Tensor, radius: int = 100
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """True rolling-ball background of the last two dims of `image`
    (skimage.restoration.rolling_ball semantics):
        eroded(p) = min_q [img(p+q) + ball(q)]
        bg(p)     = max_q [eroded(p+q) - ball(q)]
    Returns (background, image - background), float32."""
    kernel = _ball_kernel(int(radius))
    img = image.to(torch.float32)
    background = _ball_pass(_ball_pass(img, kernel, True), kernel, False)
    return background, img - background


def rolling_ball(image, rad, *, device="cuda"):
    """algorithms.py rolling_ball: (background, corrected) numpy float32
    of a 2D image, computed on `device`."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(image, np.float32)).to(dev)
    bg, corr = rolling_ball_skimage(x, int(rad))
    return bg.cpu().numpy(), corr.cpu().numpy()
