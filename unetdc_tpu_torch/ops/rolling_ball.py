"""Rolling-ball background correction (reference utils/data_loader.py):
per channel, a morphological opening with
cv2.getStructuringElement(MORPH_ELLIPSE, (radius, radius)) (the cv2
argument is the kernel size), a saturating subtract of the background, then
NORM_MINMAX to [0, 255]. Port of the JAX package's `ops/rolling_ball.py`.

CUDA tensors go through one hand-written kernel (`csrc/rolling_ball.cu`:
erode, dilate with the subtract and the per-plane range, normalise), CPU
tensors through the plain version, the chain of shifted mins and maxes of
`ops/morphology.py`; the two are bit-equal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from unetdc_tpu_torch.ops import cuda_build as cb
from unetdc_tpu_torch.ops.morphology import (_footprint_rows, ellipse_kernel,
                                             morph_open)
from unetdc_tpu_torch.utils import profiling

MAX_PLANES = 65535  # the kernel's grid holds one plane per z index
MAX_KSIZE = 16384  # the largest footprint a block's shared memory holds
_SMEM_BYTES = 232448  # shared memory a block can use on the H100
_ACC_BYTES = 32768  # the accumulator ring's share a tile aims at


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


def rolling_ball_correction_plain(planes: torch.Tensor, radius: int = 50
                                  ) -> torch.Tensor:
    """Plain version: background-correct planes (..., H, W) of uint8 values
    independently."""
    kernel = ellipse_kernel(radius)
    background = morph_open(planes, kernel)
    corrected = torch.clamp(planes.to(torch.float32) - background, min=0.0)
    return normalize_minmax_u8(corrected)


@functools.lru_cache(maxsize=None)
def footprint_table(ksize: int
                    ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """The kernel's footprint: (rows, 3) int32 (dy, lo, hi), row i of
    `ellipse_kernel(ksize)` covering columns [c - lo, c + hi] of input row
    r + dy for output (r, c) (anchor ksize // 2), in the order in which the
    runs nest; and (dy_min, dy_max, left, right), the rows' offsets and the
    widest run's reach."""
    kernel = ellipse_kernel(ksize)
    ay, ax = kernel.shape[0] // 2, kernel.shape[1] // 2
    runs = sorted((ax - j1, j2 - 1 - ax, i - ay)
                  for i, j1, j2 in _footprint_rows(kernel))
    if not runs or any(lo < 0 or hi < 0 for lo, hi, _ in runs) or any(
            a[1] > b[1] for a, b in zip(runs, runs[1:])):
        raise ValueError(f"ksize {ksize}: footprint row runs must nest "
                         "around the anchor")
    table = np.array([(dy, lo, hi) for lo, hi, dy in runs], np.int32)
    return table, (int(table[:, 0].min()), int(table[:, 0].max()),
                   int(table[:, 1].max()), int(table[:, 2].max()))


def _smem_bytes(nrows: int, ring: int, tw: int, left: int, right: int
                ) -> int:
    """A block's shared memory: the table (8 bytes a row, 16-aligned), the
    accumulator ring (a byte a column) and two row buffers with the halo."""
    return -(-8 * nrows // 16) * 16 + ring * tw + 2 * (tw + left + right)


def kernel_tile(ksize: int) -> Tuple[int, int, int]:
    """(ring, tw, rb) of the kernel at `ksize`: accumulator rows (a power
    of two >= the footprint's height); a block's output columns (the most
    whose ring takes at most 32 KB, else the most that fit); and its output
    rows (half the ring: at ksize 50 on the H100, 32 rows beat 16 and 64,
    the halo rows' cost against the blocks in flight). ValueError where no
    tile fits a block's shared memory (ksize > MAX_KSIZE)."""
    table, (dy_min, dy_max, left, right) = footprint_table(ksize)
    ring = 1 << (dy_max - dy_min).bit_length()
    fits = [w for w in (256, 128, 64, 32, 16, 8, 4)
            if _smem_bytes(len(table), ring, w, left, right) <= _SMEM_BYTES]
    if not fits:
        raise ValueError(f"rolling ball: no tile of the CUDA kernel fits "
                         f"ksize {ksize} in a block's shared memory; it "
                         f"takes ksize <= {MAX_KSIZE}")
    tw = next((w for w in fits if ring * w <= _ACC_BYTES), fits[-1])
    return ring, tw, max(ring // 2, 16)


@functools.lru_cache(maxsize=None)
def _device_table(ksize: int, device: torch.device) -> torch.Tensor:
    """The table packed as the kernel reads it, (dy, lo | hi << 16) int32
    pairs, uploaded once per (ksize, device)."""
    t = footprint_table(ksize)[0]
    packed = np.stack([t[:, 0], t[:, 1] | (t[:, 2] << 16)], 1)
    return torch.from_numpy(np.ascontiguousarray(packed)).to(device)


def rolling_ball_correction(planes: torch.Tensor, radius: int = 50
                            ) -> torch.Tensor:
    """Background-correct uint8 image planes (..., H, W) independently.
    CPU tensors take the plain version; a CUDA tensor must be uint8."""
    if planes.device.type == "cpu":
        return rolling_ball_correction_plain(planes, radius)
    if planes.dtype != torch.uint8 or planes.dim() < 2:
        raise ValueError("rolling_ball_correction: a CUDA tensor must be "
                         f"uint8 (..., H, W), not {planes.dtype} "
                         f"{tuple(planes.shape)}")
    ksize = int(radius)
    table, (dy_min, dy_max, left, right) = footprint_table(ksize)
    ring, tw, rb = kernel_tile(ksize)
    out = torch.empty(planes.shape, dtype=torch.uint8, device=planes.device)
    if out.numel() == 0:
        return out
    h, w = planes.shape[-2:]
    if planes.dim() == 2:
        x = planes[None, None]
    elif planes.dim() == 3:
        x = planes[:, None]
    else:
        x = planes.reshape(-1, *planes.shape[-3:])
    nb, nc = x.shape[:2]
    if nb * nc > MAX_PLANES:
        raise ValueError(f"rolling_ball_correction: {nb * nc} planes > "
                         f"{MAX_PLANES}")
    ero = torch.empty((nb * nc, h, w), dtype=torch.uint8,
                      device=planes.device)
    minmax = torch.empty((nb * nc, 2), dtype=torch.int32,
                         device=planes.device)
    dev_table = _device_table(ksize, planes.device)
    with cb.on_device(planes):
        rc = cb.lib().rb_rolling_ball(
            x.data_ptr(), nb, nc, h, w, *x.stride(), dev_table.data_ptr(),
            len(table), dy_min, dy_max, left, right, ring, tw, rb,
            ero.data_ptr(), out.data_ptr(), minmax.data_ptr(),
            cb.stream_of(planes))
    cb.check(rc, "rb_rolling_ball")
    cb.LAUNCHES["rolling_ball"] += 1
    profiling.count("rolling_ball.kernel")
    return out


def rolling_ball_correction_rgb(image: torch.Tensor, radius: int = 50
                                ) -> torch.Tensor:
    """(..., H, W, C) uint8 -> same, each channel corrected on its own."""
    planes = image.movedim(-1, -3)
    return rolling_ball_correction(planes, radius).movedim(-3, -1)
