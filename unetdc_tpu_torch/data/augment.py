"""Training augmentations, batched on the device; port of the JAX package's
`data/augment.py`.

Parity target: the albumentations pipeline of train_DC_focal.py:183-190 /
train.py:86-93:
    HorizontalFlip(p=0.5), VerticalFlip(p=0.2), RandomRotate90(p=0.5),
    RandomBrightnessContrast(p=0.2), ElasticTransform(alpha=1, sigma=50,
    p=0.3), ToTensorV2.

The JAX package draws from a PRNG key inside one jitted function. Here the
work is split in two:
  - `draw_augment` takes a `torch.Generator` and draws, per sample and in
    the JAX order, the decisions and values: hflip, vflip, rot90 and its k,
    brightness/contrast and its two values, elastic, then the two uniform
    noise fields of the displacement. Every draw is made whatever the
    decisions, so a batch always consumes the same amount of the stream.
  - `apply_augment` is deterministic given those draws.
The trainer derives one generator per batch from the epoch's generator, as
the JAX trainer splits one key per batch. The JAX and torch random streams
differ; the distributions and the arithmetic given the draws match.

Notes (from the JAX package):
  - RandomBrightnessContrast uses the albumentations defaults (limits
    +-0.2, brightness_by_max, max value 1.0 for floats):
    img' = clip(img * (1 + c) + b, 0, 1).
  - ElasticTransform follows modern albumentations (>= 1.4): displacement
    = gaussian_filter(uniform(-1, 1), sigma) * alpha per axis, bilinear
    remap with REFLECT_101 borders for the image and nearest for the mask.
    At sigma = 50 the field is synthesized on a stride-s coarse grid (blur
    sigma/s) and bilinearly upsampled (half-pixel centres, edge weights
    renormalized, as `jax.image.resize(..., "bilinear")`); s = 1 for small
    images keeps the exact full-resolution path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from unetdc_tpu_torch.ops.filters import gaussian_filter_scipy
from unetdc_tpu_torch.utils.profiling import sync


@dataclasses.dataclass
class AugmentDraws:
    """Per-sample draws of one batch (CPU tensors, leading dim B)."""
    hflip: torch.Tensor        # bool
    vflip: torch.Tensor        # bool
    rot_k: torch.Tensor        # int64 in 0..3 (0 when no rotation)
    bc: torch.Tensor           # bool
    contrast: torch.Tensor     # f32, 1 + U(-0.2, 0.2)
    brightness: torch.Tensor   # f32, U(-0.2, 0.2)
    elastic: torch.Tensor      # bool
    noise_x: torch.Tensor      # (B, ch, cw) f32 U(-1, 1)
    noise_y: torch.Tensor      # (B, ch, cw) f32 U(-1, 1)


def field_stride(hw: Tuple[int, int], sigma: float) -> int:
    """Coarse-grid stride of the elastic field (JAX `_elastic_displacement`)."""
    h, w = hw
    return min(max(1, min(h, w) // 64), max(1, int(sigma // 6)))


def noise_shape(hw: Tuple[int, int], sigma: float) -> Tuple[int, int]:
    s = field_stride(hw, sigma)
    return -(-hw[0] // s), -(-hw[1] // s)


def draw_augment(gen: torch.Generator, batch: int, hw: Tuple[int, int],
                 p_hflip: float = 0.5, p_vflip: float = 0.2,
                 p_rot90: float = 0.5, p_bc: float = 0.2,
                 p_elastic: float = 0.3, elastic_sigma: float = 50.0
                 ) -> AugmentDraws:
    """Draw one batch's augmentation decisions from `gen` (a CPU generator),
    sample by sample in the JAX order (`_augment_one`)."""
    ns = noise_shape(hw, elastic_sigma)
    cols = {k: [] for k in ("hflip", "vflip", "rot_k", "bc", "contrast",
                            "brightness", "elastic", "noise_x", "noise_y")}

    def u():
        return float(torch.rand((), generator=gen))

    for _ in range(batch):
        cols["hflip"].append(u() < p_hflip)
        cols["vflip"].append(u() < p_vflip)
        do_r = u() < p_rot90
        k = int(torch.randint(0, 4, (), generator=gen))
        cols["rot_k"].append(k if do_r else 0)
        cols["bc"].append(u() < p_bc)
        cols["contrast"].append(1.0 + (u() * 0.4 - 0.2))
        cols["brightness"].append(u() * 0.4 - 0.2)
        cols["elastic"].append(u() < p_elastic)
        cols["noise_x"].append(torch.rand(ns, generator=gen) * 2 - 1)
        cols["noise_y"].append(torch.rand(ns, generator=gen) * 2 - 1)
    return AugmentDraws(
        hflip=torch.tensor(cols["hflip"]), vflip=torch.tensor(cols["vflip"]),
        rot_k=torch.tensor(cols["rot_k"], dtype=torch.int64),
        bc=torch.tensor(cols["bc"]),
        contrast=torch.tensor(cols["contrast"], dtype=torch.float32),
        brightness=torch.tensor(cols["brightness"], dtype=torch.float32),
        elastic=torch.tensor(cols["elastic"]),
        noise_x=torch.stack(cols["noise_x"]),
        noise_y=torch.stack(cols["noise_y"]))


# ------------------------------------------------------------------ field --
def elastic_field(noise_y: torch.Tensor, noise_x: torch.Tensor,
                  hw: Tuple[int, int], alpha: float, sigma: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy, dx) of shape (..., h, w) from uniform noise fields (..., ch, cw)
    on the stride-s grid: blur sigma/s, scale by alpha, bilinear upsample
    by s (half-pixel centres, clamped edges) and crop to (h, w)."""
    h, w = hw
    s = field_stride(hw, sigma)
    out = []
    for noise in (noise_y, noise_x):
        d = gaussian_filter_scipy(noise, sigma / s) * alpha
        if s > 1:
            lead = d.shape[:-2]
            ch, cw = d.shape[-2:]
            d = F.interpolate(d.reshape(-1, 1, ch, cw), size=(ch * s, cw * s),
                              mode="bilinear", align_corners=False)
            d = d.reshape(*lead, ch * s, cw * s)[..., :h, :w]
        out.append(d)
    return out[0], out[1]


# ------------------------------------------------------------------ remap --
def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect-101 index fold for |i| < 2n."""
    i = i.abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _shift_r101(img: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """(B, H, W, ...) shifted by (oy, ox) with reflect-101 edges:
    out[:, y, x] = img[:, reflect(y + oy), reflect(x + ox)]."""
    h, w = img.shape[1:3]
    dev = img.device
    iy = _reflect101(torch.arange(h, device=dev) + oy, h)
    ix = _reflect101(torch.arange(w, device=dev) + ox, w)
    return img.index_select(1, iy).index_select(2, ix)


def remap_subpixel(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                   nearest: bool) -> torch.Tensor:
    """Gather-free remap of (B, H, W[, C]) for |displacement| < 1 px (JAX
    `_remap_subpixel`): selects over the 9 reflect-101 shifted copies.
    Displacements are clipped to +-(1 - 1e-6); the nearest path rounds the
    absolute coordinate (half to even), so its offset depends on the parity
    of the pixel index, exactly as the gather version's."""
    eps = 1e-6
    dy = dy.clamp(-1 + eps, 1 - eps)
    dx = dx.clamp(-1 + eps, 1 - eps)
    S = {(oy, ox): _shift_r101(img, oy, ox)
         for oy in (-1, 0, 1) for ox in (-1, 0, 1)}
    chan = img.dim() == 4

    def _b(m):  # broadcast a (B, H, W) tensor over the channel dim
        return m[..., None] if chan else m

    if nearest:
        h, w = dy.shape[-2:]
        yy = torch.arange(h, dtype=dy.dtype, device=dy.device)[:, None]
        xx = torch.arange(w, dtype=dx.dtype, device=dx.device)[None, :]
        ry = (torch.round(yy + dy) - yy).to(torch.int32)
        rx = (torch.round(xx + dx) - xx).to(torch.int32)
        out = S[(0, 0)]
        for oy in (-1, 0, 1):
            for ox in (-1, 0, 1):
                if (oy, ox) != (0, 0):
                    out = torch.where(_b((ry == oy) & (rx == ox)),
                                      S[(oy, ox)], out)
        return out

    ey = dy < 0
    ex = dx < 0
    fy = _b(dy - torch.where(ey, -1.0, 0.0))
    fx = _b(dx - torch.where(ex, -1.0, 0.0))

    def corner(a, b):
        return torch.where(
            _b(ey & ex), S[(a - 1, b - 1)],
            torch.where(_b(ey & ~ex), S[(a - 1, b)],
                        torch.where(_b(~ey & ex), S[(a, b - 1)], S[(a, b)])))

    return (corner(0, 0) * (1 - fy) * (1 - fx)
            + corner(0, 1) * (1 - fy) * fx
            + corner(1, 0) * fy * (1 - fx)
            + corner(1, 1) * fy * fx)


def _remap_gather(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                  nearest: bool) -> torch.Tensor:
    """Remap of (B, H, W[, C]) by any displacement below the image size
    (JAX `_remap_bilinear` / `_remap_nearest`), reflect-101 edges."""
    b, h, w = img.shape[:3]
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + dy
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + dx
    flat = img.reshape(b, h * w, -1)

    def at(yy, xx):
        idx = (_reflect101(yy, h) * w + _reflect101(xx, w)).reshape(b, -1, 1)
        out = torch.gather(flat, 1, idx.expand(-1, -1, flat.shape[-1]))
        return out.reshape(img.shape)

    if nearest:
        return at(torch.round(ys).long(), torch.round(xs).long())
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    fy, fx = ys - y0, xs - x0
    if img.dim() == 4:
        fy, fx = fy[..., None], fx[..., None]
    return ((at(y0, x0) * (1 - fy) * (1 - fx)) + (at(y0, x0 + 1) * (1 - fy)
            * fx) + (at(y0 + 1, x0) * fy * (1 - fx))
            + (at(y0 + 1, x0 + 1) * fy * fx))


# ------------------------------------------------------------------ apply --
def apply_augment(images: torch.Tensor, masks: torch.Tensor,
                  draws: AugmentDraws, elastic_alpha: float = 1.0,
                  elastic_sigma: float = 50.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one batch's draws: images (B, H, W, 3) f32 in [0, 1], masks
    (B, H, W), H == W (true after the resize). Deterministic."""
    dev = images.device
    fields = dataclasses.fields(draws)
    with sync("augment_draws", len(fields)):  # one blocking upload each
        d = {f.name: getattr(draws, f.name).to(dev) for f in fields}
    hw = tuple(masks.shape[1:3])

    def sel(flag, a, b):
        return torch.where(flag.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    img, mask = images, masks
    img = sel(d["hflip"], img.flip(2), img)
    mask = sel(d["hflip"], mask.flip(2), mask)
    img = sel(d["vflip"], img.flip(1), img)
    mask = sel(d["vflip"], mask.flip(1), mask)
    for k in (1, 2, 3):
        is_k = d["rot_k"] == k
        img = sel(is_k, torch.rot90(img, k, dims=(1, 2)), img)
        mask = sel(is_k, torch.rot90(mask, k, dims=(1, 2)), mask)
    c = d["contrast"].reshape(-1, 1, 1, 1)
    b = d["brightness"].reshape(-1, 1, 1, 1)
    img = sel(d["bc"], torch.clamp(img * c + b, 0.0, 1.0), img)
    if bool(draws.elastic.any()):  # draws live on the CPU: no device sync
        dy, dx = elastic_field(d["noise_y"], d["noise_x"], hw, elastic_alpha,
                               elastic_sigma)
        remap = remap_subpixel if elastic_alpha <= 1.0 else _remap_gather
        img = sel(d["elastic"], remap(img, dy, dx, nearest=False), img)
        mask = sel(d["elastic"], remap(mask, dy, dx, nearest=True), mask)
    return img, mask


def augment_batch(gen: torch.Generator, images: torch.Tensor,
                  masks: torch.Tensor, **kw) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Draw from `gen` and apply: images (B,H,W,3) f32, masks (B,H,W)."""
    probs = {k: kw.pop(k) for k in ("p_hflip", "p_vflip", "p_rot90", "p_bc",
                                    "p_elastic") if k in kw}
    sigma = kw.get("elastic_sigma", 50.0)
    draws = draw_augment(gen, images.shape[0], tuple(masks.shape[1:3]),
                         elastic_sigma=sigma, **probs)
    return apply_augment(images, masks, draws, **kw)
