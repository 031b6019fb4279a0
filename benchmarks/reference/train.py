"""Plain reference of the first training steps: the reference trainers'
data path (utils/data_loader.py: rolling ball at the original size,
cv2 resize to 512, /255; masks binarised and resized nearest), the
augmentation of `reference/augment.py` (in float32), the UNet/UNetDC
with train-mode BatchNorm in the precision asked for (float64 when it
judges, float32 for a control or a fault in the program's place), the
losses of utils/metrics_DC.py in logits form and Adam
(torch.optim.Adam's update: lr 1e-3, betas 0.9/0.999, eps 1e-8 outside
the square root).

The two losses (reference utils/metrics_DC.py):
  focal_dice = 0.3 * focal(alpha 1, gamma 2) + 0.7 * (1 - soft dice)
  combined   = 0.5 * BCE + 0.5 * (1 - soft dice)
with BCE(sigmoid(z), t) computed as max(z, 0) - z t + log1p(exp(-|z|)).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from reference import augment, model, ops


def bce_logits(z, t):
    return torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs()))


def soft_dice_loss(p, t, smooth=1e-7):
    inter = (p * t).sum((2, 3))
    union = p.sum((2, 3)) + t.sum((2, 3))
    return 1.0 - ((2.0 * inter + smooth) / (union + smooth)).mean()


def loss_fn(kind: str, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """z, t: (B, 1, H, W)."""
    bce = bce_logits(z, t)
    dice = soft_dice_loss(torch.sigmoid(z), t)
    if kind == "focal_dice":
        focal = ((1.0 - torch.exp(-bce)) ** 2 * bce).mean()
        return 0.3 * focal + 0.7 * dice
    if kind == "combined":
        return 0.5 * bce.mean() + 0.5 * dice
    raise ValueError(kind)


def prepare_batch(images_u8, masks_u8, gen, size: int, device):
    """Raw (B, H, W, 3) uint8 images and (B, H, W) 0/1 masks (numpy) ->
    augmented (B, 3, S, S) float32 input and (B, 1, S, S) target."""
    imgs = torch.as_tensor(images_u8, device=device)
    b, h, w, _ = imgs.shape
    planes = ops.rolling_ball(imgs.permute(0, 3, 1, 2).reshape(-1, h, w), 50)
    planes = ops.resize_u8(planes, (size, size)).reshape(b, 3, size, size)
    x = (planes.to(torch.float32) / 255.0).permute(0, 2, 3, 1)
    m = ops.resize_nearest(torch.as_tensor(masks_u8, device=device),
                           (size, size)).to(torch.float32)
    draws = augment.draw(gen, b, (size, size))
    xs, ms = [], []
    for i in range(b):
        xi, mi = augment.apply(x[i], m[i], draws[i])
        xs.append(xi)
        ms.append(mi)
    return (torch.stack(xs).permute(0, 3, 1, 2).contiguous(),
            torch.stack(ms)[:, None])


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr=1e-3,
                 betas=(0.9, 0.999), eps=1e-8):
        self.p = params
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            self.p[k].sub_(self.lr * (self.m[k] / c1) / denom)


def first_steps(params0: Dict[str, torch.Tensor], dilations, loss: str,
                batches: List[dict], size: int, device,
                quant: Optional[str] = None, dtype=torch.float32):
    """Run len(batches) steps from params0 (which are not modified) with
    the model, the loss and Adam in `dtype`. Each batch is {'images',
    'masks', 'gen'}. Returns (losses, first gradients, parameters after
    the last step)."""
    params = {k: v.detach().to(device, dtype).clone()
              for k, v in params0.items()}
    opt = Adam(params)
    losses, grads0 = [], None
    for bt in batches:
        x, t = prepare_batch(bt["images"], bt["masks"], bt["gen"], size,
                             device)
        x, t = x.to(dtype), t.to(dtype)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        z = model.forward(leaves, x, dilations, train=True, quant=quant)
        lval = loss_fn(loss, z, t)
        names = list(leaves)
        gs = torch.autograd.grad(lval, [leaves[k] for k in names])
        grads = dict(zip(names, gs))
        for v in params.values():
            v.requires_grad_(False)
        if grads0 is None:
            grads0 = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(lval.detach()))
        del z, lval, gs, grads
    return losses, grads0, params
