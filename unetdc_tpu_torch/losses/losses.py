"""Segmentation losses, formula-exact with the reference
(utils/metrics_DC.py); port of the JAX package's `losses/losses.py`.

Tensors are NHWC (B, H, W, C) like the JAX package's; dice reduces over the
spatial dims (1, 2), the reference's per-(batch, channel) reduction.

The probability-space functions are the parity surface for evaluation.
Training uses the logits-space variants: the reference feeds sigmoid
probabilities to BCE, whose gradient -1/p explodes as predictions saturate
(it NaNs within two epochs in f32 and bf16). The `*_from_logits` functions
compute the same values through log-sigmoid identities with bounded
gradients (d bce / d z = sigmoid(z) - t). Do not simplify them back.
"""

from __future__ import annotations

from typing import Optional

import torch

_SPATIAL = (1, 2)  # H, W of NHWC


def _wmean(vals: torch.Tensor, weights: Optional[torch.Tensor]
           ) -> torch.Tensor:
    """Mean over (B, ...) values with optional per-sample weights (B,):
    sum(vals * w) / (sum(w) * per-sample element count); plain mean when
    weights is None. Weight 0 excludes a sample."""
    if weights is None:
        return vals.mean()
    w = weights.reshape((-1,) + (1,) * (vals.dim() - 1)).to(vals.dtype)
    per_sample = 1
    for s in vals.shape[1:]:
        per_sample *= s
    return (vals * w).sum() / (w.sum() * per_sample)


def dice_loss(pred: torch.Tensor, target: torch.Tensor, smooth: float = 1e-7,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft dice loss (utils/metrics_DC.py:11-17): per-sample dice over the
    spatial dims, 1 - (weighted) mean."""
    intersection = (pred * target).sum(_SPATIAL)
    union = pred.sum(_SPATIAL) + target.sum(_SPATIAL)
    dice = (2.0 * intersection + smooth) / (union + smooth)
    return 1.0 - _wmean(dice, weights)


def _bce(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12
         ) -> torch.Tensor:
    """Elementwise BCE on probabilities, log terms clamped for stability."""
    p = pred.clamp(eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))


def combined_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5 * BCE + 0.5 * dice (utils/metrics_DC.py:19-22)."""
    return 0.5 * _bce(pred, target).mean() + 0.5 * dice_loss(pred, target)


def dice_coef(y_true: torch.Tensor, y_pred: torch.Tensor,
              smooth: float = 1e-7, weights: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Hard dice: pred binarized at 0.5 (utils/metrics_DC.py:24-29)."""
    y_pred = (y_pred > 0.5).to(torch.float32)
    intersection = (y_true * y_pred).sum(_SPATIAL)
    union = y_true.sum(_SPATIAL) + y_pred.sum(_SPATIAL)
    dice = (2.0 * intersection + smooth) / (union + smooth)
    return _wmean(dice, weights)


def _focal_terms(bce: torch.Tensor, alpha: float, gamma: float
                 ) -> torch.Tensor:
    pt = torch.exp(-bce)
    return alpha * (1.0 - pt) ** gamma * bce


def _reduce(fl: torch.Tensor, reduction: str,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    if reduction == "mean":
        return _wmean(fl, weights)
    if reduction == "sum":
        return fl.sum()
    return fl


def focal_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 1.0,
               gamma: float = 2.0, reduction: str = "mean") -> torch.Tensor:
    """Binary focal loss on probabilities (utils/metrics_DC.py:31-63):
    bce elementwise, pt = exp(-bce), alpha * (1-pt)^gamma * bce."""
    return _reduce(_focal_terms(_bce(pred, target), alpha, gamma), reduction)


def focal_dice_loss(pred: torch.Tensor, target: torch.Tensor,
                    alpha: float = 1.0, gamma: float = 2.0,
                    ratio: float = 0.3) -> torch.Tensor:
    """ratio * focal + (1 - ratio) * dice; production training uses
    ratio=0.3 (utils/metrics_DC.py:65-73, train_DC_focal.py:222)."""
    fl = focal_loss(pred, target, alpha=alpha, gamma=gamma)
    return ratio * fl + (1.0 - ratio) * dice_loss(pred, target)


# ------------------------------------------------- logits space (training) --
def _bce_from_logits(logits: torch.Tensor, target: torch.Tensor
                     ) -> torch.Tensor:
    """Elementwise BCE(sigmoid(z), t), stably:
    max(z, 0) - z*t + log1p(exp(-|z|)). At z = 0 the gradients follow
    JAX's: `jnp.maximum` splits a tie in halves (so does `torch.maximum`,
    clamp would not) and `jnp.abs` has slope +1 (torch's abs has 0)."""
    abs_z = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * target
            + torch.log1p(torch.exp(-abs_z)))


def combined_loss_from_logits(logits: torch.Tensor, target: torch.Tensor,
                              weights: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """combined_loss with the stable BCE; dice on sigmoid(logits)."""
    return (0.5 * _wmean(_bce_from_logits(logits, target), weights)
            + 0.5 * dice_loss(torch.sigmoid(logits), target,
                              weights=weights))


def focal_loss_from_logits(logits: torch.Tensor, target: torch.Tensor,
                           alpha: float = 1.0, gamma: float = 2.0,
                           reduction: str = "mean",
                           weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """focal_loss with the stable elementwise BCE; `weights` applies to the
    mean reduction only."""
    fl = _focal_terms(_bce_from_logits(logits, target), alpha, gamma)
    return _reduce(fl, reduction, weights)


def focal_dice_loss_from_logits(logits: torch.Tensor, target: torch.Tensor,
                                alpha: float = 1.0, gamma: float = 2.0,
                                ratio: float = 0.3,
                                weights: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    fl = focal_loss_from_logits(logits, target, alpha=alpha, gamma=gamma,
                                weights=weights)
    dl = dice_loss(torch.sigmoid(logits), target, weights=weights)
    return ratio * fl + (1.0 - ratio) * dl
