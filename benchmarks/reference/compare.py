"""The numbers that decide `correct` for probabilities and masks."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from reference import ops

BAND = 1e-4   # reference probabilities kept: BAND < p < 1 - BAND


def logit_gap(p_prog: torch.Tensor, p_ref: torch.Tensor) -> float:
    """Mean |logit(p) - logit(p_ref)| over the pixels whose reference
    probability is not saturated (|logit| < 9.2), where a float32 sigmoid
    still holds the logit; the side judged is clamped to 1e-7 first."""
    keep = (p_ref > BAND) & (p_ref < 1 - BAND)
    lp = torch.logit(p_prog.double().clamp(1e-7, 1 - 1e-7))
    lr = torch.logit(p_ref.double())
    d = (lp - lr).abs()[keep]
    return float(d.mean()) if d.numel() else 0.0


DECISIVE = 1.0  # logit units around the threshold


def reference_masks(p_ref: torch.Tensor, thresh: float,
                    out_hw: Tuple[int, int]):
    """(mask, decisive) at out_hw of (B, S, S) reference probabilities:
    the thresholded mask resized as the pipelines resize it, and where
    that mask stays the same with the threshold moved DECISIVE logits
    either way (a pixel the reference decides firmly)."""
    z = math.log(thresh / (1 - thresh))

    def at(t):
        return ops.resize_u8((p_ref > t).to(torch.uint8), out_hw).cpu()

    lo = at(1 / (1 + math.exp(-(z - DECISIVE))))
    hi = at(1 / (1 + math.exp(-(z + DECISIVE))))
    return at(thresh).numpy(), (lo == hi).numpy()


def mask_counts(mask_prog: np.ndarray, mask_ref: np.ndarray,
                decisive: np.ndarray) -> Tuple[int, int]:
    """(pixels the reference decides firmly where the masks differ, pixels
    the reference decides firmly)."""
    return (int(((mask_prog != mask_ref) & decisive).sum()),
            int(decisive.sum()))
