"""The least work of each of the port's kernels at the shapes the
quantifier drives, for their roofline shares: useful operations (2 per
multiply-add; K2 by the layers it fuses, not by its tile plan) and bytes
with each input read once and each output written once.

  K1 `conv3x3_relu_pool`: enc1's second conv (64 -> 64, 3x3) + ReLU +
     2x2 max pool; reads x (B, H, W, 64) bf16 and the 3x3x64x64 kernel,
     writes y (B, H, W, 64) and the pooled (B, H/2, W/2, 64), bf16.
  K2 `dec1_head`: upconv1 (128 -> 64, 2x2 stride 2), the skip concat,
     dec1's two 3x3 convs (128 -> 64, 64 -> 64) and the 1x1 head with the
     sigmoid; reads dec2 (B, H/2, W/2, 128), enc1 (B, H, W, 64) bf16 and
     the four kernels, writes (B, H, W) f32 probabilities.
  K3 `component_tables`: reads (B, H, W) int32 labels, writes the
     (B, cap, 1 + 2k) int32 table of areas and coordinate-sum chunks
     (k chunks per axis: the split plan of 8-bit chunks for exact int32
     sums), cap = max(5120, max_labels + 1).

Peaks are `harness/peaks.py`'s.
"""

from __future__ import annotations

from harness.peaks import BF16_FLOPS, HBM_BYTES_PER_S

BF16 = 2


def k1(b: int, h: int, w: int, c: int = 64):
    ops = 2 * b * h * w * 9 * c * c
    byts = BF16 * (b * h * w * c + 9 * c * c + c
                   + b * h * w * c + b * (h // 2) * (w // 2) * c)
    return ops, byts


def k2(b: int, h: int, w: int, c: int = 64):
    ops = (2 * b * (h // 2) * (w // 2) * 2 * c * c * 4      # upconv1
           + 2 * b * h * w * 9 * 2 * c * c                    # dec1 conv0
           + 2 * b * h * w * 9 * c * c                        # dec1 conv1
           + 2 * b * h * w * c)                               # head
    weights = 2 * c * c * 4 + 9 * 2 * c * c + 9 * c * c + c + 3 * c + 1
    byts = (BF16 * (b * (h // 2) * (w // 2) * 2 * c + b * h * w * c
                    + weights) + 4 * b * h * w)
    return ops, byts


def k3_chunks(h: int, w: int) -> int:
    n_pix = h * w
    bits = min(8, ((2 ** 31 - 1) // n_pix + 1).bit_length() - 1)
    mc = max(h - 1, w - 1, 1)
    return len(range(0, mc.bit_length(), bits))


def k3(b: int, h: int, w: int, max_labels: int = 4096):
    cap = max(5120, max_labels + 1)
    nf = 1 + 2 * k3_chunks(h, w)
    ops = b * h * w * nf          # one add per feature per pixel
    byts = 4 * b * h * w + 4 * b * cap * nf
    return ops, byts


def bound_s(ops: int, byts: int, peak_ops: float = BF16_FLOPS) -> float:
    """Least seconds: the larger of operations over the peak rate and
    bytes over the HBM rate."""
    return max(ops / peak_ops, byts / HBM_BYTES_PER_S)
