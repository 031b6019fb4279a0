"""U-Net and U-Net-DC segmentation models as `nn.Module`s.

Same architecture as the JAX package's `models/unet.py` (reference
models/model.py `UNet`, models/model_2.py `UNetDC`): double 3x3 convs with
BatchNorm, dilations 1/2/4/8/16 in the UNetDC encoder, 2x2 stride-2
transposed-conv upsampling, a 1x1 head and the sigmoid inside `forward`.
Module names follow the reference state dict (`enc1.0.weight`, ...,
`upconv4.weight`, `out_conv.weight`), so a reference `.pth` loads directly.

`forward` takes and returns NHWC tensors, like the JAX package, so the two
are compared like with like; the convolutions run NCHW-logical on a
channels-last view.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
_BLOCKS = ("enc1", "enc2", "enc3", "enc4", "bottleneck",
           "dec4", "dec3", "dec2", "dec1")


def double_conv(cin: int, cout: int, dilation: int) -> nn.Sequential:
    """(Conv3x3 -> BN -> ReLU) x 2, padding == dilation (models/model_2.py)."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation),
        nn.BatchNorm2d(cout, eps=BN_EPS),
        nn.ReLU(inplace=True),
        nn.Conv2d(cout, cout, 3, padding=dilation, dilation=dilation),
        nn.BatchNorm2d(cout, eps=BN_EPS),
        nn.ReLU(inplace=True),
    )


class _UNetBase(nn.Module):
    dilations: Tuple[int, int, int, int, int] = (1, 1, 1, 1, 1)

    def __init__(self, in_channels: int = 3, out_channels: int = 1):
        super().__init__()
        d = self.dilations
        self.enc1 = double_conv(in_channels, 64, d[0])
        self.enc2 = double_conv(64, 128, d[1])
        self.enc3 = double_conv(128, 256, d[2])
        self.enc4 = double_conv(256, 512, d[3])
        self.bottleneck = double_conv(512, 1024, d[4])
        self.upconv4 = nn.ConvTranspose2d(1024, 512, 2, 2)
        self.dec4 = double_conv(1024, 512, 1)
        self.upconv3 = nn.ConvTranspose2d(512, 256, 2, 2)
        self.dec3 = double_conv(512, 256, 1)
        self.upconv2 = nn.ConvTranspose2d(256, 128, 2, 2)
        self.dec2 = double_conv(256, 128, 1)
        self.upconv1 = nn.ConvTranspose2d(128, 64, 2, 2)
        self.dec1 = double_conv(128, 64, 1)
        self.out_conv = nn.Conv2d(64, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, out) probabilities."""
        x = x.permute(0, 3, 1, 2)
        e1 = self.enc1(x)
        e2 = self.enc2(F.max_pool2d(e1, 2))
        e3 = self.enc3(F.max_pool2d(e2, 2))
        e4 = self.enc4(F.max_pool2d(e3, 2))
        b = self.bottleneck(F.max_pool2d(e4, 2))
        d4 = self.dec4(torch.cat([self.upconv4(b), e4], 1))
        d3 = self.dec3(torch.cat([self.upconv3(d4), e3], 1))
        d2 = self.dec2(torch.cat([self.upconv2(d3), e2], 1))
        d1 = self.dec1(torch.cat([self.upconv1(d2), e1], 1))
        return torch.sigmoid(self.out_conv(d1).float()).permute(0, 2, 3, 1)


class UNet(_UNetBase):
    """Classic 4-level U-Net (reference models/model.py)."""

    dilations = (1, 1, 1, 1, 1)


class UNetDC(_UNetBase):
    """U-Net with dilations 1/2/4/8/16 in the encoder and bottleneck
    (reference models/model_2.py)."""

    dilations = (1, 2, 4, 8, 16)


def fold_batchnorm(state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fold BatchNorm into the convs of a reference state dict (eval mode).

    For y = BN(conv(x) + b): W' = W * gamma / sqrt(var + eps) per output
    channel, b' = (b - mean) * gamma / sqrt(var + eps) + beta, in float32
    and in the JAX package's operation order (`models/unet.py
    fold_batchnorm`). Returns float32 CPU tensors in the folded layout the
    fast forward consumes:
      {block: {"conv0"/"conv1": {"kernel": HWIO, "bias": (O,)}},
       "upconv{n}": {"kernel": (I, O, 2, 2), "bias"},
       "out_conv": {"kernel": (1, 1, I, O), "bias"}}
    """
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in
          state_dict.items() if not k.endswith("num_batches_tracked")}
    out: Dict[str, Dict] = {}
    for block in _BLOCKS:
        convs = {}
        for i, (ci, bi) in enumerate(((0, 1), (3, 4))):
            scale = sd[f"{block}.{bi}.weight"] / torch.sqrt(
                sd[f"{block}.{bi}.running_var"] + BN_EPS)
            w = sd[f"{block}.{ci}.weight"].permute(2, 3, 1, 0)  # HWIO
            convs[f"conv{i}"] = {
                "kernel": (w * scale).contiguous(),
                "bias": (sd[f"{block}.{ci}.bias"]
                         - sd[f"{block}.{bi}.running_mean"]) * scale
                + sd[f"{block}.{bi}.bias"],
            }
        out[block] = convs
    for n in (4, 3, 2, 1):
        out[f"upconv{n}"] = {"kernel": sd[f"upconv{n}.weight"].contiguous(),
                             "bias": sd[f"upconv{n}.bias"]}
    out["out_conv"] = {
        "kernel": sd["out_conv.weight"].permute(2, 3, 1, 0).contiguous(),
        "bias": sd["out_conv.bias"]}
    return out
