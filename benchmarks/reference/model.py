"""Plain float32 UNet / UNetDC (malani86/unet-DC-segmentation,
models/model.py:7-50 and models/model_2.py:5-80), written from the
published description with nothing but torch operations.

The state dict keys are the published ones (`enc1.0.weight`, ...,
`upconv4.weight`, `out_conv.weight`). Tensors are NCHW. BatchNorm in eval
mode uses the running statistics (BatchNorm is never folded here); in
train mode it normalises with the batch's mean and biased variance, as the
trainer being measured does, and the running statistics are not needed by
any comparison, so they are not updated.

`quant` replaces every convolution operand (input and weight) by its value
rounded to a lower precision (`fp8_e4m3`: per-tensor scale amax / 448),
the operand rounding of an fp8 path; gradients pass straight through the
rounding. It serves only as the control of the comparisons.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

WIDTHS = (64, 128, 256, 512, 1024)
BN_EPS = 1e-5


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().amax().clamp_min(1e-30)
        scale = amax / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _q(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return t
    if quant == "fp8_e4m3":
        return _RoundFP8.apply(t)
    raise ValueError(f"unknown quant {quant!r}")


def conv(x, w, b, dilation=1, quant=None):
    """3x3 (padding = dilation) or 1x1 convolution in float32."""
    pad = dilation if w.shape[-1] == 3 else 0
    return F.conv2d(_q(x, quant), _q(w, quant), b, 1, pad, dilation)


def batchnorm(x, sd, key, train):
    g, beta = sd[key + ".weight"], sd[key + ".bias"]
    if train:
        mean = x.mean((0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean((0, 2, 3))
    else:
        mean, var = sd[key + ".running_mean"], sd[key + ".running_var"]
    inv = torch.rsqrt(var + BN_EPS) * g
    return (x - mean[:, None, None]) * inv[:, None, None] \
        + beta[:, None, None]


def double_conv(x, sd, name, dilation, train, quant):
    for ci, bi in ((0, 1), (3, 4)):
        x = conv(x, sd[f"{name}.{ci}.weight"], sd[f"{name}.{ci}.bias"],
                 dilation, quant)
        x = torch.relu(batchnorm(x, sd, f"{name}.{bi}", train))
    return x


def upconv(x, sd, name, quant):
    return F.conv_transpose2d(_q(x, quant), _q(sd[name + ".weight"], quant),
                              sd[name + ".bias"], stride=2)


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, dilations,
            train: bool = False, quant: Optional[str] = None,
            features: bool = False) -> torch.Tensor:
    """Logits (B, 1, H, W) of an NCHW float32 batch; with `features`, the
    (B, widths[0], H, W) input of the 1x1 head instead. TF32 is turned off:
    on the card cuDNN and cuBLAS would otherwise round float32 operands to
    10-bit mantissas. cuDNN's algorithm search is off too: its heuristic
    choice needs no timing runs for every new shape."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    d = dilations
    e1 = double_conv(x, sd, "enc1", d[0], train, quant)
    e2 = double_conv(F.max_pool2d(e1, 2), sd, "enc2", d[1], train, quant)
    e3 = double_conv(F.max_pool2d(e2, 2), sd, "enc3", d[2], train, quant)
    e4 = double_conv(F.max_pool2d(e3, 2), sd, "enc4", d[3], train, quant)
    bn = double_conv(F.max_pool2d(e4, 2), sd, "bottleneck", d[4], train,
                     quant)
    x = bn
    for lvl, skip in ((4, e4), (3, e3), (2, e2), (1, e1)):
        x = torch.cat([upconv(x, sd, f"upconv{lvl}", quant), skip], 1)
        x = double_conv(x, sd, f"dec{lvl}", 1, train, quant)
    if features:
        return x
    return conv(x, sd["out_conv.weight"], sd["out_conv.bias"], 1, quant)


def param_shapes(in_channels: int = 3, widths=WIDTHS):
    """{key: shape} of the published state dict's parameters, in module
    order (BatchNorm running statistics excluded)."""
    shapes = {}
    enc = [in_channels] + list(widths)
    names = ["enc1", "enc2", "enc3", "enc4", "bottleneck"]
    for i, name in enumerate(names):
        cin, cout = enc[i], enc[i + 1]
        shapes.update({f"{name}.0.weight": (cout, cin, 3, 3),
                       f"{name}.0.bias": (cout,),
                       f"{name}.1.weight": (cout,), f"{name}.1.bias": (cout,),
                       f"{name}.3.weight": (cout, cout, 3, 3),
                       f"{name}.3.bias": (cout,),
                       f"{name}.4.weight": (cout,), f"{name}.4.bias": (cout,)})
    for lvl in (4, 3, 2, 1):
        cin, cout = widths[lvl], widths[lvl - 1]
        name = f"dec{lvl}"
        shapes.update({f"upconv{lvl}.weight": (cin, cout, 2, 2),
                       f"upconv{lvl}.bias": (cout,),
                       f"{name}.0.weight": (cout, 2 * cout, 3, 3),
                       f"{name}.0.bias": (cout,),
                       f"{name}.1.weight": (cout,), f"{name}.1.bias": (cout,),
                       f"{name}.3.weight": (cout, cout, 3, 3),
                       f"{name}.3.bias": (cout,),
                       f"{name}.4.weight": (cout,), f"{name}.4.bias": (cout,)})
    shapes["out_conv.weight"] = (1, widths[0], 1, 1)
    shapes["out_conv.bias"] = (1,)
    return shapes
