"""BN-folded inference forward of UNet/UNetDC with the thin-channel stages
on the port's fused CUDA kernels.

Counterpart of the JAX package's `models/unet_fast.py::forward_folded_pallas`:
- the stem enc1.conv0, enc2 .. dec2 and upconv4 .. upconv2 are ordinary
  `F.conv2d` / `F.conv_transpose2d` / `F.max_pool2d` (XLA's share there);
- enc1.conv1 + ReLU + the 2x2 pool is kernel K1
  (`ops/fused_conv.py::conv3x3_relu_pool`);
- upconv1 -> concat -> dec1 -> out_conv -> sigmoid is kernel K2
  (`ops/fused_conv.py::dec1_head`).

The JAX version packs pixel pairs into 128 lanes for the TPU; here the
activations stay NHWC at the kernels and NCHW-logical/channels-last
between the library convolutions, and the kernels take the folded HWIO
weights directly. Public tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from unetdc_tpu_torch.ops import fused_conv

_ENC = ("enc2", "enc3", "enc4", "bottleneck")
_DEC = ("dec4", "dec3", "dec2")


def build_fast_params(folded: Dict[str, Any], dtype=torch.bfloat16,
                      device="cpu") -> Dict[str, Any]:
    """Weights for `forward_folded` from `unet.fold_batchnorm(...)`, cast
    once to `dtype` on `device` (the fused kernels keep their biases f32,
    as the Pallas kernels do)."""

    def t(a, dt=dtype):
        return a.to(device=device, dtype=dt).contiguous()

    def oihw(k):
        return t(k.permute(3, 2, 0, 1))

    fp: Dict[str, Any] = {}
    for name in ("enc1",) + _ENC + _DEC:
        blk = folded[name]
        fp[name] = {"k0": oihw(blk["conv0"]["kernel"]),
                    "b0": t(blk["conv0"]["bias"]),
                    "k1": oihw(blk["conv1"]["kernel"]),
                    "b1": t(blk["conv1"]["bias"])}
    # K1 weights: enc1.conv1 HWIO
    fp["k1"] = {"w": t(folded["enc1"]["conv1"]["kernel"]),
                "b": t(folded["enc1"]["conv1"]["bias"], torch.float32)}
    for n in (4, 3, 2):
        fp[f"upconv{n}"] = {"k": t(folded[f"upconv{n}"]["kernel"]),
                            "b": t(folded[f"upconv{n}"]["bias"])}
    oc = folded["out_conv"]["kernel"]  # (1, 1, 64, n_out)
    if oc.shape[-1] != 1:
        raise ValueError("the fused head supports one output channel")
    f32 = torch.float32
    fp["head"] = {
        # upconv1 (I, O, 2, 2) -> (p, q, I, O)
        "w_up": t(folded["upconv1"]["kernel"].permute(2, 3, 0, 1)),
        "b_up": t(folded["upconv1"]["bias"], f32),
        "w0": t(folded["dec1"]["conv0"]["kernel"]),  # (3,3,128,64): [up, enc1]
        "b0": t(folded["dec1"]["conv0"]["bias"], f32),
        "w1": t(folded["dec1"]["conv1"]["kernel"]),
        "b1": t(folded["dec1"]["conv1"]["bias"], f32),
        "w_oc": t(oc.reshape(-1)),
        "b_oc": t(folded["out_conv"]["bias"].reshape(1), f32),
    }
    return fp


def _conv(x, k, b, dil=1):
    return torch.relu(F.conv2d(x, k, b, padding=dil, dilation=dil))


def _dc(x, p, dil=1):
    return _conv(_conv(x, p["k0"], p["b0"], dil), p["k1"], p["b1"], dil)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def forward_folded(fp: Dict[str, Any], x: torch.Tensor,
                   dilations: Tuple[int, ...] = (1, 2, 4, 8, 16),
                   conv_pool: Callable = fused_conv.conv3x3_relu_pool,
                   head: Callable = fused_conv.dec1_head) -> torch.Tensor:
    """(B, H, W, 3) float in [0, 1] -> (B, H, W, 1) f32 probabilities.

    H and W must be divisible by 16. `conv_pool` / `head` default to the
    fused kernels K1 / K2; passing their `*_plain` versions gives the plain
    PyTorch reference path of the same forward."""
    d = dilations
    if d[0] != 1:
        raise ValueError("the fused enc1 stage needs an undilated enc1")
    dt = fp["enc1"]["k0"].dtype
    xc = x.to(dt).permute(0, 3, 1, 2)  # channels-last NCHW view
    stem = _conv(xc, fp["enc1"]["k0"], fp["enc1"]["b0"])
    enc1, pooled = conv_pool(_nhwc(stem), fp["k1"]["w"], fp["k1"]["b"])
    enc2 = _dc(pooled.permute(0, 3, 1, 2), fp["enc2"], d[1])
    enc3 = _dc(F.max_pool2d(enc2, 2), fp["enc3"], d[2])
    enc4 = _dc(F.max_pool2d(enc3, 2), fp["enc4"], d[3])
    bott = _dc(F.max_pool2d(enc4, 2), fp["bottleneck"], d[4])
    dec = bott
    for n, name, skip in ((4, "dec4", enc4), (3, "dec3", enc3),
                          (2, "dec2", enc2)):
        up = F.conv_transpose2d(dec, fp[f"upconv{n}"]["k"],
                                fp[f"upconv{n}"]["b"], stride=2)
        dec = _dc(torch.cat([up, skip], 1), fp[name])
    return head(_nhwc(dec), enc1, fp["head"])
