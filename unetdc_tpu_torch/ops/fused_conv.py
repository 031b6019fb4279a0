"""The two fused convolution kernels of the UNetDC forward (K1, K2) and
their plain PyTorch versions.

K1 `conv3x3_relu_pool` replaces the JAX package's Pallas kernel
`ops/pallas_conv.py::pair_conv_pool` (enc1.conv1): y = ReLU(conv3x3(x) + b)
and pool = maxpool2x2(y) in one pass, accumulated in f32 and rounded once
to the storage type. Source: `csrc/fused_conv.cu`.

K2 `dec1_head` replaces `ops/pallas_conv.py::dec1_head`: upconv1
(ConvTranspose2d 128->64, k2 s2, + bias) -> concat [up, enc1] (never
materialised) -> conv3x3 128->64 + ReLU -> conv3x3 64->64 + ReLU -> 1x1
64->1 + bias -> sigmoid, f32 probabilities out. Source: same file.

Layout: NHWC activations, as the JAX package's public functions use. The
TPU kernels work in a pair layout with mid/side weight splits that exist only
for the TPU's 128 lanes; these kernels owe the same outputs, not that
layout, and take the folded HWIO weights directly.

Rounding points (same as the Pallas bodies): K1 rounds y once; K2 rounds
`up` after its bias and edge mask, `h` after conv0's ReLU, and `d1` after
conv1's ReLU; the 1x1 head and the sigmoid stay f32.

Each wrapper launches its CUDA kernel for a CUDA tensor (or raises) and
runs the plain version only for a CPU tensor.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from unetdc_tpu_torch.ops import cuda_build as cb

_DTYPES = (torch.bfloat16, torch.float32)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _oihw(w_hwio: torch.Tensor) -> torch.Tensor:
    return w_hwio.permute(3, 2, 0, 1)


# ---------------------------------------------------------------------------
# K1: conv3x3 64->64 + bias + ReLU, and its 2x2 max pool
# ---------------------------------------------------------------------------

def conv3x3_relu_pool_plain(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1. x (B,H,W,C) bf16/f32, w (3,3,C,C) HWIO in x's
    type, b (C,) f32 -> (y (B,H,W,C), pool (B,H/2,W/2,C)) in x's type."""
    y = F.conv2d(_nchw(x.float()), _oihw(w.float()), b.float(), padding=1)
    y = torch.relu(y).to(x.dtype)
    pool = F.max_pool2d(y.float(), 2).to(x.dtype)
    return _nhwc(y), _nhwc(pool)


def _check_k1(x, w, b):
    if x.dtype not in _DTYPES or w.dtype != x.dtype or \
            b.dtype != torch.float32:
        raise TypeError("conv3x3_relu_pool: x, w in bf16 or f32 (same type)"
                        ", b f32")
    B, H, W, C = x.shape
    if C != 64 or tuple(w.shape) != (3, 3, 64, 64) or tuple(b.shape) != (64,):
        raise ValueError("conv3x3_relu_pool: kernel takes 64->64 channels, "
                         f"got x {tuple(x.shape)} w {tuple(w.shape)}")
    if H % 2 or W % 2:
        raise ValueError("conv3x3_relu_pool: H and W must be even")
    for t in (x, w, b):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv3x3_relu_pool: tensors must be contiguous "
                             "and on one device")


def conv3x3_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (see module docstring). CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return conv3x3_relu_pool_plain(x, w, b)
    _check_k1(x, w, b)
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    pool = torch.empty((B, H // 2, W // 2, C), dtype=x.dtype, device=x.device)
    name = ("k1_conv3x3_relu_pool_bf16" if x.dtype == torch.bfloat16
            else "k1_conv3x3_relu_pool_f32")
    rc = getattr(cb.lib(), name)(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                 y.data_ptr(), pool.data_ptr(), B, H, W,
                                 cb.stream_of(x))
    cb.check(rc, name)
    cb.LAUNCHES["conv3x3_relu_pool"] += 1
    return y, pool


# ---------------------------------------------------------------------------
# K2: upconv1 -> concat -> dec1 double conv -> out_conv -> sigmoid
# ---------------------------------------------------------------------------

HEAD_KEYS = ("w_up", "b_up", "w0", "b0", "w1", "b1", "w_oc", "b_oc")


def dec1_head_plain(dec2: torch.Tensor, enc1: torch.Tensor,
                    head: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain version of K2. dec2 (B,H/2,W/2,128), enc1 (B,H,W,64) in
    bf16/f32; `head` is `unet_fast.build_fast_params(...)["head"]`. Returns
    (B,H,W,1) f32 probabilities."""
    dt = enc1.dtype
    w_up = head["w_up"].float().permute(2, 3, 0, 1)  # (p,q,I,O) -> (I,O,p,q)
    up = F.conv_transpose2d(_nchw(dec2.float()), w_up, head["b_up"].float(),
                            stride=2).to(dt)
    cat = torch.cat([up.float(), _nchw(enc1.float())], 1)
    h = torch.relu(F.conv2d(cat, _oihw(head["w0"].float()),
                            head["b0"].float(), padding=1)).to(dt)
    d1 = torch.relu(F.conv2d(h.float(), _oihw(head["w1"].float()),
                             head["b1"].float(), padding=1)).to(dt)
    o = F.conv2d(d1.float(), head["w_oc"].float().view(1, -1, 1, 1),
                 head["b_oc"].float())
    return _nhwc(torch.sigmoid(o))


def _check_k2(dec2, enc1, head):
    dt = enc1.dtype
    if dt not in _DTYPES or dec2.dtype != dt:
        raise TypeError("dec1_head: dec2 and enc1 in bf16 or f32 (same type)")
    B, H, W, C = enc1.shape
    shapes = {"w_up": ((2, 2, 128, 64), dt), "b_up": ((64,), torch.float32),
              "w0": ((3, 3, 128, 64), dt), "b0": ((64,), torch.float32),
              "w1": ((3, 3, 64, 64), dt), "b1": ((64,), torch.float32),
              "w_oc": ((64,), dt), "b_oc": ((1,), torch.float32)}
    if C != 64 or H % 2 or W % 2 or \
            tuple(dec2.shape) != (B, H // 2, W // 2, 128):
        raise ValueError(f"dec1_head: got dec2 {tuple(dec2.shape)} enc1 "
                         f"{tuple(enc1.shape)}")
    for k, (shape, t) in shapes.items():
        v = head[k]
        if tuple(v.shape) != shape or v.dtype != t:
            raise ValueError(f"dec1_head: {k} must be {shape} {t}, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for t in (dec2, enc1, *head.values()):
        if t.device != enc1.device or not t.is_contiguous():
            raise ValueError("dec1_head: tensors must be contiguous and on "
                             "one device")


def dec1_head(dec2: torch.Tensor, enc1: torch.Tensor,
              head: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K2 (see module docstring). CPU tensors take the plain version."""
    if enc1.device.type == "cpu":
        return dec1_head_plain(dec2, enc1, head)
    _check_k2(dec2, enc1, head)
    B, H, W, _ = enc1.shape
    out = torch.empty((B, H, W, 1), dtype=torch.float32, device=enc1.device)
    name = ("k2_dec1_head_bf16" if enc1.dtype == torch.bfloat16
            else "k2_dec1_head_f32")
    rc = getattr(cb.lib(), name)(
        dec2.data_ptr(), enc1.data_ptr(),
        *(head[k].data_ptr() for k in HEAD_KEYS), out.data_ptr(), B, H, W,
        cb.stream_of(enc1))
    cb.check(rc, name)
    cb.LAUNCHES["dec1_head"] += 1
    return out
