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

`ext` mode (both kernels; the counterpart of the Pallas kernels' `ext=True`)
takes one row shard of the image with real halo rows from its neighbours
(K1: one above and one below; K2: one for dec2, two for enc1) and pads only
the width; K2's `edge_flags` (is_top, is_bottom) say where the shard
touches the global image edge, the only place where its `up` and `h` rows
are masked. Shards reassembled from `ext` launches equal the unsharded
kernel bit for bit: each output pixel is computed by the same sequence of
operations wherever its shard starts.

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


def _check_aligned(name: str, *ts: torch.Tensor) -> None:
    """The kernels' tensor maps (TMA) and vector loads need 16-byte aligned
    bases."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: activations and weights must start on a "
                         "16-byte boundary")


# ---------------------------------------------------------------------------
# K1: conv3x3 64->64 + bias + ReLU, and its 2x2 max pool
# ---------------------------------------------------------------------------

def conv3x3_relu_pool_plain(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, ext: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1. x (B,H,W,C) bf16/f32, w (3,3,C,C) HWIO in x's
    type, b (C,) f32 -> (y (B,H,W,C), pool (B,H/2,W/2,C)) in x's type.
    ext: x is (B,H+2,W,C), a row shard with one real halo row above and
    below, so only the width is zero-padded."""
    xr = _nchw(x.float())
    if not ext:
        xr = F.pad(xr, (0, 0, 1, 1))
    y = F.conv2d(xr, _oihw(w.float()), b.float(), padding=(0, 1))
    y = torch.relu(y).to(x.dtype)
    pool = F.max_pool2d(y.float(), 2).to(x.dtype)
    return _nhwc(y), _nhwc(pool)


def _check_k1(x, w, b, ext=False):
    if x.dtype not in _DTYPES or w.dtype != x.dtype or \
            b.dtype != torch.float32:
        raise TypeError("conv3x3_relu_pool: x, w in bf16 or f32 (same type)"
                        ", b f32")
    B, H, W, C = x.shape
    H -= 2 * ext
    if C != 64 or tuple(w.shape) != (3, 3, 64, 64) or tuple(b.shape) != (64,):
        raise ValueError("conv3x3_relu_pool: kernel takes 64->64 channels, "
                         f"got x {tuple(x.shape)} w {tuple(w.shape)}")
    if H <= 0 or H % 2 or W % 2:
        raise ValueError("conv3x3_relu_pool: H and W must be even "
                         "(H without the halo rows in ext mode)")
    for t in (x, w, b):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv3x3_relu_pool: tensors must be contiguous "
                             "and on one device")
    _check_aligned("conv3x3_relu_pool", x, w)


def conv3x3_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      ext: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (see module docstring). CPU tensors take the plain version.
    ext=True: x carries one real halo row above and below its H rows."""
    if x.device.type == "cpu":
        return conv3x3_relu_pool_plain(x, w, b, ext)
    _check_k1(x, w, b, ext)
    B, H, W, C = x.shape
    H -= 2 * ext
    y = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    pool = torch.empty((B, H // 2, W // 2, C), dtype=x.dtype, device=x.device)
    name = ("k1_conv3x3_relu_pool_bf16" if x.dtype == torch.bfloat16
            else "k1_conv3x3_relu_pool_f32")
    with cb.on_device(x):
        rc = getattr(cb.lib(), name)(x.data_ptr(), w.data_ptr(),
                                     b.data_ptr(), y.data_ptr(),
                                     pool.data_ptr(), B, H, W, int(ext),
                                     cb.stream_of(x))
    cb.check(rc, name)
    cb.LAUNCHES["conv3x3_relu_pool_ext" if ext else "conv3x3_relu_pool"] += 1
    return y, pool


# ---------------------------------------------------------------------------
# K2: upconv1 -> concat -> dec1 double conv -> out_conv -> sigmoid
# ---------------------------------------------------------------------------

HEAD_KEYS = ("w_up", "b_up", "w0", "b0", "w1", "b1", "w_oc", "b_oc")


def _row_mask(t: torch.Tensor, n: int, top: bool, bot: bool
              ) -> torch.Tensor:
    """Zero the first n rows (dim 2) when `top`, the last n when `bot`."""
    keep = torch.ones(t.shape[2], dtype=torch.bool, device=t.device)
    if top:
        keep[:n] = False
    if bot:
        keep[-n:] = False
    return torch.where(keep.view(1, 1, -1, 1), t, 0.0)


def dec1_head_plain(dec2: torch.Tensor, enc1: torch.Tensor,
                    head: Dict[str, torch.Tensor], ext: bool = False,
                    edge_flags: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Plain version of K2. dec2 (B,H/2,W/2,128), enc1 (B,H,W,64) in
    bf16/f32; `head` is `unet_fast.build_fast_params(...)["head"]`. Returns
    (B,H,W,1) f32 probabilities.
    ext: dec2 (B,H/2+2,...) and enc1 (B,H+4,...) carry real halo rows, and
    `edge_flags` (is_top, is_bottom) say where the shard touches the image
    edge: only there are `up` (after its bias) and `h` zeroed outside the
    image, as SAME padding would see them."""
    dt = enc1.dtype
    d, e = _nchw(dec2.float()), _nchw(enc1.float())
    if not ext:
        d, e, edge_flags = F.pad(d, (0, 0, 1, 1)), F.pad(e, (0, 0, 2, 2)), \
            (1, 1)
    top, bot = bool(edge_flags[0]), bool(edge_flags[1])
    w_up = head["w_up"].float().permute(2, 3, 0, 1)  # (p,q,I,O) -> (I,O,p,q)
    up = F.conv_transpose2d(d, w_up, head["b_up"].float(), stride=2)
    up = _row_mask(up, 2, top, bot).to(dt)
    cat = torch.cat([up.float(), e], 1)
    h = torch.relu(F.conv2d(cat, _oihw(head["w0"].float()),
                            head["b0"].float(), padding=(0, 1)))
    h = _row_mask(h, 1, top, bot).to(dt)
    d1 = torch.relu(F.conv2d(h.float(), _oihw(head["w1"].float()),
                             head["b1"].float(), padding=(0, 1))).to(dt)
    o = F.conv2d(d1.float(), head["w_oc"].float().view(1, -1, 1, 1),
                 head["b_oc"].float())
    return _nhwc(torch.sigmoid(o))


def _check_k2(dec2, enc1, head, ext=False):
    dt = enc1.dtype
    if dt not in _DTYPES or dec2.dtype != dt:
        raise TypeError("dec1_head: dec2 and enc1 in bf16 or f32 (same type)")
    B, H, W, C = enc1.shape
    H -= 4 * ext
    shapes = {"w_up": ((2, 2, 128, 64), dt), "b_up": ((64,), torch.float32),
              "w0": ((3, 3, 128, 64), dt), "b0": ((64,), torch.float32),
              "w1": ((3, 3, 64, 64), dt), "b1": ((64,), torch.float32),
              "w_oc": ((64,), dt), "b_oc": ((1,), torch.float32)}
    if C != 64 or H <= 0 or H % 2 or W % 2 or \
            tuple(dec2.shape) != (B, H // 2 + 2 * ext, W // 2, 128):
        raise ValueError(f"dec1_head: got dec2 {tuple(dec2.shape)} enc1 "
                         f"{tuple(enc1.shape)}" + (" (ext)" if ext else ""))
    for k, (shape, t) in shapes.items():
        v = head[k]
        if tuple(v.shape) != shape or v.dtype != t:
            raise ValueError(f"dec1_head: {k} must be {shape} {t}, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for t in (dec2, enc1, *head.values()):
        if t.device != enc1.device or not t.is_contiguous():
            raise ValueError("dec1_head: tensors must be contiguous and on "
                             "one device")
    _check_aligned("dec1_head", dec2, enc1, head["w_up"], head["w0"],
                   head["w1"])


def dec1_head(dec2: torch.Tensor, enc1: torch.Tensor,
              head: Dict[str, torch.Tensor], ext: bool = False,
              edge_flags: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """K2 (see module docstring). CPU tensors take the plain version.
    ext / edge_flags: see `dec1_head_plain`."""
    if enc1.device.type == "cpu":
        return dec1_head_plain(dec2, enc1, head, ext, edge_flags)
    _check_k2(dec2, enc1, head, ext)
    B, H, W, _ = enc1.shape
    H -= 4 * ext
    top, bot = (int(bool(f)) for f in edge_flags) if ext else (1, 1)
    out = torch.empty((B, H, W, 1), dtype=torch.float32, device=enc1.device)
    name = ("k2_dec1_head_bf16" if enc1.dtype == torch.bfloat16
            else "k2_dec1_head_f32")
    with cb.on_device(enc1):
        rc = getattr(cb.lib(), name)(
            dec2.data_ptr(), enc1.data_ptr(),
            *(head[k].data_ptr() for k in HEAD_KEYS), out.data_ptr(), B, H,
            W, int(ext), top, bot, cb.stream_of(enc1))
    cb.check(rc, name)
    cb.LAUNCHES["dec1_head_ext" if ext else "dec1_head"] += 1
    return out
