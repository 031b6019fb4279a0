"""Int8 quantized inference forward (post-training quantization, opt-in);
port of the JAX package's `models/unet_int8.py`.

Scheme (the JAX package's, unchanged):
- Weights: per-output-channel symmetric int8 after folding each input
  channel's activation scale into the weight (W' = W * s_act(in)), so the
  decoder's concat(up, skip) inputs keep their own scales.
- Activations: per-tensor symmetric int8, scales from the per-tag maxima
  of an f32 calibration forward (`forward_calib`); ReLU outputs quantize
  to [0, 127], upconv outputs to [-127, 127].
- Each conv is int8 x int8 -> int32, then `clip(round(R*m + c), lo, 127)`
  with m = s_w / s_next and c = bias / s_next (lo = 0 is the ReLU).
  Max-pools run on int8; out_conv dequantizes to f32 and the sigmoid
  follows.

Layout: the port's natural NHWC. The JAX package quantizes enc1, dec1 and
out_conv in its pair layout; their pair kernels hold every tap of the
natural kernel once per output column (zeros elsewhere), so the
per-column scales, int8 weights, m and c are the natural ones, tiled over
the two phases. upconv1 is a (I, 4*O) matmul with columns (p, q, o)
quantized per column (256 scales, bias tiled 4x), as in the JAX package;
upconv4..2 take one scale per o.

Products: `torch._int_mm` (int8 x int8 -> int32, exact; the worst case
1024*9*127^2 < 2^31) on an explicit im2col of zero-padded shifted views,
with K padded to a multiple of 8 and N to at least 8, as cuBLASLt's int8
product needs. The JAX package's int8 convs are XLA ops outside any Pallas
kernel, and this is the port's first int8 convolution, timed in PERF.md.

Requantization rounding: XLA on the CPU compiles the JAX package's
`R.astype(f32) * m + c` to one fused multiply-add (checked: its int8
outputs equal round(fma(f32(R), m, c)) and not two roundings), so the port
computes f32(R) * m + c in float64, where the product is exact, and rounds
once to float32: the same int8 values on the CPU and on the card.

The quantizer is numpy in float64, as in the JAX package, so its int8
weights, m and c equal the JAX package's bit for bit; the calibration
sidecar has the same `.npz` keys (`maxima`, `tags`) and loads in either
package.
"""

from __future__ import annotations

from itertools import product
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unetdc_tpu_torch.core import mesh as M

# One activation scale per quantization point: "<blk>a" = the block's conv0
# output, "<blk>" = the block output, "up*" = transposed-conv outputs.
TAGS: Tuple[str, ...] = (
    "in",
    "enc1a", "enc1", "enc2a", "enc2", "enc3a", "enc3", "enc4a", "enc4",
    "botta", "bott",
    "up4", "dec4a", "dec4", "up3", "dec3a", "dec3", "up2", "dec2a", "dec2",
    "up1", "dec1a", "dec1",
)
_ENC = ("enc2", "enc3", "enc4", "bottleneck")
_DEC = ((4, "dec4", "up4", "enc4"), (3, "dec3", "up3", "enc3"),
        (2, "dec2", "up2", "enc2"))


# ---------------------------------------------------------------------------
# Calibration: the plain f32 forward that also records the per-tag maxima
# ---------------------------------------------------------------------------
def _conv(x, k, b, dil=1):
    return torch.relu(F.conv2d(x, k, b, padding=dil, dilation=dil))


def forward_calib(fp: Dict[str, Any], x: torch.Tensor,
                  dilations: Sequence[int] = (1, 2, 4, 8, 16)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain f32 forward + activation maxima.

    `fp`: `unet_fast.build_fast_params(folded, torch.float32, device)`;
    `x`: (B, H, W, 3) f32 in [0, 1]. Returns (probs (B, H, W, 1), maxima
    (len(TAGS),) f32 on x's device). The same convolutions as the plain
    path of `unet_fast.forward_folded` (K1, K2 not involved)."""
    d = tuple(dilations)
    if d[0] != 1:
        raise ValueError("int8 path requires an undilated enc1")
    rec: Dict[str, torch.Tensor] = {"in": x.amax()}

    def dc(xi, p, tag, dil=1):
        a = _conv(xi, p["k0"], p["b0"], dil)
        rec[tag + "a"] = a.amax()
        y = _conv(a, p["k1"], p["b1"], dil)
        rec[tag] = y.amax()
        return y

    with torch.no_grad():
        xc = x.to(fp["enc1"]["k0"].dtype).permute(0, 3, 1, 2)
        skips = [dc(xc, fp["enc1"], "enc1")]
        for name, tag, dil in zip(_ENC, ("enc2", "enc3", "enc4", "bott"),
                                  d[1:]):
            skips.append(dc(F.max_pool2d(skips[-1], 2), fp[name], tag, dil))
        dec = skips.pop()
        for n, name, up_tag, _ in _DEC:
            up = F.conv_transpose2d(dec, fp[f"upconv{n}"]["k"],
                                    fp[f"upconv{n}"]["b"], stride=2)
            rec[up_tag] = up.abs().amax()
            dec = dc(torch.cat([up, skips.pop()], 1), fp[name], name)
        head = fp["head"]
        up = F.conv_transpose2d(dec, head["w_up"].permute(2, 3, 0, 1),
                                head["b_up"], stride=2)
        rec["up1"] = up.abs().amax()
        h = _conv(torch.cat([up, skips.pop()], 1),
                  head["w0"].permute(3, 2, 0, 1), head["b0"])
        rec["dec1a"] = h.amax()
        d1 = _conv(h, head["w1"].permute(3, 2, 0, 1), head["b1"])
        rec["dec1"] = d1.amax()
        o = F.conv2d(d1, head["w_oc"].view(1, -1, 1, 1), head["b_oc"])
        probs = torch.sigmoid(o).permute(0, 2, 3, 1).contiguous()
        maxima = torch.stack([rec[t].float() for t in TAGS])
    return probs, maxima


# ---------------------------------------------------------------------------
# Calibration sidecar (.npz next to the checkpoint)
# ---------------------------------------------------------------------------
def save_calibration(path, maxima: np.ndarray) -> None:
    """Persist the per-tag maxima so later runs rebuild the same int8
    params whatever the dataset order."""
    m = np.asarray(maxima, np.float32)
    if m.shape != (len(TAGS),):
        raise ValueError(f"expected {len(TAGS)} maxima, got {m.shape}")
    np.savez(path, maxima=m, tags=np.array(TAGS))


def load_calibration(path) -> np.ndarray:
    """Load and validate a `save_calibration` sidecar -> (len(TAGS),) f32."""
    with np.load(path, allow_pickle=False) as z:
        tags = tuple(str(t) for t in z["tags"])
        m = np.asarray(z["maxima"], np.float32)
    if tags != TAGS:
        raise ValueError(
            f"calibration sidecar {path} was written for a different "
            f"quantization-point layout ({len(tags)} tags vs {len(TAGS)}); "
            "delete it to recalibrate")
    if m.shape != (len(TAGS),) or not np.all(np.isfinite(m)) or m.min() < 0:
        raise ValueError(f"calibration sidecar {path} is corrupt: {m!r}")
    return m


# ---------------------------------------------------------------------------
# Quantization (host numpy, float64; once per engine)
# ---------------------------------------------------------------------------
def _act_scale(maxima: Dict[str, float], tag: str) -> float:
    return max(float(maxima[tag]), 1e-8) / 127.0


def _quant_kernel(W: np.ndarray, in_scales: np.ndarray, in_axis: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold per-input-channel activation scales into W, then quantize per
    output channel (last axis) -> (int8 kernel, (Cout,) f32 s_w)."""
    shape = [1] * W.ndim
    shape[in_axis] = -1
    Wf = W.astype(np.float64) * in_scales.reshape(shape)
    red = tuple(i for i in range(W.ndim) if i != W.ndim - 1)
    sw = np.maximum(np.abs(Wf).max(axis=red), 1e-12) / 127.0
    Wq = np.clip(np.rint(Wf / sw), -127, 127).astype(np.int8)
    return Wq, sw.astype(np.float32)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return np.asarray(tree, np.float32)


def build_int8_params(folded: Dict[str, Any], maxima: np.ndarray,
                      dilations: Sequence[int] = (1, 2, 4, 8, 16)
                      ) -> Dict[str, Any]:
    """Quantize `unet.fold_batchnorm(...)` given the calibration maxima
    (TAGS order). Returns numpy leaves in the natural layout:
      blocks: k0, k1 (3, 3, I, O) int8 HWIO; m0, c0, m1, c1 (O,) f32;
      upconv4..2: k (2, 2, I, O) int8 [p, q, i, o]; m, c (O,);
      upconv1: k (I, 4*O) int8, columns (p, q, o); m, c (4*O,);
      out_conv: k (1, 1, I, n_out) int8, sw and b (n_out,);
      in_inv: f32 1 / s_in.
    `prepare_int8_params` lays them out for `forward_int8`."""
    if tuple(dilations)[0] != 1:
        raise ValueError("int8 path requires an undilated enc1")
    mx = {t: float(v) for t, v in zip(TAGS, np.asarray(maxima))}
    P = _numpy_tree(folded)
    s = {t: _act_scale(mx, t) for t in TAGS}
    f32 = np.float32
    qp: Dict[str, Any] = {"in_inv": f32(1.0 / s["in"])}

    def dc(name, in_tag_groups):
        blk = P[name]
        in_scales = np.concatenate(
            [np.full(n, s[t], f32) for t, n in in_tag_groups])
        k0q, sw0 = _quant_kernel(blk["conv0"]["kernel"], in_scales, 2)
        mid = name + "a" if name != "bottleneck" else "botta"
        out_t = name if name != "bottleneck" else "bott"
        k1 = blk["conv1"]["kernel"]
        k1q, sw1 = _quant_kernel(k1, np.full(k1.shape[2], s[mid], f32), 2)
        return {"k0": k0q, "m0": (sw0 / s[mid]).astype(f32),
                "c0": (blk["conv0"]["bias"] / s[mid]).astype(f32),
                "k1": k1q, "m1": (sw1 / s[out_t]).astype(f32),
                "c1": (blk["conv1"]["bias"] / s[out_t]).astype(f32)}

    qp["enc1"] = dc("enc1", [("in", P["enc1"]["conv0"]["kernel"].shape[2])])
    for name, prev in zip(_ENC, ("enc1", "enc2", "enc3", "enc4")):
        qp[name] = dc(name, [(prev, P[name]["conv0"]["kernel"].shape[2])])
    for n, src in ((4, "bott"), (3, "dec4"), (2, "dec3")):
        k = np.transpose(P[f"upconv{n}"]["kernel"], (2, 3, 0, 1))
        kq, sw = _quant_kernel(k, np.full(k.shape[2], s[src], f32), 2)
        out_t = f"up{n}"
        qp[f"upconv{n}"] = {
            "k": kq, "m": (sw / s[out_t]).astype(f32),
            "c": (P[f"upconv{n}"]["bias"] / s[out_t]).astype(f32)}
    for _, name, up_tag, skip_tag in _DEC:
        half = P[name]["conv0"]["kernel"].shape[2] // 2
        qp[name] = dc(name, [(up_tag, half), (skip_tag, half)])
    w1 = P["upconv1"]["kernel"]  # (I, O, 2, 2)
    i, o = w1.shape[:2]
    k1 = np.transpose(w1, (0, 2, 3, 1)).reshape(i, 4 * o)
    kq, sw = _quant_kernel(k1, np.full(i, s["dec2"], f32), 0)
    qp["upconv1"] = {"k": kq, "m": (sw / s["up1"]).astype(f32),
                     "c": (np.tile(P["upconv1"]["bias"], 4)
                           / s["up1"]).astype(f32)}
    half = P["dec1"]["conv0"]["kernel"].shape[2] // 2
    qp["dec1"] = dc("dec1", [("up1", half), ("enc1", half)])
    ko = P["out_conv"]["kernel"]
    kq, sw = _quant_kernel(ko, np.full(ko.shape[2], s["dec1"], f32), 2)
    qp["out_conv"] = {"k": kq, "sw": sw,
                      "b": P["out_conv"]["bias"].astype(f32)}
    return qp


# ---------------------------------------------------------------------------
# Int8 forward
# ---------------------------------------------------------------------------
def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _mat(w2d: np.ndarray, device) -> torch.Tensor:
    """(K, N) int8 weight matrix padded to K, N multiples of 8 (N >= 8),
    stored column-major: cuBLASLt then picks Hopper int8 kernels, 3.5-7x
    faster on the main path's shapes than for a row-major matrix (measured
    on an H100, PERF.md)."""
    k, n = w2d.shape
    out = np.zeros((_round8(k), _round8(n)), np.int8)
    out[:k, :n] = w2d
    return torch.from_numpy(np.ascontiguousarray(out.T)).to(device).t()


def _vec(v: np.ndarray, device, reps: int = 1) -> torch.Tensor:
    """A float32 vector, tiled, as exact float64 (requantization)."""
    return torch.from_numpy(np.tile(np.asarray(v, np.float32), reps)).to(
        device=device, dtype=torch.float64)


def prepare_int8_params(qp: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """`build_int8_params` output as `forward_int8` takes it on `device`:
    each conv a padded (9*I, O) int8 matrix (rows (ky, kx, i)), each upconv
    a (I, 4*O) matrix (columns (p, q, o)), m and c in float64."""
    dp: Dict[str, Any] = {"in_inv": float(qp["in_inv"])}
    for name in ("enc1",) + _ENC + ("dec4", "dec3", "dec2", "dec1"):
        p = qp[name]
        blk = {}
        for j in (0, 1):
            k = p[f"k{j}"]
            blk[f"w{j}"] = _mat(k.reshape(-1, k.shape[-1]), device)
            blk[f"n{j}"] = k.shape[-1]
            blk[f"m{j}"] = _vec(p[f"m{j}"], device)
            blk[f"c{j}"] = _vec(p[f"c{j}"], device)
        dp[name] = blk
    for n in (4, 3, 2):
        p = qp[f"upconv{n}"]
        k = p["k"]  # (2, 2, I, O)
        dp[f"upconv{n}"] = {
            "w": _mat(np.transpose(k, (2, 0, 1, 3)).reshape(k.shape[2], -1),
                      device),
            "m": _vec(p["m"], device, 4), "c": _vec(p["c"], device, 4)}
    p = qp["upconv1"]
    dp["upconv1"] = {"w": _mat(p["k"], device), "m": _vec(p["m"], device),
                     "c": _vec(p["c"], device)}
    p = qp["out_conv"]
    k = p["k"].reshape(-1, p["k"].shape[-1])
    dp["out_conv"] = {"w": _mat(k, device), "n": k.shape[1],
                      "sw": _vec(p["sw"], device), "b": _vec(p["b"], device)}
    return dp


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, M padded past 16 as
    cuBLASLt's int8 product needs."""
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros(17 - m, a.shape[1])])
    return torch._int_mm(a, w)[:m]


def _im2col(x: torch.Tensor, dil: int, kp: int,
            halo: bool = False) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B*H*W, kp) rows of the 3x3 neighbourhood at
    dilation `dil` (taps (ky, kx) outer, channels inner; zero outside the
    image and in the padding columns past 9*C). With `halo`, x is a row
    shard carrying `dil` real rows above and below its H - 2*dil output
    rows, and only its width is padded. Channel runs that fill 8-byte
    words are copied as int64, twice as fast as byte copies."""
    b, h, w, c = x.shape
    oh = h - 2 * dil if halo else h
    xp = x.new_zeros(b, oh + 2 * dil, w + 2 * dil, c)
    top = 0 if halo else dil
    xp[:, top:top + h, dil:dil + w] = x
    cols = (x.new_zeros if kp > 9 * c else x.new_empty)(b, oh, w, kp)
    src, dst, cw = xp, cols, c
    if c % 8 == 0:
        src, dst, cw = xp.view(torch.int64), cols.view(torch.int64), c // 8
    for t, (ky, kx) in enumerate(product(range(3), range(3))):
        dst[..., t * cw:(t + 1) * cw] = src[:, ky * dil:ky * dil + oh,
                                            kx * dil:kx * dil + w]
    return cols.view(b * oh * w, kp)


def _requant(r: torch.Tensor, m: torch.Tensor, c: torch.Tensor,
             lo: float) -> torch.Tensor:
    """clip(round(f32(R) * m + c), lo, 127) -> int8, the multiply-add
    rounded once to float32 (module docstring); lo = 0 is the ReLU."""
    y = torch.addcmul(c, r.to(torch.float32), m)  # computed in float64
    return y.to(torch.float32).round_().clamp_(lo, 127.0).to(torch.int8)


def _conv_q(x: torch.Tensor, p: Dict[str, Any], j: int, dil: int,
            halo: bool = False) -> torch.Tensor:
    b, h, w, _ = x.shape
    wt = p[f"w{j}"]
    r = _int_mm(_im2col(x, dil, wt.shape[0], halo), wt)[:, :p[f"n{j}"]]
    return _requant(r, p[f"m{j}"], p[f"c{j}"], 0.0).view(
        b, h - 2 * dil if halo else h, w, -1)


def _dc_q(x, p, dil=1):
    return _conv_q(_conv_q(x, p, 0, dil), p, 1, dil)


def _pool_q(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.view(b, h // 2, 2, w // 2, 2, c).amax((2, 4))


def _upconv_q(x: torch.Tensor, p: Dict[str, Any]) -> torch.Tensor:
    """2x2 stride-2 transposed conv as one (B*H*W, I) x (I, 4*O) product,
    requantized, then the pixel shuffle out[2h+p, 2w+q] = y[h, w, p, q]."""
    b, h, w, i = x.shape
    y = _requant(_int_mm(x.reshape(-1, i), p["w"]), p["m"], p["c"], -127.0)
    o = y.shape[1] // 4
    return y.view(b, h, w, 2, 2, o).permute(0, 1, 3, 2, 4, 5).reshape(
        b, 2 * h, 2 * w, o)


def forward_int8(dp: Dict[str, Any], x: torch.Tensor,
                 dilations: Sequence[int] = (1, 2, 4, 8, 16),
                 apply_sigmoid: bool = True) -> torch.Tensor:
    """Quantized forward. `dp`: `prepare_int8_params(...)` on x's device;
    `x`: (B, H, W, 3) f32 in [0, 1], H and W divisible by 16. Returns
    (B, H, W, n_out) f32 probabilities (or logits)."""
    d = tuple(dilations)
    if d[0] != 1:
        raise ValueError("int8 path requires an undilated enc1")
    with torch.no_grad():
        xq = torch.clamp(torch.round(x.to(torch.float32) * dp["in_inv"]),
                         -127.0, 127.0).to(torch.int8)
        skips = [_dc_q(xq, dp["enc1"])]
        for name, dil in zip(_ENC, d[1:]):
            skips.append(_dc_q(_pool_q(skips[-1]), dp[name], dil))
        dec = skips.pop()
        for n, name, _, _ in _DEC + ((1, "dec1", None, None),):
            up = _upconv_q(dec, dp[f"upconv{n}"])
            dec = _dc_q(torch.cat([up, skips.pop()], -1), dp[name])
        return _out_conv_q(dec, dp["out_conv"], apply_sigmoid)


def _out_conv_q(x: torch.Tensor, p: Dict[str, Any], apply_sigmoid: bool
                ) -> torch.Tensor:
    """The 1x1 head, dequantized to f32 (and the sigmoid)."""
    b, h, w, c = x.shape
    r = _int_mm(x.reshape(-1, c), p["w"])[:, :p["n"]]
    out = torch.addcmul(p["b"], r.to(torch.float32), p["sw"]
                        ).to(torch.float32).view(b, h, w, -1)
    return torch.sigmoid(out) if apply_sigmoid else out


def _dc_q_shards(shards, ps, dil=1):
    """`_dc_q` of one data group's row shards (`ps`: each shard's params),
    each conv on its own halo of `dil` int8 rows, zeros (the quantised
    zero) past the image; a one-element list is the whole image."""
    for j in (0, 1):
        halo = len(shards) > 1
        shards = [_conv_q(t, p, j, dil, halo) for t, p in zip(
            M.halo(shards, dil, 1) if halo else shards, ps)]
    return shards


def _forward_int8_group(dps, x, d, apply_sigmoid):
    """One data group's `forward_int8`, its height split over the devices
    of `dps` (each shard's params, on its device). Pools, upconvs and
    out_conv are local; a level whose pool would cut a seam is gathered
    onto the first device, as in `unet_fast._forward_group`. Every product
    is exact int32 and every scale static, so the result equals
    `forward_int8` byte for byte."""
    devs = [dp["enc1"]["w0"].device for dp in dps]
    xq = torch.clamp(torch.round(x.to(torch.float32) * dps[0]["in_inv"]),
                     -127.0, 127.0).to(torch.int8)
    cur = _dc_q_shards(M.split(xq, len(dps), 1, devs),
                       [dp["enc1"] for dp in dps])
    skips = [cur]
    for name, dil in zip(_ENC, d[1:]):
        cur = [_pool_q(t) for t in M.gather_if_odd(cur, 1)]
        cur = _dc_q_shards(cur, [dp[name] for dp in dps], dil)
        skips.append(cur)
    cur = skips.pop()
    for n, name, _, _ in _DEC + ((1, "dec1", None, None),):
        skip = skips.pop()
        up = [_upconv_q(t, dp[f"upconv{n}"]) for t, dp in zip(cur, dps)]
        if len(up) < len(skip):
            up = M.split(up[0], len(skip), 1, devs)
        cur = _dc_q_shards([torch.cat(p, -1) for p in zip(up, skip)],
                           [dp[name] for dp in dps])
    out = [_out_conv_q(t, dp["out_conv"], apply_sigmoid)
           for t, dp in zip(cur, dps)]
    return M.gather(out, 1, devs[0])


def forward_int8_spmd(replicas: Dict[torch.device, Dict[str, Any]],
                      x: torch.Tensor,
                      dilations: Sequence[int] = (1, 2, 4, 8, 16), *,
                      mesh: M.Mesh, shard_space: bool = True,
                      apply_sigmoid: bool = True) -> torch.Tensor:
    """`forward_int8` under a ('data', 'space') mesh, as
    `unet_fast.forward_folded_spmd` runs the float forward: `replicas`
    maps each distinct device to its `prepare_int8_params` copy; the batch
    splits over the data groups and, with `shard_space`, each group's
    height over its space shards (`_forward_int8_group`). Output: (B, H,
    W, n_out) f32 on x's device in batch order, byte-equal to
    `forward_int8`. Shapes that do not divide (B % n_data, H % (2 *
    n_space)) run `forward_int8` on the mesh's first device, as the float
    forward routes them."""
    d = tuple(dilations)
    if d[0] != 1:
        raise ValueError("int8 path requires an undilated enc1")
    nd = mesh.shape[M.DATA_AXIS]
    ns = mesh.shape[M.SPACE_AXIS] if shard_space else 1
    if x.shape[0] % nd or x.shape[1] % (2 * ns):
        return forward_int8(replicas[mesh.first], x.to(mesh.first), d,
                            apply_sigmoid).to(x.device)
    outs = []
    with torch.no_grad():
        for g, xg in enumerate(M.split_batch(mesh, x)):
            devs = mesh.grid[g][:ns]
            outs.append(
                forward_int8(replicas[devs[0]], xg, d, apply_sigmoid)
                if ns == 1 else _forward_int8_group(
                    [replicas[dv] for dv in devs], xg, d, apply_sigmoid))
    return M.gather(outs, 0, x.device)
