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

`forward_folded_spmd` is the counterpart of `forward_folded_pallas_spmd`:
the same forward under a ('data', 'space') mesh (`core/mesh.py`), with the
batch split over the data groups and the height over the space shards.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from unetdc_tpu_torch.core import mesh as M
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


def _stem_input(x, dt):
    """(B, H, W, 3) -> the stem conv's NCHW input in channels-last memory,
    whatever x's own layout (an RGB batch permuted back, a grayscale plane
    broadcast to 3 channels): cuDNN picks its algorithm by memory format,
    so the sharded stem's shards and the unsharded stem agree."""
    return x.to(dt).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


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
    stem = _conv(_stem_input(x, dt), fp["enc1"]["k0"], fp["enc1"]["b0"])
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


# ------------------------------------------------------------ sharded --
def _conv_sharded(shards, weights, dil):
    """ReLU(conv3x3) of a height-sharded NCHW activation: each shard gets
    its own halo of `dil` rows and pads only its width. `weights`: (k, b)
    of each shard's device."""
    return [torch.relu(F.conv2d(s, k, b, padding=(0, dil), dilation=dil))
            for s, (k, b) in zip(M.halo(shards, dil, 2), weights)]


def _dc_sharded(shards, ps, dil=1):
    out = _conv_sharded(shards, [(p["k0"], p["b0"]) for p in ps], dil)
    return _conv_sharded(out, [(p["k1"], p["b1"]) for p in ps], dil)


_ROUTED: set = set()


def _log_once(msg: str) -> None:
    if msg not in _ROUTED:
        _ROUTED.add(msg)
        print(f"unetdc_tpu_torch: {msg}", file=sys.stderr)


def forward_folded_spmd(replicas: Dict[torch.device, Dict[str, Any]],
                        x: torch.Tensor,
                        dilations: Tuple[int, ...] = (1, 2, 4, 8, 16),
                        *, mesh: M.Mesh, shard_space: bool = True,
                        conv_pool: Callable = fused_conv.conv3x3_relu_pool,
                        head: Callable = fused_conv.dec1_head
                        ) -> torch.Tensor:
    """`forward_folded` under a ('data', 'space') mesh; counterpart of the
    JAX package's `forward_folded_pallas_spmd`.

    `replicas` maps each distinct device of the mesh to its copy of the
    `build_fast_params` weights. The batch splits over the data groups;
    with `shard_space` each group splits the height over its space shards:
    - the stem conv runs per shard on a 1-row halo, K1 per shard in `ext`
      mode on a 1-row halo of its output;
    - enc2 .. dec2 run per shard, each library conv on its own halo of
      `dilation` rows; pools and upconvs are local. A level whose pool
      would cut across a shard seam (odd rows per shard) is gathered onto
      the group's first device, the levels below it run whole there, and
      the decoder splits again at the first level whose encoder ran
      sharded;
    - K2 per shard in `ext` mode on dec2 with a 1-row halo and enc1 with a
      2-row halo, with the shard's (is_top, is_bottom) edge flags.
    Halo rows past the global image are zeros: the SAME padding of the
    next conv's input, never relu(bias) of the previous conv. A group
    without space sharding (one shard) runs `forward_folded`. Output:
    (B, H, W, 1) f32 on x's device, in batch order.

    Shapes that do not divide (B % n_data, H % (2 * n_space)) run the
    unsharded forward on the mesh's first device instead, logged once, as
    the JAX engine routes them (`pipelines/engine.py:197-205`)."""
    nd = mesh.shape[M.DATA_AXIS]
    ns = mesh.shape[M.SPACE_AXIS] if shard_space else 1
    B, H = x.shape[0], x.shape[1]
    if B % nd or H % (2 * ns):
        _log_once(f"batch {B} x height {H} does not divide over the "
                  f"{nd}x{ns} mesh; running the unsharded forward on "
                  f"{mesh.first}")
        return forward_folded(replicas[mesh.first], x.to(mesh.first),
                              dilations, conv_pool, head).to(x.device)
    outs = []
    for g, xg in enumerate(M.split_batch(mesh, x)):
        devs = mesh.grid[g][:ns]
        if ns == 1:
            outs.append(forward_folded(replicas[devs[0]], xg, dilations,
                                       conv_pool, head))
        else:
            outs.append(_forward_group([replicas[dv] for dv in devs], xg,
                                       dilations, conv_pool, head))
    return M.gather(outs, 0, x.device)


def _forward_group(fps, x, dilations, conv_pool, head):
    """One data group's forward, its height split over the devices of
    `fps` (each shard's weights, on its device)."""
    d = dilations
    if d[0] != 1:
        raise ValueError("the fused enc1 stage needs an undilated enc1")
    S = len(fps)
    devs = [fp["enc1"]["k0"].device for fp in fps]
    dt = fps[0]["enc1"]["k0"].dtype
    xs = M.split(_stem_input(x, dt), S, 2, devs)
    stem = _conv_sharded(xs, [(fp["enc1"]["k0"], fp["enc1"]["b0"])
                              for fp in fps], 1)
    enc1, pooled = [], []
    for s, fp in zip(M.halo([_nhwc(t) for t in stem], 1, 1), fps):
        y, p = conv_pool(s, fp["k1"]["w"], fp["k1"]["b"], ext=True)
        enc1.append(y)
        pooled.append(p.permute(0, 3, 1, 2))

    # enc2 .. bottleneck: sharded while each pool stays inside a shard
    skips, cur, sharded = [], pooled, True
    for i, name in enumerate(("enc2", "enc3", "enc4", "bottleneck")):
        cur = (_dc_sharded(cur, [fp[name] for fp in fps], d[i + 1])
               if sharded else _dc(cur, fps[0][name], d[i + 1]))
        if name == "bottleneck":
            break
        skips.append((cur, sharded))
        if sharded:
            cur = M.gather_if_odd(cur, 2)
            if len(cur) == 1:
                cur, sharded = cur[0], False
        cur = ([F.max_pool2d(t, 2) for t in cur] if sharded
               else F.max_pool2d(cur, 2))
    # dec4 .. dec2: a level runs sharded where its encoder level did
    for n, name in ((4, "dec4"), (3, "dec3"), (2, "dec2")):
        skip, skip_sharded = skips[n - 2]
        ups = [(fp[f"upconv{n}"]["k"], fp[f"upconv{n}"]["b"]) for fp in fps]
        if sharded:
            up = [F.conv_transpose2d(t, k, b, stride=2)
                  for t, (k, b) in zip(cur, ups)]
        else:
            up = F.conv_transpose2d(cur, *ups[0], stride=2)
            if skip_sharded:
                up = M.split(up, S, 2, devs)
        sharded = skip_sharded
        cur = (_dc_sharded([torch.cat(p, 1) for p in zip(up, skip)],
                           [fp[name] for fp in fps])
               if sharded else _dc(torch.cat([up, skip], 1), fps[0][name]))
    out = [head(a, b, fp["head"], ext=True, edge_flags=(i == 0, i == S - 1))
           for i, (a, b, fp) in enumerate(zip(
               M.halo([_nhwc(t) for t in cur], 1, 1), M.halo(enc1, 2, 1),
               fps))]
    return M.gather(out, 1, devs[0])
