"""Per-block device time of the port's production forward, with a
per-block roofline; port of the JAX package's `utils/forward_profile.py`.

`utils.device_profile` attributes megastep time to stages; this module
times each block of `models/unet_fast.py::forward_folded` (bf16, kernels
K1 and K2) alone on device-resident inputs, at full width, and holds it
against the H100's peaks:
  - useful FLOPs: the network's multiply-adds (2 per MAC) from the conv
    shapes; they sum to `device_profile.forward_flops`;
  - exec FLOPs: what the block issues. The library convs are counted as
    their useful FLOPs (cuDNN's own tiling is not visible); K2 recomputes
    the halo of its tiles (`K2_TILE`, from `csrc/fused_conv.cu`), and K1's
    tiles have no recompute;
  - minimum traffic: each input read once, each output written once and
    the weights, all counted in bf16;
  - bound: "compute" or "HBM", whichever of exec FLOPs over 989.4 TFLOP/s
    and traffic over 3.35 TB/s (H100 SXM5 data sheet) takes longer; a
    reading above 1.05 of either peak (a block too small to time alone)
    is "sub-floor" and gets no share.

The port's forward is not the JAX package's pair layout, so its blocks
differ; `JAX_ROWS` names the JAX tool's row (or rows) each port row
covers, every JAX row exactly once.

Timing: CUDA events around `iters` back-to-back calls after a warm-up
(`device_profile.event_ms`). Isolated blocks miss the whole forward's
cache reuse; the `_sum_of_layers_ms` and `_whole_forward_ms` rows show
the gap.

    python -m unetdc_tpu_torch.utils.forward_profile [--batch 8 --size 512
        --iters 24 --json_out F --device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from unetdc_tpu_torch.utils.device_profile import (PEAK_BF16_FLOPS, clean,
                                                   event_ms)

PEAK_HBM_BYTES = 3.35e12  # H100 SXM5 HBM3, data sheet
SUB_FLOOR = 1.05
# K2's bf16 tile plan (csrc/fused_conv.cu, namespace k2): TH x TW output
# pixels a tile; upconv1 over the (TH+4) x (TW+4) concat window, conv0
# over MT0 m16 row tiles (>= (TH+2) x (TW+2) h pixels), conv1 and the
# head over the TH x TW outputs; tiles_x = ceil(W / TW)
K2_TILE = {"TH": 32, "TW": 12, "MT0": 32}

# port row -> the JAX tool's rows it covers (unetdc_tpu/utils/
# forward_profile.py). JAX's enc1 row holds the stem and enc1.conv1 in
# its pair layout; the port times the stem alone and enc1.conv1 in K1
# with the pool, so the two port rows together cover JAX's enc1 and
# pool1 rows.
JAX_ROWS = {
    "enc1.conv0 (stem 3->64)": ("enc1 (pair dc 3->64->64)",),
    "enc1.conv1+relu+pool1 (K1)": ("pool1 (from pair)",),
    "enc2 (dc 64->128, dil 2)": ("enc2 (dc 64->128, dil 2)",),
    "pool2+enc3 (128->256, dil 4)": ("pool2+enc3 (128->256, dil 4)",),
    "pool3+enc4 (256->512, dil 8)": ("pool3+enc4 (256->512, dil 8)",),
    "pool4+bottleneck (512->1024, dil 16)":
        ("pool4+bottleneck (512->1024, dil 16)",),
    "upconv4 (2x2 convT 1024->512)": ("upconv4 (2x2 convT 1024->512)",),
    "dec4 (concat+dc 1024->512)": ("dec4 (concat+dc 1024->512)",),
    "upconv3 (512->256)": ("upconv3 (512->256)",),
    "dec3 (concat+dc 512->256)": ("dec3 (concat+dc 512->256)",),
    "upconv2 (256->128)": ("upconv2 (256->128)",),
    "dec2 (concat+dc 256->128)": ("dec2 (concat+dc 256->128)",),
    "upconv1+dec1+out_conv+sigmoid (K2)": (
        "upconv1 (pair pixel-shuffle 128->64)",
        "dec1 (pair concat+dc 128->64->64)",
        "out_conv+sigmoid (1x1 64->1)"),
}


def _conv(n: int, h: int, w: int, k: int, cin: int, cout: int) -> int:
    """FLOPs (2 per MAC) of a k x k conv of n (h, w) maps, cin -> cout."""
    return 2 * n * h * w * k * k * cin * cout


def k2_exec_flops(B: int, H: int, W: int) -> int:
    """FLOPs K2's tiles issue on a (B, H, W) output: every tile computes
    its whole upconv window and conv0 row tiles, including the halo rows
    and columns that its neighbours compute again, and the last tile
    column runs whole past W."""
    th, tw = K2_TILE["TH"], K2_TILE["TW"]
    tiles = B * -(-H // th) * -(-W // tw)
    up = 2 * (th + 4) * (tw + 4) * 128 * 64   # upconv1, 4 sub-positions
    c0 = 2 * K2_TILE["MT0"] * 16 * 9 * 128 * 64
    c1 = 2 * th * tw * 9 * 64 * 64
    head = 2 * th * tw * 64
    return tiles * (up + c0 + c1 + head)


def _weights(*convs: Tuple[int, int, int]) -> int:
    """bf16 bytes of the (k, cin, cout) convs' weights."""
    return sum(2 * k * k * ci * co for k, ci, co in convs)


def _bytes(ts) -> int:
    return sum(2 * t.numel() for t in ts)


def profile_forward(batch: int = 8, size: int = 512, iters: int = 24,
                    seed: int = 0, verbose: bool = True, device="cuda"
                    ) -> Dict:
    """One row per block of the production forward on `device` ("cuda"
    unless asked; a missing card raises): {name: {ms, useful_flops,
    useful_gflop, exec_gflop, mfu, exec_util, traffic_mb, bound}}, plus
    `_sum_of_layers_ms`, `_whole_forward_ms` and `_device` (its name).
    On the CPU, `ms` is the host clock's and no share or bound against
    the H100 peaks is given."""
    from unetdc_tpu_torch.device import resolve_device
    from unetdc_tpu_torch.models.unet import UNetDC
    from unetdc_tpu_torch.models.unet_fast import _dc, _nhwc, forward_folded
    from unetdc_tpu_torch.ops import fused_conv as fc
    from unetdc_tpu_torch.utils.device_profile import random_fast_params

    dev = resolve_device(device)
    fp, _ = random_fast_params(seed, torch.bfloat16, dev)
    d = UNetDC.dilations
    B, S = batch, size
    g = torch.Generator().manual_seed(seed)

    def r(*shape, cl=False):
        """Random bf16 input; NCHW in channels-last memory with cl, as the
        forward hands the blocks their inputs."""
        t = torch.rand(*shape, generator=g).to(dev, torch.bfloat16)
        return t.contiguous(memory_format=torch.channels_last) if cl else t

    pool = F.max_pool2d
    up_t = F.conv_transpose2d
    C = (64, 128, 256, 512, 1024)
    L: List[Tuple] = []  # (name, op, inputs, useful, exec, weight bytes)

    x = r(B, 3, S, S, cl=True)
    L.append(("enc1.conv0 (stem 3->64)",
              lambda a: _nhwc(torch.relu(F.conv2d(
                  a, fp["enc1"]["k0"], fp["enc1"]["b0"], padding=1))),
              (x,), _conv(B, S, S, 3, 3, 64), None, _weights((3, 3, 64))))
    stem = r(B, S, S, 64)
    k1 = _conv(B, S, S, 3, 64, 64)
    L.append(("enc1.conv1+relu+pool1 (K1)",
              lambda a: fc.conv3x3_relu_pool(a, fp["k1"]["w"], fp["k1"]["b"]),
              (stem,), k1, k1, _weights((3, 64, 64))))
    skip = {}
    prev = r(B, 64, S // 2, S // 2, cl=True)
    names = ("enc2 (dc 64->128, dil 2)", "pool2+enc3 (128->256, dil 4)",
             "pool3+enc4 (256->512, dil 8)",
             "pool4+bottleneck (512->1024, dil 16)")
    for i, (name, blk) in enumerate(zip(names, ("enc2", "enc3", "enc4",
                                               "bottleneck"))):
        s = S >> (i + 1)
        cin, cout = C[i], C[i + 1]
        fl = _conv(B, s, s, 3, cin, cout) + _conv(B, s, s, 3, cout, cout)

        def op(a, blk=blk, dil=d[i + 1], first=(i == 0)):
            return _dc(a if first else pool(a, 2), fp[blk], dil)

        L.append((name, op, (prev,), fl, None,
                  _weights((3, cin, cout), (3, cout, cout))))
        skip[blk] = prev = r(B, cout, s, s, cl=True)
    for n, (name_up, name_dec), enc in (
            (4, ("upconv4 (2x2 convT 1024->512)",
                 "dec4 (concat+dc 1024->512)"), "enc4"),
            (3, ("upconv3 (512->256)", "dec3 (concat+dc 512->256)"), "enc3"),
            (2, ("upconv2 (256->128)", "dec2 (concat+dc 256->128)"),
             "enc2")):
        s, cin, cout = S >> (n - 1), C[n], C[n - 1]
        L.append((name_up,
                  lambda a, n=n: up_t(a, fp[f"upconv{n}"]["k"],
                                      fp[f"upconv{n}"]["b"], stride=2),
                  (prev,), 2 * B * s * s * cin * cout, None,
                  2 * 4 * cin * cout))
        up = r(B, cout, s, s, cl=True)
        blk = f"dec{n}"
        L.append((name_dec,
                  lambda a, b, blk=blk: _dc(torch.cat([a, b], 1), fp[blk]),
                  (up, skip[enc]),
                  _conv(B, s, s, 3, 2 * cout, cout)
                  + _conv(B, s, s, 3, cout, cout), None,
                  _weights((3, 2 * cout, cout), (3, cout, cout))))
        prev = r(B, cout, s, s, cl=True)
    dec2, enc1 = prev, r(B, S, S, 64)
    k2 = (2 * B * S * S * 128 * 64 + _conv(B, S, S, 3, 128, 64)
          + _conv(B, S, S, 3, 64, 64) + 2 * B * S * S * 64)
    L.append(("upconv1+dec1+out_conv+sigmoid (K2)",
              lambda a, b: fc.dec1_head(_nhwc(a), b, fp["head"]),
              (dec2, enc1), k2, k2_exec_flops(B, S, S),
              2 * 4 * 128 * 64
              + _weights((3, 128, 64), (3, 64, 64), (1, 64, 1))))

    on_card = dev.type == "cuda"
    if verbose:
        print(f"  {'layer':40s} {'ms':>8s} {'useful':>8s} {'MFU%':>6s} "
              f"{'exec%':>6s} {'trafficMB':>9s} {'bound':>9s}")
    rows: Dict = {}
    total = 0.0
    with torch.no_grad():
        for name, op, ins, useful, execf, w_b in L:
            execf = useful if execf is None else execf
            outs = op(*ins)
            outs = outs if isinstance(outs, tuple) else (outs,)
            traffic = _bytes(ins) + _bytes(outs) + w_b
            del outs
            ms = event_ms(lambda: op(*ins), iters, dev)
            total += ms
            sec = ms / 1e3
            row = {"ms": ms, "useful_flops": useful,
                   "useful_gflop": useful / 1e9, "exec_gflop": execf / 1e9,
                   "mfu": None, "exec_util": None,
                   "traffic_mb": traffic / 1e6, "bound": None}
            if on_card:
                epc = execf / sec / PEAK_BF16_FLOPS
                bw = traffic / sec / PEAK_HBM_BYTES
                sub = epc > SUB_FLOOR or bw > SUB_FLOOR
                row.update(
                    mfu=None if sub else useful / sec / PEAK_BF16_FLOPS,
                    exec_util=None if sub else epc,
                    bound="sub-floor" if sub else (
                        "compute" if execf / PEAK_BF16_FLOPS
                        > traffic / PEAK_HBM_BYTES else "HBM"))
            rows[name] = row
            if verbose:
                def pct(v):
                    return "   n/a" if v is None else f"{v * 100:6.1f}"
                print(f"  {name:40s} {ms:8.3f} {useful / 1e9:7.1f}G "
                      f"{pct(row['mfu'])} {pct(row['exec_util'])} "
                      f"{traffic / 1e6:9.1f} {row['bound'] or '-':>9s}")
        xin = torch.rand(B, S, S, 3, generator=g).to(dev)
        whole = event_ms(lambda: forward_folded(fp, xin, d), iters, dev)
    rows["_sum_of_layers_ms"] = total
    rows["_whole_forward_ms"] = whole
    rows["_device"] = (torch.cuda.get_device_name(dev) if on_card
                       else "cpu")
    if verbose:
        print(f"  {'SUM of isolated layers':40s} {total:8.3f}")
        print(f"  {'whole forward':40s} {whole:8.3f}  ({rows['_device']})")
    return rows


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--json_out", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to run (default: the GPU)")
    args = ap.parse_args(argv)
    rows = profile_forward(args.batch, args.size, args.iters,
                           device=args.device)
    line = json.dumps(clean(rows))
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return rows


if __name__ == "__main__":
    main()
