"""Per-stage device time of the inference megastep; port of the JAX
package's `utils/device_profile.py`.

Stages mirror `pipelines/engine.py::QuantifyEngine._megastep`:
  rolling_ball -> resize_u8 -> forward -> thresh+maskresize ->
  cc+regionprops -> packbits (the JAX engine packs its masks into bits
  for its TPU link; the port's engine does not, the stage is kept for the
  JAX stage table), plus forward_int8 with `int8=True`.

Forward stages, and how they map to the JAX tool's:
  - `forward_bf16`: the port's forward on library ops alone (cuDNN convs
    in bf16 for enc1.conv1 + pool and for the dec1 head, in place of
    kernels K1 and K2: `library_conv_pool`, `library_head`); it stands in
    for the JAX tool's XLA forward of the same name;
  - `forward_kernels`: the production forward with K1 and K2; the
    counterpart of the JAX tool's `forward_pallas`. `total_kernels` and
    `img_per_s_device_kernels` are its megastep, as `total_pallas` /
    `img_per_s_device_pallas` are there.

Timing. Eager PyTorch runs every call, so no looped program is needed (the
JAX tool loops each stage inside one jit against its TPU link's dispatch
cost). Each stage runs on device-resident inputs after a warm-up and is
timed two ways on the card:
  - CUDA events around `iters` back-to-back calls (`event_ms`);
  - torch.profiler's CUDA activity, one session per call: the summed
    durations of the kernels and memsets the call launches (`device_ms`,
    median), by kernel name (K1/K2/K3 picked out in `kernels_ms`), and
    the stage's idle share 1 - device_ms / event_ms. The component
    propagation of `cc+regionprops` syncs the host once per sweep, so its
    idle share is high.
On the CPU (`device="cpu"`) the host clock times the calls and no device
time is reported.

FLOPs: `forward_flops` counts the network's multiply-adds (2 per MAC)
from the conv shapes; `forward_mfu` is that over the kernel forward's
event time and the H100 SXM dense bf16 peak (card only).

    python -m unetdc_tpu_torch.utils.device_profile [--batch 8 --size 512
        --iters 24 --json_out F --int8 --device {cuda,cpu}]

Prints a per-stage table and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core peak, no sparsity
PEAK_BF16_FLOPS = 989.4e12
# the port's CUDA kernels, by the name of their __global__ function
KERNELS = {"K1": re.compile(r"k1_(bf16|f32)_kernel"),
           "K2": re.compile(r"k2_(bf16|f32)_kernel"),
           "K3": re.compile(r"k3_kernel"),
           "RB": re.compile(r"rb_(morph|normalize)_kernel")}


def make_blob_images(n, h, w, seed=0, gray=False):
    """Synthetic microscopy-like images: dark field + bright droplets;
    the port's copy of the repo's `bench.make_blob_images`, byte-equal.

    `gray=True` replicates one channel into RGB (the reference's real
    data has all three channels equal)."""
    rng = np.random.RandomState(seed)
    imgs = np.empty((n, h, w, 3), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        if gray:
            img = np.repeat((rng.rand(h, w, 1) * 60).astype(np.uint8),
                            3, axis=-1)
        else:
            img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        for _ in range(40):
            cy, cx = rng.randint(10, h - 10), rng.randint(10, w - 10)
            r = rng.randint(3, 12)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
            img[blob] = np.minimum(img[blob] + 180, 255)
        imgs[i] = img
    return imgs


def unet_forward_flops(h: int, w: int, widths=(64, 128, 256, 512, 1024),
                       cin: int = 3) -> int:
    """Multiply-add FLOPs (2 per MAC) of one UNet/UNetDC forward on an
    (h, w) image, from the conv shapes: the double 3x3 convs, the 2x2
    stride-2 upconvs and the 1x1 head."""
    f, c = 0, cin
    for i, wd in enumerate(widths):                # encoder, bottleneck
        f += 2 * (h >> i) * (w >> i) * 9 * (c * wd + wd * wd)
        c = wd
    for i in range(len(widths) - 2, -1, -1):       # upconv + decoder
        wd = widths[i]
        f += 2 * (h >> (i + 1)) * (w >> (i + 1)) * c * wd * 4
        f += 2 * (h >> i) * (w >> i) * 9 * (2 * wd * wd + wd * wd)
        c = wd
    return f + 2 * h * w * c


def forward_flops(batch: int, size: int) -> int:
    """FLOPs of one UNetDC forward of a (batch, size, size, 3) batch."""
    return batch * unet_forward_flops(size, size)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device="cuda"):
    """(fn(), ms) of one call: CUDA events around it on the card (the
    card synchronised), the host clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def event_ms(fn: Callable, iters: int, device="cuda", warmup: int = 2
             ) -> float:
    """ms per call of `iters` back-to-back calls after `warmup` calls:
    CUDA events around the run on the card, the host clock on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    _sync(device)

    def run():
        for _ in range(iters):
            fn()

    return timed(run, device)[1] / iters


def device_split(fn: Callable, reps: int = 20, warmup: int = 3
                 ) -> Tuple[float, Dict[str, float], int]:
    """Device time of one fn() call on the card from torch.profiler's CUDA
    activity, one profiler session per call (so no activity lands on the
    wrong call); host enqueue time is not counted.

    Returns (median over sessions of the summed kernel and memset ms,
    {kernel name: median ms}, sessions that recorded nothing). A session
    now and then records no device activity; such sessions are repeated
    (at most `reps` times in all). If every session is empty, a one-kernel
    control is profiled: if it records, fn launched nothing on the card
    and the time is 0; if not, the profiler records nothing in this
    process (seen once a CUDA child process has run after the process's
    first profiler session) and RuntimeError is raised."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one(f=fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            f()
            torch.cuda.synchronize()
        names: Dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0.0) + \
                    e.time_range.elapsed_us() / 1e3
        return names

    for _ in range(warmup):
        one()
    sessions, empty = [], 0
    while len(sessions) < reps and empty < reps:
        names = one()
        if names:
            sessions.append(names)
        else:
            empty += 1
    if not sessions:
        probe = torch.zeros(1, device=torch.cuda.current_device())
        if not one(lambda: probe.add_(1)):
            raise RuntimeError("torch.profiler records no device activity "
                               "in this process")
        return 0.0, {}, empty
    total = statistics.median(sum(s.values()) for s in sessions)
    by_name = {n: statistics.median(s.get(n, 0.0) for s in sessions)
               for n in {n for s in sessions for n in s}}
    return total, by_name, empty


def device_ms(fn: Callable, reps: int = 20, warmup: int = 3) -> float:
    """Median device ms of one fn() call (`device_split`'s total)."""
    return device_split(fn, reps, warmup)[0]


def kernel_ms(by_name: Dict[str, float]) -> Dict[str, float]:
    """{"K1"|"K2"|"K3"|"RB": ms} of the port's kernels in a `device_split`
    breakdown (only those that ran)."""
    out: Dict[str, float] = {}
    for k, rx in KERNELS.items():
        ms = sum(t for n, t in by_name.items() if rx.search(n))
        if ms:
            out[k] = ms
    return out


def measure(fn: Callable, iters: int, device) -> Dict:
    """One stage's times: `event_ms`, and on the card `device_ms`,
    `idle_share` and `kernels_ms` (`device_split` over `iters` calls)."""
    device = torch.device(device)
    ms = event_ms(fn, iters, device)
    r: Dict = {"event_ms": ms, "device_ms": None, "idle_share": None,
               "kernels_ms": {}}
    if device.type == "cuda":
        busy, by_name, _ = device_split(fn, reps=iters, warmup=1)
        r.update(device_ms=busy, idle_share=max(0.0, 1.0 - busy / ms),
                 kernels_ms=kernel_ms(by_name))
    return r


def random_fast_params(seed: int, dtype, device):
    """BN-folded forward weights of a UNetDC with the JAX package's
    initializers, drawn from `seed`, as `build_fast_params` gives them;
    also the folded f32 tree."""
    from unetdc_tpu_torch.models.unet import UNetDC, fold_batchnorm, init_flax_
    from unetdc_tpu_torch.models.unet_fast import build_fast_params

    model = init_flax_(UNetDC(), torch.Generator().manual_seed(seed))
    folded = fold_batchnorm(model.state_dict())
    return build_fast_params(folded, dtype, device), folded


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def library_conv_pool(x, w, b):
    """K1's function on library ops in x's type (conv3x3 + bias + ReLU, 2x2
    max pool; NHWC in and out), for `forward_folded`'s `conv_pool`."""
    y = torch.relu(F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                            b.to(x.dtype), padding=1))
    return _nhwc(y), _nhwc(F.max_pool2d(y, 2))


def library_head(dec2, enc1, head):
    """K2's function on library ops in enc1's type (upconv1, concat, dec1
    double conv, 1x1 head, sigmoid in f32; NHWC), for `forward_folded`'s
    `head`."""
    dt = enc1.dtype
    up = F.conv_transpose2d(dec2.permute(0, 3, 1, 2),
                            head["w_up"].permute(2, 3, 0, 1),
                            head["b_up"].to(dt), stride=2)
    h = torch.relu(F.conv2d(torch.cat([up, enc1.permute(0, 3, 1, 2)], 1),
                            head["w0"].permute(3, 2, 0, 1),
                            head["b0"].to(dt), padding=1))
    d1 = torch.relu(F.conv2d(h, head["w1"].permute(3, 2, 0, 1),
                             head["b1"].to(dt), padding=1))
    logit = F.conv2d(d1, head["w_oc"].view(1, -1, 1, 1), head["b_oc"].to(dt))
    return torch.sigmoid(logit.float()).permute(0, 2, 3, 1)


_BIT_WEIGHTS = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8)


def packbits(masks: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B, ceil(n / 8)) uint8: each image's values as bits,
    nonzero = 1, most significant bit first (np.packbits' order)."""
    bits = (masks.reshape(masks.shape[0], -1) != 0).to(torch.uint8)
    bits = F.pad(bits, (0, (-bits.shape[1]) % 8))
    w = _BIT_WEIGHTS.to(masks.device)
    return (bits.view(bits.shape[0], -1, 8) * w).sum(-1).to(torch.uint8)


def profile_stages(batch: int = 8, size: int = 512, iters: int = 24,
                   seed: int = 0, verbose: bool = True, int8: bool = False,
                   device="cuda") -> Dict:
    """Time each megastep stage on `device` ("cuda" unless asked; a
    missing card raises).

    Returns the JAX tool's keys: {stage: seconds per batch call} (the
    event time), `total` (the stages with the library forward),
    `img_per_s_device`, `total_kernels` / `img_per_s_device_kernels` (with
    the kernel forward), with `int8` `forward_int8` / `total_int8` /
    `img_per_s_device_int8`, and `forward_flops`; on the card also
    `forward_mfu` (kernel forward) and `forward_mfu_bf16` (library
    forward). `stages` holds
    each stage's `measure` record and `device` the device's name."""
    from unetdc_tpu_torch.device import resolve_device
    from unetdc_tpu_torch.models import unet_int8 as qi
    from unetdc_tpu_torch.models.unet import UNetDC
    from unetdc_tpu_torch.models.unet_fast import (build_fast_params,
                                                   forward_folded)
    from unetdc_tpu_torch.ops.connected_components import quantify_mask_batch
    from unetdc_tpu_torch.ops.resize import resize_linear_u8_cv2exact
    from unetdc_tpu_torch.ops.rolling_ball import rolling_ball_correction

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(make_blob_images(batch, size, size, seed=seed)
                            ).to(dev)
    fp, folded = random_fast_params(seed, torch.bfloat16, dev)
    dil = UNetDC.dilations
    x_f32 = torch.from_numpy(rng.rand(batch, size, size, 3).astype(
        np.float32)).to(dev)
    probs = torch.from_numpy(rng.rand(batch, size, size, 1).astype(
        np.float32)).to(dev)
    masks = torch.from_numpy(
        (make_blob_images(batch, size, size, seed=seed + 1)[..., 0] > 128)
        .astype(np.uint8)).to(dev)
    planes = imgs.permute(0, 3, 1, 2)

    stages = [
        ("rolling_ball", lambda: rolling_ball_correction(planes, 50)),
        ("resize_u8", lambda: resize_linear_u8_cv2exact(planes,
                                                        (size, size))),
        ("forward_bf16", lambda: forward_folded(
            fp, x_f32, dil, library_conv_pool, library_head)),
        ("thresh+maskresize", lambda: resize_linear_u8_cv2exact(
            (probs[..., 0] > 0.3).to(torch.uint8), (size, size))),
        ("cc+regionprops", lambda: quantify_mask_batch(masks, 1, 4096,
                                                       connectivity=1)),
        ("packbits", lambda: packbits(masks)),
        ("forward_kernels", lambda: forward_folded(fp, x_f32, dil)),
    ]
    if int8:
        # calibrate on a small slice: the scales' values do not change the
        # time, and the plain f32 calibration forward is slow on the CPU
        fp32 = build_fast_params(folded, torch.float32, dev)
        maxima = qi.forward_calib(fp32, x_f32[:1, :128, :128], dil)[1]
        qp = qi.prepare_int8_params(
            qi.build_int8_params(folded, maxima.cpu().numpy(), dil), dev)
        del fp32
        stages.append(("forward_int8",
                       lambda: qi.forward_int8(qp, x_f32, dil)))

    out: Dict = {}
    recs: Dict[str, Dict] = {}
    with torch.no_grad():
        for name, op in stages:
            recs[name] = measure(op, iters, dev)
            sec = recs[name]["event_ms"] / 1e3
            out[name] = sec
            if verbose:
                r = recs[name]
                extra = ("" if r["device_ms"] is None else
                         f"  device {r['device_ms']:8.3f} ms  idle "
                         f"{r['idle_share']:.3f}")
                print(f"  {name:20s} {sec * 1e3:9.3f} ms/batch-{batch}  "
                      f"{batch / sec if sec else float('inf'):9.1f} img/s"
                      + extra)

    out["total"] = sum(v for k, v in out.items()
                       if k not in ("forward_int8", "forward_kernels"))
    out["img_per_s_device"] = batch / out["total"]
    out["total_kernels"] = (out["total"] - out["forward_bf16"]
                            + out["forward_kernels"])
    out["img_per_s_device_kernels"] = batch / out["total_kernels"]
    if int8:
        out["total_int8"] = (out["total"] - out["forward_bf16"]
                             + out["forward_int8"])
        out["img_per_s_device_int8"] = batch / out["total_int8"]
    fl = forward_flops(batch, size)
    out["forward_flops"] = fl
    if dev.type == "cuda":  # a CPU time over the H100 peak is no MFU
        out["forward_mfu"] = fl / out["forward_kernels"] / PEAK_BF16_FLOPS
        out["forward_mfu_bf16"] = fl / out["forward_bf16"] / PEAK_BF16_FLOPS
    out["stages"] = recs
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    if verbose:
        print(f"  {'TOTAL':20s} {out['total'] * 1e3:9.3f} ms/batch-{batch}  "
              f"{out['img_per_s_device']:9.1f} img/s (library forward)")
        print(f"  {'TOTAL (kernels)':20s} {out['total_kernels'] * 1e3:9.3f}"
              f" ms/batch-{batch}  {out['img_per_s_device_kernels']:9.1f}"
              " img/s")
        if int8:
            print(f"  {'TOTAL (int8 fwd)':20s} {out['total_int8'] * 1e3:9.3f}"
                  f" ms/batch-{batch}  {out['img_per_s_device_int8']:9.1f}"
                  " img/s")
        if "forward_mfu" in out:
            print(f"  forward: {fl / 1e12:.3f} TFLOP/batch, MFU "
                  f"{out['forward_mfu'] * 100:.1f}% of the H100 bf16 peak")
        print(f"  device: {out['device']}")
    return out


def clean(v):
    """JSON-ready copy: non-finite floats -> None, in nested dicts too."""
    if isinstance(v, dict):
        return {k: clean(x) for k, x in v.items()}
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--json_out", default=None)
    ap.add_argument("--int8", action="store_true",
                    help="also time the quantized int8 forward")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to run (default: the GPU)")
    args = ap.parse_args(argv)
    res = profile_stages(args.batch, args.size, args.iters, int8=args.int8,
                         device=args.device)
    line = json.dumps(clean(res))
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
