#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`unetdc_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one JSON line:
  1. build   — compile the CUDA kernels from `unetdc_tpu_torch/csrc`;
  2. inputs  — a seeded, decisive full-width UNetDC checkpoint and 16
               seeded microscopy-like PNGs (8 RGB at 512x512, 8 grayscale at
               600x800, so both size buckets and the mask resize run);
  3. cli     — the port CLI in-process (--batch 8, bf16, cuda), once to warm
               up and once counted: every kernel launch counter is zeroed
               just before and read just after; the artifact tree and the
               droplet tables are checked (scipy labels the written masks);
  4. kernels — K1, K2, K3 at the shapes the CLI run gave them: agreement
               with their plain PyTorch versions, times, bounds, launches;
  5. masks   — the same images through the f32 kernel path and the plain
               f32 path (TF32 off): every pixel whose 0.3 decision differs
               must sit within 1e-3 of the threshold, and at most 1e-5 of
               the mask pixels may differ; the bf16 kernel path's distance
               from the plain bf16 and plain f32 paths is reported.
Then the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure raises: the script exits
nonzero and prints no result. It needs CUDA and the rest of the checkout.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# dense tensor-core bf16; f32 (and 32-bit integer adds) off the tensor cores
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
BATCH = 8
PX_PER_UM = 3.45


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------- inputs --
def make_decisive_checkpoint(path, seed: int = 0, out_scale: float = 300.0,
                             img_size: int = 512, device="cuda"):
    """The port's copy of tests/torch_reference.py::make_decisive_checkpoint:
    a random UNetDC whose logits are centred on their median over a probe
    image and steeply scaled, so masks have structure and the sigmoid
    saturates."""
    import torch

    from unetdc_tpu_torch.models.unet import UNetDC

    torch.manual_seed(seed)
    m = UNetDC().eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.5, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
        probe = torch.rand(1, 3, img_size, img_size,
                           generator=torch.Generator().manual_seed(123))
        m = m.to(device)
        probs = m(probe.to(device).permute(0, 2, 3, 1))
        center = torch.logit(probs.clamp(1e-6, 1 - 1e-6)).median()
        m.out_conv.weight.mul_(out_scale)
        m.out_conv.bias.sub_(center).mul_(out_scale)
    torch.save({k: v.cpu() for k, v in m.state_dict().items()}, str(path))


def make_images(d: Path, seed: int = 7):
    """Bright disks on dark noise (tests/test_pipeline_e2e.py), 8 RGB at
    512x512 and 8 grayscale-as-RGB at 600x800."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    d.mkdir(parents=True, exist_ok=True)
    for i in range(16):
        h, w = (512, 512) if i < 8 else (600, 800)
        c = 3 if i < 8 else 1
        img = (rng.rand(h, w, c) * 60).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        for _ in range(40):
            cy, cx = rng.randint(12, h - 12), rng.randint(12, w - 12)
            r = rng.randint(3, 12)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
            img[blob] = np.minimum(img[blob].astype(np.int32) + 180, 255)
        img = np.repeat(img, 3 // c, axis=-1)
        Image.fromarray(img).save(d / f"img{i:02d}.png")


# ------------------------------------------------------------------ cli --
def run_cli(img_dir, ckpt, out_dir, precision="bf16"):
    from unetdc_tpu_torch.cli.quantify_droplets_batch import main

    return main(["--img_dir", str(img_dir), "--ckpt_path", str(ckpt),
                 "--out_dir", str(out_dir), "--batch", str(BATCH),
                 "--precision", precision, "--device", "cuda",
                 "--save_overlays", "--px_per_micron", str(PX_PER_UM)])


def check_artifacts(img_dir, out_dir):
    """The reference CLI's artifact tree, and droplet counts/areas that
    agree with scipy's labeling of the written masks."""
    import numpy as np
    import pandas as pd
    from PIL import Image
    from scipy import ndimage as ndi

    out = Path(out_dir)
    imgs = sorted(Path(img_dir).glob("*.png"))
    summary = pd.read_csv(out / "summary_per_image.csv")
    check(list(summary.columns) == ["filename", "droplet_count",
                                    "total_area_px"], "summary schema")
    check(list(summary.filename) == [p.name for p in imgs], "summary rows")
    for name in ("all_droplets.csv", "droplet_size_stats.csv"):
        check((out / name).exists(), name)
    check((out / "all_droplets.xlsx").exists()
          or (out / "all_droplets_noexcel.csv").exists(), "excel fallback")
    try:
        import matplotlib  # noqa: F401
        check((out / "size_histogram.png").exists(), "histogram")
    except ImportError:
        pass
    total = 0
    for i, p in enumerate(imgs):
        src = np.array(Image.open(p))
        mask = np.array(Image.open(out / "predicted_masks"
                                   / f"{p.stem}_pred.png"))
        check(mask.shape == src.shape[:2], f"{p.name}: mask size")
        check(set(np.unique(mask)) <= {0, 255}, f"{p.name}: mask values")
        check((out / "overlays" / f"{p.stem}_overlay.png").exists(),
              f"{p.name}: overlay")
        df = pd.read_csv(out / f"{p.stem}_droplets.csv")
        lab, n = ndi.label(mask > 0)
        check(n == len(df) == summary.droplet_count[i],
              f"{p.name}: droplet count {len(df)} vs scipy {n}")
        if n:
            areas = np.bincount(lab.ravel())[1:]
            check(np.array_equal(df["area"].to_numpy(), areas),
                  f"{p.name}: areas")
            cy = ndi.sum_labels(np.indices(lab.shape)[0], lab,
                                np.arange(1, n + 1)) / areas
            check(np.allclose(df["centroid-0"], cy, rtol=1e-12, atol=0),
                  f"{p.name}: centroids")
        total += n
    check(total > 0, "no droplets found")
    return total


# -------------------------------------------------------------- kernels --
def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of fn() on the card, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_rows(engine, img_dir, out_dir, launches):
    """Capture each kernel's inputs on the main path's shapes, hold the
    kernel against its plain version, and time kernel, plain and library."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from PIL import Image

    from unetdc_tpu_torch.models.unet_fast import forward_folded
    from unetdc_tpu_torch.ops import fused_conv as fc
    from unetdc_tpu_torch.ops.component_tables import (
        component_tables, component_tables_plain)
    from unetdc_tpu_torch.ops.connected_components import (_coord_plan,
                                                           label_batch)
    from unetdc_tpu_torch.io.images import decode_rgb

    seen = {}

    def rec_k1(*a):
        seen["k1"] = a
        return fc.conv3x3_relu_pool(*a)

    def rec_k2(*a):
        seen["k2"] = a
        return fc.dec1_head(*a)

    imgs = sorted(Path(img_dir).glob("*.png"))
    batch = np.stack([decode_rgb(p) for p in imgs[:BATCH]])
    with torch.no_grad():
        x = engine._preprocess(torch.from_numpy(batch).cuda(), 50, True)
        forward_folded(engine.params, x, engine._dilations, rec_k1, rec_k2)
    masks = np.stack([np.array(Image.open(
        Path(out_dir) / "predicted_masks" / f"{p.stem}_pred.png")) // 255
        for p in imgs[BATCH:2 * BATCH]])
    labels, _ = label_batch(torch.from_numpy(masks).cuda(), 1)
    labels = labels.contiguous()
    h, w = masks.shape[1:]
    plan = _coord_plan(h, w, force_split=True)
    torch.cuda.synchronize()
    rows = []

    # K1 ---------------------------------------------------------------
    x1, w1, b1 = seen["k1"]
    B, H, W, C = x1.shape
    y, p = fc.conv3x3_relu_pool(x1, w1, b1)
    yr, pr = fc.conv3x3_relu_pool_plain(x1, w1, b1)
    err = max(float((y.float() - yr.float()).abs().max()),
              float((p.float() - pr.float()).abs().max()))
    check(torch.allclose(y.float(), yr.float(), atol=1e-2, rtol=1e-2)
          and torch.allclose(p.float(), pr.float(), atol=1e-2, rtol=1e-2),
          f"K1 bf16 disagrees with its plain version (max err {err})")
    xf, wf = x1.float(), w1.float()
    yf, pf = fc.conv3x3_relu_pool(xf, wf, b1)
    yrf, prf = fc.conv3x3_relu_pool_plain(xf, wf, b1)
    err32 = float((yf - yrf).abs().max())
    check(torch.allclose(yf, yrf, atol=2e-5, rtol=1e-5)
          and torch.allclose(pf, prf, atol=2e-5, rtol=1e-5),
          f"K1 f32 disagrees with its plain version (max err {err32})")
    xn = x1.permute(0, 3, 1, 2)
    wn = w1.permute(3, 2, 0, 1).contiguous()
    bn = b1.to(x1.dtype)
    flops = 2 * B * H * W * C * 64 * 9
    byts = nbytes(x1, y, p, w1, b1)
    rows.append(dict(
        name="K1 conv3x3_relu_pool", route="cuda",
        source="unetdc_tpu_torch/csrc/fused_conv.cu",
        replaces="unetdc_tpu/ops/pallas_conv.py:260",
        launches=launches.get("conv3x3_relu_pool", 0),
        max_abs_err=err, max_abs_err_f32=err32,
        ms=cuda_ms(lambda: fc.conv3x3_relu_pool(x1, w1, b1)),
        plain_ms=cuda_ms(lambda: fc.conv3x3_relu_pool_plain(x1, w1, b1),
                         reps=5),
        library_ms=cuda_ms(lambda: F.max_pool2d(
            torch.relu(F.conv2d(xn, wn, bn, padding=1)), 2)),
        **bound(byts, flops, "bf16"), shapes=f"x {tuple(x1.shape)} bf16"))

    # K2 ---------------------------------------------------------------
    dec2, enc1, head = seen["k2"]
    o = fc.dec1_head(dec2, enc1, head)
    orf = fc.dec1_head_plain(dec2, enc1, head)
    err = float((o - orf).abs().max())
    # The decisive checkpoint scales the 1x1 head by 300, so a one-ulp bf16
    # difference in d1 (f32 sums taken in another order) moves a
    # probability near 0.5 by several hundredths. Held here: the 0.3 masks
    # the pipeline takes from it, and |dprob| < 0.05 with the head at the
    # model's own scale (weights and bias / 300) on the same activations.
    flips = float(((o > 0.3) != (orf > 0.3)).float().mean())
    check(flips < 1e-3, f"K2 bf16 0.3-mask mismatch {flips}")
    unscaled = dict(head, w_oc=head["w_oc"] / 300, b_oc=head["b_oc"] / 300)
    err_unscaled = float((fc.dec1_head(dec2, enc1, unscaled)
                          - fc.dec1_head_plain(dec2, enc1, unscaled)
                          ).abs().max())
    check(err_unscaled < 0.05, f"K2 bf16 |dprob| {err_unscaled} >= 0.05")
    h32 = {k: (v.float() if v.dtype == torch.bfloat16 else v)
           for k, v in unscaled.items()}
    o32 = fc.dec1_head(dec2.float(), enc1.float(), h32)
    or32 = fc.dec1_head_plain(dec2.float(), enc1.float(), h32)
    err32 = float((o32 - or32).abs().max())
    check(torch.allclose(o32, or32, atol=3e-6, rtol=1e-5),
          f"K2 f32 disagrees with its plain version (max err {err32})")
    B, H, W, _ = enc1.shape
    flops = 2 * B * H * W * (128 * 64 + 128 * 64 * 9 + 64 * 64 * 9 + 64)
    byts = nbytes(dec2, enc1, o, *head.values())
    dt = enc1.dtype
    w_up = head["w_up"].permute(2, 3, 0, 1).contiguous()
    w0n = head["w0"].permute(3, 2, 0, 1).contiguous()
    w1n = head["w1"].permute(3, 2, 0, 1).contiguous()
    wocn = head["w_oc"].view(1, 64, 1, 1)
    bias = {k: head[k].to(dt) for k in ("b_up", "b0", "b1", "b_oc")}
    d2n, e1n = dec2.permute(0, 3, 1, 2), enc1.permute(0, 3, 1, 2)

    def lib_k2():
        up = F.conv_transpose2d(d2n, w_up, bias["b_up"], stride=2)
        hh = torch.relu(F.conv2d(torch.cat([up, e1n], 1), w0n, bias["b0"],
                                 padding=1))
        d1 = torch.relu(F.conv2d(hh, w1n, bias["b1"], padding=1))
        return torch.sigmoid(F.conv2d(d1, wocn, bias["b_oc"]).float())

    rows.append(dict(
        name="K2 dec1_head", route="cuda",
        source="unetdc_tpu_torch/csrc/fused_conv.cu",
        replaces="unetdc_tpu/ops/pallas_conv.py:425",
        launches=launches.get("dec1_head", 0),
        max_abs_err=err, mask_mismatch=flips,
        max_abs_err_unscaled_head=err_unscaled,
        max_abs_err_f32_unscaled_head=err32,
        ms=cuda_ms(lambda: fc.dec1_head(dec2, enc1, head)),
        plain_ms=cuda_ms(lambda: fc.dec1_head_plain(dec2, enc1, head),
                         reps=5),
        library_ms=cuda_ms(lib_k2),
        **bound(byts, flops, "bf16"),
        shapes=f"dec2 {tuple(dec2.shape)} enc1 {tuple(enc1.shape)} bf16"))

    # K3 ---------------------------------------------------------------
    cap = max(5120, engine.max_labels + 1)
    t = component_tables(labels, *plan, cap=cap)
    tr = component_tables_plain(labels, *plan, cap=cap)
    check(torch.equal(t, tr), "K3 disagrees with its plain version")
    B = labels.shape[0]
    nfeat = t.shape[-1]
    m = (1 << plan[1]) - 1
    pidx = torch.arange(h * w, device="cuda")
    feats = torch.stack([torch.ones_like(pidx)]
                        + [((pidx // w) >> s) & m for s in plan[0]]
                        + [((pidx % w) >> s) & m for s in plan[0]],
                        -1).to(torch.int32).repeat(B, 1)
    lab64 = labels.reshape(B, -1).long()
    ok = (lab64 >= 0) & (lab64 < cap)
    idx = (torch.where(ok, lab64, cap) + (cap + 1) * torch.arange(
        B, device="cuda")[:, None]).reshape(-1, 1).expand(-1, nfeat)
    tab = torch.zeros(B * (cap + 1), nfeat, dtype=torch.int32, device="cuda")

    def lib_k3():
        tab.zero_()
        tab.scatter_add_(0, idx, feats)

    n_in = int(ok.sum())
    rows.append(dict(
        name="K3 component_tables", route="cuda",
        source="unetdc_tpu_torch/csrc/component_tables.cu",
        replaces="unetdc_tpu/ops/pallas_props.py:181",
        launches=launches.get("component_tables", 0),
        max_abs_err=float((t - tr).abs().max()),
        ms=cuda_ms(lambda: component_tables(labels, *plan, cap=cap)),
        plain_ms=cuda_ms(lambda: component_tables_plain(labels, *plan,
                                                        cap=cap), reps=5),
        library_ms=cuda_ms(lib_k3),
        **bound(nbytes(labels, t), n_in * nfeat, "f32"),
        shapes=f"labels {tuple(labels.shape)} int32, cap {cap}, "
               f"plan {plan}"))
    return rows


def stage_times(engine, img_dir):
    """Card time of each megastep stage for one batch of each size bucket
    (CUDA events, a synchronize between stages; warm)."""
    import numpy as np
    import torch

    from unetdc_tpu_torch.io.images import decode_rgb
    from unetdc_tpu_torch.ops.connected_components import quantify_mask_batch
    from unetdc_tpu_torch.ops.resize import resize_linear_u8_cv2exact
    from unetdc_tpu_torch.pipelines.engine import grayscale_view

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    imgs = sorted(Path(img_dir).glob("*.png"))
    result = {}
    for name, group in (("512x512 rgb", imgs[:BATCH]),
                        ("600x800 gray", imgs[BATCH:2 * BATCH])):
        batch = grayscale_view(np.stack([decode_rgb(p) for p in group]))
        out_hw = batch.shape[1:3]
        for _ in range(2):  # the second pass is the one kept
            ms = {}
            x_u8, ms["upload"] = timed(
                lambda: torch.from_numpy(batch).cuda())
            x, ms["rolling_ball+resize"] = timed(
                lambda: engine._preprocess(x_u8, 50, True))
            with torch.no_grad():
                probs, ms["forward"] = timed(lambda: engine.forward_probs(x))
            masks, ms["threshold+mask_resize"] = timed(
                lambda: resize_linear_u8_cv2exact(
                    (probs[..., 0] > 0.3).to(torch.uint8), out_hw))
            _, ms["cc+tables"] = timed(lambda: quantify_mask_batch(
                masks, 1, engine.max_labels, tables=engine._tables))
        result[name] = ms
    return result


def bound(byts: int, ops: int, kind: str):
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    t_b = byts / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": byts, "ops": ops}


# ---------------------------------------------------------------- masks --
def compare_runs(img_dir, a_dir, b_dir):
    """(mask mismatch fraction, number of per-image CSVs that differ)."""
    import numpy as np
    from PIL import Image

    diff = tot = csv_diff = 0
    for p in sorted(Path(img_dir).glob("*.png")):
        ma = np.array(Image.open(Path(a_dir) / "predicted_masks"
                                 / f"{p.stem}_pred.png"))
        mb = np.array(Image.open(Path(b_dir) / "predicted_masks"
                                 / f"{p.stem}_pred.png"))
        diff += int((ma != mb).sum())
        tot += ma.size
        csv_diff += ((Path(a_dir) / f"{p.stem}_droplets.csv").read_bytes()
                     != (Path(b_dir) / f"{p.stem}_droplets.csv").read_bytes())
    return diff / tot, csv_diff


def threshold_flips(ckpt, img_dir, thresh=0.3, near=1e-3):
    """f32 kernel forward vs plain f32 forward on both batches: max |dprob|,
    pixels whose 0.3 decision flips, and flips of pixels whose plain
    probability is farther than `near` from the threshold."""
    import numpy as np
    import torch

    from unetdc_tpu_torch.io.images import decode_rgb
    from unetdc_tpu_torch.pipelines.engine import grayscale_view, load_engine

    ek = load_engine(str(ckpt), fast=False, device="cuda")
    ep = load_engine(str(ckpt), fast=False, device="cuda", kernels=False)
    imgs = sorted(Path(img_dir).glob("*.png"))
    out = {"max_abs_dprob": 0.0, "flips": 0, "flips_not_near_threshold": 0}
    with torch.no_grad():
        for group in (imgs[:BATCH], imgs[BATCH:2 * BATCH]):
            batch = grayscale_view(np.stack([decode_rgb(p) for p in group]))
            x = ek._preprocess(torch.from_numpy(batch).cuda(), 50, True)
            pk, pp = ek.forward_probs(x), ep.forward_probs(x)
            flip = (pk > thresh) != (pp > thresh)
            out["max_abs_dprob"] = max(out["max_abs_dprob"],
                                       float((pk - pp).abs().max()))
            out["flips"] += int(flip.sum())
            out["flips_not_near_threshold"] += int(
                (flip & ((pp - thresh).abs() >= near)).sum())
    return out


def run_plain(img_dir, ckpt, out_dir, precision):
    from unetdc_tpu_torch.pipelines.engine import load_engine
    from unetdc_tpu_torch.pipelines.quantify_batch import BatchQuantifyPipeline

    eng = load_engine(str(ckpt), fast=(precision == "bf16"), device="cuda",
                      kernels=False)
    pipe = BatchQuantifyPipeline(eng, str(out_dir), batch=BATCH,
                                 px_per_micron=PX_PER_UM)
    pipe.run(str(img_dir), progress=False)
    pipe.write_reports(skip_excel=True, skip_histogram=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from unetdc_tpu_torch.device import resolve_device
        from unetdc_tpu_torch.ops import cuda_build as cb
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    resolve_device("cuda")  # TF32 off for the f32 phases

    t0 = time.perf_counter()
    lib = cb.build()
    cb.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT))})

    work = Path(tempfile.mkdtemp(prefix="unetdc_smoke_"))
    try:
        t0 = time.perf_counter()
        ckpt = work / "decisive_unetdc.pth"
        make_decisive_checkpoint(ckpt, seed=0, img_size=512)
        img_dir = work / "imgs"
        make_images(img_dir)
        emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
              "images": 16, "sizes": ["512x512 rgb", "600x800 gray"]})

        run_cli(img_dir, ckpt, work / "warm")  # first-call costs
        torch.cuda.synchronize()
        cb.reset_launches()
        t0 = time.perf_counter()
        pipe = run_cli(img_dir, ckpt, work / "out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cb.LAUNCHES)
        n_drop = check_artifacts(img_dir, work / "out")
        ms = pipe.engine.megastep_ms
        emit({"phase": "cli", "images": 16, "seconds": wall,
              "e2e_img_per_s": 16 / wall, "megastep_ms": ms,
              "megastep_ms_median": statistics.median(ms),
              "device_img_per_s": BATCH * len(ms) / (sum(ms) / 1e3),
              "droplets": n_drop, "launches": launches})
        for k in ("conv3x3_relu_pool", "dec1_head", "component_tables"):
            check(launches.get(k, 0) >= 1, f"{k} never launched")

        rows = kernel_rows(pipe.engine, img_dir, work / "out", launches)
        emit({"phase": "stages",
              "ms": stage_times(pipe.engine, img_dir)})
        emit({"kernels": rows})

        run_cli(img_dir, ckpt, work / "k32", precision="f32")
        run_plain(img_dir, ckpt, work / "p32", "f32")
        run_plain(img_dir, ckpt, work / "pbf", "bf16")
        f32_mis, f32_csv = compare_runs(img_dir, work / "k32", work / "p32")
        bf_mis, bf_csv = compare_runs(img_dir, work / "out", work / "pbf")
        x_mis, x_csv = compare_runs(img_dir, work / "out", work / "p32")
        probs = threshold_flips(ckpt, img_dir)
        emit({"phase": "masks",
              "f32_kernels_vs_plain_f32": {"mask_mismatch": f32_mis,
                                           "csv_differ": f32_csv, **probs},
              "bf16_kernels_vs_plain_bf16": {"mask_mismatch": bf_mis,
                                             "csv_differ": bf_csv},
              "bf16_kernels_vs_plain_f32": {"mask_mismatch": x_mis,
                                            "csv_differ": x_csv}})
        # f32: the two paths sum in other orders, and the decisive head
        # scales logits by 300, so a pixel whose probability sits within
        # ~1e-5 of the threshold may flip; every flip must be such a pixel
        check(probs["flips_not_near_threshold"] == 0,
              "f32 kernel path flips a pixel far from the threshold")
        check(f32_mis <= 1e-5, f"f32 kernel path mask mismatch {f32_mis}")
        # bf16: a one-ulp rounding difference in enc1 propagates through
        # the whole network; a sanity bound only (see PERF.md)
        check(bf_mis < 5e-2 and x_mis < 5e-2, "bf16 path mask mismatch")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
