#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`unetdc_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one JSON line:
  1. build   — compile the CUDA kernels from `unetdc_tpu_torch/csrc`,
               then build (or find built, or find failed) the host
               libraries libfastio and libalgo (`native`), so that no
               timed phase pays for g++;
  2. inputs  — a seeded, decisive full-width UNetDC checkpoint and 16
               seeded microscopy-like PNGs (8 RGB at 512x512, 8 grayscale at
               600x800, so both size buckets and the mask resize run);
  3. cli     — the port CLI in-process (--batch 8, bf16, cuda), once to warm
               up and once counted: every kernel launch counter is zeroed
               just before and read just after; the artifact tree and the
               droplet tables are checked (scipy labels the written masks);
               the counted run's stage timers (host_decode, h2d_upload,
               device_fetch, host_write_artifacts, host_csv: `host_split_s`)
               and a third run with --profile (its stage report and the
               torch.profiler trace's size: `profile`);
  3b. gui    — (between the counted and the profiled CLI run: before the
               process's first torch.profiler session, since a CUDA child
               process started after one leaves the later sessions without
               device activity) the Qt GUI (gui/qt_app.py, --device cuda)
               headless under
               tests/fake_pyside6.py: the 16 images, the decisive
               checkpoint, batch 8, overlays on, Excel and histogram off
               (the card's image has neither xlsxwriter nor matplotlib);
               its click spawns the port CLI in a child process on the
               card: no message box, "All done" in the log pane, the
               results tables and overlay gallery filled; then the frozen
               entry (gui/entry.py) dispatching `--cli
               quantify_droplets_batch` in-process, counted (K1, K2, K3
               launched: the `gui_entry` path); both runs' summary and
               droplet CSVs and masks byte-equal to an in-process CLI run
               of the GUI's argv.
 4. kernels — K1, K2, K3 at the shapes the CLI run gave them (K3 at both
               image sizes): agreement with their plain PyTorch versions,
               event time around one call (`ms`), device time from
               torch.profiler (`device_ms`: the kernels and memsets one
               call launches, host enqueue excluded), bounds, launches,
               the fractions of the bound reached and the time over the
               library call's (K3 also at 512x512); every kernel must beat
               its library call; the rolling ball (RB, ksize 50) on the
               quantifier's (8, 1, 1024, 1024) gray planes and the
               trainer's permuted (8, 3, 512, 512) view, torch.equal to
               its plain chain, with the chain's ms (no library call
               computes it);
               then K3 on scipy-labelled blob batches at the overflow
               caps 8193 and 32769 and on its global-atomics path
               (`k3_overflow` line), each exactly equal to plain;
 4b. device_profile, forward_profile — the package's profilers
               (utils/device_profile.py, utils/forward_profile.py) at batch
               8, 512x512: per megastep stage the event ms, device ms and
               idle share, int8 included, forward_mfu; the kernel forward
               below the library forward, its K1 + K2 device time within
               10% of the `kernels` line's, K3 in cc+regionprops; per block
               of the forward its ms, FLOPs, traffic and bound, the rows'
               useful FLOPs summing to forward_flops exactly.
  5. masks   — the same images through the f32 kernel path and the plain
               f32 path (TF32 off): every pixel whose 0.3 decision differs
               must sit within 1e-3 of the threshold, and at most 1e-5 of
               the mask pixels may differ; the bf16 kernel path's distance
               from the plain bf16 and plain f32 paths is reported.
  5b. sharded — multi-device inference on meshes built over the one card
               repeated (one card shows the arithmetic of the sharded
               path, not peer copies or overlap between cards): K1 and K2
               in `ext` mode on 2 and 4 row shards of the main path's
               inputs (halos from the neighbours, zeros at the edges),
               reassembled `torch.equal` to the unsharded kernels in bf16
               and f32 and held to their plain `ext` versions;
               forward_folded_spmd on meshes (2,1), (1,2), (1,4), (2,2):
               f32 masks and probabilities equal to the unsharded kernel
               forward's, bf16 distance reported (cuDNN's bf16 convs pick
               shape-dependent algorithms), K1/K2 launches per mesh;
               BatchQuantifyPipeline over the 16 images with an f32 engine
               on mesh (2,1), and on mesh (2,2) with shard_space (the
               counted sharded path: K1_ext, K2_ext, K3 launched): masks
               and CSVs byte-equal to the f32 single-device CLI run; the
               bf16 engine on (2,1) reported against the `cli` run; the CLI
               with --data_parallel 1 byte-equal to the `cli` run.
  6. train   — the training path: 16 seeded 512x512 image/mask pairs
               (split 9/3/4, so the last training batch holds 1 image); two
               epochs of the full-width UNetDC through the port's
               train_dc_focal CLI (bf16, batch 8, cuda) with its test
               phase (without matplotlib and seaborn, which the CLI's
               plots need: Trainer.fit and the test phase directly), a
               third epoch resumed from `.last`, and the port's
               quantify CLI on the trained `.msgpack` (K1-K3 launched);
               the train step timed alone on one device-resident batch of
               8 (`train_step` line: median ms, img/s, mfu, peak memory,
               first and last loss, a torch.profiler split of one step);
               one step on the card and on the CPU from the same weights
               (`train_f32_card_vs_cpu` line: f32 with TF32 off and f64;
               see `card_vs_cpu_step` for the tolerances).
  6b. train_mesh — training on meshes over the one card repeated (the
               arithmetic of the sharded step, not peer copies):
               (a) one f32 step (TF32 off) at 512x512, batch 8, on (2,1),
               (1,2), (2,2) and (1,4), `shard_space` where the mesh has a
               space axis, each against the single-device step from the
               same seed-0 weights (cuDNN's heuristic algorithms: timing
               every f32 shard shape costs minutes): loss within 1e-5
               relative, every parameter within 2.05 * lr, the BatchNorm
               running statistics within 1e-5 of each buffer's largest
               magnitude;
               then 7 valid samples padded to (2,1) against one device on
               the 7; (b) the bf16 step's event time on one device and on
               each mesh (reported, not gated; a torch.profiler split of
               the (2,2) step); (c) Trainer.fit, f32, 2 epochs on the
               16-pair set on (2,2) with `shard_space`, then a third
               resumed from `.last` (the same dataset objects, as in one
               process), against 3 epochs on one device: every history
               value within 2e-4 relative; (d), after the int8 phase,
               whose sidecar and unsharded run it uses: the int8 engine
               with `shard_space` on (1,2) and (2,2) over the 16 images,
               masks and CSVs byte-equal to the unsharded int8 run, K3
               launched (the `int8_sharded` path); then
               `dryrun_multichip(4)` over the card repeated 4 times. The
               line prints after the int8 line, with the card's name and
               power limit and the seconds of (a), (b) and (c).
  7. int8    — the port CLI with --int8 over the 16 images: K3 launched,
               K1/K2 not; the calibration sidecar written, and a second
               run that loads it gives byte-equal masks and CSVs; the
               card's forward_int8 against the CPU's on 2 images at
               128x128 from the same int8 params (equal 0.3 mask,
               probabilities within 1e-6); mask agreement with the f32
               kernel path; the int8 forward's ms per batch of 8 at 512x512
               beside the bf16 kernel forward's, its peak memory and a
               torch.profiler split (reported, not gated).
  8. heatmaps — HeatmapV1Engine and BlobInspectorEngine (CLI defaults:
               kernel 55, 3 rings, contour threshold 0, min size 20), bf16,
               over the 16 images at full width: K1/K2/K3 launch counts
               and megastep ms of each engine; each engine's heatmap stage
               on the card and on the CPU from the card's masks and
               tables: ROI, Otsu thresholds, radial_u8, target_pct,
               conv_pct and remove_small_batch equal, spatial_u8 within 1.
  9. library — the library surface (`unetdc_tpu_torch/library.py` and the
               ops behind it) on the card over the 16 images with the
               decisive checkpoint: segmentation_deep_learning (bf16,
               K1/K2: the counted `library` path), convert_to_8_bits,
               rolling_ball at r = 25/50/100 (the 8 600x800 images),
               label, quantify_mask_adaptive, regionprops_table,
               centroid_size_image, distance_transform_edt,
               peak_local_max_device, watershed_device, watershed_custom,
               blobs_detection (LoG, DoG, DoH) and the contour and density
               helpers, from the masks segmentation_deep_learning gave;
               ms per call (host clock, card synchronised); each held to
               the port on the CPU from the same inputs on images 0, 1, 8
               and 9 (the rolling ball on image 8): equal, or within the
               tolerance its test states; K1 and K2 at the library's own
               shapes (batch 1, captured from one segmentation_deep_learning
               call) held to their plain versions as in phase 4;
               segmentation_deep_learning itself with the f32 engine (TF32
               off) in the library's cache, card vs CPU, with the masks
               phase's rule (every 512x512 flip within 1e-3 of the
               threshold, at most 1e-5 of the library's mask pixels), and
               the timed bf16 masks within 5e-2 of the f32 CPU masks.
 10. int8_trained — utils/int8_trained_eval.py at the JAX package's
               defaults (128 images at 256x256, 10 epochs, 16 held out):
               int8 vs bf16 mask agreement (mean, min), count match rate,
               mean |count difference|, val dice, wall seconds; its own
               launch counts (the `int8_trained` path: K1, K2, K3), and
               each kernel's inputs at 256x256 held to the plain version.
 11. native_io — native_available(), libfastio vs PIL decode (PNG, JPEG
               q90) and mask-encode host ms on a 600x800 image, and
               equality with PIL's decode (JPEG within 2 levels).
 12. epoch_wall — utils/epoch_wall.py at its defaults (144 + 64 synthetic
               512x512 images, batch 8, 4 epochs, bf16): epoch walls, the
               device time per image of a train and an eval batch, and
               their ratio (above 2 is reported, not failed); every number
               finite.
Every line of phases 3b, 4b, 6b and 9-12 carries the card's name and
power limit.
Then the `kernels` line (with each kernel's launches on every path), the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure raises: the script exits
nonzero and prints no result. It needs CUDA and the rest of the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# dense tensor-core bf16 and int8; f32 (and 32-bit integer adds) off the
# tensor cores
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
BATCH = 8
PX_PER_UM = 3.45
DECISIVE_SCALE = 300.0  # the decisive checkpoint's head scale


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------- inputs --
def make_decisive_checkpoint(path, seed: int = 0,
                             out_scale: float = DECISIVE_SCALE,
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
def run_cli(img_dir, ckpt, out_dir, precision="bf16", int8=False,
            extra=()):
    from unetdc_tpu_torch.cli.quantify_droplets_batch import main

    return main(["--img_dir", str(img_dir), "--ckpt_path", str(ckpt),
                 "--out_dir", str(out_dir), "--batch", str(BATCH),
                 "--precision", precision, "--device", "cuda",
                 "--save_overlays", "--px_per_micron", str(PX_PER_UM)]
                + (["--int8"] if int8 else []) + list(extra))


def check_artifacts(img_dir, out_dir, need_droplets: bool = True):
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
    check(total > 0 or not need_droplets, "no droplets found")
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


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one fn() call (`utils/device_profile.py::
    device_ms`: torch.profiler's CUDA activity, one session per call, host
    enqueue not counted); a kernel call that records none fails."""
    from unetdc_tpu_torch.utils.device_profile import device_ms as dev_ms

    t = dev_ms(fn, reps, warmup)
    check(t > 0, "a kernel call recorded no device time")
    return t


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def hold_k1(x, w, b, where: str) -> float:
    """K1 held to its plain version on (x, w, b): bf16 within 1e-2
    (atol and rtol), f32 within 2e-5 / 1e-5; its max abs error."""
    import torch

    from unetdc_tpu_torch.ops import fused_conv as fc

    y, p = fc.conv3x3_relu_pool(x, w, b)
    yr, pr = fc.conv3x3_relu_pool_plain(x, w, b)
    atol, rtol = (1e-2, 1e-2) if x.dtype == torch.bfloat16 else (2e-5, 1e-5)
    err = max(float((y.float() - yr.float()).abs().max()),
              float((p.float() - pr.float()).abs().max()))
    check(torch.allclose(y.float(), yr.float(), atol=atol, rtol=rtol)
          and torch.allclose(p.float(), pr.float(), atol=atol, rtol=rtol),
          f"{where}: K1 {x.dtype} at {tuple(x.shape)} disagrees with its "
          f"plain version (max err {err})")
    return err


def hold_k2(dec2, enc1, head, head_scale: float, where: str):
    """K2 held to its plain version: (max abs error, 0.3-mask flip share,
    max abs error with the head at the model's own scale).

    A checkpoint may scale the 1x1 head (the decisive one by 300), so a
    one-ulp bf16 difference in d1 (f32 sums taken in another order) moves
    a probability near 0.5 by several hundredths. Held here: the 0.3
    masks the pipeline takes from it (< 1e-3 of pixels flip), and
    |dprob| < 0.05 with the head at the model's own scale (weights and
    bias / head_scale) on the same activations."""
    from unetdc_tpu_torch.ops import fused_conv as fc

    o = fc.dec1_head(dec2, enc1, head)
    orf = fc.dec1_head_plain(dec2, enc1, head)
    err = float((o - orf).abs().max())
    flips = float(((o > 0.3) != (orf > 0.3)).float().mean())
    at = f"{where}: K2 at {tuple(dec2.shape)}"
    check(flips < 1e-3, f"{at}: 0.3-mask mismatch {flips}")
    own = dict(head, w_oc=head["w_oc"] / head_scale,
               b_oc=head["b_oc"] / head_scale)
    err_own = float((fc.dec1_head(dec2, enc1, own)
                     - fc.dec1_head_plain(dec2, enc1, own)).abs().max())
    check(err_own < 0.05, f"{at}: |dprob| {err_own} >= 0.05")
    return err, flips, err_own


@contextlib.contextmanager
def capturing(engines=()):
    """Yield {"K1"|"K2"|"K3": {shapes: (args, kwargs)}}, filled with the
    inputs (cloned) of the first card call of each kernel at each shape,
    while every call goes on to the kernel's wrapper (which counts it).
    Covers engines built inside the block and the given `engines`."""
    import torch

    from unetdc_tpu_torch.ops import fused_conv as fc
    from unetdc_tpu_torch.pipelines import engine as E

    seen = {"K1": {}, "K2": {}, "K3": {}}

    def rec(key, fn):
        def call(*a, **k):
            shapes = tuple(tuple(t.shape) for t in a if torch.is_tensor(t))
            if a[0].is_cuda and shapes not in seen[key]:
                seen[key][shapes] = ([t.clone() if torch.is_tensor(t) else t
                                      for t in a], dict(k))
            return fn(*a, **k)
        return call

    spots = [(fc, "conv3x3_relu_pool", "K1"), (fc, "dec1_head", "K2"),
             (E, "component_tables", "K3")]
    spots += [(e, a, k) for e in engines for a, k in
              (("_conv_pool", "K1"), ("_head", "K2"), ("_tables", "K3"))]
    saved = [(o, a, getattr(o, a)) for o, a, _ in spots]
    try:
        for o, a, k in spots:
            setattr(o, a, rec(k, getattr(o, a)))
        yield seen
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)


def hold_captured(seen, head_scale: float, where: str):
    """Every captured K1, K2 and K3 call held to its plain version (K1/K2
    as `hold_k1`/`hold_k2`, K3 equal); one row per kernel and shape."""
    import torch

    from unetdc_tpu_torch.ops.component_tables import (
        component_tables, component_tables_plain)

    rows = []
    for (a, k) in seen["K1"].values():
        rows.append({"kernel": "K1", "x": list(a[0].shape),
                     "dtype": str(a[0].dtype),
                     "max_abs_err": hold_k1(*a, where)})
    for (a, k) in seen["K2"].values():
        err, flips, err_own = hold_k2(*a, head_scale, where)
        rows.append({"kernel": "K2", "dec2": list(a[0].shape),
                     "dtype": str(a[0].dtype), "max_abs_err": err,
                     "mask_flip_share": flips,
                     "max_abs_err_own_head_scale": err_own})
    for (a, k) in seen["K3"].values():
        ok = torch.equal(component_tables(*a, **k),
                         component_tables_plain(*a, **k))
        check(ok, f"{where}: K3 at {tuple(a[0].shape)} disagrees with its "
                  "plain version")
        rows.append({"kernel": "K3", "labels": list(a[0].shape),
                     "cap": k.get("cap"), "equal": ok})
    return rows


def kernel_rows(engine, img_dir, out_dir, launches):
    """Capture each kernel's inputs on the main path's shapes, hold the
    kernel against its plain version, and time kernel, plain and library."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from PIL import Image

    from unetdc_tpu_torch.models.unet_fast import forward_folded
    from unetdc_tpu_torch.ops import fused_conv as fc
    from unetdc_tpu_torch.ops.component_tables import component_tables_plain
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

    def cli_labels(group):
        masks = np.stack([np.array(Image.open(
            Path(out_dir) / "predicted_masks" / f"{p.stem}_pred.png")) // 255
            for p in group])
        return label_batch(torch.from_numpy(masks).cuda(), 1)[0].contiguous()

    labels = cli_labels(imgs[BATCH:2 * BATCH])  # (8, 600, 800)
    labels512 = cli_labels(imgs[:BATCH])  # (8, 512, 512)
    h, w = labels.shape[1:]
    plan = _coord_plan(h, w, force_split=True)
    torch.cuda.synchronize()
    rows = []

    # K1 ---------------------------------------------------------------
    x1, w1, b1 = seen["k1"]
    B, H, W, C = x1.shape
    y, p = fc.conv3x3_relu_pool(x1, w1, b1)
    err = hold_k1(x1, w1, b1, "cli")
    err32 = hold_k1(x1.float(), w1.float(), b1, "cli")
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
        device_ms=device_ms(lambda: fc.conv3x3_relu_pool(x1, w1, b1)),
        plain_ms=cuda_ms(lambda: fc.conv3x3_relu_pool_plain(x1, w1, b1),
                         reps=5),
        library_ms=cuda_ms(lambda: F.max_pool2d(
            torch.relu(F.conv2d(xn, wn, bn, padding=1)), 2)),
        **bound(byts, flops, "bf16"), shapes=f"x {tuple(x1.shape)} bf16"))

    # K2 ---------------------------------------------------------------
    dec2, enc1, head = seen["k2"]
    o = fc.dec1_head(dec2, enc1, head)
    err, flips, err_unscaled = hold_k2(dec2, enc1, head, DECISIVE_SCALE,
                                       "cli")
    unscaled = dict(head, w_oc=head["w_oc"] / DECISIVE_SCALE,
                    b_oc=head["b_oc"] / DECISIVE_SCALE)
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
        device_ms=device_ms(lambda: fc.dec1_head(dec2, enc1, head)),
        plain_ms=cuda_ms(lambda: fc.dec1_head_plain(dec2, enc1, head),
                         reps=5),
        library_ms=cuda_ms(lib_k2),
        **bound(byts, flops, "bf16"),
        shapes=f"dec2 {tuple(dec2.shape)} enc1 {tuple(enc1.shape)} bf16"))

    # K3 ---------------------------------------------------------------
    cap = max(5120, engine.max_labels + 1)
    plan512 = _coord_plan(*labels512.shape[1:], force_split=True)
    rows.append(dict(
        name="K3 component_tables", route="cuda",
        source="unetdc_tpu_torch/csrc/component_tables.cu",
        replaces="unetdc_tpu/ops/pallas_props.py:181",
        launches=launches.get("component_tables", 0),
        max_abs_err=0.0,  # k3_timing holds it equal to the plain version
        **k3_timing(labels, cap),
        plain_ms=cuda_ms(lambda: component_tables_plain(labels, *plan,
                                                        cap=cap), reps=5),
        library_ms=cuda_ms(k3_library(labels, cap)),
        at_512x512=dict(
            k3_timing(labels512, cap),
            plain_ms=cuda_ms(lambda: component_tables_plain(
                labels512, *plan512, cap=cap), reps=5),
            library_ms=cuda_ms(k3_library(labels512, cap)))))
    return rows, seen


def rolling_ball_rows(launches):
    """The rolling-ball kernel (ksize 50) on blob images at the main
    path's shapes: the quantifier's gray (8, 1, 1024, 1024) planes and the
    trainer's permuted (8, 3, 512, 512) view. Each held torch.equal to the
    plain chain; bound: each plane read and written once, and two passes
    of one min/max a pixel for each column the widest run adds and each
    footprint row past the first."""
    import torch

    from unetdc_tpu_torch.ops.rolling_ball import (
        footprint_table, rolling_ball_correction,
        rolling_ball_correction_plain)
    from unetdc_tpu_torch.utils.device_profile import make_blob_images

    k = 50
    table, (_, _, left, right) = footprint_table(k)
    gray = torch.from_numpy(make_blob_images(BATCH, 1024, 1024, seed=21,
                                             gray=True)[..., 0]).cuda()
    rgb = torch.from_numpy(make_blob_images(BATCH, 512, 512, seed=22)).cuda()
    rows = []
    for what, x in (("gray", gray[:, None]),
                    ("permuted HWC view", rgb.permute(0, 3, 1, 2))):
        same = torch.equal(rolling_ball_correction(x, k),
                           rolling_ball_correction_plain(x, k))
        check(same, f"rolling ball disagrees with its plain version at "
              f"{tuple(x.shape)}")
        px = x.numel()
        rows.append(dict(
            name="RB rolling_ball", route="cuda",
            source="unetdc_tpu_torch/csrc/rolling_ball.cu",
            replaces="none (XLA shifts: unetdc_tpu/ops/rolling_ball.py)",
            launches=launches.get("rolling_ball", 0), torch_equal=same,
            ms=cuda_ms(lambda: rolling_ball_correction(x, k)),
            device_ms=device_ms(lambda: rolling_ball_correction(x, k)),
            plain_ms=cuda_ms(lambda: rolling_ball_correction_plain(x, k),
                             reps=5),
            library_ms=None,
            **bound(2 * px, 2 * px * (left + right + len(table) - 1), "f32"),
            shapes=f"planes {tuple(x.shape)} uint8 ({what}), ksize {k}"))
    return rows


def row_shards(t, S, n):
    """t (B, H, ...) cut into S row shards, each with n halo rows from its
    neighbours (zeros past the image): the `ext` kernels' inputs."""
    import torch

    from unetdc_tpu_torch.core.mesh import halo

    return halo(list(torch.chunk(t, S, 1)), n, 1)


def ext_kernel_rows(seen):
    """K1 and K2 in `ext` mode on row shards of the main path's inputs:
    2 and 4 shards reassembled `torch.equal` to the unsharded kernel in
    bf16 and f32 (every edge-flag pattern: top, interior, bottom shards),
    each held to its plain `ext` version, and the top shard of 2 timed
    against its bound and the library call on the same slab."""
    import torch
    import torch.nn.functional as F

    from unetdc_tpu_torch.ops import fused_conv as fc

    rows = []
    x1, w1, b1 = seen["k1"]
    for xx, ww in ((x1, w1), (x1.float(), w1.float())):
        y, p = fc.conv3x3_relu_pool(xx, ww, b1)
        for S in (2, 4):
            parts = [fc.conv3x3_relu_pool(sh, ww, b1, ext=True)
                     for sh in row_shards(xx, S, 1)]
            check(torch.equal(torch.cat([q[0] for q in parts], 1), y)
                  and torch.equal(torch.cat([q[1] for q in parts], 1), p),
                  f"K1 ext {xx.dtype} S={S}: shards != unsharded kernel")
    s0 = row_shards(x1, 2, 1)[0]
    y, p = fc.conv3x3_relu_pool(s0, w1, b1, ext=True)
    yr, pr = fc.conv3x3_relu_pool_plain(s0, w1, b1, ext=True)
    err = max(float((y.float() - yr.float()).abs().max()),
              float((p.float() - pr.float()).abs().max()))
    check(torch.allclose(y.float(), yr.float(), atol=1e-2, rtol=1e-2)
          and torch.allclose(p.float(), pr.float(), atol=1e-2, rtol=1e-2),
          f"K1 ext bf16 disagrees with its plain version (max err {err})")
    s32 = row_shards(x1.float(), 2, 1)[0]
    y32, p32 = fc.conv3x3_relu_pool(s32, w1.float(), b1, ext=True)
    yr32, pr32 = fc.conv3x3_relu_pool_plain(s32, w1.float(), b1, ext=True)
    err32 = float((y32 - yr32).abs().max())
    check(torch.allclose(y32, yr32, atol=2e-5, rtol=1e-5)
          and torch.allclose(p32, pr32, atol=2e-5, rtol=1e-5),
          f"K1 ext f32 disagrees with its plain version (max err {err32})")
    B, H, W, C = y.shape
    sn = s0.permute(0, 3, 1, 2)
    wn = w1.permute(3, 2, 0, 1).contiguous()
    bn = b1.to(s0.dtype)
    rows.append(dict(
        name="K1_ext conv3x3_relu_pool(ext)", route="cuda",
        source="unetdc_tpu_torch/csrc/fused_conv.cu",
        replaces="unetdc_tpu/ops/pallas_conv.py:260",
        max_abs_err=err, max_abs_err_f32=err32,
        shards_bit_equal={"bf16": [2, 4], "f32": [2, 4]},
        ms=cuda_ms(lambda: fc.conv3x3_relu_pool(s0, w1, b1, ext=True)),
        device_ms=device_ms(lambda: fc.conv3x3_relu_pool(s0, w1, b1,
                                                         ext=True)),
        plain_ms=cuda_ms(lambda: fc.conv3x3_relu_pool_plain(
            s0, w1, b1, ext=True), reps=5),
        library_ms=cuda_ms(lambda: F.max_pool2d(torch.relu(F.conv2d(
            sn, wn, bn, padding=(0, 1))), 2)),
        **bound(nbytes(s0, y, p, w1, b1), 2 * B * H * W * C * 64 * 9,
                "bf16"),
        shapes=f"x {tuple(s0.shape)} bf16 (top shard of 2)"))

    dec2, enc1, head = seen["k2"]
    unscaled = dict(head, w_oc=head["w_oc"] / DECISIVE_SCALE,
                    b_oc=head["b_oc"] / DECISIVE_SCALE)
    h32 = {k: (v.float() if v.dtype == torch.bfloat16 else v)
           for k, v in unscaled.items()}
    for d, e, hd in ((dec2, enc1, head), (dec2.float(), enc1.float(), h32)):
        o = fc.dec1_head(d, e, hd)
        for S in (2, 4):
            parts = [fc.dec1_head(a, b, hd, ext=True,
                                  edge_flags=(i == 0, i == S - 1))
                     for i, (a, b) in enumerate(zip(row_shards(d, S, 1),
                                                    row_shards(e, S, 2)))]
            check(torch.equal(torch.cat(parts, 1), o),
                  f"K2 ext {e.dtype} S={S}: shards != unsharded kernel")
    d0, e0 = row_shards(dec2, 2, 1)[0], row_shards(enc1, 2, 2)[0]
    flags = (1, 0)
    o = fc.dec1_head(d0, e0, head, ext=True, edge_flags=flags)
    orf = fc.dec1_head_plain(d0, e0, head, ext=True, edge_flags=flags)
    err = float((o - orf).abs().max())
    flips = float(((o > 0.3) != (orf > 0.3)).float().mean())
    check(flips < 1e-3, f"K2 ext bf16 0.3-mask mismatch {flips}")
    err_unscaled = float((fc.dec1_head(d0, e0, unscaled, True, flags)
                          - fc.dec1_head_plain(d0, e0, unscaled, True, flags)
                          ).abs().max())
    check(err_unscaled < 0.05, f"K2 ext bf16 |dprob| {err_unscaled}")
    d32, e32 = d0.float(), e0.float()
    o32 = fc.dec1_head(d32, e32, h32, True, flags)
    or32 = fc.dec1_head_plain(d32, e32, h32, True, flags)
    err32 = float((o32 - or32).abs().max())
    check(torch.allclose(o32, or32, atol=3e-6, rtol=1e-5),
          f"K2 ext f32 disagrees with its plain version (max err {err32})")
    B, H, W, _ = o.shape
    dt = enc1.dtype
    w_up = head["w_up"].permute(2, 3, 0, 1).contiguous()
    w0n = head["w0"].permute(3, 2, 0, 1).contiguous()
    w1n = head["w1"].permute(3, 2, 0, 1).contiguous()
    wocn = head["w_oc"].view(1, 64, 1, 1)
    bias = {k: head[k].to(dt) for k in ("b_up", "b0", "b1", "b_oc")}
    d2n, e1n = d0.permute(0, 3, 1, 2), e0.permute(0, 3, 1, 2)

    def lib_k2():  # the library chain on the same slabs (no edge masks)
        up = F.conv_transpose2d(d2n, w_up, bias["b_up"], stride=2)
        hh = torch.relu(F.conv2d(torch.cat([up, e1n], 1), w0n, bias["b0"],
                                 padding=(0, 1)))
        d1 = torch.relu(F.conv2d(hh, w1n, bias["b1"], padding=(0, 1)))
        return torch.sigmoid(F.conv2d(d1, wocn, bias["b_oc"]).float())

    rows.append(dict(
        name="K2_ext dec1_head(ext)", route="cuda",
        source="unetdc_tpu_torch/csrc/fused_conv.cu",
        replaces="unetdc_tpu/ops/pallas_conv.py:425",
        max_abs_err=err, mask_mismatch=flips,
        max_abs_err_unscaled_head=err_unscaled,
        max_abs_err_f32_unscaled_head=err32,
        shards_bit_equal={"bf16": [2, 4], "f32": [2, 4]},
        ms=cuda_ms(lambda: fc.dec1_head(d0, e0, head, True, flags)),
        device_ms=device_ms(lambda: fc.dec1_head(d0, e0, head, True, flags)),
        plain_ms=cuda_ms(lambda: fc.dec1_head_plain(d0, e0, head, True,
                                                    flags), reps=5),
        library_ms=cuda_ms(lib_k2),
        **bound(nbytes(d0, e0, o, *head.values()),
                2 * B * H * W * (128 * 64 + 128 * 64 * 9 + 64 * 64 * 9 + 64),
                "bf16"),
        shapes=f"dec2 {tuple(d0.shape)} enc1 {tuple(e0.shape)} bf16 "
               "(top shard of 2, flags (1, 0))"))
    return rows


def batch_split_divergence(params, x, dilations):
    """The first library call of the kernel forward whose output on the
    whole batch differs from its outputs on the two halves (in call order):
    where a batch split changes the arithmetic."""
    import torch
    import torch.nn.functional as F

    from unetdc_tpu_torch.models.unet_fast import forward_folded

    names = ("conv2d", "conv_transpose2d", "max_pool2d")

    def record(xx):
        seen, orig = [], {n: getattr(F, n) for n in names}

        def wrap(n):
            def f(*a, **k):
                out = orig[n](*a, **k)
                seen.append((n, tuple(a[0].shape), out))
                return out
            return f

        try:
            for n in names:
                setattr(F, n, wrap(n))
            forward_folded(params, xx, dilations)
        finally:
            for n in names:
                setattr(F, n, orig[n])
        return seen

    half = x.shape[0] // 2
    whole, a, b = record(x), record(x[:half]), record(x[half:])
    for i, ((n, shape, o), (_, _, oa), (_, _, ob)) in enumerate(
            zip(whole, a, b)):
        if not torch.equal(o, torch.cat([oa, ob])):
            return {"call": i, "of": len(whole), "op": n,
                    "input_shape": list(shape),
                    "max_abs_diff": float((o - torch.cat([oa, ob])).float()
                                          .abs().max())}
    return None


def sharded_phase(work: Path, img_dir: Path, ckpt: Path, cb):
    """Multi-device inference on meshes over the one card repeated (see
    the docstring, phase 5b)."""
    import numpy as np
    import torch

    from unetdc_tpu_torch.core.mesh import make_mesh
    from unetdc_tpu_torch.io.images import decode_rgb
    from unetdc_tpu_torch.models.unet_fast import (forward_folded,
                                                   forward_folded_spmd)
    from unetdc_tpu_torch.pipelines.engine import grayscale_view, load_engine
    from unetdc_tpu_torch.pipelines.quantify_batch import BatchQuantifyPipeline

    t0 = time.perf_counter()
    card = torch.device("cuda", 0)

    def mesh(nd, ns):
        return make_mesh(nd, ns, devices=[card] * (nd * ns))

    def pipeline(precision, m, shard_space, out):
        eng = load_engine(str(ckpt), mesh=m, fast=(precision == "bf16"),
                          shard_space=shard_space)
        pipe = BatchQuantifyPipeline(eng, str(out), batch=BATCH,
                                     px_per_micron=PX_PER_UM,
                                     save_overlays=True)
        pipe.run(str(img_dir), progress=False)
        pipe.write_reports(skip_excel=True, skip_histogram=True)
        return eng

    r = {"phase": "sharded", "card_repeated": True, "failed": []}

    def hold(cond, what):  # every comparison is reported before a failure
        if not cond:
            r["failed"].append(what)
    # the counted sharded path: f32 engine, mesh (2,2), shard_space
    pipeline("f32", mesh(2, 2), True, work / "sh_warm")
    torch.cuda.synchronize()
    cb.reset_launches()
    eng = pipeline("f32", mesh(2, 2), True, work / "sh22")
    torch.cuda.synchronize()
    r["launches"] = dict(cb.LAUNCHES)
    for k in ("conv3x3_relu_pool_ext", "dec1_head_ext", "component_tables"):
        hold(r["launches"].get(k, 0) >= 1,
             f"sharded path: {k} never launched")
    mis, csv = compare_runs(img_dir, work / "sh22", work / "k32")
    r["f32_mesh_2x2_shard_space_vs_f32_cli"] = {
        "mask_mismatch": mis, "csv_differ": csv,
        "megastep_ms": eng.megastep_ms}
    hold(mis == 0 and csv == 0, f"f32 (2,2) shard_space pipeline vs the "
         f"f32 CLI: masks {mis}, CSVs {csv}")
    pipeline("f32", mesh(2, 1), False, work / "sh21")
    mis, csv = compare_runs(img_dir, work / "sh21", work / "k32")
    r["f32_mesh_2x1_vs_f32_cli"] = {"mask_mismatch": mis, "csv_differ": csv}
    hold(mis == 0 and csv == 0, f"f32 (2,1) pipeline vs the f32 CLI: "
         f"masks {mis}, CSVs {csv}")
    eng = pipeline("bf16", mesh(2, 1), False, work / "shb21")
    mis, csv = compare_runs(img_dir, work / "shb21", work / "out")
    r["bf16_mesh_2x1_vs_cli"] = {"mask_mismatch": mis, "csv_differ": csv,
                                 "megastep_ms": eng.megastep_ms}
    hold(mis < 5e-2, f"bf16 (2,1) pipeline mask mismatch {mis}")
    run_cli(img_dir, ckpt, work / "dp1", extra=["--data_parallel", "1"])
    mis, csv = compare_runs(img_dir, work / "dp1", work / "out")
    r["cli_data_parallel_1_vs_cli"] = {"mask_mismatch": mis,
                                       "csv_differ": csv}
    hold(mis == 0 and csv == 0, f"--data_parallel 1 vs the CLI: masks "
         f"{mis}, CSVs {csv}")

    # forward_folded_spmd against the unsharded kernel forward, on both
    # size buckets' engine inputs (RGB 512x512; grayscale 600x800 resized)
    imgs = sorted(Path(img_dir).glob("*.png"))
    r["forward"] = {}
    with torch.no_grad():
        for precision in ("f32", "bf16"):
            e = load_engine(str(ckpt), fast=(precision == "bf16"))
            rows = {}
            for bucket, group in (("512 rgb", imgs[:BATCH]),
                                  ("600x800 gray", imgs[BATCH:2 * BATCH])):
                batch = grayscale_view(np.stack([decode_rgb(p)
                                                 for p in group]))
                x = e._preprocess(torch.from_numpy(batch).cuda(), 50, True)
                ref = forward_folded(e.params, x, e._dilations)
                for nd, ns in ((2, 1), (1, 2), (1, 4), (2, 2)):
                    torch.cuda.synchronize()
                    cb.reset_launches()
                    got = forward_folded_spmd({card: e.params}, x,
                                              e._dilations, mesh=mesh(nd, ns))
                    torch.cuda.synchronize()
                    n = dict(cb.LAUNCHES)
                    row = {
                        "max_abs_dprob": float((got - ref).abs().max()),
                        "mask_mismatch": float(((got > 0.3) != (ref > 0.3))
                                               .float().mean()),
                        "launches": {k: n.get(k, 0) for k in (
                            "conv3x3_relu_pool", "conv3x3_relu_pool_ext",
                            "dec1_head", "dec1_head_ext")}}
                    rows[f"{bucket} {nd}x{ns}"] = row
                    if precision == "f32":
                        hold(torch.equal(got > 0.3, ref > 0.3),
                             f"f32 forward_folded_spmd {nd}x{ns} {bucket}: "
                             "masks differ")
                    else:
                        hold(row["mask_mismatch"] < 5e-2,
                             f"bf16 forward_folded_spmd {nd}x{ns} {bucket}: "
                             f"mismatch {row['mask_mismatch']}")
                rows[f"{bucket} batch_split_first_divergence"] = \
                    batch_split_divergence(e.params, x, e._dilations)
            r["forward"][precision] = rows
            del e
    r["seconds"] = time.perf_counter() - t0
    return r


def k3_library(labels, cap):
    """K3's library yardstick on `labels`: zero_ + scatter_add_ of the
    same per-label count and coordinate-chunk sums into a (B*(cap+1),
    nfeat) int32 table (out-of-range labels go to a spill row)."""
    import torch

    from unetdc_tpu_torch.ops.connected_components import _coord_plan

    B, h, w = labels.shape
    shifts, bits = _coord_plan(h, w, force_split=True)
    nfeat = 1 + 2 * len(shifts)
    m = (1 << bits) - 1
    pidx = torch.arange(h * w, device="cuda")
    feats = torch.stack([torch.ones_like(pidx)]
                        + [((pidx // w) >> s) & m for s in shifts]
                        + [((pidx % w) >> s) & m for s in shifts],
                        -1).to(torch.int32).repeat(B, 1)
    lab64 = labels.reshape(B, -1).long()
    ok = (lab64 >= 0) & (lab64 < cap)
    idx = (torch.where(ok, lab64, cap) + (cap + 1) * torch.arange(
        B, device="cuda")[:, None]).reshape(-1, 1).expand(-1, nfeat)
    tab = torch.zeros(B * (cap + 1), nfeat, dtype=torch.int32, device="cuda")

    def lib_k3():
        tab.zero_()
        tab.scatter_add_(0, idx, feats)

    return lib_k3


def k3_timing(labels, cap):
    """K3 held to its plain version on `labels`, with its event and device
    times and its bound (the labels read once, the table written once)."""
    import torch

    from unetdc_tpu_torch.ops.component_tables import (
        component_tables, component_tables_plain)
    from unetdc_tpu_torch.ops.connected_components import _coord_plan

    plan = _coord_plan(*labels.shape[1:], force_split=True)
    t = component_tables(labels, *plan, cap=cap)
    check(torch.equal(t, component_tables_plain(labels, *plan, cap=cap)),
          f"K3 disagrees with its plain version at {tuple(labels.shape)}, "
          f"cap {cap}")
    n_in = int(((labels >= 0) & (labels < cap)).sum())
    r = dict(shapes=f"labels {tuple(labels.shape)} int32, cap {cap}, "
                    f"plan {plan}",
             components_max=int(labels.amax()),
             ms=cuda_ms(lambda: component_tables(labels, *plan, cap=cap)),
             device_ms=device_ms(lambda: component_tables(labels, *plan,
                                                          cap=cap)),
             **bound(nbytes(labels, t), n_in * t.shape[-1], "f32"))
    r["frac_of_bound_device"] = r["bound_ms"] / r["device_ms"]
    return r


def blob_labels(seed: int = 11, b: int = BATCH, h: int = 600, w: int = 800):
    """Seeded (b, h, w) int32 labels of 2-6 px blobs, one in ~85% of the
    4x4 cells (row 3 and column 3 of each cell stay empty), numbered by
    scipy.ndimage.label in raster order: ~25K components an image, runs of
    one label 2-3 pixels long, as the engine's overflow re-runs see."""
    import numpy as np
    from scipy import ndimage as ndi

    rng = np.random.RandomState(seed)
    ch, cw = h // 4, w // 4
    out = np.zeros((b, h, w), np.int32)
    for i in range(b):
        on = rng.rand(ch, cw) < 0.85
        bh, bw = rng.randint(1, 3, (ch, cw)), rng.randint(2, 4, (ch, cw))
        oy, ox = rng.randint(0, 4 - bh), rng.randint(0, 4 - bw)
        cells = np.zeros((ch, 4, cw, 4), bool)
        for dy in range(3):
            for dx in range(3):
                cells[:, dy, :, dx] = (on & (dy >= oy) & (dy < oy + bh)
                                       & (dx >= ox) & (dx < ox + bw))
        out[i], _ = ndi.label(cells.reshape(h, w))
    return out


def k3_overflow_cases():
    """K3 on scipy-labelled blob batches at the engine's overflow caps
    (8193, 32769) and at a cap whose table takes the global-atomics path;
    each exactly equal to the plain version."""
    import torch

    from unetdc_tpu_torch.ops.component_tables import cluster_max_cap

    caps = (8193, 32769, 262145)
    check(caps[1] <= cluster_max_cap(2) < caps[2],
          f"K3 cluster capacity {cluster_max_cap(2)}: the caps {caps} no "
          "longer cover both paths")
    labels = torch.from_numpy(blob_labels()).cuda()
    return [dict(k3_timing(labels, cap),
                 path="cluster" if cap <= cluster_max_cap(2) else "global")
            for cap in caps]


def stage_times(engine, img_dir):
    """Card time of each megastep stage for one batch of each size bucket
    (`utils/device_profile.py::timed`: CUDA events, the card synchronised
    after each stage; warm)."""
    import numpy as np
    import torch

    from unetdc_tpu_torch.io.images import decode_rgb
    from unetdc_tpu_torch.ops.connected_components import quantify_mask_batch
    from unetdc_tpu_torch.ops.resize import resize_linear_u8_cv2exact
    from unetdc_tpu_torch.pipelines.engine import grayscale_view
    from unetdc_tpu_torch.utils.device_profile import timed

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


# ---------------------------------------------------------------- train --
TRAIN_PAIRS = 16


def make_train_set(d: Path, seed: int = 16):
    """16 seeded pairs of a 512x512 RGB image (bright disks on dark noise)
    and its mask (the disks, 255)."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    for sub in ("images", "masks"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[:512, :512]
    for i in range(TRAIN_PAIRS):
        img = (rng.rand(512, 512, 3) * 60).astype(np.uint8)
        mask = np.zeros((512, 512), np.uint8)
        for _ in range(30):
            cy, cx = rng.randint(16, 496, 2)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.randint(4, 16) ** 2
            img[blob] = np.minimum(img[blob].astype(np.int32) + 150, 255)
            mask[blob] = 255
        Image.fromarray(img).save(d / "images" / f"t{i:02d}.png")
        Image.fromarray(mask).save(d / "masks" / f"t{i:02d}.png")


def plotting_modules() -> dict:
    """Which of the CLIs' plotting modules this machine has."""
    import importlib.util

    return {m: importlib.util.find_spec(m) is not None
            for m in ("matplotlib", "seaborn")}


def have_plotting() -> bool:
    return all(plotting_modules().values())


def run_train(train_dir: Path, out_dir: Path, epochs: int,
              resume: bool = False):
    """The port's train_dc_focal CLI (bf16, batch 8, cuda) run in `out_dir`
    (it writes its plots and artifact folders to the working directory);
    returns (trainer, stdout). Without matplotlib/seaborn the CLI cannot
    draw its plots, so Trainer.fit and the test phase are driven directly
    with the CLI's settings."""
    from unetdc_tpu_torch.cli.train_dc_focal import main

    ckpt = out_dir / "best_UNetDC_focal_model.msgpack"
    argv = ["--image_dir", str(train_dir / "images"), "--mask_dir",
            str(train_dir / "masks"), "--epochs", str(epochs), "--batch",
            str(BATCH), "--precision", "bf16", "--device", "cuda",
            "--ckpt_path", str(ckpt)]
    if resume:
        argv += ["--resume", "--skip_test"]
    out_dir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    buf = io.StringIO()
    try:
        os.chdir(out_dir)
        with contextlib.redirect_stdout(buf):
            trainer = (main(argv) if have_plotting()
                       else fit_without_plots(argv))
    finally:
        os.chdir(cwd)
    return trainer, buf.getvalue()


def fit_without_plots(argv):
    """train_dc_focal's steps without its matplotlib/seaborn artifacts."""
    from unetdc_tpu_torch.checkpoint.native import load_checkpoint
    from unetdc_tpu_torch.cli.train_dc_focal import build_parser
    from unetdc_tpu_torch.data.dataset import (SegmentationData,
                                               discover_pairs, split_dataset)
    from unetdc_tpu_torch.train.test_phase import run_test_phase
    from unetdc_tpu_torch.train.trainer import TrainConfig, Trainer

    a = build_parser().parse_args(argv)
    (tr, trm), (va, vam), (te, tem) = split_dataset(
        *discover_pairs(a.image_dir, a.mask_dir))
    trainer = Trainer(TrainConfig(
        num_epochs=a.epochs, batch_size=a.batch, ckpt_path=a.ckpt_path,
        save_val_masks_dir=a.val_masks_dir, resume=a.resume), device="cuda")

    def mk(il, ml, sh):
        return SegmentationData(a.image_dir, a.mask_dir, il, ml,
                                batch_size=a.batch, shuffle=sh, seed=a.seed)

    trainer.fit(mk(tr, trm, True), mk(va, vam, False))
    if not a.skip_test:
        trainer.variables = load_checkpoint(a.ckpt_path)
        trainer.run_epoch_eval(mk(te, tem, False), a.test_masks_dir)
        run_test_phase(trainer, mk(te, tem, False), a.diff_map_dir,
                       a.overlay_dir)
    return trainer


EPOCH_LINE = re.compile(r"Epoch (\d+)/(\d+) \| Train Loss: (\S+), "
                        r"Val Loss: (\S+), Train Dice: (\S+), "
                        r"Val Dice: (\S+)")


def train_phase(work: Path, cb):
    """Two epochs through the CLI with its test phase, a third resumed
    from `.last`, then the port's quantify CLI on the trained checkpoint."""
    import torch

    t0 = time.perf_counter()
    data = work / "train_set"
    make_train_set(data)
    out = work / "train_run"
    trainer, log = run_train(data, out, epochs=2)
    epochs = [m.groups() for m in EPOCH_LINE.finditer(log)]
    check(len(epochs) == 2, f"expected 2 epoch lines, got {len(epochs)}")
    losses = [float(v) for e in epochs for v in e[2:4]]
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(all(math.isfinite(v) for k in ("train_loss", "val_loss")
              for v in trainer.history[k]), "non-finite history")
    check("Model saved!" in log, "no 'Model saved!'")
    ckpt = out / "best_UNetDC_focal_model.msgpack"
    files = [str(ckpt) + s for s in ("", ".meta.json", ".opt", ".last",
                                     ".state.json")]
    check(all(os.path.exists(f) for f in files), "checkpoint files")
    check("Test Dice:" in log or not have_plotting(), "no test phase")
    check(len(list((out / "overlay_diff_test").glob("*.png"))) == 4,
          "test-phase overlays")
    two_epochs_s = time.perf_counter() - t0
    _, log3 = run_train(data, out, epochs=3, resume=True)
    check("Resumed from" in log3 and "Epoch 3/3" in log3,
          "the resumed third epoch")
    e3 = [m.groups() for m in EPOCH_LINE.finditer(log3)]
    check(len(e3) == 1 and math.isfinite(float(e3[0][2])), "epoch 3 loss")

    torch.cuda.synchronize()
    cb.reset_launches()
    pipe = run_cli(data / "images", ckpt, work / "quant_trained")
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)
    for k in ("conv3x3_relu_pool", "dec1_head", "component_tables"):
        check(launches.get(k, 0) >= 1,
              f"{k} not launched quantifying the trained checkpoint")
    n_drop = check_artifacts(data / "images", work / "quant_trained",
                             need_droplets=False)
    return {"phase": "train", "pairs": TRAIN_PAIRS, "split": "9/3/4",
            "ran_through": ("cli.train_dc_focal.main" if have_plotting()
                            else "Trainer.fit + test phase (matplotlib/"
                                 "seaborn absent)"),
            "plots": plotting_modules(),
            "epochs": [{"epoch": int(e[0]), "train_loss": float(e[2]),
                        "val_loss": float(e[3]), "train_dice": float(e[4]),
                        "val_dice": float(e[5])} for e in epochs + e3],
            "two_epochs_with_test_phase_s": two_epochs_s,
            "resumed": True, "files": [os.path.basename(f) for f in files],
            "quantified_trained_msgpack": {
                "images": TRAIN_PAIRS, "droplets": n_drop,
                "launches": launches,
                "megastep_ms_median": statistics.median(
                    pipe.engine.megastep_ms)}}


def train_step_timing(work: Path, warmup: int = 3, reps: int = 20):
    """The train step alone on one device-resident batch of 8 at 512x512,
    bf16, from fresh weights (cuDNN's autotuning falls in the warm-up)."""
    import numpy as np
    import torch

    from unetdc_tpu_torch.io.images import decode_rgb
    from unetdc_tpu_torch.train.trainer import TrainConfig, Trainer
    from unetdc_tpu_torch.utils.device_profile import forward_flops
    from PIL import Image

    tr = Trainer(TrainConfig(batch_size=BATCH, compute_dtype="bf16"),
                 device="cuda")
    names = sorted((work / "train_set" / "images").glob("*.png"))[:BATCH]
    imgs = torch.from_numpy(np.stack([decode_rgb(p) for p in names])).cuda()
    masks = torch.from_numpy(np.stack([
        (np.array(Image.open(work / "train_set" / "masks" / p.name)) > 0)
        .astype(np.uint8) for p in names])).cuda()
    x, m = tr.preprocess(imgs, masks)
    m = m[..., None]
    valid = torch.ones(BATCH, device="cuda")
    for _ in range(warmup):
        tr.train_step(x, m, valid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    losses = []
    t0 = time.perf_counter()
    for a, b in ev:
        a.record()
        losses.append(tr.train_step(x, m, valid)[0])
        b.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    ms = [a.elapsed_time(b) for a, b in ev]
    step_ms = statistics.median(ms)
    losses = [float(v) for v in losses]
    flops = 3 * forward_flops(BATCH, 512)
    r = {"phase": "train_step", "batch": BATCH, "size": "512x512",
         "dtype": "bf16", "steps": reps, "step_ms_median": step_ms,
         "step_ms_min": min(ms), "step_ms_max": max(ms),
         "wall_ms_per_step": wall * 1e3,
         "img_per_s": BATCH / (step_ms / 1e3),
         "model_tflop_per_step": flops / 1e12,
         "bound_ms": flops / PEAK_OPS["bf16"] * 1e3,
         "mfu": flops / (step_ms / 1e3) / PEAK_OPS["bf16"],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "loss_first": losses[0], "loss_last": losses[-1]}
    r["device_profile"] = profile_step(lambda: tr.train_step(x, m, valid),
                                       step_ms)
    check(all(math.isfinite(v) for v in losses), "non-finite step loss")
    check(losses[-1] < losses[0],
          f"loss did not fall over the timed steps: {losses}")
    return r


KERNEL_CLASSES = (
    ("conv (cuDNN)", re.compile(r"conv|cudnn|xmma|implicit|wgrad|dgrad|"
                                r"fprop|sm90|cutlass|gemm", re.I)),
    ("adam", re.compile(r"adam", re.I)),
    ("batchnorm/elementwise/reduce", re.compile(r".")))
INT8_CLASSES = (
    ("int8 product (cuBLASLt)", re.compile(r"gemm|imma|xmma|sm90|cutlass|"
                                           r"cublas", re.I)),
    ("copies and fills (im2col, padding, dtype conversions)",
     re.compile(r"copy|fill|cat|index", re.I)),
    ("requant/pool/elementwise", re.compile(r".")))


def profile_step(fn, step_ms: float, top: int = 12,
                 classes=KERNEL_CLASSES):
    """Device time of one call of `fn` by kernel class and the top
    kernels (torch.profiler, CUDA activity), and the share of the step's
    event time in which no kernel ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    by_class = {c: 0.0 for c, _ in classes}
    for name, (t, _) in per_name.items():
        c = next(c for c, rx in classes if rx.search(name))
        by_class[c] += t
    busy = sum(by_class.values())
    return {"device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / step_ms),
            "by_class_ms": by_class,
            "top_kernels": [{"name": n[:90], "ms": t, "count": k} for n, (t, k)
                            in sorted(per_name.items(),
                                      key=lambda kv: -kv[1][0])[:top]]}


def card_vs_cpu_step(work: Path):
    """One train step at 128x128, batch 2, from the same seeded weights on
    the card and on the CPU, in f32 (TF32 off) and in f64. The conv biases
    that precede a BatchNorm (true gradient 0) are left out.
      - f32: loss within 1e-5 relative; every gradient within 1e-4
        relative L2 of the CPU's, except where f32 itself cannot hold 1e-4:
        behind the deep train-mode BatchNorms (8x8 to 32x32 maps at this
        size) the backward pass cancels ~1000-fold, so the rounding of the
        card's f32 reductions shows (the CPU accumulates them in f64). The
        card's own floor is the same step computed another valid f32 way:
        the batch in the other order and NCHW memory instead of
        channels-last (other cuDNN and BatchNorm kernels, other reduction
        orders; the same gradient in exact arithmetic). Where that floor
        passes 2.5e-5, the card must be within 4x it of the CPU. The
        BatchNorm scale and shift gradients are single f32 sums over
        N*H*W terms that largely cancel, rounded alike by both of the
        card's kernels but not by the CPU's f64 accumulation: held within
        1e-3.
      - f64: every gradient within 1e-6 relative L2 of the CPU's: the card
        computes the same function, the f32 gaps are rounding."""
    import numpy as np
    import torch

    from unetdc_tpu_torch.io.images import decode_rgb
    from unetdc_tpu_torch.train.trainer import TrainConfig, Trainer
    from PIL import Image

    cfg = TrainConfig(img_size=128, batch_size=2, compute_dtype="f32",
                      augment=False, seed=3)
    names = sorted((work / "train_set" / "images").glob("*.png"))[:2]
    imgs = np.stack([decode_rgb(p) for p in names])
    masks = np.stack([(np.array(Image.open(
        work / "train_set" / "masks" / p.name)) > 0).astype(np.uint8)
        for p in names])
    grads, loss = {}, {}
    for run, dev, dt, order in (
            ("card", "cuda", torch.float32, [0, 1]),
            ("card_other", "cuda", torch.float32, [1, 0]),
            ("cpu", "cpu", torch.float32, [0, 1]),
            ("card_f64", "cuda", torch.float64, [0, 1]),
            ("cpu_f64", "cpu", torch.float64, [0, 1])):
        tr = Trainer(cfg, device=dev)
        tr.model.to(dt).compute_dtype = dt
        x, m = tr.preprocess(torch.from_numpy(imgs[order]).to(dev),
                             torch.from_numpy(masks[order]).to(dev))
        if run == "card_other":   # NCHW memory under the model's permute
            x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        met = tr.train_step(x.to(dt), m[..., None].to(dt),
                            torch.ones(2, device=dev, dtype=dt))
        loss[run] = float(met[0])
        grads[run] = {n: p.grad.detach().double().cpu()
                      for n, p in tr.model.named_parameters()}

    def rel(run, ref, n):
        return float((grads[run][n] - grads[ref][n]).norm()
                     / grads[ref][n].norm())

    rows = {}
    for n in grads["cpu"]:
        parts = n.split(".")
        if not parts[0].startswith(("upconv", "out_conv")) \
                and parts[1] in ("0", "3") and parts[2] == "bias":
            continue          # conv bias before a BatchNorm
        rows[n] = (rel("card", "cpu", n), rel("card_other", "card", n),
                   rel("card_f64", "cpu_f64", n))
    held = [n for n, r in rows.items() if r[0] <= 1e-4]
    floor = [n for n, r in rows.items() if r[0] > 1e-4 and r[1] > 2.5e-5]
    bn_affine = [n for n in rows if n.split(".")[1] in ("1", "4")]
    bad32 = [n for n, r in rows.items() if n not in held and not (
        n in floor and r[0] <= 4 * r[1]) and not (
        n in bn_affine and r[0] <= 1e-3)]
    bad64 = [n for n, r in rows.items() if r[2] > 1e-6]
    loss_rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    loss_rel64 = abs(loss["card_f64"] - loss["cpu_f64"]) / loss["cpu_f64"]
    worst = max(floor or rows, key=lambda n: rows[n][0] / rows[n][1])
    r = {"phase": "train_f32_card_vs_cpu", "size": "128x128", "batch": 2,
         "loss_card": loss["card"], "loss_cpu": loss["cpu"],
         "loss_rel_diff": loss_rel, "loss_rel_diff_f64": loss_rel64,
         "grads_compared": len(rows), "within_1e-4": len(held),
         "at_f32_floor": len(floor),
         "bn_affine_over_1e-4_not_at_floor": [
             n for n in bn_affine if rows[n][0] > 1e-4 and n not in floor],
         "grad_rel_l2_max_held": max((rows[n][0] for n in held),
                                     default=0.0),
         "floor_worst": {"param": worst, "card_vs_cpu": rows[worst][0],
                         "card_floor": rows[worst][1]},
         "grad_rel_l2_max_f64": max(v[2] for v in rows.values()),
         "failed": bad32 + bad64}
    check(loss_rel <= 1e-5 and loss_rel64 <= 1e-9,
          f"loss card vs CPU: f32 {loss_rel}, f64 {loss_rel64}")
    check(not bad32 and not bad64,
          "gradients card vs CPU (f32 card-cpu, f32 card floor, f64 "
          f"card-cpu relative L2): { {n: rows[n] for n in bad32 + bad64} }")
    return r


# ----------------------------------------------------------- train_mesh --
MESHES = ((2, 1, False), (1, 2, True), (2, 2, True), (1, 4, True))


@contextlib.contextmanager
def seed0_weights_drawn_once():
    """Every Trainer built inside starts from flax's initializers at seed 0,
    drawn once and copied into each model (the draws take seconds for the
    full-width model on the host)."""
    import torch

    from unetdc_tpu_torch.models.unet import UNetDC
    from unetdc_tpu_torch.train import trainer as T

    real = T.init_flax_
    seed0 = real(UNetDC(), torch.Generator().manual_seed(0)).state_dict()

    def init(model, generator):
        if isinstance(model, UNetDC) and generator.initial_seed() == 0:
            model.load_state_dict(seed0)
            return model
        return real(model, generator)

    T.init_flax_ = init
    try:
        yield
    finally:
        T.init_flax_ = real


def train_set_batch(work: Path, device, n: int = BATCH):
    """The first n pairs of the train set as uint8 tensors on `device`."""
    import numpy as np
    import torch
    from PIL import Image

    from unetdc_tpu_torch.io.images import decode_rgb

    names = sorted((work / "train_set" / "images").glob("*.png"))[:n]
    imgs = np.stack([decode_rgb(p) for p in names])
    masks = np.stack([(np.array(Image.open(
        work / "train_set" / "masks" / p.name)) > 0).astype(np.uint8)
        for p in names])
    return (torch.from_numpy(imgs).to(device),
            torch.from_numpy(masks).to(device))


def step_delta(t, ref) -> dict:
    """A trainer's state after one step against the reference's: the
    largest parameter delta and the largest running-statistic delta over
    its buffer's largest magnitude."""
    dp = max(float((a - b).detach().abs().max()) for a, b in zip(
        t.model.parameters(), ref.model.parameters()))
    ds = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(
        t.model.buffers(), ref.model.buffers()) if b.is_floating_point())
    return {"max_param_delta": dp, "bn_stats_rel_diff": ds}


def train_mesh_phase(work: Path, device: str = "cuda", size: int = 512,
                     reps: int = 10):
    """(a)-(c) of phase 6b on meshes over the one card repeated (see the
    docstring); failures are collected in `failed` and raised by the
    caller after the line is printed."""
    import numpy as np
    import torch

    from unetdc_tpu_torch.core import mesh as M
    from unetdc_tpu_torch.data.dataset import (SegmentationData,
                                               discover_pairs, split_dataset)
    from unetdc_tpu_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    dev = M.norm_device(device)
    r = {"phase": "train_mesh", "card_repeated": True, "size": size,
         "batch": BATCH, "failed": []}

    def hold(cond, what):
        if not cond:
            r["failed"].append(what)

    def mesh(nd, ns):
        return M.make_mesh(nd, ns, devices=[dev] * (nd * ns))

    def cfg(dtype, **kw):
        return TrainConfig(batch_size=BATCH, img_size=size, augment=False,
                           compute_dtype=dtype, seed=0, **kw)

    def f32_trainer(*a, **k):
        # the Trainer lets cuDNN time its algorithms for every new shape,
        # which in f32 (no tensor cores) costs minutes over the meshes'
        # shard shapes; the f32 checks take cuDNN's heuristic choice
        t = Trainer(*a, **k)
        torch.backends.cudnn.benchmark = False
        return t

    imgs, masks = train_set_batch(work, dev)
    parts = r["seconds_by_part"] = {}
    with seed0_weights_drawn_once():
        # (a) one f32 step per mesh against one device, TF32 off
        ref = f32_trainer(cfg("f32"), device=dev)
        x, m = ref.preprocess(imgs, masks)
        m = m[..., None]
        ones = np.ones(BATCH, np.float32)
        valid = torch.ones(BATCH, device=dev)
        loss_1 = float(ref.train_step(x, m, valid, ones)[0])
        r["f32_step"] = {"single_loss": loss_1}
        for nd, ns, ss in MESHES:
            t = f32_trainer(cfg("f32", shard_space=ss), mesh=mesh(nd, ns))
            loss = float(t.train_step(x, m, valid, ones)[0])
            row = {"loss": loss, "loss_rel_diff": abs(loss - loss_1)
                   / abs(loss_1), **step_delta(t, ref)}
            r["f32_step"][f"{nd}x{ns}"] = row
            hold(row["loss_rel_diff"] <= 1e-5 and row["max_param_delta"]
                 <= 2.05 * t.cfg.lr and row["bn_stats_rel_diff"] <= 1e-5,
                 f"f32 step on {nd}x{ns}: {row}")
            del t
        # the ragged step: 7 valid samples padded to (2, 1) with a replica
        # of weight 0, against one device on the 7
        ref = f32_trainer(cfg("f32"), device=dev)
        loss_1 = float(ref.train_step(x[:7], m[:7], valid[:7], ones[:7])[0])
        t = f32_trainer(cfg("f32"), mesh=mesh(2, 1))
        xp, mp, vp = M.pad_to_data_axis(x[:7], m[:7], ones[:7], t.mesh)
        loss = float(t.train_step(xp, mp, torch.from_numpy(vp).to(dev),
                                  vp)[0])
        row = {"loss": loss, "single_loss": loss_1,
               "loss_rel_diff": abs(loss - loss_1) / abs(loss_1),
               **step_delta(t, ref)}
        r["f32_step"]["ragged_7_on_2x1"] = row
        hold(xp.shape[0] == 8 and row["loss_rel_diff"] <= 1e-5
             and row["max_param_delta"] <= 2.05 * t.cfg.lr
             and row["bn_stats_rel_diff"] <= 1e-5, f"ragged step: {row}")
        del t, ref
        parts["a_f32_steps"] = time.perf_counter() - t0

        # (b) the bf16 step's event time per mesh (reported, not gated)
        if dev.type == "cuda":
            steps = {}
            for shape in ((1, 1, False),) + MESHES:
                nd, ns, ss = shape
                t = Trainer(cfg("bf16", shard_space=ss),
                            mesh=None if nd * ns == 1 else mesh(nd, ns),
                            device=dev)
                xb, mb = t.preprocess(imgs, masks)
                mb = mb[..., None]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: t.train_step(xb, mb, valid, ones),
                             reps=reps)
                steps[f"{nd}x{ns}"] = {
                    "step_ms_median": ms,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
                if (nd, ns) == (2, 2):
                    steps["2x2"]["device_profile"] = profile_step(
                        lambda: t.train_step(xb, mb, valid, ones), ms)
                del t
            r["bf16_step"] = {"single_device_ms_perf_md": 42.9, **steps}
        parts["b_bf16_timing"] = time.perf_counter() - t0 - sum(
            parts.values())

        # (c) Trainer.fit, f32, on (2, 2) with shard_space: 2 epochs, then
        # a third resumed from `.last`, against 3 epochs on one device
        data = work / "train_set"
        (tr, trm), (va, vam), _ = split_dataset(
            *discover_pairs(str(data / "images"), str(data / "masks")))

        def datasets():  # one pair per run: the shuffle follows its calls
            return [SegmentationData(str(data / "images"),
                                     str(data / "masks"), il, ml,
                                     batch_size=BATCH, shuffle=sh, seed=0)
                    for il, ml, sh in ((tr, trm, True), (va, vam, False))]

        def fit(m_, epochs, ckpt, sets, resume=False):
            c = cfg("f32", num_epochs=epochs, resume=resume, patience=50,
                    shard_space=True, ckpt_path=str(ckpt),
                    save_last=m_ is not None)
            with contextlib.redirect_stdout(io.StringIO()):
                return f32_trainer(c, mesh=m_, device=dev).fit(*sets)

        fit_dir = work / "train_mesh_fit"
        fit_dir.mkdir()
        t1 = time.perf_counter()
        h1 = fit(None, 3, fit_dir / "one.msgpack", datasets())
        t2 = time.perf_counter()
        sets = datasets()
        hm = fit(mesh(2, 2), 2, fit_dir / "mesh.msgpack", sets)
        h3 = fit(mesh(2, 2), 3, fit_dir / "mesh.msgpack", sets, resume=True)
        t3 = time.perf_counter()
        shutil.rmtree(fit_dir)
        hist = {k: hm[k] + h3[k] for k in hm}
        worst = {k: max(abs(a - b) / abs(b) for a, b in zip(hist[k], h1[k]))
                 for k in h1}
        r["fit_2x2_shard_space"] = {
            "epochs_single": len(h1["train_loss"]),
            "epochs_mesh": [len(hm["train_loss"]), len(h3["train_loss"])],
            "history_mesh": hist, "history_single": h1,
            "max_rel_diff": worst, "single_s": t2 - t1, "mesh_s": t3 - t2}
        hold(len(h3["train_loss"]) == 1 and all(
            v <= 2e-4 for v in worst.values()), f"fit on 2x2: {worst}")
    r["seconds"] = time.perf_counter() - t0
    parts["c_fit"] = r["seconds"] - sum(parts.values())
    return r


def int8_sharded(work: Path, img_dir: Path, ckpt: Path, cb, r: dict):
    """(d) of phase 6b: the int8 engine with shard_space on (1, 2) and
    (2, 2), from the int8 phase's sidecar, byte-equal to its unsharded
    run; K3's launches on (2, 2) are the `int8_sharded` path."""
    import torch

    from unetdc_tpu_torch.core.mesh import make_mesh
    from unetdc_tpu_torch.pipelines.engine import load_engine
    from unetdc_tpu_torch.pipelines.quantify_batch import BatchQuantifyPipeline

    t0 = time.perf_counter()
    card = torch.device("cuda", 0)
    sidecar = str(ckpt) + ".int8calib.npz"
    out = {}
    for nd, ns in ((1, 2), (2, 2)):
        eng = load_engine(str(ckpt), quantize="int8", calib_path=sidecar,
                          mesh=make_mesh(nd, ns, devices=[card] * (nd * ns)),
                          shard_space=True)
        torch.cuda.synchronize()
        cb.reset_launches()
        d = work / f"int8_sh{nd}{ns}"
        pipe = BatchQuantifyPipeline(eng, str(d), batch=BATCH,
                                     px_per_micron=PX_PER_UM)
        pipe.run(str(img_dir), progress=False)
        torch.cuda.synchronize()
        launches = dict(cb.LAUNCHES)
        mis, csv = compare_runs(img_dir, d, work / "int8_a")
        out[f"{nd}x{ns}"] = {"mask_mismatch": mis, "csv_differ": csv,
                             "launches": launches,
                             "megastep_ms": eng.megastep_ms}
        if (mis, csv) != (0, 0):
            r["failed"].append(f"int8 shard_space {nd}x{ns} vs unsharded "
                               f"int8: masks {mis}, CSVs {csv}")
        if launches.get("component_tables", 0) < 1:
            r["failed"].append(f"int8 shard_space {nd}x{ns}: K3 never "
                               "launched")
    out["seconds"] = time.perf_counter() - t0
    r["int8_shard_space"] = out
    return out["2x2"]["launches"]


def mesh_dryrun(r: dict):
    """`dryrun_multichip(4)` over the card repeated 4 times."""
    import torch

    from unetdc_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(4, devices=[torch.device("cuda", 0)] * 4)
    r["dryrun_multichip_4"] = {"line": buf.getvalue().strip(),
                               "seconds": time.perf_counter() - t0}


# ------------------------------------------------------------------ gui --

def gui_phase(work: Path, img_dir: Path, ckpt: Path, cb, card: str):
    """The Qt GUI (`gui/qt_app.py`, headless under tests/fake_pyside6.py)
    on the card: its click spawns the port CLI in a child process; then the
    frozen entry's `--cli quantify_droplets_batch` in-process, counted.
    Each run's tables and masks are held byte-equal to an in-process CLI
    run with the same settings (the GUI's argv)."""
    import importlib.util

    import pytest
    import torch

    from unetdc_tpu_torch.cli.quantify_droplets_batch import main as cli
    from unetdc_tpu_torch.gui import build_batch_command, entry, qt_app

    # by path: an installed package named `tests` would shadow the
    # checkout's tests/, which has no __init__.py
    spec = importlib.util.spec_from_file_location(
        "fake_pyside6", ROOT / "tests" / "fake_pyside6.py")
    fake = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake)

    def argv(out):  # the CLI's flags in the GUI's argv
        return build_batch_command(
            str(img_dir), str(ckpt), str(out), batch=BATCH,
            save_overlays=True, skip_excel=True, skip_histogram=True)[3:]

    def drive(app):
        win = fake.created_main_windows[-1]
        win.img_dir.setText(str(img_dir))
        win.ckpt.setText(str(ckpt))
        win.out_dir.setText(str(work / "gui_out"))
        win.batch.setValue(BATCH)
        win.overlays.setChecked(True)
        win.excel.setChecked(False)  # the card's image has no xlsxwriter
        win.hist.setChecked(False)   # nor matplotlib
        win.run_btn.click()  # the fake QThread runs the child to its end

    t0 = time.perf_counter()
    mp = pytest.MonkeyPatch()
    try:
        fake.install(mp)
        # the child CLI imports the package from this checkout
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        fake.exec_hook = drive
        try:
            qt_app.main(["--device", "cuda"])
        except SystemExit as e:
            check(e.code == 0, f"the GUI exited with {e.code}")
        gui_s = time.perf_counter() - t0
        win = fake.created_main_windows[-1]
        boxes = list(fake.message_boxes)
        log = list(win.log.lines)
        tables = (win.summary_table.rows, win.stats_table.rows)
        gallery = sum(isinstance(w, fake.QLabel) for w in (
            win.gallery.inner.layout.items if win.gallery.inner else ()))
        child = win.worker.cmd
    finally:
        mp.undo()
    check(boxes == [], f"gui: message boxes {boxes}")
    check(any("All done" in ln for ln in log), "gui: no 'All done' in the "
          f"log pane; its tail: {log[-20:]}")
    check(tables[0] == 16 and tables[1] >= 3, f"gui: results tables {tables}")
    check(gallery == 32, f"gui: {gallery} overlay gallery labels, not 32")
    check(child[1:3] == ["-m", "unetdc_tpu_torch.cli.quantify_droplets_batch"]
          and child[3:] == argv(work / "gui_out"),
          f"gui: spawned {child}")

    cli(argv(work / "gui_cli"))
    torch.cuda.synchronize()
    cb.reset_launches()
    entry.main(["--cli", "quantify_droplets_batch"] + argv(work / "gui_entry"))
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)
    for k in ("conv3x3_relu_pool", "dec1_head", "component_tables"):
        check(launches.get(k, 0) >= 1, f"gui entry: {k} never launched")
    ref = work / "gui_cli"
    names = ["summary_per_image.csv", "all_droplets.csv"] + sorted(
        str(p.relative_to(ref)) for p in (ref / "predicted_masks").iterdir())
    check(len(names) == 18, f"gui: {len(names) - 2} masks, not 16")
    equal = {run: all((work / run / n).read_bytes() == (ref / n).read_bytes()
                      for n in names) for run in ("gui_out", "gui_entry")}
    check(all(equal.values()), f"gui: artifacts not byte-equal to the "
          f"in-process CLI run: {equal}")
    return {"phase": "gui", "card": card, "gui_run_s": gui_s,
            "seconds": time.perf_counter() - t0, "log_lines": len(log),
            "summary_rows": tables[0], "stats_rows": tables[1],
            "gallery_labels": gallery, "child_argv_tail": child[-12:],
            "files_compared": len(names),
            "byte_equal_to_in_process_cli": equal,
            "entry_launches": launches}


# ------------------------------------------------------------ profilers --
def device_profile_phase(rows, card: str):
    """`utils/device_profile.py::profile_stages(8, 512, int8=True)`: per
    stage the event ms, device ms and idle share; the kernel forward below
    the library forward, and its K1 + K2 device time within 10% of the
    `kernels` line's."""
    from unetdc_tpu_torch.utils.device_profile import profile_stages

    t0 = time.perf_counter()
    res = profile_stages(BATCH, 512, int8=True, verbose=False)
    st = res["stages"]
    for name, r in st.items():
        check(all(math.isfinite(r[k]) and r[k] > 0 for k in
                  ("event_ms", "device_ms")) or name == "resize_u8",
              f"device_profile: {name} {r}")
    kern = st["forward_kernels"]["kernels_ms"]
    k12 = kern.get("K1", 0.0) + kern.get("K2", 0.0)
    line = sum(r["device_ms"] for r in rows
               if r["name"].split()[0] in ("K1", "K2"))
    check(res["forward_kernels"] < res["forward_bf16"],
          f"device_profile: forward_kernels {res['forward_kernels']} s not "
          f"below forward_bf16 {res['forward_bf16']} s")
    check("K1" in kern and "K2" in kern and not st["forward_bf16"][
        "kernels_ms"], f"device_profile: kernels {kern}, library forward "
        f"{st['forward_bf16']['kernels_ms']}")
    check(abs(k12 / line - 1) <= 0.10, f"device_profile: K1 + K2 {k12} ms "
          f"vs the kernels line's {line} ms")
    check("K3" in st["cc+regionprops"]["kernels_ms"],
          "device_profile: K3 not in cc+regionprops")
    keep = ("total", "img_per_s_device", "total_kernels",
            "img_per_s_device_kernels", "total_int8", "img_per_s_device_int8",
            "forward_flops", "forward_mfu", "forward_mfu_bf16", "device")
    return {"phase": "device_profile", "card": card, "batch": BATCH,
            "size": 512, "seconds": time.perf_counter() - t0,
            "stages": st, **{k: res[k] for k in keep},
            "k1_k2_device_ms": k12, "k1_k2_device_ms_kernels_line": line}


def forward_profile_phase(card: str):
    """`utils/forward_profile.py::profile_forward(8, 512)`: the per-block
    table; the rows' useful FLOPs sum to `forward_flops` exactly."""
    from unetdc_tpu_torch.utils.device_profile import forward_flops
    from unetdc_tpu_torch.utils.forward_profile import profile_forward

    t0 = time.perf_counter()
    rows = profile_forward(BATCH, 512, verbose=False)
    blocks = {k: v for k, v in rows.items() if not k.startswith("_")}
    useful = sum(r["useful_flops"] for r in blocks.values())
    check(useful == forward_flops(BATCH, 512),
          f"forward_profile: rows sum to {useful} FLOPs, not "
          f"{forward_flops(BATCH, 512)}")
    for name, r in blocks.items():
        check(math.isfinite(r["ms"]) and r["ms"] > 0
              and r["bound"] in ("compute", "HBM", "sub-floor"),
              f"forward_profile: {name} {r}")
    return {"phase": "forward_profile", "card": card,
            "seconds": time.perf_counter() - t0, "useful_flops_sum": useful,
            "rows": rows}


def epoch_wall_phase(card: str):
    """`utils/epoch_wall.py` at its defaults (144 + 64 images at 512x512,
    batch 8, 4 epochs): its JSON, every number finite; a ratio above 2 is
    reported, not failed."""
    from unetdc_tpu_torch.utils.epoch_wall import run

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run(device="cuda")
    for k, v in res.items():
        check(not isinstance(v, float) or math.isfinite(v),
              f"epoch_wall: {k} = {v}")
    log = [ln for ln in buf.getvalue().splitlines()
           if ln.startswith(("epoch", "mask-saving"))]
    return {"phase": "epoch_wall", "card": card,
            "seconds": time.perf_counter() - t0, **res, "log": log}


# ----------------------------------------------------------------- int8 --
def int8_phase(work: Path, img_dir: Path, ckpt: Path, cb, bf16_engine):
    """The int8 forward through the port CLI, its sidecar, card vs CPU,
    agreement with the f32 kernel path and its time (see the docstring)."""
    import numpy as np
    import torch

    from unetdc_tpu_torch.io.images import decode_rgb
    from unetdc_tpu_torch.models import unet_int8 as qi
    from unetdc_tpu_torch.pipelines.engine import grayscale_view
    from unetdc_tpu_torch.utils.device_profile import forward_flops

    t0 = time.perf_counter()
    sidecar = Path(str(ckpt) + ".int8calib.npz")
    if sidecar.exists():
        sidecar.unlink()
    torch.cuda.synchronize()
    cb.reset_launches()
    pipe = run_cli(img_dir, ckpt, work / "int8_a", int8=True)
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)
    check(launches.get("component_tables", 0) >= 1,
          "int8 path: K3 never launched")
    check(launches.get("conv3x3_relu_pool", 0) == 0
          and launches.get("dec1_head", 0) == 0,
          f"int8 path launched K1/K2: {launches}")
    check(sidecar.exists(), "int8: no calibration sidecar written")
    n_drop = check_artifacts(img_dir, work / "int8_a", need_droplets=False)
    first_ms = list(pipe.engine.megastep_ms)
    pipe2 = run_cli(img_dir, ckpt, work / "int8_b", int8=True)
    eng = pipe2.engine
    check(np.array_equal(eng.calib_maxima, pipe.engine.calib_maxima),
          "int8: the sidecar did not pin the scales")
    rerun_mis, rerun_csv = compare_runs(img_dir, work / "int8_a",
                                        work / "int8_b")
    check(rerun_mis == 0 and rerun_csv == 0,
          f"int8 rerun from the sidecar differs: {rerun_mis}, {rerun_csv}")
    f32_mis, f32_csv = compare_runs(img_dir, work / "int8_a", work / "k32")

    imgs = sorted(Path(img_dir).glob("*.png"))
    rgb = np.stack([decode_rgb(p) for p in imgs[:BATCH]])
    # card vs CPU from the same int8 params, 2 images at 128x128
    qp = qi.build_int8_params(eng._folded, eng.calib_maxima)
    size = eng.img_size
    with torch.no_grad():
        eng.img_size = 128
        x128 = eng._preprocess(torch.from_numpy(rgb[:2]).cuda(), 50, True)
        eng.img_size = size
        pg = qi.forward_int8(qi.prepare_int8_params(qp, "cuda"), x128).cpu()
        pc = qi.forward_int8(qi.prepare_int8_params(qp, "cpu"), x128.cpu())
    card_cpu = float((pg - pc).abs().max())
    card_cpu_mask_eq = bool(torch.equal(pg > 0.3, pc > 0.3))
    check(card_cpu <= 1e-6 and card_cpu_mask_eq,
          f"int8 card vs CPU: |dprob| {card_cpu}, masks {card_cpu_mask_eq}")

    # forward time per batch of 8 at 512x512, int8 vs the bf16 kernels
    with torch.no_grad():
        x = eng._preprocess(torch.from_numpy(grayscale_view(rgb)).cuda(),
                            50, True)
        int8_ms = cuda_ms(lambda: eng.forward_probs(x), reps=10)
        bf16_ms = cuda_ms(lambda: bf16_engine.forward_probs(x), reps=10)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.forward_probs(x)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        prof = profile_step(lambda: eng.forward_probs(x), int8_ms,
                            classes=INT8_CLASSES)
    ops = forward_flops(BATCH, 512)
    return {"phase": "int8", "seconds": time.perf_counter() - t0,
            "images": 16, "droplets": n_drop, "launches": launches,
            "megastep_ms_first_run": first_ms,
            "megastep_ms": eng.megastep_ms,
            "sidecar": sidecar.name, "rerun_mask_mismatch": rerun_mis,
            "rerun_csv_differ": rerun_csv,
            "vs_f32_kernels": {"mask_agreement": 1.0 - f32_mis,
                               "csv_differ": f32_csv},
            "card_vs_cpu_128": {"max_abs_dprob": card_cpu,
                                "mask_equal": card_cpu_mask_eq},
            "forward_ms_b8_512": int8_ms, "bf16_kernel_forward_ms": bf16_ms,
            "x_bf16": int8_ms / bf16_ms, "peak_gb": peak,
            "bound_ms": ops / PEAK_OPS["int8"] * 1e3, "bound_by": "operations",
            "int8_tera_ops": ops / 1e12, "device_profile": prof}


# ------------------------------------------------------------- heatmaps --
def heatmaps_phase(img_dir: Path, ckpt: Path, cb):
    """Both heatmap engines over the 16 images, and each engine's stage on
    the card and on the CPU from the card's masks (see the docstring)."""
    import numpy as np
    import torch

    from unetdc_tpu_torch.io.images import decode_rgb
    from unetdc_tpu_torch.ops.connected_components import remove_small_batch
    from unetdc_tpu_torch.ops.contours import contour_scan
    from unetdc_tpu_torch.ops.roi import gray_of, generate_roi_mask_gray
    from unetdc_tpu_torch.ops.threshold import otsu_threshold
    from unetdc_tpu_torch.ops.filters import gaussian_blur
    from unetdc_tpu_torch.pipelines.engine import (QuantifyEngine,
                                                   grayscale_view,
                                                   load_state_dict)
    from unetdc_tpu_torch.pipelines.heatmaps import (BlobInspectorEngine,
                                                     HeatmapV1Engine)

    t0 = time.perf_counter()
    imgs = sorted(Path(img_dir).glob("*.png"))
    groups = [grayscale_view(np.stack([decode_rgb(p) for p in g]))
              for g in (imgs[:BATCH], imgs[BATCH:2 * BATCH])]
    out = {"phase": "heatmaps", "images": 16}
    for name, cls, kw in (
            ("heatmap_v1", HeatmapV1Engine, {}),
            ("blobinspector", BlobInspectorEngine,
             dict(kernel_size=55, nb_layers=3, contour_thresh=0,
                  contour_min_size=20))):
        eng = cls(load_state_dict(str(ckpt)), device="cuda", **kw)
        for b in groups:  # warm-up
            eng.run_batch(b, b.shape[1:3])
        eng.megastep_ms.clear()
        torch.cuda.synchronize()
        cb.reset_launches()
        res = [eng.run_batch(b, b.shape[1:3]) for b in groups]
        torch.cuda.synchronize()
        launches = dict(cb.LAUNCHES)
        for k in ("conv3x3_relu_pool", "dec1_head", "component_tables",
                  "rolling_ball"):
            check(launches.get(k, 0) >= 1, f"{name}: {k} never launched")
        r = {"launches": launches, "megastep_ms": list(eng.megastep_ms),
             "droplets": int(sum(int(x["count"].sum()) for x in res)),
             "stage": []}
        for b in groups:
            x = torch.from_numpy(b).cuda()
            cap = eng.max_labels
            with torch.no_grad():
                base = QuantifyEngine._megastep(eng, x, 0.3, 1, b.shape[1:3],
                                                50, True, cap)
                gpu = eng.heatmap_stage(x, base["mask"], base, cap)
                stage_ms = cuda_ms(lambda: eng.heatmap_stage(
                    x, base["mask"], base, cap), reps=3, warmup=1)
                cpu = eng.heatmap_stage(
                    x.cpu(), base["mask"].cpu(),
                    {k: v.cpu() for k, v in base.items()}, cap)
                gray = gray_of(x)
                extra_g, extra_c = {}, {}
                if cls is HeatmapV1Engine:
                    for dst, g in ((extra_g, gray), (extra_c, gray.cpu())):
                        bl = torch.clamp(torch.round(gaussian_blur(g)), 0,
                                         255).to(torch.uint8)
                        dst["otsu"] = otsu_threshold(bl)
                        dst["roi"] = generate_roi_mask_gray(g)
                else:
                    for dst, g in ((extra_g, gray), (extra_c, gray.cpu())):
                        dst["remove_small_batch"] = remove_small_batch(
                            contour_scan(g, eng.contour_thresh),
                            eng.contour_min_size, cap, connectivity=2)
            gpu.update(extra_g)
            cpu.update(extra_c)
            row = {"shape": list(b.shape), "stage_ms": stage_ms}
            for k in gpu:
                a, c = gpu[k].cpu(), cpu[k]
                if k == "spatial_u8":
                    d = int((a.int() - c.int()).abs().max())
                    row["spatial_u8_max_level_diff"] = d
                    check(d <= 1, f"{name}: spatial_u8 card vs CPU {d}")
                else:
                    row[f"{k}_equal"] = bool(torch.equal(a, c))
                    check(row[f"{k}_equal"], f"{name}: {k} card != CPU")
            if "otsu" in gpu:
                row["otsu_thresholds"] = gpu["otsu"].tolist()
            r["stage"].append(row)
        out[name] = r
        del eng
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


# -------------------------------------------------------------- library --
LIB_RADII = (25, 50, 100)
LIB_HELD = (0, 1, 8, 9)  # the CPU holds 2 RGB 512x512, 2 gray 600x800


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def host_ms(fn):
    """(result, ms) of one fn() on the host clock, the card synchronised
    before and after."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def same(a, b, rtol: float = 0.0) -> bool:
    """Equality of nested results (arrays, lists, tuples, dicts); float
    arrays within rtol when it is not 0."""
    import numpy as np

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k], rtol)
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y, rtol)
                                        for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if rtol and a.dtype.kind == "f":
        return bool(np.allclose(a, b, rtol=rtol, atol=0.0))
    return bool(np.array_equal(a, b))


def library_functions(imgs, ckpt: str, device: str, masks=None):
    """The library surface on `device`, as a list of (name, fn(i) -> host
    result, image indices, rtol): rtol 0 asks for equality; a float
    result is held at its test's tolerance (tests/test_torch_library.py,
    tests/test_torch_edt_watershed.py, tests/test_torch_blobs.py). Each fn
    reads the outputs of those before it through `state`. With `masks`
    (another device's segmentation_deep_learning outputs), the functions
    that take a mask take those instead of this device's."""
    import numpy as np
    import torch
    from scipy import ndimage as ndi

    from unetdc_tpu_torch import library as L
    from unetdc_tpu_torch.ops import connected_components as CC
    from unetdc_tpu_torch.ops import edt as E
    from unetdc_tpu_torch.ops import regionprops as R

    dev = torch.device(device)
    n = len(imgs)
    state = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def host(d):
        return {k: v.cpu().numpy() for k, v in d.items()}

    def seg(i):
        out = masks[i] if masks is not None else \
            L.segmentation_deep_learning(imgs[i], ckpt, device=device)
        state.setdefault("fg", {})[i] = out > 0
        return out

    def gray(i):
        out = L.convert_to_8_bits(imgs[i])
        state.setdefault("gray", {})[i] = out
        return out

    def fg(i):
        return state["fg"][i]

    def label(i):
        lab, k = CC.label(t(fg(i)), 1)
        state.setdefault("lab", {})[i] = (lab, int(k))
        return lab.cpu().numpy(), int(k)

    def props(i):
        lab, k = state["lab"][i]
        return host(R.regionprops_table(lab, max(k, 1)))

    def csi(i):
        lab, k = state["lab"][i]
        out = R.centroid_size_image(lab, max(k, 1)).cpu().numpy()
        state.setdefault("csi", {})[i] = out
        return out

    def edt(i):
        out = E.distance_transform_edt(t(fg(i)))
        state.setdefault("edt", {})[i] = out
        return out.cpu().numpy()

    def peaks(i):
        c, v = E.peak_local_max_device(state["edt"][i], t(fg(i)), 3, 1024)
        c, v = c.cpu().numpy(), v.cpu().numpy()
        state.setdefault("peaks", {})[i] = c[v]
        return c, v

    def ws_device(i):
        d2 = E.distance_transform_edt_sq(t(fg(i)))
        pk = np.zeros(fg(i).shape, bool)
        pk[tuple(state["peaks"][i].T)] = True
        markers = t(ndi.label(pk)[0].astype(np.int32))
        height = (d2.max() - d2).to(torch.int32)
        return E.watershed_device(height, markers, t(fg(i))).cpu().numpy()

    def ws_custom(i):
        dots, labels = L.watershed_custom(
            fg(i), L.binary_to_dots(fg(i))[::7], device=device)
        return np.asarray(dots), np.asarray(labels)

    def contour(i):
        out = L.contour_scan(state["gray"][i], 30, device=device)
        state.setdefault("contour", {})[i] = out
        return out

    def contour_others(i):
        g = state["gray"][i]
        return [getattr(L, f)(g, 30, device=device) for f in (
            "contour_spreading_4", "contour_spreading_8",
            "contour_shrinking_box")] + [
            L.remove_objects(state["contour"][i], 20, device=device)]

    def density(i):
        c, m, s = state["contour"][i], fg(i), state["csi"][i]
        cy, cx = L.calculate_contours_centroid(c, device=device)
        return ([cy, cx], L.density_map(m, c, 55, device=device),
                L.density_maps(m, c, s, 55, device=device),
                L.get_target(m, c, 3, cy, cx, device=device),
                L.get_targets(m, c, s, 3, cy, cx, device=device))

    def blobs(algo):
        def fn(i):
            x = state["gray"][i].astype(np.float32) / 255.0
            return L.blobs_detection(x, algo, 3, 12, device=device)
        return fn

    every, gray_only = range(n), range(n // 2, n)
    fns = [("segmentation_deep_learning", seg, every, 0.0),
           ("convert_to_8_bits", gray, every, 0.0)]
    for r in LIB_RADII:
        fns.append((f"rolling_ball_r{r}",
                    lambda i, r=r: L.rolling_ball(state["gray"][i], r,
                                                  device=device),
                    gray_only, 0.0))
    fns += [("label", label, every, 0.0),
            ("quantify_mask_adaptive",
             lambda i: host(CC.quantify_mask_adaptive(t(fg(i)), 1)),
             every, 0.0),
            ("regionprops_table", props, every, 1e-6),
            ("centroid_size_image", csi, every, 0.0),
            ("distance_transform_edt", edt, every, 0.0),
            ("peak_local_max_device", peaks, every, 0.0),
            ("watershed_device", ws_device, every, 0.0),
            ("watershed_custom", ws_custom, every, 0.0),
            ("blobs_detection_log", blobs(1), every, 0.0),
            ("blobs_detection_dog", blobs(2), every, 0.0),
            ("blobs_detection_doh", blobs(3), every, 0.0),
            ("contour_scan", contour, every, 0.0),
            ("contours_and_remove_objects", contour_others, every, 0.0),
            ("density_helpers", density, every, 1e-6)]
    return fns


def library_phase(img_dir: Path, ckpt: Path, cb, card: str):
    """The library surface on the card at realistic size, each function
    held to the port on the CPU (see the docstring)."""
    import numpy as np
    import torch

    from unetdc_tpu_torch import library as L
    from unetdc_tpu_torch.io.native import decode_rgb
    from unetdc_tpu_torch.pipelines.engine import load_engine

    t0 = time.perf_counter()
    imgs = [decode_rgb(p) for p in sorted(Path(img_dir).glob("*.png"))]
    imgs = imgs[:BATCH] + [i[..., 0] for i in imgs[BATCH:]]  # gray 2D
    card_fns = library_functions(imgs, str(ckpt), "cuda")
    r = {"phase": "library", "card": card, "images": len(imgs),
         "sizes": ["512x512 rgb", "600x800 gray"], "ms_per_call": {},
         "failed": []}
    card_out = {}
    with torch.no_grad():
        for name, fn, idx, _ in card_fns:      # first-call costs
            for i in (0, BATCH):
                if i in idx:
                    fn(i)
        torch.cuda.synchronize()
        cb.reset_launches()
        for name, fn, idx, _ in card_fns:
            outs = {}
            times = []
            for i in idx:
                outs[i], ms = host_ms(lambda: fn(i))
                times.append(ms)
            card_out[name] = outs
            r["ms_per_call"][name] = statistics.median(times)
            print(f"library: {name} {r['ms_per_call'][name]:.3f} ms/call",
                  file=sys.stderr, flush=True)
        torch.cuda.synchronize()
    r["launches"] = dict(cb.LAUNCHES)
    for k in ("conv3x3_relu_pool", "dec1_head"):
        check(r["launches"].get(k, 0) >= 1, f"library: {k} never launched")

    # the same functions on the CPU: the held images (one per radius for
    # the rolling ball, ~26 s a 600x800 image at r = 100 on the CPU)
    # from the card's masks: the bf16 segmentation itself is held below
    t1 = time.perf_counter()
    cpu_fns = library_functions(imgs, str(ckpt), "cpu",
                                masks=card_out["segmentation_deep_learning"])
    held = {}
    for name, fn, idx, rtol in cpu_fns:
        want = [i for i in LIB_HELD if i in idx]
        if name.startswith("rolling_ball"):
            want = want[:1]
        ok = all([same(card_out[name][i], fn(i), rtol) for i in want])
        if name == "segmentation_deep_learning":
            continue
        print(f"library: {name} held on the CPU: {ok}", file=sys.stderr,
              flush=True)
        held[name] = {"images": want, "equal" if not rtol else
                      f"within_rtol_{rtol:g}": ok}
        if not ok:
            r["failed"].append(name)
    r["held_on_cpu"] = held
    r["cpu_seconds"] = time.perf_counter() - t1

    # K1 and K2 at the library's own shapes (batch 1): their inputs from
    # one segmentation_deep_learning call, held to the plain versions
    key = (str(ckpt), "cuda")
    with capturing(engines=[L._MODEL_CACHE[key]]) as seen:
        L.segmentation_deep_learning(imgs[0], str(ckpt), device="cuda")
    check(seen["K1"] and seen["K2"], "library: K1/K2 inputs not captured")
    r["kernels_held_to_plain"] = hold_captured(seen, DECISIVE_SCALE,
                                               "library")
    del seen

    # segmentation_deep_learning itself with the f32 engine (TF32 off) in
    # the library's cache, on the card and on the CPU: the card's
    # convolutions sum in another order, so a pixel whose probability
    # sits within 1e-3 of the threshold may flip (the masks phase's rule);
    # every flip must be such a pixel, and at most 1e-5 of the library's
    # mask pixels (resized on each device) may differ. The bf16 masks the
    # timed run gave are held to the f32 CPU masks with the masks phase's
    # sanity bound (5e-2).
    bf16_engine = L._MODEL_CACHE[key]
    mis = far = pix = masks_mis = masks_pix = bf_mis = 0
    for d in ("cuda", "cpu"):
        L._MODEL_CACHE[(str(ckpt), d)] = load_engine(str(ckpt), fast=False,
                                                     device=d)
    try:
        for i in LIB_HELD:
            pg, pc = (L._segmentation_probs(L._MODEL_CACHE[(str(ckpt), d)],
                                            imgs[i], torch.device(d))
                      .cpu().numpy() for d in ("cuda", "cpu"))
            flip = (pg > 0.3) != (pc > 0.3)
            mis += int(flip.sum())
            far += int((flip & (np.abs(pc - 0.3) >= 1e-3)).sum())
            pix += flip.size
            mg, mc = (L.segmentation_deep_learning(imgs[i], str(ckpt),
                                                   device=d)
                      for d in ("cuda", "cpu"))
            masks_mis += int((mg != mc).sum())
            masks_pix += mg.size
            bf_mis += int((card_out["segmentation_deep_learning"][i]
                           != mc).sum())
    finally:
        L._MODEL_CACHE.pop((str(ckpt), "cpu"))
        L._MODEL_CACHE[key] = bf16_engine
    r["segmentation_f32_card_vs_cpu"] = {
        "images": list(LIB_HELD), "flips_512": mis,
        "flips_not_near_threshold": far, "flip_fraction": mis / pix,
        "mask_pixels_differ": masks_mis,
        "mask_mismatch": masks_mis / masks_pix}
    r["segmentation_bf16_card_vs_f32_cpu"] = {
        "images": list(LIB_HELD), "mask_mismatch": bf_mis / masks_pix}
    if far or mis / pix > 1e-5 or masks_mis / masks_pix > 1e-5 \
            or bf_mis / masks_pix >= 5e-2:
        r["failed"].append("segmentation_deep_learning")
    fg = [card_out["segmentation_deep_learning"][i] > 0
          for i in range(len(imgs))]
    r["mask_fraction"] = float(np.mean([m.mean() for m in fg]))
    r["droplets_label"] = int(sum(card_out["label"][i][1]
                                  for i in range(len(imgs))))
    r["blobs"] = {a: int(sum(len(b) for b in
                             card_out[f"blobs_detection_{a}"].values()))
                  for a in ("log", "dog", "doh")}
    r["seconds"] = time.perf_counter() - t0
    return r


# --------------------------------------------------------- int8_trained --
def int8_trained_phase(card: str, cb):
    """The trained-checkpoint int8 contract at the JAX package's defaults:
    128 synthetic 256x256 droplet images, 10 epochs (bf16), 16 held-out
    images through the bf16 and the int8 engines. The launch counts are
    zeroed just before and read just after (the `int8_trained` path); the
    bf16 engine's K1, K2 and K3 inputs at 256x256 (and the int8 engine's
    K3 inputs) are captured and held to the plain versions."""
    from unetdc_tpu_torch.utils.int8_trained_eval import train_and_eval_int8

    t0 = time.perf_counter()
    buf = io.StringIO()
    cb.reset_launches()
    with contextlib.redirect_stdout(buf), capturing() as seen:
        out = train_and_eval_int8(device="cuda")
    launches = dict(cb.LAUNCHES)
    wall = time.perf_counter() - t0
    check(out["trained_val_dice"] > 0.5,
          f"int8_trained: training did not take ({out})")
    check(0.0 <= out["int8_trained_agreement_min"]
          <= out["int8_trained_agreement"] <= 1.0,
          f"int8_trained: agreement out of range ({out})")
    for k in ("conv3x3_relu_pool", "dec1_head", "component_tables"):
        check(launches.get(k, 0) >= 1, f"int8_trained: {k} never launched")
    held = hold_captured(seen, 1.0, "int8_trained")
    return {"phase": "int8_trained", "card": card, "images": 128,
            "size": "256x256", "epochs": 10, "held_out": 16, **out,
            "wall_s": wall, "launches": launches,
            "kernels_held_to_plain": held}


# ------------------------------------------------------------ native_io --
def native_io_phase(work: Path, img_dir: Path, card: str):
    """libfastio against PIL on a 600x800 image: decode (PNG, JPEG q90)
    and mask encode, host ms per call (median of 20) and equality."""
    import numpy as np
    from PIL import Image

    from unetdc_tpu_torch.io import images as pil
    from unetdc_tpu_torch.io import native as N

    d = work / "native_io"
    d.mkdir()
    src = pil.decode_rgb(sorted(Path(img_dir).glob("*.png"))[BATCH])
    src[..., 1] = np.roll(src[..., 1], 7, axis=1)  # a true RGB image
    png, jpg = d / "a.png", d / "a.jpg"
    Image.fromarray(src).save(png)
    Image.fromarray(src).save(jpg, quality=90)
    mask = ((src[..., 0] > 100) * 255).astype(np.uint8)
    r = {"phase": "native_io", "card": card,
         "native_available": N.native_available(),
         "shape": list(src.shape[:2]), "host_ms": {}}

    def ms(fn):
        fn()
        times = []
        for _ in range(20):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    for name, p in (("png", png), ("jpeg_q90", jpg)):
        a, b = N.decode_rgb(p), pil.decode_rgb(p)
        r["host_ms"][f"{name}_decode"] = ms(lambda: N.decode_rgb(p))
        r["host_ms"][f"{name}_decode_pil"] = ms(lambda: pil.decode_rgb(p))
        r[f"{name}_equal_pil"] = bool(np.array_equal(a, b))
        r[f"{name}_max_diff_pil"] = int(np.abs(a.astype(int) - b).max())
    for name, fn in (("mask_png_encode", N.encode_png_gray),
                     ("mask_png_encode_pil", pil.encode_png_gray)):
        out = d / f"{name}.png"
        r["host_ms"][name] = ms(lambda: fn(out, mask))
        check(np.array_equal(np.array(Image.open(out)), mask),
              f"native_io: {name} does not decode back to its input")
    check(r["png_equal_pil"], "native_io: PNG decode differs from PIL's")
    check(r["jpeg_q90_max_diff_pil"] <= 2,
          "native_io: JPEG decode more than 2 levels from PIL's")
    return r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from unetdc_tpu_torch.device import resolve_device
        from unetdc_tpu_torch.ops import cuda_build as cb
        from unetdc_tpu_torch.utils import profiling as prof
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    resolve_device("cuda")  # TF32 off for the f32 phases

    t0 = time.perf_counter()
    lib = cb.build()
    cb.lib()
    seconds = time.perf_counter() - t0
    # the host libraries (libfastio, libalgo) are built or found failed
    # here, so no timed run below pays for the compiler
    from unetdc_tpu_torch.io import native as N
    from unetdc_tpu_torch.ops import watershed as W
    t0 = time.perf_counter()
    native = {"fastio": N.native_available(),
              "algo": W._load_algo() is not None,
              "seconds": time.perf_counter() - t0}
    emit({"phase": "build", "seconds": seconds,
          "library": str(lib.relative_to(ROOT)), "native": native})

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
        prof.reset_stages()
        t0 = time.perf_counter()
        pipe = run_cli(img_dir, ckpt, work / "out")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cb.LAUNCHES)
        host_split = prof.stage_totals()
        n_drop = check_artifacts(img_dir, work / "out")
        ms = pipe.engine.megastep_ms
        # before the process's first torch.profiler session: once one has
        # traced the card, a CUDA child process (the GUI's CLI) leaves
        # this process's later sessions without device activity
        card = card_label()
        gui = gui_phase(work, img_dir, ckpt, cb, card)
        prof.reset_stages()
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run_cli(img_dir, ckpt, work / "prof_out",
                    extra=["--profile", str(work / "prof")])
        prof_wall = time.perf_counter() - t1
        traces = list((work / "prof").glob("*.pt.trace.json"))
        report = buf.getvalue()
        check(len(traces) == 1 and "stage timings:" in report,
              "--profile wrote no trace or no stage report")
        emit({"phase": "cli", "images": 16, "seconds": wall,
              "e2e_img_per_s": 16 / wall, "megastep_ms": ms,
              "megastep_ms_median": statistics.median(ms),
              "device_img_per_s": BATCH * len(ms) / (sum(ms) / 1e3),
              "droplets": n_drop, "launches": launches,
              "host_split_s": host_split,
              "profile": {"seconds": prof_wall,
                          "stage_totals_s": prof.stage_totals(),
                          "stage_report": report[
                              report.index("stage timings:"):].split(
                                  "\n All done")[0].splitlines(),
                          "trace_bytes": traces[0].stat().st_size}})
        for name in ("host_decode", "h2d_upload", "device_fetch",
                     "host_write_artifacts", "host_csv"):
            check(name in host_split, f"stage {name} not timed")
        for k in ("conv3x3_relu_pool", "dec1_head", "component_tables",
                  "rolling_ball"):
            check(launches.get(k, 0) >= 1, f"{k} never launched")
        emit(gui)

        rows, seen = kernel_rows(pipe.engine, img_dir, work / "out",
                                 launches)
        rows += ext_kernel_rows(seen)
        del seen
        rows += rolling_ball_rows(launches)
        for r in rows:
            r["frac_of_bound"] = r["bound_ms"] / r["ms"]
            r["frac_of_bound_device"] = r["bound_ms"] / r["device_ms"]
            if r["library_ms"] is not None:
                r["x_library"] = r["ms"] / r["library_ms"]
        emit({"phase": "k3_overflow", "cases": k3_overflow_cases()})
        emit({"phase": "stages",
              "ms": stage_times(pipe.engine, img_dir)})
        # every kernel must beat its library yardstick, where it has one
        for r in rows:
            if r["library_ms"] is not None:
                check(r["ms"] < r["library_ms"],
                      f"{r['name']}: {r['ms']:.3f} ms, slower than the "
                      f"library call ({r['library_ms']:.3f} ms)")
        emit(device_profile_phase(rows, card))
        emit(forward_profile_phase(card))

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
        sharded = sharded_phase(work, img_dir, ckpt, cb)
        emit(sharded)
        check(not sharded["failed"], f"sharded: {sharded['failed']}")

        train = train_phase(work, cb)
        emit(train)
        emit(train_step_timing(work))
        emit(card_vs_cpu_step(work))
        tmesh = train_mesh_phase(work)
        tmesh["card"] = card
        int8 = int8_phase(work, img_dir, ckpt, cb, pipe.engine)
        emit(int8)
        int8_sh = int8_sharded(work, img_dir, ckpt, cb, tmesh)
        mesh_dryrun(tmesh)
        emit(tmesh)
        check(not tmesh["failed"], f"train_mesh: {tmesh['failed']}")
        heat = heatmaps_phase(img_dir, ckpt, cb)
        emit(heat)
        lib = library_phase(img_dir, ckpt, cb, card)
        emit(lib)
        check(not lib["failed"], f"library: {lib['failed']}")
        i8t = int8_trained_phase(card, cb)
        emit(i8t)
        emit(native_io_phase(work, img_dir, card))
        emit(epoch_wall_phase(card))
        paths = {"cli": launches, "gui_entry": gui["entry_launches"],
                 "train_quantify": train["quantified_trained_msgpack"][
                     "launches"],
                 "int8_cli": int8["launches"],
                 "heatmap_v1": heat["heatmap_v1"]["launches"],
                 "blobinspector": heat["blobinspector"]["launches"],
                 "sharded": sharded["launches"],
                 "int8_sharded": int8_sh,
                 "library": lib["launches"],
                 "int8_trained": i8t["launches"]}
        keys = {"K1": "conv3x3_relu_pool", "K2": "dec1_head",
                "K3": "component_tables",
                "K1_ext": "conv3x3_relu_pool_ext", "K2_ext": "dec1_head_ext",
                "RB": "rolling_ball"}
        for r in rows:
            k = keys[r["name"].split()[0]]
            r["launches_by_path"] = {p: n.get(k, 0) for p, n in paths.items()}
            if k.endswith("_ext"):
                r["launches"] = sharded["launches"].get(k, 0)
        emit({"kernels": rows})
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(card_label(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
