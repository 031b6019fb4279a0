"""Entry kind `quantify_cli`: the batch quantifier as a biologist runs it,
`unetdc_tpu_torch.cli.quantify_droplets_batch.main`, in process, once per
folder. The workload file and the configuration are the one source of the
traffic: batch, background radius and label cap (the workload's),
threshold and precision (the configuration's) go to the CLI as arguments,
so a change of the CLI's defaults changes nothing here. One unit is one
CLI call over the folder that set-up wrote; every call re-reads and
re-decodes it and writes a new output tree, which is counted and then
deleted (the last is kept for the check).

The check compares the last folder of the window with the plain reference
(`reference/`), recomputed from the same PNG files and the same weights:
  - probabilities: the forward's (B, 512, 512) output of every batch of
    that folder, captured on the device as the CLI's engine returns it,
    against the float32 reference's;
  - masks: the written mask PNGs against the reference's thresholded and
    resized masks: the fraction of the pixels the reference decides
    firmly (`reference/compare.py`) that differ;
  - tables: each written droplet CSV against the reference's labelling
    and properties of the written mask itself (images that differ; the
    limit is 0).
"""

from __future__ import annotations

import csv
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

from harness import core
from harness.weights import inference_state_dict
from reference import compare as ref_cmp
from reference import model as ref_model
from reference import ops as ref_ops
from traffic import droplet_images


def _argv(state, img_dir, out_dir, extra=()):
    return (["--img_dir", str(img_dir), "--ckpt_path", str(state["ckpt"]),
             "--out_dir", str(out_dir), "--device", str(state["device"])]
            + list(state["traffic_args"]) + list(extra))


def traffic_args(ctx) -> list:
    t, inf = ctx.workload["traffic"], ctx.config["inference"]
    return ["--batch", str(t["batch"]),
            "--background_radius", str(t["background_radius"]),
            "--max_labels", str(t["max_labels"]),
            "--prob_thresh", repr(inf["prob_thresh"]),
            "--precision", inf["compute_dtype"]]


def reference_input(ctx, imgs: np.ndarray) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> the reference's (B, 3, S, S) float32 input:
    rolling ball per channel, cv2 resize to S, / 255."""
    size = ctx.config["input_size"]
    b, h, w = imgs.shape[:3]
    planes = torch.as_tensor(imgs, device=ctx.device).permute(0, 3, 1, 2)
    planes = ref_ops.rolling_ball(planes.reshape(-1, h, w),
                                  ctx.workload["traffic"]["background_radius"])
    return ref_ops.resize_u8(planes, (size, size)).reshape(
        b, 3, size, size).to(torch.float32) / 255.0


def make_inputs(ctx):
    """The image folder and the weights (.pth) under the run's directory;
    the weights are scaled on the folder's first image."""
    from PIL import Image

    cfg, wl = ctx.config, ctx.workload
    folder = ctx.tmp / "images"
    drops = droplet_images.write_folder(folder, wl["traffic"]["images"],
                                        core.sub_seed(ctx.seed, 2))
    first = np.array(Image.open(sorted(folder.iterdir())[0]))[None]
    sd = inference_state_dict(core.sub_seed(ctx.seed, 1), ctx.device,
                              reference_input(ctx, first), cfg["dilations"],
                              **cfg["synthetic_weights"])
    sd = {k: v.cpu() for k, v in sd.items()}
    ckpt = ctx.tmp / "weights.pth"
    torch.save(sd, str(ckpt))
    ctx.keep.update(state_dict=sd, folder=folder, drops=drops)
    return ckpt, folder


def setup(ctx):
    from unetdc_tpu_torch.cli import quantify_droplets_batch as cli
    from unetdc_tpu_torch.pipelines import engine as eng

    ckpt, folder = make_inputs(ctx)
    state = {"cli": cli, "ckpt": ckpt, "folder": folder, "k": 0,
             "device": ctx.device.type,
             "traffic_args": traffic_args(ctx),
             "probs": [], "kept": None}
    # capture each batch's probabilities as the engine returns them (a
    # device copy; the last folder's are kept for the check)
    orig = eng.QuantifyEngine.forward_probs

    def forward_probs(self, x, mesh=None):
        out = orig(self, x, mesh)
        state["probs"].append(out.detach()[..., 0].clone())
        return out

    eng.QuantifyEngine.forward_probs = forward_probs
    state["undo"] = [lambda: setattr(eng.QuantifyEngine, "forward_probs",
                                     orig)]
    # warm-up: one batch of the same images, through the same call
    warm = ctx.tmp / "warm"
    warm.mkdir()
    names = sorted(p.name for p in folder.iterdir())
    for n in names[:ctx.workload["traffic"]["batch"]]:
        (warm / n).symlink_to(folder / n)
    cli.main(_argv(state, warm, ctx.tmp / "warm_out"))
    shutil.rmtree(ctx.tmp / "warm_out")
    state["names"] = [Path(n).stem for n in names]
    return state


def instrument(ctx, state):
    """Host spans around the calls the CLI makes into each layer."""
    from unetdc_tpu_torch.pipelines import engine as eng
    from unetdc_tpu_torch.pipelines import quantify_batch as qb

    sp = ctx.spans
    state["undo"] += [
        sp.wrap(eng, "load_engine", "load_engine"),
        sp.wrap(qb.BatchQuantifyPipeline, "_write_batch_outputs",
                "write_outputs"),
        sp.wrap(qb.BatchQuantifyPipeline, "write_reports", "write_reports"),
        sp.wrap(eng.QuantifyEngine, "fetch_batch", "fetch_batch"),
        sp.wrap(eng.QuantifyEngine, "_megastep", "megastep_enqueue"),
        sp.wrap(qb, "list_images", "list_images"),
    ]


def unit(ctx, state):
    from unetdc_tpu_torch.utils.profiling import reset_stages, stage_totals

    out = ctx.tmp / f"out{state['k']}"
    state["k"] += 1
    state["probs"] = []
    reset_stages()
    with ctx.spans.span("cli_call"):
        pipe = state["cli"].main(_argv(state, state["folder"], out))
    stages = stage_totals()
    written = sum((out / "predicted_masks" / f"{n}_pred.png").exists()
                  and (out / f"{n}_droplets.csv").exists()
                  for n in state["names"])
    if state["kept"] is not None:
        shutil.rmtree(state["kept"])
    state["kept"] = out
    n = len(state["names"])
    return {"attempted": n, "failed": n - written, "images": written,
            "stages": stages, "megastep_ms": list(pipe.engine.megastep_ms)}


def describe(records) -> str:
    """One line on where a run's time went, for the run's stderr."""
    imgs = sum(r["images"] for r in records)
    ms = [m for r in records for m in r["megastep_ms"]]
    st = {}
    for r in records:
        for k, v in r["stages"].items():
            st[k] = st.get(k, 0.0) + v
    return (f"megastep_ms_mean {sum(ms) / max(len(ms), 1):.2f} "
            + " ".join(f"{k}_ms_per_img {v / max(imgs, 1) * 1e3:.2f}"
                       for k, v in sorted(st.items())))


def release(ctx, state):
    for undo in reversed(state["undo"]):
        undo()
    ctx.keep["probs"] = [p.cpu() for p in state["probs"]]
    ctx.keep["out"] = state["kept"]
    ctx.keep["names"] = state["names"]
    state["probs"] = []


def _read_table(path: Path) -> np.ndarray:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return np.array([[float(v) for v in r[1:6]] for r in rows[1:]],
                    np.float64).reshape(-1, 5)


def compare(ctx, probs_prog, out_dir: Path) -> dict:
    """The check's numbers for one folder's outputs."""
    from PIL import Image

    cfg = ctx.config
    keep = ctx.keep
    sd = {k: v.to(ctx.device, torch.float32)
          for k, v in keep["state_dict"].items()}
    thresh = cfg["inference"]["prob_thresh"]
    batch = ctx.workload["traffic"]["batch"]
    names = keep["names"]
    diff_px = tot_px = bad_tables = 0
    p_prog, p_ref, comps = [], [], []
    for bi in range(0, len(names), batch):
        group = names[bi:bi + batch]
        imgs = np.stack([np.array(Image.open(keep["folder"] / f"{n}.png"))
                         for n in group])
        with torch.no_grad():
            probs = torch.sigmoid(ref_model.forward(
                sd, reference_input(ctx, imgs), cfg["dilations"]))[:, 0]
            ref_mask, decisive = ref_cmp.reference_masks(
                probs, thresh, imgs.shape[1:3])
        p_prog.append(probs_prog[bi // batch][:len(group)].cpu())
        p_ref.append(probs.cpu())
        for j, n in enumerate(group):
            m = np.array(Image.open(out_dir / "predicted_masks"
                                    / f"{n}_pred.png")) // 255
            d, t = ref_cmp.mask_counts(m, ref_mask[j], decisive[j])
            diff_px += d
            tot_px += t
            table = _read_table(out_dir / f"{n}_droplets.csv")
            want = ref_ops.droplet_table(m)
            bad_tables += not (table.shape == want.shape
                               and np.array_equal(table, want))
            comps.append(len(want))
    p_prog, p_ref = torch.cat(p_prog), torch.cat(p_ref)
    drawn = [len(d) for d in keep["drops"]]
    print("info components_per_image "
          f"{np.mean(comps):.2f} droplets_drawn_per_image "
          f"{np.mean(drawn):.2f} ratio {np.sum(comps) / np.sum(drawn):.4f}",
          file=sys.stderr)
    return {"logit_gap": ref_cmp.logit_gap(p_prog, p_ref),
            "mask_mismatch": diff_px / tot_px,
            "table_mismatch": float(bad_tables)}


def check(ctx):
    vals = compare(ctx, ctx.keep["probs"], ctx.keep["out"])
    limits = ctx.workload["limits"]
    return {k: {"value": vals[k], "limit": limits[k]} for k in limits}


def control(ctx, extra):
    """The check's numbers for one CLI call with `extra` arguments (the
    program's own lower-precision path, --int8) in place of the timed
    call; run after set-up, without a window."""
    state = setup(ctx)
    state["probs"] = []
    out = ctx.tmp / "control_out"
    state["cli"].main(_argv(state, state["folder"], out, extra))
    state["kept"] = out
    release(ctx, state)
    return compare(ctx, ctx.keep["probs"], out)
