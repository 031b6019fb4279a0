"""Entry kind `library_segment`: one closed-loop BlobInspector caller of
`unetdc_tpu_torch.library.segmentation_deep_learning(image, ckpt_path)`,
back to back on images decoded in set-up, cycling through them. One unit
is one call; it returns the mask on the host.

The check compares, for each image, the last call's outputs with the
plain reference recomputed from the same image and weights (float
resize to 512, the float32 forward, threshold, cv2 uint8 resize back):
  - probabilities: the forward's (512, 512) output as the library's
    engine returned it, captured on the device;
  - masks: the returned mask against the reference's: the fraction of
    the pixels the reference decides firmly (`reference/compare.py`) that
    differ.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import core
from harness.weights import inference_state_dict
from reference import compare as ref_cmp
from reference import model as ref_model
from reference import ops as ref_ops
from traffic import droplet_images


def setup(ctx):
    from unetdc_tpu_torch import library

    wl = ctx.workload
    imgs = make_inputs(ctx)
    ckpt = ctx.tmp / "weights.pth"
    torch.save(ctx.keep["state_dict"], str(ckpt))
    state = {"lib": library, "ckpt": str(ckpt), "imgs": imgs, "k": 0,
             "masks": {}, "probs": {}, "cur": None, "undo": [],
             "thresh": ctx.config["inference"]["prob_thresh"]}
    for i in range(wl["traffic"]["warmup_calls"]):
        library.segmentation_deep_learning(
            imgs[i % len(imgs)], str(ckpt), state["thresh"],
            device=ctx.device.type)
    engine = library._MODEL_CACHE[(str(ckpt), str(ctx.device))]
    orig = engine.forward_probs

    def forward_probs(x, mesh=None):
        out = orig(x, mesh)
        state["probs"][state["cur"]] = out.detach()[0, :, :, 0].clone()
        return out

    engine.forward_probs = forward_probs
    state["undo"].append(lambda: delattr(engine, "forward_probs"))
    return state


def instrument(ctx, state):
    from unetdc_tpu_torch.ops import resize

    sp = ctx.spans
    state["undo"] += [
        sp.wrap(resize, "resize_linear", "resize_in"),
        sp.wrap(resize, "resize_mask_linear_round", "resize_out"),
    ]


def unit(ctx, state):
    i = state["k"] % len(state["imgs"])
    state["k"] += 1
    state["cur"] = i
    t0 = time.perf_counter()
    with ctx.spans.span("segmentation_call"):
        mask = state["lib"].segmentation_deep_learning(
            state["imgs"][i], state["ckpt"], state["thresh"],
            device=ctx.device.type)
    ms = (time.perf_counter() - t0) * 1e3
    state["masks"][i] = mask
    return {"attempted": 1, "failed": 0, "ms": ms}


def release(ctx, state):
    for undo in reversed(state["undo"]):
        undo()
    ctx.keep["probs"] = {i: p.cpu() for i, p in state["probs"].items()}
    ctx.keep["masks"] = state["masks"]
    state["lib"]._MODEL_CACHE.clear()


def reference_input(ctx, img: np.ndarray) -> torch.Tensor:
    """An (H, W, 3) uint8 image -> the reference's (1, 3, S, S) float32
    input: / 255, float cv2 resize to S."""
    size = ctx.config["input_size"]
    x = torch.as_tensor(img, device=ctx.device).to(torch.float32) / 255.0
    x = ref_ops.resize_float(x, (size, size))
    return x.permute(2, 0, 1)[None].contiguous()


def make_inputs(ctx):
    """The images, and the weights scaled on the first (kept on the
    host in ctx.keep)."""
    cfg = ctx.config
    imgs, _ = droplet_images.make_images(ctx.workload["traffic"]["images"],
                                         core.sub_seed(ctx.seed, 2))
    sd = inference_state_dict(core.sub_seed(ctx.seed, 1), ctx.device,
                              reference_input(ctx, imgs[0]), cfg["dilations"],
                              **cfg["synthetic_weights"])
    ctx.keep.update(state_dict={k: v.cpu() for k, v in sd.items()},
                    images=imgs)
    return imgs


def reference_probs(ctx, img: np.ndarray, quant=None) -> torch.Tensor:
    dev = ctx.device
    sd = ctx.keep.setdefault("sd_dev", {
        k: v.to(dev, torch.float32) for k, v in ctx.keep["state_dict"].items()})
    with torch.no_grad():
        return torch.sigmoid(ref_model.forward(
            sd, reference_input(ctx, img), ctx.config["dilations"],
            quant=quant))[0, 0]


def compare(ctx, probs_prog: dict, masks_prog: dict) -> dict:
    thresh = ctx.config["inference"]["prob_thresh"]
    diff = tot = 0
    p_prog, p_ref = [], []
    for i, mask in sorted(masks_prog.items()):
        img = ctx.keep["images"][i]
        p = reference_probs(ctx, img)
        ref, decisive = ref_cmp.reference_masks(p[None], thresh,
                                                img.shape[:2])
        d, t = ref_cmp.mask_counts(np.asarray(mask) // 255, ref[0],
                                   decisive[0])
        diff += d
        tot += t
        p_prog.append(probs_prog[i].cpu())
        p_ref.append(p.cpu())
    p_prog, p_ref = torch.stack(p_prog), torch.stack(p_ref)
    return {"logit_gap": ref_cmp.logit_gap(p_prog, p_ref),
            "mask_mismatch": diff / tot}


def check(ctx):
    vals = compare(ctx, ctx.keep["probs"], ctx.keep["masks"])
    limits = ctx.workload["limits"]
    return {k: {"value": vals[k], "limit": limits[k]} for k in limits}


def control(ctx, quant):
    """The check's numbers with the reference computed at `quant` (the
    conv operands rounded to fp8) in the program's place."""
    imgs = make_inputs(ctx)
    thresh = ctx.config["inference"]["prob_thresh"]
    probs, masks = {}, {}
    for i, img in enumerate(imgs):
        p = reference_probs(ctx, img, quant=quant)
        probs[i] = p
        masks[i] = ref_ops.resize_u8((p > thresh).to(torch.uint8)[None],
                                     img.shape[:2])[0].cpu().numpy() * 255
    return compare(ctx, probs, masks)
