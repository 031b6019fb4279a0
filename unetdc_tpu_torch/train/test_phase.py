"""Test-phase visualizations: difference maps and overlays per test image
(train_DC_focal.py:406-449); port of the JAX package's
`train/test_phase.py`. Masks resize with TRUE nearest (keyword
interpolation at :422-423); the overlay base is the PREPROCESSED model
input (rolling-ball corrected) scaled back to [0, 255] and INTER_LINEAR
resized to the original size (:439-444), not the raw file."""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from unetdc_tpu_torch.data.dataset import SegmentationData
from unetdc_tpu_torch.data.prefetch import Prefetcher
from unetdc_tpu_torch.ops.diffmap import (create_difference_map,
                                          overlay_difference)
from unetdc_tpu_torch.ops.resize import resize_linear_u8, resize_nearest


def _predict(trainer, batch, thresh: float):
    """(x on the device, pred (B,S,S) uint8, true (B,S,S) uint8, x as
    numpy) of one batch in eval mode."""
    x, m, _, _ = trainer._device_batch(batch)
    probs = trainer.predict_probs(x)
    pred = (probs[..., 0] > thresh).to(torch.uint8)
    return pred, m[..., 0].to(torch.uint8), x


def _img_u8(x: torch.Tensor) -> torch.Tensor:
    """A preprocessed (S,S,3) image in [0, 1] back to uint8."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def run_extra_test_visualizations(trainer, data: SegmentationData,
                                  out_dir: str = ".",
                                  masks_dir: str = "predicted_masks_test"):
    """The reference's extra test-set passes (train_DC_focal.py:506-611):

    1. a second `predicted_masks_test/` dump — threshold 0.3, INTER_NEAREST
       resize to the original size, `{base}_pred.png` (:509-537);
    2. 3-panel `prediction_visualization_test_batch{b}_img{i}.png` figures —
       original / true mask / predicted mask at 512 (:541-554), up to 3 per
       batch;
    3. 3-panel `differences_overlay_batch{b}_img{i}.png` figures — original /
       diff map / overlay at the original size (:556-611), every image.

    The reference shadows its batch index with the inner loop variable, so
    its figures all save under the last image's index; like the JAX
    package, this implements the intent (per-(batch, image) filenames)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    mask_out = os.path.join(out_dir, masks_dir)
    os.makedirs(mask_out, exist_ok=True)
    thresh = 0.3  # hard-coded in the reference pass (:517)
    for bi, batch in enumerate(Prefetcher(data.batches())):
        pred, true, x = _predict(trainer, batch, thresh)
        oh, ow = batch["orig_size"]
        for j in range(batch["n_valid"]):
            pred_o = (resize_nearest(pred[j], (oh, ow)) * 255).cpu().numpy()
            base = os.path.splitext(batch["filenames"][j])[0]
            save_path = os.path.join(mask_out, f"{base}_pred.png")
            Image.fromarray(pred_o.astype(np.uint8)).save(save_path)
            print(f"Saved predicted mask to: {save_path}")
        imgs512 = x.cpu().numpy()
        pred_np, true_np = pred.cpu().numpy(), true.cpu().numpy()
        for i in range(min(3, batch["n_valid"])):
            plt.figure(figsize=(10, 5))
            plt.subplot(1, 3, 1)
            plt.imshow(np.clip(imgs512[i], 0, 1))
            plt.title("Original Image")
            plt.subplot(1, 3, 2)
            plt.imshow(true_np[i], cmap="gray")
            plt.title("True Mask")
            plt.subplot(1, 3, 3)
            plt.imshow(pred_np[i], cmap="gray")
            plt.title("Predicted Mask")
            plt.savefig(os.path.join(
                out_dir, f"prediction_visualization_test_batch{bi}_img{i}.png"))
            plt.close()
        for j in range(batch["n_valid"]):
            img512 = _img_u8(x[j])
            diff = create_difference_map(true[j], pred[j])
            if (oh, ow) != tuple(diff.shape[:2]):
                diff = resize_nearest(diff, (oh, ow), dims=(0, 1))
                img_o = resize_linear_u8(img512, (oh, ow))
            else:
                img_o = img512
            overlay = overlay_difference(img_o, diff)
            plt.figure(figsize=(12, 6))
            for k, (title, panel) in enumerate(
                    (("Original", img_o), ("Diff Map", diff),
                     ("Overlayed", overlay))):
                plt.subplot(1, 3, k + 1)
                plt.title(title)
                plt.imshow(panel.cpu().numpy())
                plt.axis("off")
            plt.tight_layout()
            plt.savefig(os.path.join(
                out_dir, f"differences_overlay_batch{bi}_img{j}.png"))
            plt.close()


def run_test_phase(trainer, data: SegmentationData, diff_map_dir: str,
                   overlay_dir: str):
    """Per test image: `{base}_diffmap.png` (true vs predicted at the
    original size) and `{base}_overlay.png` (train_DC_focal.py:406-449)."""
    os.makedirs(diff_map_dir, exist_ok=True)
    os.makedirs(overlay_dir, exist_ok=True)
    thresh = trainer.cfg.metric_thresh
    for batch in Prefetcher(data.batches()):
        pred, true, x = _predict(trainer, batch, thresh)
        oh, ow = batch["orig_size"]
        for j in range(batch["n_valid"]):
            diff = create_difference_map(resize_nearest(true[j], (oh, ow)),
                                         resize_nearest(pred[j], (oh, ow)))
            base = os.path.splitext(batch["filenames"][j])[0]
            Image.fromarray(diff.cpu().numpy()).save(
                os.path.join(diff_map_dir, f"{base}_diffmap.png"))
            img_o = resize_linear_u8(_img_u8(x[j]), (oh, ow))
            overlay = overlay_difference(img_o, diff)
            Image.fromarray(overlay.cpu().numpy()).save(
                os.path.join(overlay_dir, f"{base}_overlay.png"))
            print(f"Saved difference map: "
                  f"{os.path.join(diff_map_dir, base + '_diffmap.png')}")
