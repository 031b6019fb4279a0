"""The trained-checkpoint int8 contract: train a UNetDC to saturation on
synthetic droplet images, then measure how far the int8 engine's masks
and droplet counts are from the bf16 engine's on held-out images; port of
the JAX package's `utils/int8_trained_eval.py`.

On a random checkpoint the logits crowd the 0.3 threshold and int8
rounding flips many pixels; a trained head is saturated almost
everywhere, so agreement should approach 1. The run is the port's
`Trainer.fit` (bf16, focal-dice) on `make_droplet_dataset`, then
`load_engine(ckpt)` (bf16, kernels K1/K2/K3 on the card) against
`load_engine(ckpt, quantize="int8")`.

    python -m unetdc_tpu_torch.utils.int8_trained_eval [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict

import numpy as np


def _droplet_image(rng: np.random.RandomState, size: int, yy, xx):
    """One dark-field image with 12-23 bright droplets, and its mask; the
    JAX package's draws, in its order."""
    img = (rng.rand(size, size, 3) * 60 + 40).astype(np.uint8)
    mask = np.zeros((size, size), np.uint8)
    for _ in range(rng.randint(12, 24)):
        cy = rng.randint(8, size - 8)
        cx = rng.randint(8, size - 8)
        r = rng.randint(3, 10)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img[blob] = np.minimum(img[blob] + 170, 255)
        mask |= blob.astype(np.uint8)
    return img, mask


def make_droplet_dataset(root: str, n: int = 128, size: int = 256,
                         seed: int = 0) -> None:
    """`n` synthetic microscopy images and their exact masks under
    root/{images,masks} (PNGs through `io/native`)."""
    from unetdc_tpu_torch.io.native import encode_png_gray, encode_png_rgb

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    mask_dir = os.path.join(root, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    yy, xx = np.mgrid[:size, :size]
    for i in range(n):
        img, mask = _droplet_image(rng, size, yy, xx)
        encode_png_rgb(os.path.join(img_dir, f"d{i:04d}.png"), img)
        encode_png_gray(os.path.join(mask_dir, f"d{i:04d}.png"), mask * 255)


def eval_images(n: int, size: int, seed: int) -> np.ndarray:
    """(n, size, size, 3) uint8 held-out images from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    return np.stack([_droplet_image(rng, size, yy, xx)[0] for _ in range(n)])


def train_and_eval_int8(workdir: str | None = None, n_images: int = 128,
                        size: int = 256, epochs: int = 10,
                        n_eval: int = 16, seed: int = 0,
                        verbose: bool = False, *, device="cuda"
                        ) -> Dict[str, float]:
    """Returns int8_trained_agreement (mean per-image share of equal mask
    pixels), int8_trained_agreement_min, int8_trained_count_match_rate,
    int8_trained_count_mean_abs_diff and trained_val_dice."""
    from unetdc_tpu_torch.data.dataset import SegmentationData, discover_pairs
    from unetdc_tpu_torch.pipelines.engine import load_engine
    from unetdc_tpu_torch.train.trainer import TrainConfig, Trainer

    ctx = tempfile.TemporaryDirectory() if workdir is None else None
    root = ctx.name if ctx is not None else workdir
    try:
        make_droplet_dataset(root, n=n_images, size=size, seed=seed)
        img_dir = os.path.join(root, "images")
        mask_dir = os.path.join(root, "masks")
        imgs_l, masks_l = discover_pairs(img_dir, mask_dir)
        n_val = max(len(imgs_l) // 8, 8)
        ckpt = os.path.join(root, "best.msgpack")
        cfg = TrainConfig(num_epochs=epochs, batch_size=8, img_size=size,
                          compute_dtype="bf16", seed=seed, ckpt_path=ckpt,
                          background_radius=25, save_last=False,
                          save_val_masks_dir=None)
        tr = Trainer(cfg, device=device)

        def mk(il, ml, shuffle):
            return SegmentationData(img_dir, mask_dir, il, ml, batch_size=8,
                                    shuffle=shuffle, seed=seed)

        hist = tr.fit(mk(imgs_l[n_val:], masks_l[n_val:], True),
                      mk(imgs_l[:n_val], masks_l[:n_val], False))
        val_dice = float(max(hist.get("val_dice") or [float("nan")]))
        del tr

        evals = eval_images(n_eval, size, seed + 1000)
        engines = []
        for quantize in (None, "int8"):
            eng = load_engine(ckpt, device=device, quantize=quantize)
            eng.img_size = size
            engines.append(eng)
        agree, count_diff = [], []
        for i in range(0, n_eval, 8):
            rf, rq = (e.run_batch(evals[i:i + 8], (size, size),
                                  background_radius=25) for e in engines)
            agree.append((rf["mask"] == rq["mask"]).mean(axis=(1, 2)))
            count_diff.extend(np.abs(rf["count"].astype(np.int64)
                                     - rq["count"]).tolist())
        agree = np.concatenate(agree)
        out = {
            "int8_trained_agreement": float(agree.mean()),
            "int8_trained_agreement_min": float(agree.min()),
            "int8_trained_count_match_rate": float(
                np.mean(np.asarray(count_diff) == 0)),
            "int8_trained_count_mean_abs_diff": float(np.mean(count_diff)),
            "trained_val_dice": val_dice,
        }
        if verbose:
            print(json.dumps(out, indent=2))
        return out
    finally:
        if ctx is not None:
            ctx.cleanup()


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return train_and_eval_int8(verbose=True,
                               device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
