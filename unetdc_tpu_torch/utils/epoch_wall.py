"""A training epoch's wall time against its summed device step time; port
of the JAX package's `utils/epoch_wall.py`.

Trains the port's `Trainer` (UNetDC, bf16, augment on) on a synthetic
droplet set for a few epochs and prints the per-epoch walls (train, val,
mask-saving val), then the device-only denominator: the device time per
image of what an epoch runs per batch, on device-resident batches
(preprocess + augment + `train_step`; preprocess + `eval_step`), from
torch.profiler's CUDA activity (`device_profile.device_split`, median of
repeats). The wall over that denominator says how far the host holds
the card back. Exits 0 iff the training ratio is at most 2, as the JAX
tool does.

    python -m unetdc_tpu_torch.utils.epoch_wall [--n_train 144 --n_val 64
        --size 512 --batch 8 --epochs 4 --device {cuda,cpu}]

On the CPU the host clock times the denominator's calls.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch


def make_droplet_dataset(out_dir: str, n: int, h: int = 512, w: int = 512,
                         seed: int = 0):
    """Synthetic microscopy set of realistic brightness: a mid-gray noisy
    field + bright droplets, masks = droplet disks (the JAX tool's draws,
    in its order; PNGs through the port's `io.native`). Realistic
    brightness matters: the brightness/contrast augmentation poisons the
    BatchNorm running statistics of tiny dark datasets."""
    from unetdc_tpu_torch.io.native import encode_png_gray, encode_png_rgb

    img_dir = os.path.join(out_dir, "images")
    mask_dir = os.path.join(out_dir, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n):
        img = (60 + rng.rand(h, w, 3) * 100).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        for _ in range(40):
            cy, cx = rng.randint(10, h - 10), rng.randint(10, w - 10)
            r = rng.randint(3, 12)
            # the disk within its bounding box (the whole-image test is the
            # same set, ~100x the work at 512x512)
            win = np.s_[max(cy - r, 0):min(cy + r + 1, h),
                        max(cx - r, 0):min(cx + r + 1, w)]
            yy, xx = np.mgrid[win]
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
            sub = img[win]
            sub[blob] = np.minimum(sub[blob].astype(np.int32) + 90,
                                   255).astype(np.uint8)
            mask[win][blob] = 255
        name = f"sample{i:03d}.png"
        encode_png_rgb(os.path.join(img_dir, name), img)
        encode_png_gray(os.path.join(mask_dir, name), mask)
        names.append(name)
    return img_dir, mask_dir, names


def device_denominators(tr, size: int, batch: int, reps: int = 5):
    """Device seconds per image of one training batch (preprocess +
    augment + train_step) and one eval batch (preprocess + eval_step) on
    device-resident uint8 batches: the median over `reps` calls of their
    device time (the host clock's on the CPU)."""
    from unetdc_tpu_torch.data.augment import augment_batch
    from unetdc_tpu_torch.utils.device_profile import device_split, timed

    dev = tr.device
    rng = np.random.RandomState(1)
    imgs = torch.from_numpy((rng.rand(batch, size, size, 3) * 255)
                            .astype(np.uint8)).to(dev)
    masks = torch.from_numpy((rng.rand(batch, size, size) > 0.97)
                             .astype(np.uint8)).to(dev)
    valid = torch.ones(batch, device=dev)
    gen = torch.Generator().manual_seed(0)

    def train_op():
        x, m = tr.preprocess(imgs, masks)
        if tr.cfg.augment:
            x, m = augment_batch(gen, x, m)
        return tr.train_step(x, m[..., None], valid)

    def eval_op():
        x, m = tr.preprocess(imgs, masks)
        return tr.eval_step(x, m[..., None], valid)

    out = {}
    for name, op in (("train", train_op), ("eval", eval_op)):
        if dev.type == "cuda":
            ms = device_split(op, reps=reps, warmup=2)[0]
        else:
            op()
            ms = statistics.median(timed(op, dev)[1] for _ in range(reps))
        out[name] = ms / 1e3 / batch
    return out


def run(n_train=144, n_val=64, size=512, batch=8, epochs=4, device="cuda"
        ) -> dict:
    """Train `epochs` epochs (at least 2: the first, with cuDNN's
    autotuning and the first decode, is left out of the best walls) and
    return the JAX tool's result keys, plus `device` (its name)."""
    from unetdc_tpu_torch.data.dataset import SegmentationData
    from unetdc_tpu_torch.device import resolve_device
    from unetdc_tpu_torch.train.trainer import Trainer, TrainConfig

    resolve_device(device)  # no GPU: raise before building anything
    with tempfile.TemporaryDirectory(prefix="epoch_wall_") as td:
        print(f"building {n_train}+{n_val} synthetic {size}^2 images in "
              f"{td} ...")
        img_dir, mask_dir, names = make_droplet_dataset(
            td, n_train + n_val, size, size)
        tr_names, va_names = names[:n_train], names[n_train:]
        train_data = SegmentationData(img_dir, mask_dir, tr_names, tr_names,
                                      batch_size=batch, shuffle=True, seed=0)
        val_data = SegmentationData(img_dir, mask_dir, va_names, va_names,
                                    batch_size=batch)
        tr = Trainer(TrainConfig(model="unetdc", img_size=size,
                                 batch_size=batch, compute_dtype="bf16",
                                 augment=True), device=device)

        def sync():
            if tr.device.type == "cuda":
                torch.cuda.synchronize(tr.device)

        walls = []
        for epoch in range(epochs):
            t0 = time.perf_counter()
            tr_loss, tr_dice, _ = tr.run_epoch_train(train_data, epoch)
            sync()
            t1 = time.perf_counter()
            tr.run_epoch_eval(val_data)
            sync()
            t2 = time.perf_counter()
            walls.append({"epoch": epoch, "train_s": t1 - t0,
                          "val_s": t2 - t1})
            print(f"epoch {epoch}: train {t1 - t0:.2f} s "
                  f"({n_train / (t1 - t0):.1f} img/s), "
                  f"val {t2 - t1:.2f} s ({n_val / (t2 - t1):.1f} img/s), "
                  f"loss {tr_loss:.4f} dice {tr_dice:.4f}")

        mask_dir_out = os.path.join(td, "val_masks")
        t0 = time.perf_counter()
        tr.run_epoch_eval(val_data, save_masks_dir=mask_dir_out)
        mask_val_s = time.perf_counter() - t0
        n_saved = len(os.listdir(mask_dir_out))
        print(f"mask-saving val: {mask_val_s:.2f} s "
              f"({n_val / mask_val_s:.1f} img/s, {n_saved} PNGs)")

        print("measuring the device denominators ...")
        dev = device_denominators(tr, size, batch)
    dev_train_epoch = dev["train"] * n_train
    dev_eval_epoch = dev["eval"] * n_val

    best_train = min(w["train_s"] for w in walls[1:])
    best_val = min(w["val_s"] for w in walls[1:])
    ratio_train = best_train / dev_train_epoch
    ratio_val = best_val / dev_eval_epoch
    return {
        "n_train": n_train, "n_val": n_val, "size": size, "batch": batch,
        "epoch_walls": walls, "mask_saving_val_s": mask_val_s,
        "device_train_s_per_img": dev["train"],
        "device_eval_s_per_img": dev["eval"],
        "device_train_epoch_s": dev_train_epoch,
        "device_eval_epoch_s": dev_eval_epoch,
        "best_train_wall_s": best_train,
        "best_val_wall_s": best_val,
        "wall_over_device_train": ratio_train,
        "wall_over_device_val": ratio_val,
        "pass": bool(ratio_train <= 2.0),
        "device": (torch.cuda.get_device_name(tr.device)
                   if tr.device.type == "cuda" else "cpu"),
    }


def main(n_train=144, n_val=64, size=512, batch=8, epochs=4, device="cuda"):
    """Print `run`'s result as one JSON line; 0 iff the training wall is at
    most 2x its device time."""
    result = run(n_train, n_val, size, batch, epochs, device)
    print(json.dumps(result))
    return 0 if result["pass"] else 1


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_train", type=int, default=144)
    ap.add_argument("--n_val", type=int, default=64)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to run (default: the GPU)")
    return main(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    raise SystemExit(_cli())
