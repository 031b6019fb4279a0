"""Training data pipeline; port of the JAX package's `data/dataset.py`.

Reference semantics (utils/data_loader.py:26-76, train_DC_focal.py:138-202):
  - images/masks discovered by sorted filename, suffix-filtered;
  - 60/20/20 split by two sklearn train_test_split(random_state=42) calls
    (80/20, then 75/25 of the remainder), reproduced here with numpy;
  - per sample: RGB decode, mask binarized (mask > 0); the trainer does the
    rolling ball, the resize to 512 and the /255 on the device;
  - DataLoader(bs=8, shuffle): batches of one original size (size
    buckets), a RandomState(seed + epoch) shuffle, a ragged last batch.
"""

from __future__ import annotations

import math
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np
from PIL import Image

from unetdc_tpu_torch.io.native import decode_rgb

_SUFFIXES = (".png", ".jpg", ".jpeg", ".tif")


def discover_pairs(image_dir: str, mask_dir: str
                   ) -> Tuple[List[str], List[str]]:
    """Sorted, suffix-filtered listings (train_DC_focal.py:142-152)."""
    images = sorted(f for f in os.listdir(image_dir)
                    if f.lower().endswith(_SUFFIXES))
    masks = sorted(f for f in os.listdir(mask_dir)
                   if f.lower().endswith(_SUFFIXES))
    if len(images) != len(masks):
        raise ValueError("Mismatch between the number of images and masks!")
    return images, masks


def _train_test_split(items: list, test_size: float, seed: int):
    """sklearn `train_test_split(items, test_size=..., random_state=seed)`
    without sklearn: n_test = ceil(test_size * n), the rest for training,
    test = p[:n_test] and train = p[n_test:] of RandomState(seed)'s
    permutation. sklearn refuses a split that leaves either side empty, and
    so does this."""
    n = len(items)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0 or n_test <= 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and "
            "train_size=None, the resulting train set will be empty. "
            "Adjust any of the aforementioned parameters.")
    p = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in p[n_test:]], [items[i] for i in p[:n_test]]


def split_dataset(images: Sequence[str], masks: Sequence[str],
                  seed: int = 42):
    """60/20/20 split matching train_DC_focal.py:155-175 (two
    train_test_split calls, random_state=42, leakage checks)."""
    pairs = list(zip(images, masks))
    train_val, test = _train_test_split(pairs, 0.2, seed)
    train, val = _train_test_split(train_val, 0.25, seed)

    def unzip(ps):
        return ([p[0] for p in ps], [p[1] for p in ps])

    tr, va, te = unzip(train), unzip(val), unzip(test)
    if not set(tr[0]).isdisjoint(va[0]):
        raise ValueError("Data leakage detected between Train & Validation!")
    if not set(tr[0]).isdisjoint(te[0]):
        raise ValueError("Data leakage detected between Train & Test!")
    return tr, va, te


class SegmentationData:
    """Host-side decode and batch assembly; yields raw uint8 batches.

    All images of a batch share one original size (size buckets). Decoded
    samples are kept in a RAM cache (up to `cache_bytes`) as read-only
    arrays, so later epochs hand out the same array objects, which the
    trainer keeps on the device by identity."""

    def __init__(self, image_dir: str, mask_dir: str,
                 image_list: Sequence[str], mask_list: Sequence[str],
                 batch_size: int = 8, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 cache_bytes: int = 4 << 30):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.image_list = list(image_list)
        self.mask_list = list(mask_list)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._cache_bytes_left = int(cache_bytes)
        self._cache: dict = {}

    def __len__(self):
        n = len(self.image_list)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_one(self, img_name: str, mask_name: str):
        key = (img_name, mask_name)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        img = decode_rgb(os.path.join(self.image_dir, img_name))
        mask = np.array(Image.open(
            os.path.join(self.mask_dir, mask_name)).convert("L"))
        mask = (mask > 0).astype(np.uint8)
        nbytes = img.nbytes + mask.nbytes
        if nbytes <= self._cache_bytes_left:
            img.setflags(write=False)
            mask.setflags(write=False)
            self._cache[key] = (img, mask)
            self._cache_bytes_left -= nbytes
        return img, mask

    def batches(self) -> Iterator[dict]:
        """Yield dicts: images (B,H,W,3) u8, masks (B,H,W) u8, the
        per-sample arrays, orig_size, filenames, n_valid. Consecutive
        same-size samples are grouped."""
        order = np.arange(len(self.image_list))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        pend_i, pend_m, pend_names, pend_hw = [], [], [], None
        for k in order:
            img, mask = self._load_one(self.image_list[k], self.mask_list[k])
            hw = img.shape[:2]
            if pend_hw is not None and (hw != pend_hw or
                                        len(pend_i) == self.batch_size):
                yield self._emit(pend_i, pend_m, pend_names, pend_hw)
                pend_i, pend_m, pend_names = [], [], []
            pend_hw = hw
            pend_i.append(img)
            pend_m.append(mask)
            pend_names.append(self.image_list[k])
            if len(pend_i) == self.batch_size:
                yield self._emit(pend_i, pend_m, pend_names, pend_hw)
                pend_i, pend_m, pend_names, pend_hw = [], [], [], None
        if pend_i and not self.drop_last:
            yield self._emit(pend_i, pend_m, pend_names, pend_hw)

    @staticmethod
    def _emit(imgs, masks, names, hw):
        return {
            "images": np.stack(imgs),
            "masks": np.stack(masks),
            # the same array objects every epoch when they come from the
            # decode cache: the trainer's device bank keys on their identity
            "sample_images": list(imgs),
            "sample_masks": list(masks),
            "orig_size": hw,
            "filenames": list(names),
            "n_valid": len(imgs),
        }
