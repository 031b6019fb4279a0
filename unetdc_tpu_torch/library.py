"""BlobInspector algorithm library: the function-for-function surface of
the reference's `algorithms.py`; port of the JAX package's `library.py`.

Every public name has the JAX function's name, positional signature and
list conventions (dots are [[y, x]] lists, labels python lists from 1).
Per-pixel work runs in the port's ops on `device` (a keyword-only
argument, "cuda" unless the caller asks for the CPU; a missing card is an
error); the list glue is host numpy, as in the reference.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from unetdc_tpu_torch.device import resolve_device
from unetdc_tpu_torch.ops import contours as C
from unetdc_tpu_torch.ops import density as D
from unetdc_tpu_torch.ops.bitdepth import (  # noqa: F401
    convert_to_8_bits, rolling_ball)
from unetdc_tpu_torch.ops.blobs import (  # noqa: F401
    blobs_detection, blobs_mask, return_blobs_algorithms)
from unetdc_tpu_torch.ops.connected_components import (
    label as _label, remove_small_batch_counted)
from unetdc_tpu_torch.ops.density import (  # noqa: F401
    min_max_mean_median_density,
    min_max_mean_sd_density as min_max_mean_SD_density)
from unetdc_tpu_torch.ops.threshold import segmentation_two_thresholds as _stt
from unetdc_tpu_torch.ops.watershed import (  # noqa: F401
    return_labeling_algorithms, watershed_custom)
from unetdc_tpu_torch.utils.profiling import span

# engines by (checkpoint path, device)
_MODEL_CACHE = {}


def _t(a, dev, dtype=None) -> torch.Tensor:
    """A host array (or tensor) as a tensor on dev."""
    return torch.as_tensor(a).to(dev, dtype)


def _segmentation_probs(engine, image, dev: torch.device) -> torch.Tensor:
    """The (512, 512) f32 probabilities segmentation_deep_learning
    thresholds: image / 255, a grayscale image broadcast to RGB, float
    `resize_linear` to 512, `engine.forward_probs`."""
    from unetdc_tpu_torch.ops.resize import resize_linear

    with span("library.prepare"), torch.no_grad():
        img = np.asarray(image, np.float32) / 255.0
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        x = resize_linear(torch.from_numpy(img).to(dev), (512, 512))[None]
    with span("library.forward"), torch.no_grad():
        return engine.forward_probs(x)[0, :, :, 0]


def segmentation_deep_learning(image, ckpt_path: Optional[str] = None,
                               thresh: float = 0.3, *, device="cuda"
                               ) -> np.ndarray:
    """algorithms.py segmentation_deep_learning: image -> 0/255 uint8 mask
    through a cached engine (`load_engine`: bf16, kernels K1 and K2 on
    the card), resized to 512 and back (float `resize_linear` in,
    `resize_mask_linear_round` out), thresholded at `thresh`.

    As in the JAX package, a grayscale image is broadcast to RGB and the
    sigmoid is applied once (the reference feeds one channel to the
    3-channel model and applies a second sigmoid).

    While tracing (`utils/profiling.py`), a call is the root span
    `library.call` over `library.prepare` (float image, upload, resize
    in), `library.forward` (its enqueue) and `library.fetch` (threshold,
    resize out, the wait for the mask, the cast)."""
    from unetdc_tpu_torch.ops.resize import resize_mask_linear_round
    from unetdc_tpu_torch.pipelines.engine import load_engine

    with span("library.call", root=True):
        dev = resolve_device(device)
        if ckpt_path is None:
            ckpt_path = os.path.join(os.path.dirname(__file__),
                                     "best_UNetDC_focal_model.pth")
        key = (str(ckpt_path), str(dev))
        if key not in _MODEL_CACHE:
            _MODEL_CACHE[key] = load_engine(ckpt_path, device=dev)
        probs = _segmentation_probs(_MODEL_CACHE[key], image, dev)
        with span("library.fetch"), torch.no_grad():
            mask = resize_mask_linear_round(
                (probs > thresh).to(torch.uint8), np.shape(image)[:2])
            return (mask.cpu().numpy() * 255).astype(np.uint8)


def segmentation_two_thresholds(image, thresh1, thresh2, *, device="cuda"
                                ) -> np.ndarray:
    """algorithms.py segmentation_two_thresholds: dilate3x3(img >= t1) &
    (img >= t2)."""
    dev = resolve_device(device)
    return _stt(_t(image, dev), thresh1, thresh2).cpu().numpy()


def labeling_custom(binary_image, dots, *, device="cuda") -> List[int]:
    """algorithms.py labeling_custom: 8-connectivity labels at the dots."""
    dev = resolve_device(device)
    lab = _label(_t(binary_image, dev), connectivity=2)[0].cpu().numpy()
    if not len(dots):
        return []
    d = np.asarray(dots, np.intp)
    return [int(v) for v in lab[d[:, 0], d[:, 1]]]


def binary_to_dots(binary_image) -> List[List[int]]:
    """algorithms.py binary_to_dots."""
    coord = np.where(np.asarray(binary_image))
    return [[int(y), int(x)] for y, x in zip(coord[0], coord[1])]


def dots_to_binary(mask_thresh, dots) -> np.ndarray:
    """algorithms.py dots_to_binary."""
    mask = np.zeros(np.asarray(mask_thresh).shape, bool)
    for coord in dots:
        mask[round(coord[0]), round(coord[1])] = True
    return mask


def _group_indices(labels):
    """label -> [its indices in increasing order], in one pass."""
    groups = {}
    for i, lab in enumerate(labels):
        groups.setdefault(lab, []).append(i)
    return groups


def sieve_labels(dots, labels, sieve_size):
    """algorithms.py sieve_labels: drop labels with <= sieve_size dots and
    renumber from 1, visiting labels in `set(labels)` order as the
    reference does."""
    sieved_dots, sieved_labels = [], []
    groups = _group_indices(labels)
    latest = 1
    for lab in set(labels):
        idx = groups[lab]
        if len(idx) > sieve_size:
            sieved_dots.extend(dots[i] for i in idx)
            sieved_labels.extend([latest] * len(idx))
            latest += 1
    return sieved_dots, sieved_labels


def _sizes_dropping_last(labels):
    """`[labels.count(i) for i in range(1, max(labels))]`: the reference's
    sizes of labels 1..max-1 (it drops the last label), by one bincount."""
    nb = int(max(labels))
    counts = np.bincount(np.asarray(labels, np.int64), minlength=nb + 1)
    return [int(c) for c in counts[1:nb]]


def mean_SD_size(labels):
    """algorithms.py mean_SD_size (the last label dropped, as there)."""
    if len(labels) == 0:
        return 0, 0
    sizes = _sizes_dropping_last(labels)
    return round(np.mean(sizes), 2), round(np.std(sizes), 2)


def mean_median_size(labels):
    """algorithms.py mean_median_size (same last-label rule)."""
    if len(labels) == 0:
        return 0, 0
    sizes = _sizes_dropping_last(labels)
    return round(np.mean(sizes), 2), round(np.median(sizes), 2)


def mean_median_min_max_size(labels):
    """algorithms.py mean_median_min_max_size (same last-label rule)."""
    if len(labels) == 0:
        return 0, 0, 0, 0, 0
    sizes = _sizes_dropping_last(labels)
    return (round(np.mean(sizes), 2), round(np.median(sizes), 2),
            round(np.min(sizes), 2), round(np.max(sizes), 2), sizes)


def return_contouring_algorithms():
    """algorithms.py return_contouring_algorithms."""
    return ["Scan", "Spreading 4-connect", "Spreading 8-connect",
            "Shrinking box", "Threshold"]


def _one(fn, image, threshold, device) -> np.ndarray:
    """A batched contour op on one 2D image."""
    dev = resolve_device(device)
    return fn(_t(image, dev)[None], threshold)[0].cpu().numpy()


def contour_scan(image, threshold, *, device="cuda") -> np.ndarray:
    """algorithms.py contour_scan."""
    return _one(C.contour_scan, image, threshold, device)


def contour_spreading_4(image, threshold, *, device="cuda") -> np.ndarray:
    """algorithms.py contour_spreading_4."""
    return _one(C.contour_spreading_4, image, threshold, device)


def contour_spreading_8(image, threshold, *, device="cuda") -> np.ndarray:
    """algorithms.py contour_spreading_8."""
    return _one(C.contour_spreading_8, image, threshold, device)


def contour_shrinking_box(image, threshold, *, device="cuda") -> np.ndarray:
    """algorithms.py contour_shrinking_box."""
    return _one(C.contour_shrinking_box, image, threshold, device)


def remove_objects(contour_mask, min_size, *, device="cuda") -> np.ndarray:
    """algorithms.py remove_objects: drop 8-connected components smaller
    than min_size. The table cap starts at 4096 and doubles until it holds
    every component, so the sieve is exact (the reference has no cap)."""
    dev = resolve_device(device)
    m = _t(contour_mask, dev)[None]
    cap = 4096
    while True:
        kept, total = remove_small_batch_counted(m, min_size, cap,
                                                 connectivity=2)
        t = int(total[0])
        if t <= cap:
            return kept[0].cpu().numpy()
        while cap < t:
            cap *= 2


def calculate_contours_centroid(image, *, device="cuda"):
    """algorithms.py calculate_contours_centroid -> [cy, cx]."""
    dev = resolve_device(device)
    cy, cx = C.calculate_contours_centroid(_t(image, dev))
    return [float(cy), float(cx)]


def return_colormaps():
    """algorithms.py return_colormaps."""
    return ["afmhot", "autumn", "bone", "cividis", "cool", "coolwarm",
            "copper", "gist_gray", "gist_heat", "gray", "hot", "inferno",
            "magma", "plasma", "rainbow", "seismic", "spring", "summer",
            "viridis", "winter", "Wistia"]


def return_colors_dictionnary():
    """algorithms.py return_colors_dictionnary."""
    return {"blue": [0, 0, 255], "cyan": [0, 255, 255], "green": [0, 255, 0],
            "magenta": [255, 0, 255], "orange": [255, 165, 0],
            "pink": [255, 192, 203], "red": [255, 0, 0],
            "royalblue": [65, 105, 225], "yellow": [255, 255, 0],
            "white": [255, 255, 255]}


def _centroid(v, dev) -> torch.Tensor:
    return torch.tensor([float(v)], dtype=torch.float32, device=dev)


def get_target(mask_thresh, mask_contour, nb_layers, centroid_y, centroid_x,
               *, device="cuda"):
    """algorithms.py get_target: the ring density % map."""
    dev = resolve_device(device)
    return D.get_target(_t(mask_thresh, dev)[None],
                        _t(mask_contour, dev)[None], int(nb_layers),
                        _centroid(centroid_y, dev),
                        _centroid(centroid_x, dev))[0].cpu().numpy()


def get_targets(mask_thresh, mask_contour, centroid_size_image, nb_layers,
                centroid_y, centroid_x, *, device="cuda"):
    """algorithms.py get_targets: (density %, count, count per 10k px,
    mean size) ring maps."""
    dev = resolve_device(device)
    outs = D.get_targets(
        _t(mask_thresh, dev)[None], _t(mask_contour, dev)[None],
        _t(centroid_size_image, dev, torch.float32)[None], int(nb_layers),
        _centroid(centroid_y, dev), _centroid(centroid_x, dev))
    return tuple(o[0].cpu().numpy() for o in outs)


def density_map(mask_thresh, mask_contour, kernel_size, *, device="cuda"):
    """algorithms.py density_map."""
    dev = resolve_device(device)
    return D.density_map(_t(mask_thresh, dev)[None],
                         _t(mask_contour, dev)[None],
                         int(kernel_size))[0].cpu().numpy()


def density_maps(mask_thresh, mask_contour, centroid_size_image,
                 kernel_size, *, device="cuda"):
    """algorithms.py density_maps: (percentage, count, count per 10k px,
    mean size) maps."""
    dev = resolve_device(device)
    outs = D.density_maps(
        _t(mask_thresh, dev)[None], _t(mask_contour, dev)[None],
        _t(centroid_size_image, dev, torch.float32)[None], int(kernel_size))
    return tuple(o[0].cpu().numpy() for o in outs)


def is_float(string) -> bool:
    """algorithms.py is_float."""
    try:
        float(string)
        return True
    except ValueError:
        return False


def _group_means_sizes(dots, labels):
    """Per-label (mean coordinate, size) in np.unique(labels) order; each
    group's mean sees its dots in their original order, as the
    reference's per-label loop does."""
    coords = np.asarray(dots, np.float64).reshape(len(labels), 2)
    order = np.argsort(np.asarray(labels), kind="stable")
    sorted_coords = coords[order]
    _, starts = np.unique(np.asarray(labels)[order], return_index=True)
    bounds = list(starts) + [len(labels)]
    means, sizes = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        means.append(sorted_coords[a:b].mean(axis=0))
        sizes.append(b - a)
    return means, sizes


def calculate_centroids_sizes(dots, labels) -> np.ndarray:
    """algorithms.py calculate_centroids_sizes."""
    if len(labels) == 0:
        return np.array([])
    means, sizes = _group_means_sizes(dots, labels)
    return np.array([[c[0], c[1], n] for c, n in zip(means, sizes)])


def calculate_centroids_sizes_image(dots, labels, image) -> np.ndarray:
    """algorithms.py calculate_centroids_sizes_image."""
    out = np.zeros(np.asarray(image).shape, np.uint16)
    if len(labels) == 0:
        return out
    means, sizes = _group_means_sizes(dots, labels)
    for c, n in zip(means, sizes):
        out[int(c[0] + 0.5), int(c[1] + 0.5)] = n
    return out


def calculate_centroids(dots, labels) -> np.ndarray:
    """algorithms.py calculate_centroids."""
    if len(labels) == 0:
        return np.array([])
    means, _ = _group_means_sizes(dots, labels)
    return np.array([[c[0], c[1]] for c in means])


def calculate_blobs_centroids_and_DTOC(dots, labels, centroid_x, centroid_y):
    """algorithms.py calculate_blobs_centroids_and_DTOC."""
    if labels == []:
        return [], []
    means, _ = _group_means_sizes(dots, labels)
    cents = np.array(means)
    dtoc = np.sqrt((cents[:, 0] - centroid_y) ** 2
                   + (cents[:, 1] - centroid_x) ** 2)
    return np.array(cents), dtoc.tolist()


def get_filename(absolute_path: str) -> str:
    """algorithms.py get_filename."""
    last = max(absolute_path.rfind("/"), absolute_path.rfind("\\"))
    return absolute_path[last + 1:]


def get_folder(absolute_path: str) -> str:
    """algorithms.py get_folder."""
    last = max(absolute_path.rfind("/"), absolute_path.rfind("\\"))
    return absolute_path[:last + 1]


def get_filename_without_extension(absolute_path: str) -> str:
    """algorithms.py get_filename_without_extension."""
    last = max(absolute_path.rfind("/"), absolute_path.rfind("\\"))
    dot = absolute_path.rfind(".")
    if last != -1:
        return absolute_path[last + 1:dot]
    return absolute_path[0:dot]
