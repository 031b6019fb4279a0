"""Watershed segmentation of the library (algorithms.py watershed_custom:
EDT -> peak_local_max(min_distance=3) -> markers -> watershed); port of
the JAX package's `ops/watershed.py`.

The EDT dispatches by size as the JAX function does: below 64x64 pixels
scipy's float64 EDT, otherwise the device's float32 sqrt of the exact
squared EDT (`ops/edt.py`), widened to float64. The two round differently,
so plateaus of -distance tie differently, and the flood follows the
dispatch. The flood is the priority-flood of `native/algo.cpp` through
ctypes (the tracked `native/libalgo.so`, or the same source built into
`unetdc_tpu_torch/_build/native/` when that does not load), with
`watershed_python`, the same flood in Python, where neither loads.
"""

from __future__ import annotations

import ctypes
import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage as ndi

from unetdc_tpu_torch.device import resolve_device
from unetdc_tpu_torch.utils import native_build


def distance_transform_edt(mask: np.ndarray, *, device="cuda") -> np.ndarray:
    """Exact EDT of the foreground, float64: scipy below 64x64 pixels, else
    the device EDT on `device`."""
    m = np.asarray(mask) > 0
    if m.size < 64 * 64:
        return ndi.distance_transform_edt(m)
    from unetdc_tpu_torch.ops.edt import distance_transform_edt as edt

    dev = resolve_device(device)
    return edt(torch.from_numpy(m).to(dev)).cpu().numpy().astype(np.float64)


def peak_local_max(image: np.ndarray, labels: np.ndarray = None,
                   min_distance: int = 3, exclude_border: bool = False
                   ) -> np.ndarray:
    """skimage.feature.peak_local_max, the subset the reference uses:
    maxima of `image` in a (2*min_distance+1)^2 window, inside labels > 0,
    in intensity order (stable), dropping any within Chebyshev distance
    < min_distance of one kept before it. (n, 2) int64."""
    img = np.asarray(image, np.float64)
    region = (np.asarray(labels) > 0 if labels is not None
              else np.ones_like(img, bool))
    size = 2 * min_distance + 1
    maxfilt = ndi.maximum_filter(img, size=size, mode="constant", cval=0.0)
    candidates = (img == maxfilt) & region & (img > 0)
    if exclude_border:
        candidates[:min_distance] = candidates[-min_distance:] = False
        candidates[:, :min_distance] = candidates[:, -min_distance:] = False
    coords = np.argwhere(candidates)
    if len(coords) == 0:
        return coords
    coords = coords[np.argsort(-img[tuple(coords.T)], kind="stable")]
    return coords[greedy_spacing(coords, img.shape, min_distance)]


def greedy_spacing(coords: np.ndarray, shape, min_distance: int
                   ) -> np.ndarray:
    """Bool mask over `coords` (in priority order): each is kept unless a
    kept one lies within Chebyshev distance < min_distance of it. A kept
    peak blocks its (2*min_distance-1)^2 square on a map of `shape`, so
    the pass is linear in the candidates (the JAX package compares each
    candidate with every kept one: the same result)."""
    r = min_distance - 1
    blocked = np.zeros(shape, bool)
    keep = np.zeros(len(coords), bool)
    for k, (y, x) in enumerate(coords):
        if not blocked[y, x]:
            keep[k] = True
            if r >= 0:
                blocked[max(y - r, 0):y + r + 1, max(x - r, 0):x + r + 1] = 1
    return keep


@native_build.once
def _load_algo() -> Optional[ctypes.CDLL]:
    """ctypes handle of the flood library; None when it neither loads nor
    builds."""
    lib = native_build.load(
        "algo", prebuilt=native_build.NATIVE_DIR / "libalgo.so")
    if lib is None:
        return None
    fn = lib.watershed_flood
    fn.argtypes = [ctypes.POINTER(ctypes.c_double),
                   ctypes.POINTER(ctypes.c_int32),
                   ctypes.POINTER(ctypes.c_uint8),
                   ctypes.c_int32, ctypes.c_int32]
    fn.restype = ctypes.c_int
    return lib


def watershed(neg_height: np.ndarray, markers: np.ndarray,
              mask: np.ndarray = None) -> np.ndarray:
    """Priority-flood watershed (skimage.segmentation.watershed semantics:
    lower `neg_height` floods first, FIFO among equal heights) -> int32
    labels; the native flood, or `watershed_python` without it."""
    lib = _load_algo()
    if lib is None:
        return watershed_python(neg_height, markers, mask)
    h = np.ascontiguousarray(neg_height, np.float64)
    out = np.ascontiguousarray(markers, np.int32).copy()
    if out.shape != h.shape or h.ndim != 2:
        raise ValueError(f"heights {h.shape} and markers {out.shape} must "
                         "be one (H, W) shape")
    region = (np.ascontiguousarray(np.asarray(mask) > 0, np.uint8)
              if mask is not None else np.ones(h.shape, np.uint8))
    if region.shape != h.shape:
        raise ValueError(f"mask {region.shape} must have shape {h.shape}")
    lib.watershed_flood(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        region.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int32(h.shape[0]), np.int32(h.shape[1]))
    return out


def watershed_python(neg_height: np.ndarray, markers: np.ndarray,
                     mask: np.ndarray = None) -> np.ndarray:
    """The priority flood in Python (the native flood's oracle)."""
    h = np.asarray(neg_height, np.float64)
    out = np.asarray(markers, np.int32).copy()
    if mask is not None:
        region = np.asarray(mask) > 0
        out[~region] = -1  # never filled
    else:
        region = np.ones_like(out, bool)
    H, W = h.shape
    heap: List[Tuple[float, int, int, int]] = []
    counter = 0
    for y, x in np.argwhere((out > 0) & region):
        heapq.heappush(heap, (h[y, x], counter, y, x))
        counter += 1
    while heap:
        _, _, y, x = heapq.heappop(heap)
        lab = out[y, x]
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W and region[ny, nx] \
                    and out[ny, nx] == 0:
                out[ny, nx] = lab
                heapq.heappush(heap, (h[ny, nx], counter, ny, nx))
                counter += 1
    out[out == -1] = 0
    return out


def watershed_custom(binary_image: np.ndarray, dots, *, device="cuda"):
    """algorithms.py watershed_custom: EDT -> peak markers -> watershed;
    returns (the dots on a labelled pixel, their labels)."""
    binary_image = np.asarray(binary_image) > 0
    distance = distance_transform_edt(binary_image, device=device)
    max_coords = peak_local_max(distance, labels=binary_image,
                                min_distance=3, exclude_border=False)
    local_maxima = np.zeros(distance.shape, bool)
    if len(max_coords):
        local_maxima[tuple(max_coords.T)] = True
    markers, _ = ndi.label(local_maxima)
    labels = watershed(-distance, markers, mask=binary_image)
    ws_labels, new_dots = [], []
    for d in dots:
        if labels[d[0]][d[1]] != 0:
            ws_labels.append(int(labels[d[0]][d[1]]))
            new_dots.append(d)
    return new_dots, ws_labels


def return_labeling_algorithms():
    """algorithms.py return_labeling_algorithms."""
    return ["No separation", "Watershed"]
