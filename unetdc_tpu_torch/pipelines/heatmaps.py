"""Heatmap pipelines v1 and v2: engines and host drivers; port of the JAX
package's `pipelines/heatmaps.py`.

v1 (reference quantify_pipline.py): the batch quantification plus, per
image, an Otsu ROI mask of the original image, a radial ring map counting
droplet centroids (10 rings) and a Gaussian-ratio spatial density map,
written as min-max-normalised 'hot' PNGs.

v2 (reference quantify.py, BlobInspector style): a contour-scan ROI with a
min-size filter, the droplets inside it labelled 8-connected, and the
ring (`get_targets`) and sliding-window (`density_maps`) percentage maps
at fixed colour scales (YlOrBr vmax=35, hot vmax=15).

Each engine's `heatmap_stage(imgs_u8, masks, stats, max_labels)` is the
work after the forward, on whatever device its tensors are on; under a
mesh (the `mesh` argument of `QuantifyEngine`) it runs per data group. The
engines take RGB (B,H,W,3) batches and the channel-equal (B,H,W) uploads
of the batch pipeline alike: the gray of three equal channels is the
channel itself (`ops/roi.py::gray_of`).

The PNGs are drawn with matplotlib, imported when they are written; the
pipelines fail with a message naming it when it is missing.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from unetdc_tpu_torch.ops.connected_components import (quantify_mask_batch,
                                                       remove_small_batch)
from unetdc_tpu_torch.ops.contours import (calculate_contours_centroid,
                                           contour_scan)
from unetdc_tpu_torch.ops.density import (density_maps, gaussian_density_map,
                                          get_targets,
                                          radial_centroid_count_map)
from unetdc_tpu_torch.ops.roi import (generate_roi_mask_gray, gray_of,
                                      moments_centroid)
from unetdc_tpu_torch.pipelines.engine import QuantifyEngine
from unetdc_tpu_torch.pipelines.quantify_batch import (BatchQuantifyPipeline,
                                                       _SUM_KEYS,
                                                       draw_overlay,
                                                       props_to_dataframe)

_PRESIEVE = ("all_area", "all_sum-0", "all_sum-1", "all_count")


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or an error naming it."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "the heatmap pipelines draw their PNGs with matplotlib, which is "
            "not installed; install matplotlib to write heatmaps") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-image min-max normalisation (quantify_pipline.py) to uint8."""
    mn = x.amin((-2, -1), keepdim=True)
    mx = x.amax((-2, -1), keepdim=True)
    y = torch.where(mx > mn, (x - mn) / (mx - mn).clamp_min(1e-30), x)
    return torch.clamp(torch.round(y * 255), 0, 255).to(torch.uint8)


def _combine_sums(stats: Dict[str, torch.Tensor], axis: int
                  ) -> torch.Tensor:
    """float32 coordinate sums from the (lo, hi) split (hi absent when the
    bare total fits int32)."""
    lo = stats[f"sum-{axis}-lo"].to(torch.float32)
    hi = stats.get(f"sum-{axis}-hi")
    return lo if hi is None else hi.to(torch.float32) * 256.0 + lo


def centroid_size_from_stats(stats: Dict[str, torch.Tensor], hw,
                             max_labels: int) -> torch.Tensor:
    """algorithms.py centroid_size_image from the droplet tables: each
    droplet's area written at int(centroid + 0.5), (B, H, W) float32. When
    two centroids land on one pixel the higher table slot wins, as in the
    JAX package's scatter on the CPU (there the last update wins); here
    the winner is chosen by a max over slot ids, so the card agrees."""
    h, w = hw
    area = stats["area"].to(torch.float32)
    b, n = area.shape
    valid = area > 0
    safe = area.clamp_min(1.0)
    cy = torch.floor(_combine_sums(stats, 0) / safe + 0.5).long()
    cx = torch.floor(_combine_sums(stats, 1) / safe + 0.5).long()
    flat = torch.where(valid, cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1),
                       h * w)
    slot = torch.full((b, h * w + 1), -1, dtype=torch.int64,
                      device=area.device)
    ids = torch.arange(n, device=area.device).expand(b, n)
    slot.scatter_reduce_(1, flat, ids, "amax")
    img = torch.where(slot >= 0, torch.gather(
        torch.where(valid, area, 0.0), 1, slot.clamp_min(0)), 0.0)
    return img[:, :-1].reshape(b, h, w)


class HeatmapV1Engine(QuantifyEngine):
    """QuantifyEngine + radial and spatial density maps
    (quantify_pipline.py). The radial map counts UNSIEVED centroids (the
    reference labels the mask afresh without min_area), so the megastep
    asks for the pre-sieve table: one propagation, not two."""

    _want_presieve = True

    def _megastep(self, imgs_u8, prob_thresh, min_area, out_hw,
                  background_radius, apply_bg, max_labels, mesh=None):
        out = super()._megastep(imgs_u8, prob_thresh, min_area, out_hw,
                                background_radius, apply_bg, max_labels,
                                mesh)
        out.update(self.heatmap_stage(imgs_u8, out["mask"], out,
                                      max_labels))
        for k in _PRESIEVE:  # consumed on the device
            del out[k]
        return out

    def heatmap_stage(self, imgs_u8, masks, stats, max_labels
                      ) -> Dict[str, torch.Tensor]:
        """ROI, its centroid, the 10-ring centroid count map and the
        21-pixel Gaussian density ratio -> 'radial_u8', 'spatial_u8'."""
        roi = generate_roi_mask_gray(gray_of(imgs_u8))
        cy, cx = moments_centroid(roi)
        all_area = stats["all_area"]
        area = all_area.to(torch.float32).clamp_min(1.0)
        valid = (torch.arange(all_area.shape[1], device=roi.device)
                 < stats["all_count"][:, None]) & (all_area > 0)
        radial = radial_centroid_count_map(
            roi, stats["all_sum-0"] / area, stats["all_sum-1"] / area,
            valid, 10, cy.to(torch.float32), cx.to(torch.float32))
        spatial = gaussian_density_map(masks, roi, 21)
        return {"radial_u8": _to_u8(radial), "spatial_u8": _to_u8(spatial)}


class HeatmapV1Pipeline(BatchQuantifyPipeline):
    """quantify_pipline.py driver: the batch artifacts plus per image
    {name}_radial_density.png and {name}_spatial_density.png (cmap 'hot')."""

    def _write_batch_outputs(self, out, paths, n_valid, rgbs=None):
        super()._write_batch_outputs(out, paths, n_valid, rgbs)
        plt = _pyplot()
        for i in range(n_valid):
            name = paths[i].stem
            plt.imsave(self.out_dir / f"{name}_radial_density.png",
                       out["radial_u8"][i], cmap="hot")
            plt.imsave(self.out_dir / f"{name}_spatial_density.png",
                       out["spatial_u8"][i], cmap="hot")


class BlobInspectorEngine(QuantifyEngine):
    """QuantifyEngine + contour-scan ROI, ring and windowed density maps
    (reference quantify.py)."""

    def __init__(self, *args, kernel_size: int = 55, nb_layers: int = 3,
                 contour_thresh: int = 0, contour_min_size: int = 20,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kernel_size = kernel_size
        self.nb_layers = nb_layers
        self.contour_thresh = contour_thresh
        self.contour_min_size = contour_min_size

    def _megastep(self, imgs_u8, prob_thresh, min_area, out_hw,
                  background_radius, apply_bg, max_labels, mesh=None):
        out = super()._megastep(imgs_u8, prob_thresh, min_area, out_hw,
                                background_radius, apply_bg, max_labels,
                                mesh)
        out.update(self.heatmap_stage(imgs_u8, out["mask"], out,
                                      max_labels))
        return out

    def heatmap_stage(self, imgs_u8, masks, stats, max_labels
                      ) -> Dict[str, torch.Tensor]:
        """ROI by contour scan + 8-connected min-size filter, droplets
        inside it labelled 8-connected (kernel K3 makes their table), the
        centroid-size image, the ring and the windowed percentage maps ->
        'roi' (uint8 0/1), 'target_pct', 'conv_pct' (float16)."""
        h, w = masks.shape[-2:]
        roi0 = contour_scan(gray_of(imgs_u8), self.contour_thresh)
        roi = remove_small_batch(roi0, self.contour_min_size, max_labels,
                                 connectivity=2)
        m = (masks > 0) & roi
        st = quantify_mask_batch(m.to(torch.uint8), 1, max_labels,
                                 connectivity=2, tables=self._tables)
        csi = centroid_size_from_stats(st, (h, w), max_labels)
        cy, cx = calculate_contours_centroid(roi)
        target = get_targets(m, roi, csi, self.nb_layers, cy, cx)[0]
        conv = density_maps(m, roi, csi, self.kernel_size)[0]
        return {"roi": roi.to(torch.uint8), "target_pct": target.half(),
                "conv_pct": conv.half()}


def save_heatmap(img, out_path, cmap, vmin, vmax):
    """quantify.py save_heatmap."""
    plt = _pyplot()
    plt.figure(figsize=(5, 5))
    plt.imshow(img, cmap=cmap, vmin=vmin, vmax=vmax)
    plt.colorbar(fraction=0.046, pad=0.04)
    plt.axis("off")
    plt.savefig(out_path, bbox_inches="tight", pad_inches=0)
    plt.close()


class BlobInspectorPipeline(BatchQuantifyPipeline):
    """quantify.py driver: per image the mask, the droplet CSV, the ROI
    debug PNG and the two fixed-scale heatmaps; no master reports (the
    reference v2 CLI writes none)."""

    def _write_batch_outputs(self, out, paths, n_valid, rgbs=None):
        from unetdc_tpu_torch.io.fastcsv import write_csv
        from unetdc_tpu_torch.io.native import encode_png_gray

        plt = _pyplot()
        for i in range(n_valid):
            name = paths[i].stem
            mask = out["mask"][i]
            encode_png_gray(self.mask_dir / f"{name}_pred.png", mask * 255)
            plt.imsave(self.mask_dir / f"{name}_mask_contour_debug.png",
                       out["roi"][i], cmap="gray")
            save_heatmap(
                out["target_pct"][i].astype(np.float32),
                self.mask_dir / f"{name}_target_density_heatmap_percentage.png",
                cmap="YlOrBr", vmin=0, vmax=35)
            save_heatmap(
                out["conv_pct"][i].astype(np.float32),
                self.mask_dir /
                f"{name}_convoluted_density_heatmap_percentage.png",
                cmap="hot", vmin=0, vmax=15)
            props_i = {k: out[k][i] for k in ("area",) + _SUM_KEYS
                       if k in out}
            df = props_to_dataframe(props_i, out["count"][i],
                                    self.px_per_micron)
            df.insert(0, "filename", paths[i].name)
            write_csv(self.out_dir / f"{name}_droplets.csv", df)
            if self.overlay_dir is not None:
                from unetdc_tpu_torch.io.native import encode_png_rgb

                encode_png_rgb(self.overlay_dir / f"{name}_overlay.png",
                               draw_overlay(rgbs[i], mask))
