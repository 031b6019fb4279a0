"""Host driver of the batch quantification pipeline; writes the reference
CLI's artifact set (quantify_droplets_batch.py):

    out_dir/predicted_masks/{stem}_pred.png      mask * 255
    out_dir/{stem}_droplets.csv                  per-image droplet table
    out_dir/overlays/{stem}_overlay.png          optional green contours
    out_dir/summary_per_image.csv                filename,droplet_count,total_area_px
    out_dir/all_droplets.csv                     concatenated droplet tables
    out_dir/all_droplets.xlsx | all_droplets_noexcel.csv (fallback)
    out_dir/droplet_size_stats.csv               mean/median/std of size col
    out_dir/size_histogram.png                   40-bin histogram, 6x4in @300dpi

Port of the JAX package's `pipelines/quantify_batch.py`. CSV schemas and
stdout lines stay as they are: the reference GUIs parse the CLI's stdout.
Overlays are drawn with cv2 (external contours, simple chain, thickness 2,
green), as the reference draws them, so the overlay PNGs match its pixels.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from unetdc_tpu_torch.io.fastcsv import write_csv
from unetdc_tpu_torch.io.images import (decode_rgb, encode_png_gray,
                                        encode_png_rgb)
from unetdc_tpu_torch.pipelines.engine import QuantifyEngine, grayscale_view

IMG_SUFFIXES = {".png", ".jpg", ".jpeg", ".tif", ".tiff"}
_SUM_KEYS = ("sum-0-lo", "sum-0-hi", "sum-1-lo", "sum-1-hi",
             "sum-0-lo16", "sum-0-hi16", "sum-1-lo16", "sum-1-hi16")


def list_images(img_dir: str) -> List[Path]:
    """Sorted image listing (quantify_droplets_batch.py)."""
    return sorted(p for p in Path(img_dir).iterdir()
                  if p.suffix.lower() in IMG_SUFFIXES)


def props_to_dataframe(props: Dict[str, np.ndarray], count: int,
                       px_per_um: Optional[float]) -> pd.DataFrame:
    """Slice the fixed-size property table to a reference-schema droplet
    DataFrame (label, area, equivalent_diameter, centroid-0/1
    [, area_sqmicron, eq_diam_micron]). Centroids are f64 divisions of the
    exact integer sums, as skimage computes them."""
    n = int(count)
    if n == 0:
        return pd.DataFrame()
    area = np.asarray(props["area"][:n], np.int64)

    def _sum(axis):
        if f"sum-{axis}-lo16" in props:
            lo = np.asarray(props[f"sum-{axis}-lo16"][:n], np.int64)
            return np.asarray(props[f"sum-{axis}-hi16"][:n],
                              np.int64) * 65536 + lo
        lo = np.asarray(props[f"sum-{axis}-lo"][:n], np.int64)
        hi = props.get(f"sum-{axis}-hi")
        return lo if hi is None else np.asarray(hi[:n], np.int64) * 256 + lo

    df = pd.DataFrame({
        "label": np.arange(1, n + 1, dtype=np.int64),
        "area": area,
        "equivalent_diameter": np.sqrt(4.0 * area.astype(np.float64) / np.pi),
        "centroid-0": _sum(0).astype(np.float64) / area,
        "centroid-1": _sum(1).astype(np.float64) / area,
    })
    if px_per_um is not None:
        df["area_sqmicron"] = df["area"] / (px_per_um ** 2)
        df["eq_diam_micron"] = df["equivalent_diameter"] / px_per_um
    return df


def draw_overlay(orig_rgb: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Green external contours, thickness 2 (quantify_droplets_batch.py:77-78),
    drawn with cv2 as the reference does. Takes RGB where the reference
    takes BGR; green is (0, 255, 0) in both orders."""
    import cv2

    cnts, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)
    out = np.ascontiguousarray(orig_rgb).copy()
    cv2.drawContours(out, cnts, -1, (0, 255, 0), 2)
    return out


class BatchQuantifyPipeline:
    """Groups images by original size, pads the trailing partial batch,
    runs the engine's megastep and writes reference-format artifacts."""

    # batches dispatched ahead of the one being written
    _MAX_INFLIGHT = 2

    def __init__(self, engine: QuantifyEngine, out_dir: str,
                 batch: int = 8, prob_thresh: float = 0.3, min_area: int = 1,
                 px_per_micron: Optional[float] = None,
                 save_overlays: bool = False, background_radius: int = 50):
        self.engine = engine
        self.out_dir = Path(out_dir)
        self.mask_dir = self.out_dir / "predicted_masks"
        self.overlay_dir = self.out_dir / "overlays" if save_overlays else None
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.mask_dir.mkdir(exist_ok=True)
        if self.overlay_dir:
            self.overlay_dir.mkdir(exist_ok=True)
        self.batch = batch
        self.prob_thresh = prob_thresh
        self.min_area = min_area
        self.px_per_micron = px_per_micron
        self.background_radius = background_radius
        self.per_image_rows: List[dict] = []
        self.all_props: List[pd.DataFrame] = []
        self._inflight: List = []
        self._pending_writes: List = []
        self._dispatch_pool: Optional[ThreadPoolExecutor] = None
        self._write_pool: Optional[ThreadPoolExecutor] = None

    # --------------------------------------------------------------
    def _flush(self, imgs: List[np.ndarray], paths: List[Path],
               size_hw: Tuple[int, int]):
        """Dispatch one batch on the dispatch thread, padded to the full
        batch size so every size bucket keeps one shape."""
        n_valid = len(imgs)
        if n_valid == 0:
            return
        rgbs = list(imgs) if self.overlay_dir is not None else None
        batch_imgs = list(imgs) + [np.zeros_like(imgs[0])] * (
            self.batch - n_valid)
        if len(self._inflight) >= self._MAX_INFLIGHT:
            self._drain(one=True)
        if self._dispatch_pool is None:
            self._dispatch_pool = ThreadPoolExecutor(max_workers=1)

        def _dispatch():
            return self.engine.dispatch_batch(
                grayscale_view(np.stack(batch_imgs)), size_hw,
                self.prob_thresh, self.min_area, self.background_radius)

        self._inflight.append((self._dispatch_pool.submit(_dispatch),
                               list(paths), n_valid, size_hw, rgbs))

    def _drain(self, one: bool = False):
        while self._inflight:
            fut, paths, n_valid, size_hw, rgbs = self._inflight.pop(0)
            host = self.engine.fetch_batch(fut.result(), size_hw)
            self._write_batch_outputs(host, paths, n_valid, rgbs)
            if one:
                break

    def _submit_write(self, fn, *args):
        if self._write_pool is None:
            self._write_pool = ThreadPoolExecutor(max_workers=2)
        self._pending_writes.append(self._write_pool.submit(fn, *args))
        while len(self._pending_writes) > 16:  # bound the queue
            self._pending_writes.pop(0).result()

    def finish_writes(self):
        for f in self._pending_writes:
            f.result()
        self._pending_writes = []

    def _write_batch_outputs(self, out, paths, n_valid, rgbs=None):
        for i in range(n_valid):
            fpath = paths[i]
            name = fpath.stem
            mask = out["mask"][i]
            self._submit_write(encode_png_gray,
                               self.mask_dir / f"{name}_pred.png", mask * 255)
            props_i = {k: out[k][i] for k in ("area",) + _SUM_KEYS
                       if k in out}
            df = props_to_dataframe(props_i, out["count"][i],
                                    self.px_per_micron)
            df.insert(0, "filename", fpath.name)
            write_csv(self.out_dir / f"{name}_droplets.csv", df)
            self.all_props.append(df)
            self.per_image_rows.append({
                "filename": fpath.name,
                "droplet_count": len(df),
                "total_area_px": int(df["area"].sum()) if not df.empty else 0,
            })
            if self.overlay_dir is not None:
                self._submit_write(
                    encode_png_rgb,
                    self.overlay_dir / f"{name}_overlay.png",
                    draw_overlay(rgbs[i], mask))

    # --------------------------------------------------------------
    def run(self, img_dir: str, progress: bool = True):
        from unetdc_tpu_torch.data.prefetch import Prefetcher

        images = list_images(img_dir)
        if progress:
            try:
                from tqdm import tqdm
                images = tqdm(images, desc="Inference")
            except ImportError:  # pragma: no cover
                pass
        images_iter = Prefetcher(((p, decode_rgb(p)) for p in images),
                                 depth=4)
        pend_imgs: List[np.ndarray] = []
        pend_paths: List[Path] = []
        pend_size: Optional[Tuple[int, int]] = None
        for p, arr in images_iter:
            hw = arr.shape[:2]
            if pend_size is not None and (hw != pend_size or
                                          len(pend_imgs) == self.batch):
                self._flush(pend_imgs, pend_paths, pend_size)
                pend_imgs, pend_paths = [], []
            pend_size = hw
            pend_imgs.append(arr)
            pend_paths.append(p)
            if len(pend_imgs) == self.batch:
                self._flush(pend_imgs, pend_paths, pend_size)
                pend_imgs, pend_paths = [], []
        if pend_imgs:
            self._flush(pend_imgs, pend_paths, pend_size)
        self._drain()
        self.finish_writes()
        for pool in (self._dispatch_pool, self._write_pool):
            if pool is not None:
                pool.shutdown(wait=True)
        self._dispatch_pool = self._write_pool = None
        return self

    # --------------------------------------------------------------
    def write_reports(self, skip_excel: bool = False,
                      skip_histogram: bool = False):
        """Master CSV/Excel + size stats + histogram
        (quantify_droplets_batch.py)."""
        out_dir = self.out_dir
        summary_df = pd.DataFrame(self.per_image_rows)
        write_csv(out_dir / "summary_per_image.csv", summary_df)
        if not self.all_props:
            return
        combined = pd.concat(self.all_props, ignore_index=True)
        write_csv(out_dir / "all_droplets.csv", combined)

        if not skip_excel:
            try:
                import xlsxwriter  # noqa: F401
                with pd.ExcelWriter(out_dir / "all_droplets.xlsx",
                                    engine="xlsxwriter") as xw:
                    combined.to_excel(xw, index=False, sheet_name="droplets")
                    summary_df.to_excel(xw, index=False,
                                        sheet_name="per_image")
            except (ImportError, AttributeError):
                write_csv(out_dir / "all_droplets_noexcel.csv", combined)
                print("⚠️  Skipped Excel file; install 'xlsxwriter<3.1.0' or "
                      "use Python ≥3.7 if you need .xlsx output.")

        if combined.empty:
            return
        size_col = ("eq_diam_micron" if "eq_diam_micron" in combined.columns
                    else "equivalent_diameter")
        stats = combined[size_col].describe()[["mean", "50%", "std"]].rename(
            {"50%": "median"})
        stats.to_csv(out_dir / "droplet_size_stats.csv")

        if not skip_histogram:
            try:
                import matplotlib
            except ImportError:
                print("⚠️  Skipped size histogram; install matplotlib if you "
                      "need size_histogram.png.")
                return
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure(figsize=(6, 4))
            plt.hist(combined[size_col], bins=40)
            plt.xlabel("Diameter (µm)" if "micron" in size_col
                       else "Diameter (pixels)")
            plt.ylabel("Count")
            plt.title("Droplet size distribution")
            plt.tight_layout()
            plt.savefig(out_dir / "size_histogram.png", dpi=300)
            plt.close()
