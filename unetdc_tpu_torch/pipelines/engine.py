"""The flagship inference engine: one megastep from raw uint8 images to
droplet tables, on the card.

Port of the JAX package's `pipelines/engine.py::QuantifyEngine`:
    rolling ball -> cv2-exact resize to img_size -> BN-folded UNetDC
    (fused kernels K1, K2) -> threshold -> cv2-exact mask resize back to
    the original size -> connected components, min-area sieve and
    regionprops tables (kernel K3).
Only uint8 images go in; masks and fixed-size droplet property tables come
out. The JAX engine packs every output into one bit-packed buffer to save
transfer calls on its TPU link; that is not needed here, so outputs travel
as they are.

`quantize="int8"` runs the post-training-quantized forward instead
(`models/unet_int8.py`, no K1/K2; under a mesh `forward_int8_spmd`),
calibrated from a sidecar, an explicit `calibrate_int8` call or, failing
both, the first batch.

Under a ('data', 'space') mesh (`core/mesh.py`) the params are replicated
once per distinct device and each batch splits over the data groups: each
group runs the megastep on its first device, its forward through
`models/unet_fast.py::forward_folded_spmd` (with `shard_space`, the
forward's height splits over the group's space shards; preprocess,
threshold, mask resize and the component tables run whole per group).
Each distinct device is driven from its own host thread, since the
component propagation syncs the host once per sweep; the groups' results
are reassembled in batch order.

The engine's `megastep_ms` records the card's time for each batch, from
CUDA events around the megastep (it includes the per-sweep host syncs of
the component propagation; under a mesh, the largest per-device sum of its
groups' times). While tracing (`utils/profiling.py`), two more events split
that time into the device spans `dev.preprocess` (rolling ball, resize
in), `dev.forward` and `dev.components` (threshold, mask resize,
labelling, tables and what a subclass adds), read with `megastep_ms`'s
events and taken from the same device under a mesh; `load_engine` is the
span `engine.load`, and an overflow re-run counts `engine.overflow_reruns`.
"""

from __future__ import annotations

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from unetdc_tpu_torch.core import mesh as M
from unetdc_tpu_torch.device import resolve_device
from unetdc_tpu_torch.models.unet import UNetDC, fold_batchnorm
from unetdc_tpu_torch.models import unet_int8 as qi
from unetdc_tpu_torch.models.unet_fast import (build_fast_params,
                                               forward_folded,
                                               forward_folded_spmd)
from unetdc_tpu_torch.ops import fused_conv
from unetdc_tpu_torch.ops.component_tables import (component_tables,
                                                   component_tables_plain)
from unetdc_tpu_torch.ops.connected_components import quantify_mask_batch
from unetdc_tpu_torch.ops.resize import resize_linear_u8_cv2exact
from unetdc_tpu_torch.ops.rolling_ball import rolling_ball_correction
from unetdc_tpu_torch.utils import profiling
from unetdc_tpu_torch.utils.profiling import stage_timer


class _StageEnds(threading.local):
    """(name, CUDA event) at the end of each stage of the megastep running
    on this thread, while tracing; None otherwise."""
    ends = None


_stage_ends = _StageEnds()


def _end_stage(name: str) -> None:
    ends = _stage_ends.ends
    if ends is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append((name, ev))


def grayscale_view(imgs_u8: np.ndarray) -> np.ndarray:
    """A (B,H,W) single-channel view when every pixel of the (B,H,W,3)
    batch has all channels equal, else the input unchanged. The engine
    broadcasts the channel back to 3 before the model, so results are
    identical; the upload and the preprocess are a third of the size."""
    if imgs_u8.ndim != 4 or imgs_u8.shape[-1] != 3:
        return imgs_u8
    c0 = imgs_u8[..., 0]
    if np.array_equal(c0, imgs_u8[..., 1]) and \
            np.array_equal(c0, imgs_u8[..., 2]):
        return np.ascontiguousarray(c0)
    return imgs_u8


class QuantifyEngine:
    """Batch segmentation + quantification on one device.

    Args:
      state_dict: reference UNetDC/UNet state dict (BatchNorm is folded
        once here).
      model_cls: UNetDC (default) or UNet.
      img_size: network input size (512 in the reference CLI).
      compute_dtype: torch.bfloat16 (default) or torch.float32.
      max_labels: per-image component capacity of the droplet tables.
      device: "cuda" (default) or "cpu"; CUDA must be present if asked for.
      kernels: True runs the fused kernels K1, K2, K3; False runs their
        plain PyTorch versions (the reference path for checking them).
      quantize: None, or "int8" for the quantized forward; its activation
        scales come from `calib_path` when that file exists, from
        `calibrate_int8`, or from the first batch the engine sees, and
        are saved to `calib_path` (when set) whenever they are calibrated.
      mesh: an optional `core.mesh.Mesh`; the engine then runs on its
        devices (`device` is ignored) and each batch must divide over its
        data groups, as in the JAX engine.
      shard_space: also split the forward's height over the mesh's space
        axis (the float or the int8 forward).
    """

    # subclasses set this to receive the pre-sieve component table
    _want_presieve = False

    def __init__(self, state_dict, model_cls=UNetDC, img_size: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 max_labels: int = 4096, device="cuda",
                 kernels: bool = True, quantize: str | None = None,
                 calib_path=None, mesh: Optional[M.Mesh] = None,
                 shard_space: bool = False):
        self.mesh = mesh
        self.shard_space = shard_space
        self.device = M.norm_device(resolve_device(
            mesh.first if mesh is not None else device))
        self.img_size = img_size
        self.max_labels = max_labels
        self.compute_dtype = compute_dtype
        self._dilations = tuple(model_cls.dilations)
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if quantize == "int8" and (self._dilations[0] != 1 or img_size % 2):
            raise ValueError("int8 path requires an undilated enc1 and an "
                             "even img_size")
        self.quantize = quantize
        self.calib_path = calib_path
        self.calib_maxima = None  # (len(TAGS),) f32 once calibrated
        folded = fold_batchnorm(state_dict)
        if quantize == "int8":
            # params appear at calibration; the folded f32 weights stay on
            # the host for the calibration forward and the quantizer
            self._folded = folded
            self.params = None
            if calib_path is not None and os.path.exists(calib_path):
                self._finalize_int8(qi.load_calibration(calib_path))
        else:
            self._set_params(lambda d: build_fast_params(
                folded, compute_dtype, d))
        if kernels:
            self._conv_pool = fused_conv.conv3x3_relu_pool
            self._head = fused_conv.dec1_head
            self._tables = component_tables
        else:
            self._conv_pool = fused_conv.conv3x3_relu_pool_plain
            self._head = fused_conv.dec1_head_plain
            self._tables = component_tables_plain
        self.megastep_ms: List[float] = []
        self._workers: Dict[torch.device, ThreadPoolExecutor] = {}

    def _set_params(self, build) -> None:
        """`self.params` on the engine's device and, under a mesh, one
        replica per distinct device (`self.replicas`)."""
        if self.mesh is None:
            self.replicas = {self.device: build(self.device)}
        else:
            self.replicas = M.replicate(self.mesh, build)
        self.params = self.replicas[self.device]

    # ------------------------------------------------------------------
    def forward_probs(self, x: torch.Tensor,
                      mesh: Optional[M.Mesh] = None) -> torch.Tensor:
        """(B, S, S, 3) float in [0, 1] -> (B, S, S, 1) f32 probabilities,
        over `mesh` (default: the engine's) when there is one."""
        mesh = mesh or self.mesh
        if mesh is None:
            x = x.to(self.device)
        if self.quantize == "int8":
            if self.params is None:
                self.calibrate_int8(x, preprocessed=True)
            if mesh is None:
                return qi.forward_int8(self.params, x, self._dilations)
            return qi.forward_int8_spmd(self.replicas, x, self._dilations,
                                        mesh=mesh,
                                        shard_space=self.shard_space)
        if mesh is None:
            return forward_folded(self.params, x, self._dilations,
                                  self._conv_pool, self._head)
        return forward_folded_spmd(self.replicas, x, self._dilations,
                                   mesh=mesh, shard_space=self.shard_space,
                                   conv_pool=self._conv_pool,
                                   head=self._head)

    # ------------------------------------------------------------------
    def _finalize_int8(self, maxima: np.ndarray) -> None:
        """Quantize on the host from per-tag maxima and move the int8
        params to the device(s); records `calib_maxima`."""
        maxima = np.asarray(maxima, np.float32)
        qp = qi.build_int8_params(self._folded, maxima, self._dilations)
        self._set_params(lambda d: qi.prepare_int8_params(qp, d))
        self.calib_maxima = maxima

    def calibrate_int8(self, batches, *, preprocessed: bool = False,
                       background_radius: int = 50, apply_bg: bool = True,
                       save: bool = True) -> None:
        """Calibrate the int8 activation scales from one or more batches:
        (B,H,W,3) or grayscale (B,H,W) uint8 images, or preprocessed
        (B,S,S,3) f32 with `preprocessed=True` (arrays or tensors), or a
        list of them. The per-tag maxima of the plain f32 forward take the
        elementwise max over the batches; with `save` they go to
        `calib_path` when it is set."""
        if self.quantize != "int8":
            raise ValueError("calibrate_int8 requires quantize='int8'")
        fp = build_fast_params(self._folded, torch.float32, self.device)
        if hasattr(batches, "shape"):
            batches = [batches]
        mx = None
        for a in batches:
            t = torch.as_tensor(a).to(self.device)
            x = t if preprocessed else self._preprocess(
                t, int(background_radius), bool(apply_bg))
            m = qi.forward_calib(fp, x, self._dilations)[1].cpu().numpy()
            mx = m if mx is None else np.maximum(mx, m)
        if mx is None:
            raise ValueError("calibrate_int8 needs at least one batch")
        self._finalize_int8(mx)
        if save and self.calib_path is not None:
            qi.save_calibration(self.calib_path, mx)

    def _preprocess(self, imgs_u8: torch.Tensor, background_radius: int,
                    apply_bg: bool) -> torch.Tensor:
        """(B,H,W,3) or grayscale (B,H,W) uint8 -> (B,S,S,3) f32 in [0,1].
        Every step is per channel, so a grayscale batch is processed once
        and broadcast to 3 channels at the end."""
        size = self.img_size
        gray = imgs_u8.dim() == 3
        planes = imgs_u8[:, None] if gray else imgs_u8.permute(0, 3, 1, 2)
        if apply_bg:
            planes = rolling_ball_correction(planes, background_radius)
        x = resize_linear_u8_cv2exact(planes, (size, size))
        x = (x.to(torch.float32) / 255.0).permute(0, 2, 3, 1)
        if gray:
            x = x.expand(-1, -1, -1, 3)
        return x

    def _megastep(self, imgs_u8: torch.Tensor, prob_thresh: float,
                  min_area: int, out_hw: Tuple[int, int],
                  background_radius: int, apply_bg: bool,
                  max_labels: int, mesh: Optional[M.Mesh] = None
                  ) -> Dict[str, torch.Tensor]:
        """One batch (a data group's, under a mesh: `mesh` is its row) on
        imgs_u8's device."""
        x = self._preprocess(imgs_u8, background_radius, apply_bg)
        _end_stage("dev.preprocess")
        probs = self.forward_probs(x, mesh)
        _end_stage("dev.forward")
        mask = (probs[..., 0] > prob_thresh).to(torch.uint8)
        masks = resize_linear_u8_cv2exact(mask, tuple(out_hw))
        stats = quantify_mask_batch(masks, min_area, max_labels,
                                    connectivity=1, tables=self._tables,
                                    want_presieve=self._want_presieve)
        return {"mask": masks, **stats}

    # ------------------------------------------------------------------
    def dispatch_batch(self, imgs_u8: np.ndarray, out_hw: Tuple[int, int],
                       prob_thresh: float = 0.3, min_area: int = 1,
                       background_radius: int = 50, apply_bg: bool = True):
        """Run one megastep on (B,H,W,3) RGB or (B,H,W) grayscale uint8;
        returns a handle for `fetch_batch` (device results + what an
        overflow re-run needs). Under a mesh the batch must divide over
        the data groups (ValueError otherwise, as the JAX engine's device
        put raises)."""
        imgs_u8 = np.ascontiguousarray(imgs_u8)
        with stage_timer("h2d_upload"):
            if self.mesh is None:
                xs = [torch.from_numpy(imgs_u8).to(self.device)]
            else:
                M.check_batch(self.mesh, imgs_u8.shape[0])
                xs = [torch.from_numpy(p).to(row[0]) for p, row in zip(
                    np.split(imgs_u8, self.mesh.shape[M.DATA_AXIS]),
                    self.mesh.grid)]
        if self.quantize == "int8" and self.params is None:
            # fallback: calibrate on the first batch (order-dependent; the
            # pipeline calibrates on a canonical sorted subset instead)
            self.calibrate_int8(imgs_u8, background_radius=background_radius,
                                apply_bg=apply_bg)
        ctx = (xs, float(prob_thresh), int(min_area), int(background_radius),
               bool(apply_bg))
        return self._run(ctx, tuple(out_hw), self.max_labels), ctx

    def _run(self, ctx, out_hw, max_labels):
        """Every data group's megastep; each distinct device's groups run
        in order on a thread of their own (inline when there is one)."""
        xs, thresh, min_area, radius, apply_bg = ctx

        def groups(gs):
            return [self._run_group(xs[g], None if self.mesh is None
                                    else self.mesh.row(g), thresh, min_area,
                                    out_hw, radius, apply_bg, max_labels)
                    for g in gs]

        by_dev: Dict[torch.device, List[int]] = {}
        for g, x in enumerate(xs):
            by_dev.setdefault(x.device, []).append(g)
        if len(by_dev) == 1:
            return groups(range(len(xs)))
        futs = [(gs, self._worker(d).submit(groups, gs))
                for d, gs in by_dev.items()]
        outs = [None] * len(xs)
        for gs, f in futs:
            for g, o in zip(gs, f.result()):
                outs[g] = o
        return outs

    def _worker(self, dev: torch.device) -> ThreadPoolExecutor:
        if dev not in self._workers:
            self._workers[dev] = ThreadPoolExecutor(1)
        return self._workers[dev]

    def close(self) -> None:
        """Stop the per-device host threads (started only for a mesh over
        more than one distinct device)."""
        for w in self._workers.values():
            w.shutdown(wait=True)
        self._workers.clear()

    def _run_group(self, x, mesh, thresh, min_area, out_hw, radius,
                   apply_bg, max_labels):
        if x.device.type != "cuda":
            return self._megastep(x, thresh, min_area, out_hw, radius,
                                  apply_bg, max_labels, mesh)
        with torch.cuda.device(x.device):  # events and launches on x's card
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ends = [] if profiling.tracing() else None
            _stage_ends.ends = ends
            ev[0].record()
            try:
                out = self._megastep(x, thresh, min_area, out_hw, radius,
                                     apply_bg, max_labels, mesh)
            finally:
                _stage_ends.ends = None
            ev[1].record()
        if ends is not None:
            ends.append(("dev.components", ev[1]))
        out["_events"] = (x.device, ev, ends)
        return out

    def _to_host(self, outs) -> Dict[str, np.ndarray]:
        per_dev: Dict[torch.device, float] = {}
        stages: Dict[torch.device, Dict[str, float]] = {}
        host = []
        for out in outs:
            ev = out.pop("_events", None)
            host.append({k: v.cpu().numpy() for k, v in out.items()})
            if ev is not None:
                dev, (a, b), ends = ev
                b.synchronize()
                per_dev[dev] = per_dev.get(dev, 0.0) + a.elapsed_time(b)
                prev, st = a, stages.setdefault(dev, {})
                for name, e in ends or ():
                    st[name] = st.get(name, 0.0) + prev.elapsed_time(e)
                    prev = e
        if per_dev:
            top = max(per_dev, key=per_dev.get)
            self.megastep_ms.append(per_dev[top])
            for name, ms in stages[top].items():
                profiling.device_span(name, ms)
        if len(host) == 1:
            return host[0]
        return {k: np.concatenate([h[k] for h in host]) for k in host[0]}

    def fetch_batch(self, handle, out_hw: Tuple[int, int]
                    ) -> Dict[str, np.ndarray]:
        """Host numpy results of a dispatched batch: 'mask' (B,H,W) uint8,
        'count', 'total', 'area' and the coordinate-sum tables. A batch
        whose component count exceeds max_labels is re-run (over the same
        mesh) at the next doubled cap that fits (the reference's skimage
        path has no cap)."""
        if isinstance(handle, dict):  # already-split results: no re-run
            outs, ctx = [handle], None
        else:
            outs, ctx = handle
        host = self._to_host([dict(o) for o in outs])
        total_max = int(host["total"].max())
        if total_max > self.max_labels:
            if ctx is None:
                raise RuntimeError(
                    f"image has {total_max} components, exceeding "
                    f"max_labels={self.max_labels}; rebuild the engine "
                    "with a larger max_labels")
            cap = max(2 * self.max_labels, 2)
            while cap < total_max:
                cap *= 2
            profiling.count("engine.overflow_reruns")
            print(f"unetdc_tpu_torch: batch has an image with {total_max} "
                  f"components (> max_labels={self.max_labels}); re-running "
                  f"it at cap {cap}", file=sys.stderr)
            host = self._to_host(self._run(ctx, tuple(out_hw), cap))
            assert int(host["total"].max()) <= cap
        return host

    def run_batch(self, imgs_u8: np.ndarray, out_hw: Tuple[int, int],
                  prob_thresh: float = 0.3, min_area: int = 1,
                  background_radius: int = 50, apply_bg: bool = True
                  ) -> Dict[str, np.ndarray]:
        """Synchronous host entry: uint8 batch -> numpy results."""
        return self.fetch_batch(
            self.dispatch_batch(imgs_u8, out_hw, prob_thresh, min_area,
                                background_radius, apply_bg), out_hw)


def load_state_dict(ckpt_path: str):
    """State dict of a reference `.pth` checkpoint or of a native msgpack
    {'params', 'batch_stats'} checkpoint (either package's trainer writes
    one)."""
    from unetdc_tpu_torch.checkpoint.convert import (load_pth_state_dict,
                                                     variables_to_state_dict)
    from unetdc_tpu_torch.checkpoint.native import load_checkpoint

    if str(ckpt_path).endswith(".pth"):
        return load_pth_state_dict(ckpt_path)
    return variables_to_state_dict(load_checkpoint(str(ckpt_path)))


def load_engine(ckpt_path: str, mesh: Optional[M.Mesh] = None,
                fast: bool = True, model_cls=UNetDC, max_labels: int = 4096,
                device="cuda", kernels: bool = True,
                quantize: str | None = None, calib_path=None,
                shard_space: bool = False) -> QuantifyEngine:
    """Engine from a checkpoint (`load_state_dict`), as the JAX engine's
    `load_engine`. `fast` selects bf16 (default) over f32; `quantize="int8"`
    the calibrated int8 forward with its scales loaded from / saved to the
    `calib_path` sidecar; `mesh` / `shard_space` the multi-device run.
    While tracing, the span `engine.load` (checkpoint read, BatchNorm fold,
    parameter build and upload)."""
    with profiling.span("engine.load"):
        return QuantifyEngine(load_state_dict(ckpt_path), model_cls=model_cls,
                              compute_dtype=torch.bfloat16 if fast
                              else torch.float32, max_labels=max_labels,
                              device=device, kernels=kernels,
                              quantize=quantize, calib_path=calib_path,
                              mesh=mesh, shard_space=shard_space)
