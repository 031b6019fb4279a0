"""Training loop reproducing the reference trainers; port of the JAX
package's `train/trainer.py`.

Reference behaviors reproduced (train_DC_focal.py / train.py):
  - Adam lr=1e-3 (b1=.9, b2=.999, eps=1e-8 outside the sqrt, as optax and
    torch both have it);
  - focal_dice_loss(alpha=1, gamma=2, ratio=0.3) for the DC-focal config
    (train_DC_focal.py:222) or combined_loss for the baseline
    (train.py:124), computed from logits (losses.losses);
  - per-step metrics: loss, hard dice of masks binarized at 0.3, pixel
    accuracy, kept on the device and summed in f64 on the host once per
    epoch; dice is averaged over batches, as the JAX trainer does;
  - per-epoch stdout lines in the exact reference format
    (train_DC_focal.py:342-346): the GUI parses them;
  - best-val-dice checkpointing and early-stop patience
    (train_DC_focal.py:348-358);
  - the reference's ReduceLROnPlateau is never stepped, so the LR is
    constant unless `plateau_scheduler=True`;
  - validation masks resized to the original size with true nearest.

Checkpoints are the JAX package's files, written by the port's own msgpack
codec: `ckpt_path` (best weights, flax variable layout), `.meta.json`,
`.opt` (optax adam state dict), `.last` (weights + optimizer + counters of
the last epoch in one atomically replaced file) and `.state.json`. A run
of either package resumes from the other's files.

The JAX trainer's `step_chunk` (fusing steps into one lax.scan dispatch to
hide the TPU link's per-call latency) has no counterpart: the port runs one
step per batch with the same numerics.

Under a ('data', 'space') mesh (`core/mesh.py`) one process drives every
device, as the JAX trainer's single controller does: the master weights,
the Adam state, the device sample bank, the preprocess and the augment
live on the mesh's first device; a ragged batch is padded to the data axis
with zero-weight replicas before preprocessing; the step runs
`models/unet.py::forward_sharded` (batch over the data groups, with
`shard_space` the height over the space shards, BatchNorm statistics of
the whole batch) as one autograd graph, whose backward sums every device's
gradient into the master weights; the loss and the metrics are computed
once, on the gathered logits, exactly as on one device. Checkpoints hold
the master weights, so a run resumes across packages and across meshes.

While tracing (`utils/profiling.py`), a training epoch is the root span
`train.epoch`; each step's `train.data_wait` (the wait for the next batch),
`train.device_batch`, `train.augment` and `train.step` (the enqueue of
forward, backward and Adam) carry its step id, and each point where the
host blocks on the device is a `sync` span that counts `host_syncs`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from unetdc_tpu_torch.checkpoint.convert import (load_optax_adam_state,
                                                 optax_adam_state_dict,
                                                 torch_state_dict_to_variables,
                                                 variables_to_state_dict)
from unetdc_tpu_torch.checkpoint.native import (BestMetricCheckpointer,
                                                load_checkpoint,
                                                load_metadata,
                                                save_checkpoint)
from unetdc_tpu_torch.core import mesh as M
from unetdc_tpu_torch.data.augment import augment_batch
from unetdc_tpu_torch.data.dataset import SegmentationData
from unetdc_tpu_torch.data.prefetch import Prefetcher
from unetdc_tpu_torch.device import resolve_device
from unetdc_tpu_torch.losses import confusion_counts, dice_coef
from unetdc_tpu_torch.losses.losses import (combined_loss_from_logits,
                                            focal_dice_loss_from_logits)
from unetdc_tpu_torch.models.unet import (UNet, UNetDC, forward_sharded,
                                          init_flax_)
from unetdc_tpu_torch.ops.resize import (resize_linear_u8_cv2exact,
                                         resize_nearest)
from unetdc_tpu_torch.ops.rolling_ball import rolling_ball_correction
from unetdc_tpu_torch.utils.profiling import span, sync

@dataclasses.dataclass
class TrainConfig:
    model: str = "unetdc"               # 'unet' | 'unetdc'
    loss: str = "focal_dice"            # 'focal_dice' | 'combined'
    focal_ratio: float = 0.3
    lr: float = 1e-3
    num_epochs: int = 15                # train_DC_focal.py:220
    patience: int = 5                   # train_DC_focal.py:230
    batch_size: int = 8
    img_size: int = 512
    metric_thresh: float = 0.3          # train_DC_focal.py:259
    background_radius: int = 50
    seed: int = 0
    ckpt_path: str = "best_UNetDC_focal_model.msgpack"
    export_pth: Optional[str] = None    # also write a reference .pth
    save_val_masks_dir: Optional[str] = None
    plateau_scheduler: bool = False     # reference never steps its scheduler
    compute_dtype: str = "bf16"
    augment: bool = True
    resume: bool = False                # resume from ckpt_path if it exists
    # write ckpt_path+'.last'(+.opt) every epoch so --resume continues the
    # exact trajectory; False reverts to best-only (reference semantics)
    save_last: bool = True
    remat: bool = False                 # activation checkpointing
    history_jsonl: Optional[str] = None  # structured per-epoch metrics log
    # under a mesh, also shard the image height over its 'space' axis
    shard_space: bool = False
    # accepted for compatibility with the JAX trainer, which fuses this many
    # steps into one dispatch; the port runs one step per batch
    step_chunk: int = 8
    # keep decoded uint8 samples on the device (keyed by the decode cache's
    # stable array identities) so later epochs upload nothing; byte budget,
    # 0 disables
    device_cache_bytes: int = 2 << 30


class Trainer:
    """UNet/UNetDC trainer on one device ("cuda" unless asked otherwise;
    a missing card is an error) or, given a `core.mesh.Mesh`, on its
    devices (`device` is then ignored; every device must be present)."""

    def __init__(self, config: TrainConfig, mesh: Optional[M.Mesh] = None,
                 device="cuda"):
        self.cfg = config
        self.mesh = mesh
        if mesh is not None:
            for d in mesh.distinct():
                resolve_device(d)
                if d.type == "cuda" and d.index >= torch.cuda.device_count():
                    raise RuntimeError(f"unetdc_tpu_torch: the mesh needs "
                                       f"{d}, but CUDA shows "
                                       f"{torch.cuda.device_count()} cards")
            device = mesh.first
        self.device = M.norm_device(resolve_device(device))
        if self.device.type == "cuda":
            # shapes are fixed for a run: let cuDNN time its algorithms once
            torch.backends.cudnn.benchmark = True
        model_cls = UNetDC if config.model == "unetdc" else UNet
        dtype = torch.bfloat16 if config.compute_dtype == "bf16" \
            else torch.float32
        # logits out; losses in logits space, probabilities taken explicitly
        model = model_cls(compute_dtype=dtype, apply_sigmoid=False,
                          remat=config.remat)
        init_flax_(model, torch.Generator().manual_seed(config.seed))
        self.model = model.to(self.device)
        self._names = [n for n, _ in self.model.named_parameters()]
        self.opt = torch.optim.Adam(
            self.model.parameters(), lr=config.lr, betas=(0.9, 0.999),
            eps=1e-8, fused=self.device.type == "cuda")
        if config.loss == "focal_dice":
            self.loss_fn = lambda z, t, w: focal_dice_loss_from_logits(
                z, t, alpha=1.0, gamma=2.0, ratio=config.focal_ratio,
                weights=w)
        else:
            self.loss_fn = combined_loss_from_logits
        self.history: Dict[str, List[float]] = {
            k: [] for k in ("train_loss", "val_loss", "train_dice",
                            "val_dice", "train_acc", "val_acc")}
        # id(host sample array) -> (device copy, host ref); the host ref
        # pins the array so its id stays valid while the bank lives
        self._devbank: Dict[int, tuple] = {}
        self._devbank_bytes_left = int(config.device_cache_bytes)

    # ------------------------------------------------------------ state --
    @property
    def variables(self) -> dict:
        """The JAX package's {'params', 'batch_stats'} tree (numpy)."""
        return torch_state_dict_to_variables(self.model.state_dict())

    @variables.setter
    def variables(self, tree: dict) -> None:
        self.model.load_state_dict(variables_to_state_dict(tree))

    def opt_state_dict(self) -> dict:
        """The optimizer as an optax state dict (flax `to_state_dict`)."""
        return optax_adam_state_dict(self.opt, self._names,
                                     injected=self.cfg.plateau_scheduler)

    def load_opt_state_dict(self, opt_sd: dict) -> None:
        load_optax_adam_state(self.opt, self._names, opt_sd)

    # ------------------------------------------------------------ batch --
    def _stack_batch(self, batch):
        """(imgs, masks) uint8 on the device, through the device-resident
        sample bank where possible (no upload on later epochs)."""
        dev = self.device
        if self.cfg.device_cache_bytes > 0 and "sample_images" in batch:
            def on_device(arr):
                hit = self._devbank.get(id(arr))
                if hit is not None:
                    return hit[0]
                with sync("bank_miss"):
                    d = torch.tensor(arr, device=dev)
                if not arr.flags.writeable and \
                        arr.nbytes <= self._devbank_bytes_left:
                    # only arrays the dataset itself caches (read-only): a
                    # mutable array's id could be reused after it is freed
                    self._devbank[id(arr)] = (d, arr)
                    self._devbank_bytes_left -= arr.nbytes
                return d
            return (torch.stack([on_device(a)
                                 for a in batch["sample_images"]]),
                    torch.stack([on_device(a)
                                 for a in batch["sample_masks"]]))
        with sync("batch_upload", 2):
            return (torch.tensor(batch["images"], device=dev),
                    torch.tensor(batch["masks"], device=dev))

    def preprocess(self, imgs_u8: torch.Tensor, masks_u8: torch.Tensor):
        """SegmentationDataset semantics (utils/data_loader.py:41-68) on the
        device: rolling ball at the original size, resize to img_size
        (cv2-exact LINEAR for the image, NEAREST for the mask), /255.
        (B,H,W,3), (B,H,W) uint8 -> (B,S,S,3), (B,S,S) float32."""
        size = (self.cfg.img_size, self.cfg.img_size)
        planes = rolling_ball_correction(imgs_u8.permute(0, 3, 1, 2),
                                         self.cfg.background_radius)
        x = resize_linear_u8_cv2exact(planes, size)
        x = (x.to(torch.float32) / 255.0).permute(0, 2, 3, 1)
        return x, resize_nearest(masks_u8, size).to(torch.float32)

    def _device_batch(self, batch):
        """(x, m (B,S,S,1), valid (B,) f32 weights, valid as numpy). Under
        a mesh a ragged batch is first padded to the data axis with
        replicas of weight 0 (the JAX order: pad, preprocess, augment)."""
        imgs, masks = self._stack_batch(batch)
        n_valid = int(batch.get("n_valid", imgs.shape[0]))
        valid = np.ones(imgs.shape[0], np.float32)
        valid[n_valid:] = 0.0
        if self.mesh is not None:
            imgs, masks, valid = M.pad_to_data_axis(imgs, masks, valid,
                                                    self.mesh)
        x, m = self.preprocess(imgs, masks)
        with sync("valid_upload"):
            valid_t = torch.from_numpy(valid).to(self.device)
        return x, m[..., None], valid_t, valid

    # ------------------------------------------------------------ steps --
    def _forward(self, x, keep=None):
        """Logits of the model in its current mode, on one device or over
        the mesh; `keep` (B,) bool leaves samples out of the batch
        statistics."""
        if self.mesh is None:
            return self.model(x, sample_mask=None if keep is None
                              else keep.to(self.device))
        return forward_sharded(self.model, x, self.mesh,
                               self.cfg.shard_space, keep)

    def _metrics(self, probs, masks, valid):
        pred = (probs > self.cfg.metric_thresh).to(torch.float32)
        dice = dice_coef(masks, pred, weights=valid)
        w = valid.reshape((-1,) + (1,) * (masks.dim() - 1))
        return dice, ((pred == masks) * w).sum()

    def train_step(self, x, m, valid, valid_np=None) -> torch.Tensor:
        """One Adam step on a preprocessed batch; returns the device
        metrics [loss, dice, correct pixels]. Samples of weight 0 are left
        out of the loss, the gradients, the BatchNorm statistics and the
        metrics."""
        self.model.train()
        keep = None
        if valid_np is not None and not valid_np.all():
            keep = torch.from_numpy(valid_np > 0.5)
        logits = self._forward(x, keep)
        loss = self.loss_fn(logits, m, valid)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        with torch.no_grad():
            dice, correct = self._metrics(torch.sigmoid(logits), m, valid)
        return torch.stack([loss.detach(), dice, correct])

    @torch.no_grad()
    def predict_probs(self, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode probabilities (B,S,S,1) of preprocessed images."""
        self.model.eval()
        return torch.sigmoid(self._forward(x))

    @torch.no_grad()
    def eval_step(self, x, m, valid):
        self.model.eval()
        logits = self._forward(x)
        probs = torch.sigmoid(logits)
        loss = self.loss_fn(logits, m, valid)
        dice, correct = self._metrics(probs, m, valid)
        counts = confusion_counts(m, probs, self.cfg.metric_thresh,
                                  sample_mask=valid > 0.5)
        return probs, torch.stack([loss, dice, correct]), counts

    @staticmethod
    def _sum_metrics(dev_metrics):
        """One stack and one fetch for an epoch's per-step device metrics;
        exact f64 sums on the host."""
        if not dev_metrics:
            return tuple(np.float64(0.0) for _ in range(3))
        with sync("sum_metrics"):
            stacked = torch.stack(dev_metrics).cpu().numpy()
        return tuple(stacked.astype(np.float64).sum(axis=0))

    # ----------------------------------------------------------- epochs --
    def run_epoch_train(self, data: SegmentationData, epoch: int):
        cfg = self.cfg
        # stateless per epoch (seed*1000+epoch), one generator per batch
        # drawn from it whatever the batch does, as the JAX trainer splits
        # one key per batch
        gen = torch.Generator().manual_seed(cfg.seed * 1000 + epoch)
        dev_metrics = []
        tot_px = 0
        n_batches = 0
        px = cfg.img_size * cfg.img_size
        with span("train.epoch", root=True, epoch=epoch):
            for step, batch in enumerate(Prefetcher(
                    data.batches(), wait_span="train.data_wait")):
                sub = torch.Generator().manual_seed(
                    int(torch.randint(0, 2 ** 62, (), generator=gen)))
                tot_px += batch["n_valid"] * px
                n_batches += 1
                with span("train.device_batch", step=step):
                    x, m, valid, valid_np = self._device_batch(batch)
                if cfg.augment:
                    with span("train.augment", step=step):
                        x, m2 = augment_batch(sub, x, m[..., 0])
                    m = m2[..., None]
                with span("train.step", step=step):
                    dev_metrics.append(self.train_step(x, m, valid,
                                                       valid_np))
            tot_loss, tot_dice, tot_correct = self._sum_metrics(dev_metrics)
        return (tot_loss / max(n_batches, 1), tot_dice / max(n_batches, 1),
                tot_correct / max(tot_px, 1))

    def run_epoch_eval(self, data: SegmentationData,
                       save_masks_dir: Optional[str] = None):
        dev_metrics, dev_counts = [], []
        tot_px = 0
        n_batches = 0
        px = self.cfg.img_size * self.cfg.img_size
        for batch in Prefetcher(data.batches()):
            tot_px += batch["n_valid"] * px
            n_batches += 1
            x, m, valid, _ = self._device_batch(batch)
            probs, metrics, counts = self.eval_step(x, m, valid)
            dev_metrics.append(metrics)
            dev_counts.append(counts)
            if save_masks_dir is not None:
                self._save_pred_masks(probs, batch, save_masks_dir)
        tot_loss, tot_dice, tot_correct = self._sum_metrics(dev_metrics)
        counts_sum = (torch.stack(dev_counts).cpu().numpy().sum(axis=0)
                      if dev_counts else np.zeros(4, np.int64))
        return (tot_loss / max(n_batches, 1), tot_dice / max(n_batches, 1),
                tot_correct / max(tot_px, 1), counts_sum)

    def _save_pred_masks(self, probs, batch, out_dir: str):
        """Reference val-mask saving (train_DC_focal.py:313-331): binarize
        at 0.3, resize to the original size with TRUE nearest (keyword
        interpolation=INTER_NEAREST at :324), save {base}_pred.png for every
        sample (the reference saves only its last batch, an indentation
        bug)."""
        pred = (probs[..., 0] > self.cfg.metric_thresh).to(torch.uint8)
        masks = (resize_nearest(pred, tuple(batch["orig_size"])) * 255
                 ).cpu().numpy()
        self._write_mask_pngs(masks, batch, out_dir)

    @staticmethod
    def _write_mask_pngs(masks, batch, out_dir: str):
        from PIL import Image

        os.makedirs(out_dir, exist_ok=True)
        for j in range(batch["n_valid"]):
            base = os.path.splitext(batch["filenames"][j])[0]
            out_path = os.path.join(out_dir, f"{base}_pred.png")
            Image.fromarray(masks[j].astype(np.uint8)).save(out_path)
            print(f"Saved predicted mask: {out_path}")

    # -------------------------------------------------------------- fit --
    def _resume(self, gate: BestMetricCheckpointer):
        """Restore weights, optimizer and counters; returns (start_epoch,
        plateau_best, plateau_count). Prefers the `.last` bundle (the
        uninterrupted trajectory: per-epoch random streams are stateless);
        a best-only checkpoint rewinds to the best epoch and says so."""
        cfg = self.cfg
        plateau_best, plateau_count, start_epoch = float("inf"), 0, 0
        last_path = cfg.ckpt_path + ".last"
        from_last = os.path.exists(last_path)
        src = last_path if from_last else cfg.ckpt_path
        blob = load_checkpoint(src)
        if from_last and isinstance(blob, dict) and "state" in blob:
            self.variables = blob["variables"]
            self.load_opt_state_dict(blob["opt"])
            st = blob["state"]
            start_epoch = int(st["last_epoch"]) + 1
            bm = float(st["best_metric"])
            if "has_best" in st:
                gate.best = bm if int(st["has_best"]) else None
            else:  # older bundles: NaN as the "no best yet" sentinel
                gate.best = None if np.isnan(bm) else bm
            gate.counter = int(st["patience_counter"])
            plateau_best = float(st["plateau_best"])
            plateau_count = int(st["plateau_count"])
        else:
            self.variables = blob
            if os.path.exists(src + ".opt"):
                self.load_opt_state_dict(load_checkpoint(src + ".opt"))
            meta = load_metadata(src) or {}
            state_path = cfg.ckpt_path + ".state.json"
            if os.path.exists(state_path):
                with open(state_path) as f:
                    st = json.load(f)
                start_epoch = int(st["last_epoch"]) + 1
                gate.best = (float(st["best_metric"])
                             if st["best_metric"] is not None else None)
                gate.counter = int(st["patience_counter"])
                pb = st.get("plateau_best")
                plateau_best = float(pb) if pb is not None else float("inf")
                plateau_count = int(st.get("plateau_count", 0))
            else:  # older checkpoints: best-epoch metadata only
                start_epoch = int(meta.get("epoch", -1)) + 1
                gate.best = float(meta.get("best_metric",
                                           meta.get("val_dice", 0.0)))
        note = ("" if from_last else
                " NOTE: weights restored are the BEST checkpoint, not "
                "the last epoch's.")
        print(f"Resumed from {src} at epoch {start_epoch} "
              f"(best val dice {(gate.best or 0.0):.4f}).{note}")
        return start_epoch, plateau_best, plateau_count

    def fit(self, train_data: SegmentationData, val_data: SegmentationData):
        """Epoch loop with reference-format stdout and early stopping."""
        cfg = self.cfg
        gate = BestMetricCheckpointer(cfg.ckpt_path, patience=cfg.patience,
                                      mode="max")
        plateau_best, plateau_count, start_epoch = float("inf"), 0, 0
        if cfg.resume and (os.path.exists(cfg.ckpt_path)
                           or os.path.exists(cfg.ckpt_path + ".last")):
            start_epoch, plateau_best, plateau_count = self._resume(gate)
        for epoch in range(start_epoch, cfg.num_epochs):
            t0 = time.time()
            tr_loss, tr_dice, tr_acc = self.run_epoch_train(train_data, epoch)
            va_loss, va_dice, va_acc, _ = self.run_epoch_eval(
                val_data, cfg.save_val_masks_dir)
            h = self.history
            for k, v in (("train_loss", tr_loss), ("val_loss", va_loss),
                         ("train_dice", tr_dice), ("val_dice", va_dice),
                         ("train_acc", tr_acc), ("val_acc", va_acc)):
                h[k].append(v)

            # exact reference stdout format (train_DC_focal.py:342-346)
            print(f"Epoch {epoch+1}/{cfg.num_epochs} | "
                  f"Train Loss: {tr_loss:.4f}, Val Loss: {va_loss:.4f}, "
                  f"Train Dice: {tr_dice:.4f}, Val Dice: {va_dice:.4f}")
            print(f"Train Acc: {tr_acc:.4f}, Val Acc: {va_acc:.4f}")
            print("-------------------------------------------------------")
            if cfg.history_jsonl:
                with open(cfg.history_jsonl, "a") as f:
                    f.write(json.dumps({
                        "epoch": epoch + 1, "train_loss": tr_loss,
                        "val_loss": va_loss, "train_dice": tr_dice,
                        "val_dice": va_dice, "train_acc": tr_acc,
                        "val_acc": va_acc,
                        "elapsed_s": time.time() - t0}) + "\n")

            if cfg.plateau_scheduler:
                # ReduceLROnPlateau(mode='min', factor=0.5, patience=5): the
                # fix the reference configured but never invoked
                if va_loss < plateau_best - 1e-12:
                    plateau_best = va_loss
                    plateau_count = 0
                else:
                    plateau_count += 1
                    if plateau_count > 5:
                        for g in self.opt.param_groups:
                            g["lr"] = g["lr"] * 0.5
                        plateau_count = 0

            improved = gate.is_improvement(va_dice)
            variables = self.variables
            opt_sd = self.opt_state_dict()
            stop = gate.update(va_dice, variables,
                               {"epoch": epoch, "val_dice": va_dice,
                                "elapsed_s": time.time() - t0})
            if improved:
                # the optimizer beside the best weights, so --resume from a
                # best-only checkpoint continues the Adam moments
                save_checkpoint(cfg.ckpt_path + ".opt", opt_sd)
                if cfg.export_pth:
                    self._export_pth(cfg.export_pth)
                print("Model saved!")
            if cfg.save_last:
                # weights + optimizer + counters of this epoch in ONE
                # atomically replaced file: an interruption at any point
                # leaves a self-consistent epoch boundary
                save_checkpoint(cfg.ckpt_path + ".last", {
                    "variables": variables,
                    "opt": opt_sd,
                    "state": {
                        "last_epoch": np.int64(epoch),
                        "val_dice": np.float64(va_dice),
                        "best_metric": np.float64(
                            gate.best if gate.best is not None else np.nan),
                        # NaN is a legal best metric for a diverged run,
                        # so it cannot double as "no best yet"
                        "has_best": np.int64(1 if gate.best is not None
                                             else 0),
                        "patience_counter": np.int64(gate.counter),
                        "plateau_best": np.float64(plateau_best),
                        "plateau_count": np.int64(plateau_count),
                    }}, {"epoch": epoch, "val_dice": va_dice})
            # state.json: the resume source for best-only checkpoints
            tmp = cfg.ckpt_path + ".state.json.tmp"
            with open(tmp, "w") as f:
                json.dump({"last_epoch": epoch,
                           "best_metric": gate.best,
                           "patience_counter": gate.counter,
                           "plateau_best": (plateau_best
                                            if plateau_best != float("inf")
                                            else None),
                           "plateau_count": plateau_count}, f)
            os.replace(tmp, cfg.ckpt_path + ".state.json")
            if stop:
                print("Early stopping!")
                break
        return self.history

    def _export_pth(self, path: str):
        """Weights in the reference .pth layout."""
        torch.save(variables_to_state_dict(self.variables), path)

    # ------------------------------------------------------------------
    def plot_curves(self, out_path: str = "loss_and_dice_focal_plot.png",
                    acc_path: str = "accuracy_plot.png"):
        """Loss/dice and accuracy curve artifacts
        (train_DC_focal.py:470-504)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        h = self.history
        epochs = range(1, len(h["train_loss"]) + 1)
        plt.figure(figsize=(12, 4))
        plt.subplot(1, 2, 1)
        plt.plot(epochs, h["train_loss"], label="Training Loss", color="red")
        plt.plot(epochs, h["val_loss"], label="Validation Loss",
                 color="green")
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.legend()
        plt.title("Training and Validation Loss")
        plt.subplot(1, 2, 2)
        plt.plot(epochs, h["train_dice"], label="Training Dice & focal",
                 color="red")
        plt.plot(epochs, h["val_dice"], label="Validation Dice",
                 color="green")
        plt.xlabel("Epoch")
        plt.ylabel("Dice")
        plt.legend()
        plt.title("Training and Validation Dice_Focal")
        plt.tight_layout()
        plt.savefig(out_path)
        plt.close()

        plt.figure(figsize=(6, 4))
        plt.plot(epochs, h["train_acc"], label="Training Accuracy")
        plt.plot(epochs, h["val_acc"], label="Validation Accuracy")
        plt.xlabel("Epoch")
        plt.ylabel("Accuracy")
        plt.legend()
        plt.title("Training and Validation Accuracy")
        plt.tight_layout()
        plt.savefig(acc_path)
        plt.close()
