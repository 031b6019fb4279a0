"""CLI: production focal-loss training — the port's counterpart of the JAX
package's `cli/train_dc_focal.py` and the reference `train_DC_focal.py`
(same flags, defaults and artifacts, plus `--device`).

    python -m unetdc_tpu_torch.cli.train_dc_focal --image_dir ... \
        --mask_dir ... [--epochs 15] [--batch 8] [--device {cuda,cpu}]

Includes the reference's full test phase: loss/dice/accuracy, confusion
matrix artifact, per-image predicted masks, difference maps and overlays
(train_DC_focal.py:365-468). Runs on the GPU unless `--device cpu` is
given; without a GPU it fails rather than fall back to the CPU.
`--data_parallel N [--shard_space S]` trains on a mesh of N x S devices
(N*S cards; with `--device cpu`, logical CPU slots): the batch splits over
N, and with S > 1 each image's height over S (`train/trainer.py`).
"""

from __future__ import annotations

import argparse
import os

STEP_CHUNK_HELP = ("accepted for compatibility with the JAX trainer, which "
                   "fuses this many steps into one dispatch; the port runs "
                   "one step per batch with the same numerics")


def add_common_flags(p: argparse.ArgumentParser) -> None:
    """Flags both trainer CLIs share, after their own."""
    p.add_argument("--step_chunk", type=int, default=8, help=STEP_CHUNK_HELP)
    p.add_argument("--remat", action="store_true",
                   help="rematerialize activations (larger batches)")
    p.add_argument("--resume", action="store_true",
                   help="resume from ckpt_path if present")
    p.add_argument("--history_jsonl", default=None,
                   help="append per-epoch metrics as JSONL")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the GPU)")


def build_mesh(args):
    """The JAX CLIs' mesh rule, `make_mesh(N, S) if N else None`, over the
    devices of `--device`; a CUDA run first checks that a card exists, and
    a mesh larger than the cards raises (never a CPU fallback)."""
    if not args.data_parallel:
        return None
    from unetdc_tpu_torch.core.mesh import make_mesh
    from unetdc_tpu_torch.device import resolve_device

    resolve_device(args.device)
    return make_mesh(args.data_parallel, getattr(args, "shard_space", 1),
                     devices=args.device)


def build_parser():
    p = argparse.ArgumentParser("Train UNetDC with focal+dice loss")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--mask_dir", required=True)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--focal_ratio", type=float, default=0.3)
    p.add_argument("--ckpt_path", default="best_UNetDC_focal_model.msgpack")
    p.add_argument("--export_pth", default=None,
                   help="also export reference-format .pth on new best")
    p.add_argument("--val_masks_dir", default="predicted_valDCfocal_masks")
    p.add_argument("--test_masks_dir", default="predicted_testDCfocal_masks")
    p.add_argument("--diff_map_dir", default="differences_map_test")
    p.add_argument("--overlay_dir", default="overlay_diff_test")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--img_size", type=int, default=512,
                   help="network input size (reference: 512)")
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--summary", action="store_true",
                   help="print a torchsummary-style model table "
                        "(the reference leaves its summary() call "
                        "commented out, train_DC_focal.py:212)")
    p.add_argument("--plateau_scheduler", action="store_true",
                   help="actually step ReduceLROnPlateau (the reference "
                        "configures but never calls it)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="train data-parallel over N devices (0 = one "
                        "device)")
    p.add_argument("--shard_space", type=int, default=1,
                   help="additionally shard image height over this many "
                        "devices (mesh = data_parallel x shard_space)")
    add_common_flags(p)
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--extra_test_viz", action="store_true",
                   help="also run the reference's extra test-set "
                        "visualization passes (train_DC_focal.py:506-611): "
                        "predicted_masks_test/ dump + triptych figures")
    p.add_argument("--extra_viz_dir", default=".",
                   help="directory for the extra visualization artifacts "
                        "(the reference writes them to the CWD)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = build_mesh(args)

    import numpy as np

    from unetdc_tpu_torch.data.dataset import (SegmentationData,
                                               discover_pairs, split_dataset)
    from unetdc_tpu_torch.train.trainer import TrainConfig, Trainer

    images, masks = discover_pairs(args.image_dir, args.mask_dir)
    (tr_i, tr_m), (va_i, va_m), (te_i, te_m) = split_dataset(images, masks)
    print(f"Training set: {len(tr_i)} images")
    print(f"Validation set: {len(va_i)} images")
    print(f"Testing set: {len(te_i)} images")

    cfg = TrainConfig(
        model="unetdc", loss="focal_dice", focal_ratio=args.focal_ratio,
        lr=args.lr, num_epochs=args.epochs, patience=args.patience,
        batch_size=args.batch, seed=args.seed,
        img_size=args.img_size, ckpt_path=args.ckpt_path,
        export_pth=args.export_pth, save_val_masks_dir=args.val_masks_dir,
        plateau_scheduler=args.plateau_scheduler,
        compute_dtype=args.precision, augment=not args.no_augment,
        resume=args.resume, history_jsonl=args.history_jsonl,
        remat=args.remat, shard_space=args.shard_space > 1,
        step_chunk=args.step_chunk)
    trainer = Trainer(cfg, mesh=mesh, device=args.device)
    if args.summary:
        from unetdc_tpu_torch.utils.summary import model_summary

        print(model_summary(trainer.model,
                            (1, args.img_size, args.img_size, 3)))

    def mk(il, ml, sh):
        return SegmentationData(args.image_dir, args.mask_dir, il, ml,
                                batch_size=args.batch, shuffle=sh,
                                seed=args.seed)

    trainer.fit(mk(tr_i, tr_m, True), mk(va_i, va_m, False))
    trainer.plot_curves()

    if args.skip_test or not te_i:
        return trainer

    # ---- test phase (train_DC_focal.py:365-468) -------------------------
    from unetdc_tpu_torch.checkpoint.native import load_checkpoint
    from unetdc_tpu_torch.losses import \
        plot_binary_confusion_matrix_with_metrics
    from unetdc_tpu_torch.train.test_phase import run_test_phase

    if os.path.exists(args.ckpt_path):
        trainer.variables = load_checkpoint(args.ckpt_path)
    te_loss, te_dice, te_acc, counts = trainer.run_epoch_eval(
        mk(te_i, te_m, False), args.test_masks_dir)
    print("========== Test Results ==========")
    print(f"Test Loss: {te_loss:.4f}")
    print(f"Test Dice: {te_dice:.4f}")
    print(f"Test Accuracy (pixel-wise): {te_acc:.4f}")
    print(f"Test Accuracy (sklearn): {te_acc:.4f}")
    tn, fp, fn, tp = counts
    cm = np.array([[tn, fp], [fn, tp]])
    plot_binary_confusion_matrix_with_metrics(cm, te_acc)
    run_test_phase(trainer, mk(te_i, te_m, False), args.diff_map_dir,
                   args.overlay_dir)
    if args.extra_test_viz:
        from unetdc_tpu_torch.train.test_phase import \
            run_extra_test_visualizations

        run_extra_test_visualizations(trainer, mk(te_i, te_m, False),
                                      args.extra_viz_dir)
    return trainer


if __name__ == "__main__":
    main()
