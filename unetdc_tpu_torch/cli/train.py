"""CLI: baseline trainer — the port's counterpart of the JAX package's
`cli/train.py` and the reference `train.py` (UNet + combined BCE/dice
loss, 50 epochs, patience 10; train.py:103-259), plus `--device`.

    python -m unetdc_tpu_torch.cli.train --image_dir ... --mask_dir ... \
        [--device {cuda,cpu}] [--data_parallel N]
"""

from __future__ import annotations

import argparse

from unetdc_tpu_torch.cli.train_dc_focal import add_common_flags, build_mesh


def build_parser():
    p = argparse.ArgumentParser("Train baseline UNet")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--mask_dir", required=True)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--ckpt_path", default="best_unet_model2.msgpack")
    p.add_argument("--export_pth", default=None)
    p.add_argument("--val_masks_dir", default="predicted_val_masks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--img_size", type=int, default=512,
                   help="network input size (reference: 512)")
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--summary", action="store_true",
                   help="print a torchsummary-style model table "
                        "(the reference leaves its summary() call "
                        "commented out, train_DC_focal.py:212)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="train data-parallel over N devices (0 = one "
                        "device)")
    add_common_flags(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = build_mesh(args)

    from unetdc_tpu_torch.data.dataset import (SegmentationData,
                                               discover_pairs, split_dataset)
    from unetdc_tpu_torch.train.trainer import TrainConfig, Trainer

    images, masks = discover_pairs(args.image_dir, args.mask_dir)
    (tr_i, tr_m), (va_i, va_m), _ = split_dataset(images, masks)
    print(f"Training set: {len(tr_i)} images")
    print(f"Validation set: {len(va_i)} images")

    cfg = TrainConfig(
        model="unet", loss="combined", lr=args.lr, num_epochs=args.epochs,
        patience=args.patience, batch_size=args.batch, seed=args.seed,
        img_size=args.img_size,
        ckpt_path=args.ckpt_path, export_pth=args.export_pth,
        save_val_masks_dir=args.val_masks_dir, compute_dtype=args.precision,
        augment=not args.no_augment,
        resume=args.resume, history_jsonl=args.history_jsonl,
        remat=args.remat, step_chunk=args.step_chunk)
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
    trainer.plot_curves("loss_and_dice_plot.png", "accuracy_plot.png")
    return trainer


if __name__ == "__main__":
    main()
