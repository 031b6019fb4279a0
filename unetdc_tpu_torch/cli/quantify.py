"""CLI: BlobInspector-style quantification + fixed-scale density heatmaps,
running the PyTorch/CUDA port; flag-compatible with the reference
`quantify.py` (the required --px_per_micron and the --kernel_size /
--nb_layers / --contour_thresh / --contour_min_size knobs) and with the
JAX package's CLI of the same name.

    python -m unetdc_tpu_torch.cli.quantify --img_dir ... \
        --px_per_micron 3.45 [--ckpt_path ...] [--out_dir quanti_results]
        [--kernel_size 55] [--nb_layers 3] [--contour_thresh 0]
        [--contour_min_size 20] [--precision {bf16,f32}]
        [--device {cuda,cpu}] [--data_parallel N]

Runs on the GPU unless `--device cpu` is given; without a GPU it fails
rather than fall back to the CPU. `--data_parallel N` splits each batch
over N devices, as the JAX CLI's flag does.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--img_dir", required=True)
    p.add_argument("--ckpt_path", default="best_UNetDC_focal_model.pth")
    p.add_argument("--out_dir", default="quanti_results")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prob_thresh", type=float, default=0.3)
    p.add_argument("--min_area", type=int, default=1)
    p.add_argument("--px_per_micron", type=float, required=True)
    p.add_argument("--save_overlays", action="store_true")
    p.add_argument("--kernel_size", type=int, default=55)
    p.add_argument("--nb_layers", type=int, default=3)
    p.add_argument("--contour_thresh", type=int, default=0)
    p.add_argument("--contour_min_size", type=int, default=20)
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="shard the batch over N devices (0 = one device)")
    p.add_argument("--max_labels", type=int, default=4096,
                   help="per-image component table capacity")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the GPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from unetdc_tpu_torch.core.mesh import make_mesh
    from unetdc_tpu_torch.pipelines.engine import load_state_dict
    from unetdc_tpu_torch.pipelines.heatmaps import (BlobInspectorEngine,
                                                     BlobInspectorPipeline)

    mesh = (make_mesh(args.data_parallel, devices=args.device)
            if args.data_parallel else None)
    engine = BlobInspectorEngine(
        load_state_dict(args.ckpt_path),
        compute_dtype=torch.bfloat16 if args.precision == "bf16"
        else torch.float32, max_labels=args.max_labels, device=args.device,
        mesh=mesh, kernel_size=args.kernel_size,
        nb_layers=args.nb_layers, contour_thresh=args.contour_thresh,
        contour_min_size=args.contour_min_size)
    pipe = BlobInspectorPipeline(
        engine, args.out_dir, batch=args.batch, prob_thresh=args.prob_thresh,
        min_area=args.min_area, px_per_micron=args.px_per_micron,
        save_overlays=args.save_overlays)
    pipe.run(args.img_dir)
    engine.close()
    print("✅ All done! Outputs are in", pipe.out_dir)
    return pipe


if __name__ == "__main__":
    main()
