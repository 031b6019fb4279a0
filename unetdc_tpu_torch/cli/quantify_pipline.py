"""CLI: batch quantification + radial/spatial density heatmaps, running
the PyTorch/CUDA port; flag-compatible with the reference
`quantify_pipline.py` (filename typo kept on purpose) and with the JAX
package's CLI of the same name.

    python -m unetdc_tpu_torch.cli.quantify_pipline --img_dir ... \
        --ckpt_path best_UNetDC_focal_model.pth --out_dir quantify_results \
        [--batch 8] [--prob_thresh 0.3] [--min_area 1] [--px_per_micron F]
        [--save_overlays] [--precision {bf16,f32}] [--max_labels N]
        [--device {cuda,cpu}] [--data_parallel N]

Runs on the GPU unless `--device cpu` is given; without a GPU it fails
rather than fall back to the CPU. `--data_parallel N` splits each batch
over N devices, as the JAX CLI's flag does.
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser("Segment lipid droplets and build a report")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--ckpt_path", default="best_UNetDC_focal_model.pth")
    p.add_argument("--out_dir", default="quantify_results")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prob_thresh", type=float, default=0.3)
    p.add_argument("--min_area", type=int, default=1)
    p.add_argument("--px_per_micron", type=float)
    p.add_argument("--save_overlays", action="store_true")
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
    from unetdc_tpu_torch.pipelines.heatmaps import (HeatmapV1Engine,
                                                     HeatmapV1Pipeline)

    mesh = (make_mesh(args.data_parallel, devices=args.device)
            if args.data_parallel else None)
    engine = HeatmapV1Engine(
        load_state_dict(args.ckpt_path),
        compute_dtype=torch.bfloat16 if args.precision == "bf16"
        else torch.float32, max_labels=args.max_labels, device=args.device,
        mesh=mesh)
    pipe = HeatmapV1Pipeline(
        engine, args.out_dir, batch=args.batch, prob_thresh=args.prob_thresh,
        min_area=args.min_area, px_per_micron=args.px_per_micron,
        save_overlays=args.save_overlays)
    pipe.run(args.img_dir)
    engine.close()
    pipe.write_reports()
    print("\n✓ All done. Outputs are in →", pipe.out_dir)
    return pipe


if __name__ == "__main__":
    main()
