"""CLI: segment lipid droplets and build a report — flag-compatible with the
reference `quantify_droplets_batch.py` (same names, defaults and output
tree), running the PyTorch/CUDA port.

    python -m unetdc_tpu_torch.cli.quantify_droplets_batch --img_dir ... \
        --ckpt_path best_UNetDC_focal_model.pth --out_dir quant_results \
        --batch 8 --prob_thresh 0.3 --min_area 1 [--px_per_micron F]
        [--save_overlays] [--background_radius 50] [--skip_excel]
        [--skip_histogram] [--precision {bf16,f32}] [--max_labels N]
        [--int8 [--int8_calib {auto,none,PATH}]] [--device {cuda,cpu}]
        [--data_parallel N] [--profile LOG_DIR]

Runs on the GPU unless `--device cpu` is given; without a GPU it fails
rather than fall back to the CPU. `--data_parallel N` splits each batch
over N devices (N cards; with `--device cpu`, N logical CPU slots), as the
JAX CLI's flag does; `--batch` must divide over them. `--profile LOG_DIR`
writes a torch.profiler trace of the whole call there (engine load, run,
reports) and prints the stage timings and the counters.
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Segment lipid droplets and build a report")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--ckpt_path", default="best_UNetDC_focal_model.pth")
    p.add_argument("--out_dir", default="quant_results")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prob_thresh", type=float, default=0.3)
    p.add_argument("--min_area", type=int, default=1,
                   help="ignore objects smaller than this (pixels²)")
    p.add_argument("--px_per_micron", type=float,
                   help="pixels per micron for physical-unit columns")
    p.add_argument("--save_overlays", action="store_true")
    p.add_argument("--background_radius", type=int, default=50,
                   help="radius for rolling ball background correction")
    p.add_argument("--skip_excel", action="store_true",
                   help="skip generation of the Excel workbook")
    p.add_argument("--skip_histogram", action="store_true",
                   help="skip histogram plot generation")
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16",
                   help="model compute precision")
    p.add_argument("--max_labels", type=int, default=4096,
                   help="per-image component capacity of the droplet tables")
    p.add_argument("--int8", action="store_true",
                   help="post-training-quantized int8 forward (per-tensor "
                        "activation scales; masks may differ marginally "
                        "from --precision f32). Scales load from the "
                        "--int8_calib sidecar when it exists; otherwise "
                        "they are calibrated on the first images in sorted "
                        "filename order and saved there")
    p.add_argument("--int8_calib", default="auto", metavar="PATH",
                   help="int8 calibration sidecar (.npz). 'auto' (default) "
                        "= <ckpt_path>.int8calib.npz; 'none' = recalibrate "
                        "every run, save nothing")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the GPU)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="shard the batch over N devices (0 = one device)")
    p.add_argument("--profile", default=None, metavar="LOG_DIR",
                   help="write a torch.profiler trace to LOG_DIR and print "
                        "the stage timings")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.int8 and args.precision == "f32":
        # f32 is the parity path; quietly replacing it by the quantized
        # forward would hand back masks that are not the parity ones
        parser.error("--int8 contradicts --precision f32 (the parity path); "
                     "drop one of the two flags")

    from unetdc_tpu_torch.core.mesh import make_mesh
    from unetdc_tpu_torch.pipelines.engine import load_engine
    from unetdc_tpu_torch.pipelines.quantify_batch import BatchQuantifyPipeline
    from unetdc_tpu_torch.utils.profiling import (counter_report,
                                                  profile_trace, span,
                                                  stage_report)

    mesh = (make_mesh(args.data_parallel, devices=args.device)
            if args.data_parallel else None)
    calib_path = None
    if args.int8 and args.int8_calib != "none":
        calib_path = (args.ckpt_path + ".int8calib.npz"
                      if args.int8_calib == "auto" else args.int8_calib)
    t_start = time.perf_counter_ns()
    with profile_trace(args.profile), span("quantify.call", root=True):
        engine = load_engine(args.ckpt_path, mesh=mesh,
                             fast=(args.precision == "bf16"),
                             max_labels=args.max_labels, device=args.device,
                             quantize="int8" if args.int8 else None,
                             calib_path=calib_path)
        pipe = BatchQuantifyPipeline(
            engine, args.out_dir, batch=args.batch,
            prob_thresh=args.prob_thresh, min_area=args.min_area,
            px_per_micron=args.px_per_micron,
            save_overlays=args.save_overlays,
            background_radius=args.background_radius)
        pipe.run(args.img_dir)
        with span("quantify.reports"):
            pipe.write_reports(skip_excel=args.skip_excel,
                               skip_histogram=args.skip_histogram)
            engine.close()
    if args.profile:
        print(stage_report())
        print(counter_report(t_start))
    # stdout contract consumed by the GUIs
    print("\n All done. Outputs are in ", pipe.out_dir)
    return pipe


if __name__ == "__main__":
    main()
