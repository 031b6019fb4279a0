#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from (benchmark runs do
not run this):

    python3 benchmarks/control.py --workload <cell> --seeds 1 2 3 \
        [--what program control half_batch] [--seconds 1]

  program     a run of the cell (set-up, a window of --seconds, the
              check) in this process: the sound runs' readings, a dozen
              seeds in one process where set-up is long;
  control     the cell's control: the program's own lower-precision path
              where it has one (the quantifier's --int8), else the plain
              reference with its conv operands rounded to fp8 e4m3 in the
              program's place; the check's numbers against the float32
              reference.
  half_batch  (training cells) the reference with half of each batch
              left out, the loss the mean over the rest, in the program's
              place.

One JSON line per seed and reading: {"seed": n, "what": ..., <number>:
value, ...}.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def reading(cell: str, seed: int, what: str, device: str = "cuda",
            workload=None, config=None, seconds: float = 1.0) -> dict:
    import torch

    from harness import core

    if what == "program":
        import run

        res = run.run_cell(cell, seed, seconds, False, device=device,
                           workload=workload, t_start=time.perf_counter())
        return {"correct": res["correct"],
                **{k: c["value"] for k, c in res["checks"].items()}}

    wl = workload or core.load_json("workloads", cell)
    cfg = config or core.load_json("configs", wl["config"])
    entry = core.load_module("entries", wl["entry"])
    with tempfile.TemporaryDirectory(prefix="unetdc-control-") as tmp:
        ctx = core.Context(wl, cfg, seed, torch.device(device), Path(tmp))
        if what == "control":
            arg = wl["control"]
            return entry.control(ctx, arg)
        if what == "half_batch":
            return entry.half_batch(ctx)
    raise ValueError(what)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+", default=["control"],
                   choices=("program", "control", "half_batch"))
    p.add_argument("--seconds", type=float, default=1.0,
                   help="the window of a program reading")
    args = p.parse_args(argv)
    import run

    run.set_env()
    for what in args.what:
        for s in args.seeds:
            t0 = time.perf_counter()
            vals = reading(args.workload, s, what, seconds=args.seconds)
            print(json.dumps({"seed": s, "what": what, **vals,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
