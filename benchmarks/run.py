#!/usr/bin/env python3
"""The benchmark of `unetdc_tpu_torch` (the PyTorch/CUDA port): one run of
one cell.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name: the cell in benchmarks/workloads/<cell>.json,
its configuration in benchmarks/configs/<config>.json, its entry kind in
benchmarks/entries/<kind>.py, each metric's reader in
benchmarks/metrics/<metric>.py; BENCHMARK.json says which metrics a cell
reports. A run sets up (inputs and weights from the seed, a warm-up of the
cell's own shapes), measures whole units of work back to back until
--seconds have passed, reads its metrics, checks what the timed path
produced against the plain reference in benchmarks/reference/, and prints
one JSON line last. With --trace 1 the window runs under torch.profiler
(CUDA activity) and the line carries the per-layer metrics instead of the
end-to-end ones; a cell with an end-to-end metric read from the device
trace runs its window under the profiler with --trace 0 as well.

Without a card (or with fewer than the cell asks for) it exits 2 and
prints no result; it exits 3 if jax, jaxlib, flax, optax or the JAX
package (unetdc_tpu) is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def set_env() -> None:
    """The CUDA driver's kernel cache at a fixed path inside the checkout
    (the port builds its own kernels into unetdc_tpu_torch/_build/)."""
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".bench_cache" / "nv")


def cell_metrics(cell: str, spec: dict):
    """(end-to-end names, per-layer names) that BENCHMARK.json gives the
    cell. A per-layer metric without a `workloads` key goes to every cell
    that reports the end-to-end metric it moves."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    layer = [m["name"] for m in spec["per_layer"]
             if cell in m.get("workloads", [])
             or ("workloads" not in m and m["moves"] in e2e)]
    return e2e, layer


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: dict = None, t_start: float = None,
             workload: dict = None) -> dict:
    """Set up, measure, read and check one run; returns the result dict
    (the printed line's keys) plus the reference checks."""
    import torch

    from harness import core
    from harness.trace import DeviceTrace

    spec = spec or core.benchmark_json()
    wl = workload or core.load_json("workloads", cell)
    cfg = core.load_json("configs", wl["config"])
    entry = core.load_module("entries", wl["entry"])
    e2e_names, layer_names = cell_metrics(cell, spec)
    traced = trace or any(m["source"] == "device_trace"
                          and m["name"] in e2e_names
                          for m in spec["end_to_end"])
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    dev = torch.device(device)
    t_start = T_START if t_start is None else t_start

    with tempfile.TemporaryDirectory(prefix="unetdc-bench-") as tmp:
        ctx = core.Context(wl, cfg, seed, dev, Path(tmp))
        card = core.card_record(0) if dev.type == "cuda" else {
            "kind": "cpu", "power_limit": "n/a"}
        state = entry.setup(ctx)
        if trace:
            entry.instrument(ctx, state)
        tr = DeviceTrace(dev) if traced and dev.type == "cuda" else None
        if tr:
            tr.start()
        records = []
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            rec = entry.unit(ctx, state)
            rec["t1"] = time.perf_counter()
            records.append(rec)
            if rec["t1"] - t0 >= seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
        cpu_s = time.process_time() - cpu0
        if tr:
            tr.stop()
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        ts = [t0] + [r["t1"] for r in records]
        dts = sorted(b - a for a, b in zip(ts, ts[1:]))
        q = statistics.quantiles(dts, n=4) if len(dts) > 1 else dts * 3
        print(f"info units {len(dts)} unit_s min {dts[0]:.4f} q1 {q[0]:.4f} "
              f"median {q[1]:.4f} q3 {q[2]:.4f} max {dts[-1]:.4f} "
              f"process_cpu_s {cpu_s:.2f} window_s {window_s:.2f}",
              file=sys.stderr)
        if hasattr(entry, "describe"):
            print("info " + entry.describe(records), file=sys.stderr)
        view = {"records": records, "window_s": window_s, "t0": t0,
                "trace": tr, "spans": ctx.spans, "workload": wl,
                "config": cfg, "ctx": ctx}
        metrics = {}
        if trace:
            names = layer_names
        else:
            names = [n for n in e2e_names if n != "setup_s"]
            metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
        for name in names:
            val = core.load_module("metrics", name).read(view)
            if val is not None:
                metrics[name] = {"value": val, "unit": units[name]}
        attempted = sum(r.get("attempted", 0) for r in records)
        failed = sum(r.get("failed", 0) for r in records)
        device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": card["kind"], "count": 1,
                      "memory_peak_bytes": int(peak),
                      "power_limit": card["power_limit"]}
        out = {"attempted": attempted, "failed": failed}
        if tr and trace:
            device_rec["busy_s"] = tr.busy_s()
            device_rec["window_s"] = tr.window_s
            out["breakdown"] = {"device_ops": tr.top_ops(10),
                                "idle_gaps": tr.idle_gaps(ctx.spans.items)}
        entry.release(ctx, state)
        del state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = entry.check(ctx)
        print(f"info check_s {time.perf_counter() - t_check:.2f}",
              file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and \
        failed == 0
    return {"correct": correct, **out, "metrics": metrics,
            "device": device_rec, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_env()

    from harness import core

    spec = core.benchmark_json()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), spec=spec)
    found = core.forbidden_modules(sys.modules)
    if found:
        print("JAX modules loaded in the benchmark process: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    for m in res["metrics"].values():
        if not math.isfinite(m["value"]):
            print("a metric is not finite", file=sys.stderr)
            return 4
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
