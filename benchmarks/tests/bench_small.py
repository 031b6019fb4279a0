"""Helpers of the benchmark's CPU tests: the cells at sizes a CPU test run
can hold (few, small images; 64x64 training pairs), run through the
harness's own run_cell with the look for a card skipped."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import core  # noqa: E402

SEED = 12345678901


def small_workload(cell: str, n: int = 8) -> dict:
    wl = copy.deepcopy(core.load_json("workloads", cell))
    t = wl["traffic"]
    if "images" in t:
        t["images"].update(n=n, height=256, width=256, droplets=[5, 30],
                           total_area_px=2500, area_px=[20, 300])
    if "pairs" in t:
        t["pairs"].update(n=24, height=64, width=64, droplets=4)
    return wl


def small_config(wl: dict) -> dict:
    cfg = copy.deepcopy(core.load_json("configs", wl["config"]))
    if "pairs" in wl["traffic"]:
        cfg["input_size"] = 64
    return cfg


def run_small(cell: str, monkeypatch, n: int = 8, seed: int = SEED,
              trace: bool = False) -> dict:
    """One run of `cell` at the small size on the CPU, through run_cell."""
    import torch

    import run

    torch.set_num_threads(4)
    wl = small_workload(cell, n)
    cfg = small_config(wl)
    orig = core.load_json
    monkeypatch.setattr(core, "load_json", lambda kind, name: copy.deepcopy(
        cfg) if kind == "configs" else orig(kind, name))
    return run.run_cell(cell, seed, 0.0, trace, device="cpu", workload=wl,
                        t_start=time.perf_counter())
