"""Reductions the metric readers share: sums over the window's unit
records, and a kernel's share of its roofline from the traced window."""

from __future__ import annotations

import re
from typing import Optional

from flops import kernels as fk

KERNEL_NAMES = {"k1": re.compile(r"k1_(bf16|f32)_kernel"),
                "k2": re.compile(r"k2_(bf16|f32)_kernel"),
                "k3": re.compile(r"k3_kernel")}


def total(view, key: str) -> float:
    return sum(r.get(key, 0) for r in view["records"])


def stage_ms_per_image(view, stage: str) -> Optional[float]:
    imgs = total(view, "images")
    if not imgs:
        return None
    secs = sum(r["stages"].get(stage, 0.0) for r in view["records"])
    return secs / imgs * 1e3


def megastep_ms(view) -> Optional[float]:
    ms = [m for r in view["records"] for m in r.get("megastep_ms", [])]
    return sum(ms) / len(ms) if ms else None


def kernel_roofline(view, kernel: str) -> Optional[float]:
    """Per cent of the roofline bound (`flops/kernels.py`) over the mean
    device time of one launch of `kernel` in the traced window, at the
    shapes the workload drives; None when the kernel did not run."""
    tr = view["trace"]
    if tr is None:
        return None
    times = tr.kernel_times(KERNEL_NAMES[kernel])
    if not times:
        return None
    t = view["workload"]["traffic"]
    b = t["batch"]
    s = view["config"]["input_size"]
    if kernel == "k3":
        ops, byts = fk.k3(b, t["images"]["height"], t["images"]["width"],
                          t["max_labels"])
    else:
        ops, byts = getattr(fk, kernel)(b, s, s)
    return fk.bound_s(ops, byts) / (sum(times) / len(times)) * 100.0


def idle_share(view) -> Optional[float]:
    tr = view["trace"]
    if tr is None:
        return None
    return (1.0 - tr.busy_s() / tr.window_s) * 100.0
