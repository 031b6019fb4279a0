"""Stage timers and the `--profile` trace (port of the JAX package's
`utils/profiling.py`).

Every pipeline stage wrapped in `stage_timer` adds its wall time to a
per-stage total, reported by `stage_report` in the JAX package's format;
the stage also shows in a `torch.profiler` trace as a `record_function`
range. `profile_trace(log_dir)` writes such a trace (Chrome trace JSON,
with CUDA activity when a card is present) into LOG_DIR.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

_STAGE_TOTALS: Dict[str, float] = defaultdict(float)
_STAGE_COUNTS: Dict[str, int] = defaultdict(int)
_lock = threading.Lock()  # the pipeline times stages from several threads


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulate wall time per pipeline stage; the stage is also a
    torch.profiler range."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    with record_function(name):
        yield
    dt = time.perf_counter() - t0
    with _lock:
        _STAGE_TOTALS[name] += dt
        _STAGE_COUNTS[name] += 1


def stage_report() -> str:
    lines = ["stage timings:"]
    with _lock:
        totals, counts = dict(_STAGE_TOTALS), dict(_STAGE_COUNTS)
    for name in sorted(totals, key=totals.get, reverse=True):
        tot = totals[name]
        n = counts[name]
        lines.append(f"  {name:32s} {tot:8.3f}s total  "
                     f"{tot / max(n, 1) * 1000:8.1f}ms/call  x{n}")
    return "\n".join(lines)


def stage_totals() -> Dict[str, float]:
    """A copy of the per-stage totals (seconds)."""
    with _lock:
        return dict(_STAGE_TOTALS)


def reset_stages():
    with _lock:
        _STAGE_TOTALS.clear()
        _STAGE_COUNTS.clear()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace scope written to LOG_DIR as
    `unetdc.<pid>.<ns>.pt.trace.json`; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:  # the pipeline's decode and dispatch threads too
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option: the calling thread
        cfg = None
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts, experimental_config=cfg) as prof:
        yield
    prof.export_chrome_trace(str(
        out / f"unetdc.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
