"""The traced window: torch.profiler with CUDA activity only (no host op
events, so a long window stays cheap to read), reduced to the device's
operation intervals.

The device is idle when the profiler starts (the caller synchronises
first), and a one-element marker operation is launched at once, so the
first device interval begins within a launch latency of the host time
recorded at the start; that maps device times onto the host clock, which
is how idle gaps are named by the host span that was open during them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None
        self.events: List[Tuple[str, float, float]] = []  # name, s, s

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        torch.zeros(1, device=self.device).add_(1)

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        # the raw kineto events: building the profiler's FunctionEvent
        # tree for a window of ~10^6 kernels would take minutes
        ev = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
              for e in self.prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
        ev.sort(key=lambda t: t[1])
        base = ev[0][1] if ev else 0.0
        # device microseconds -> host seconds (perf_counter)
        self.events = [(n, self.t0 + (a - base) / 1e6,
                        self.t0 + (b - base) / 1e6) for n, a, b in ev]
        self.prof = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Union of the device's operation intervals, clipped to the
        window."""
        out: List[List[float]] = []
        for _, a, b in self.events:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_times(self, pattern) -> List[float]:
        """Seconds of each device operation whose name matches `pattern`
        (a compiled regex)."""
        return [b - a for n, a, b in self.events if pattern.search(n)]

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for n, a, b in self.events:
            tot[n] = tot.get(n, 0.0) + (b - a)
        top = sorted(tot.items(), key=lambda t: -t[1])[:k]
        return [[n[:120], s] for n, s in top]

    def idle_gaps(self, spans: Sequence[Tuple[str, float, float]],
                  k: int = 10) -> List[list]:
        """The k longest idle gaps, each named by a host span (name, t0, t1
        on the host clock): the shortest span that covers at least half
        of the gap, else the span that overlaps it most, else 'host'."""
        busy = self.busy_intervals()
        gaps, prev = [], self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            best, name, inner = 0.0, "host", None
            for sn, s0, s1 in spans:
                ov = min(b, s1) - max(a, s0)
                if ov > best:
                    best, name = ov, sn
                if ov >= 0.5 * (b - a) and (inner is None
                                            or s1 - s0 < inner[1]):
                    inner = (sn, s1 - s0)
            out.append([inner[0] if inner else name, b - a])
        return out

