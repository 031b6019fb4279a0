"""The program's own spans and counters (`unetdc_tpu_torch.utils.profiling`,
recorded while a torch.profiler session is active, as in a traced window)
inside a run's window, for the readers of `program_span` metrics.

Times are the program's `time.perf_counter_ns()`, the clock of the
window's `t0` and of the device trace. A program that records no spans
(one older than its tracer) gives None, and so does every reader built on
these functions.
"""

from __future__ import annotations

from typing import Optional, Tuple


def _tracer():
    try:
        from unetdc_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def _window_ns(view) -> Tuple[float, float]:
    t0 = view["t0"] * 1e9
    return t0, t0 + view["window_s"] * 1e9


def spans(view, name: str) -> Optional[list]:
    """The program's spans named `name` that lie in the window, or None
    when the program has no tracer."""
    tracer = _tracer()
    if tracer is None:
        return None
    a, b = _window_ns(view)
    return [s for s in tracer.spans(name) if a <= s.t0 and s.t1 <= b]


def counts(view, name: str) -> Optional[list]:
    """The program's counter records named `name` in the window."""
    tracer = _tracer()
    if tracer is None:
        return None
    a, b = _window_ns(view)
    return [c for c in tracer.counts(name) if a <= c.t <= b]


def units(view, name: str) -> int:
    """How many spans named `name` (one per unit) lie in the window; 0
    without a tracer."""
    return len(spans(view, name) or [])


def total_ms(items: list) -> float:
    """Summed duration of spans, in ms (device spans: their device time)."""
    return sum(s.device_ms if s.device_ms is not None
               else (s.t1 - s.t0) / 1e6 for s in items)


def mean_ms(view, name: str) -> Optional[float]:
    """Mean duration of the spans `name` in the window (ms); None when
    there are none."""
    got = spans(view, name)
    return total_ms(got) / len(got) if got else None


def per_unit(view, name: str, unit: str, none_is_zero: bool = False
             ) -> Optional[float]:
    """The spans `name` summed (ms) over the number of spans `unit` in the
    window. None without units, and without spans `name` unless
    `none_is_zero` (a site that may rightly never be reached)."""
    got, n = spans(view, name), units(view, unit)
    if not n or not (got or none_is_zero):
        return None
    return total_ms(got) / n


def count_per_unit(view, name: str, unit: str, none_is_zero: bool = False
                   ) -> Optional[float]:
    """Counter `name` summed over the number of spans `unit` in the
    window. None without units, and without records of `name` unless
    `none_is_zero`."""
    got, n = counts(view, name), units(view, unit)
    if not n or not (got or none_is_zero):
        return None
    return sum(c.n for c in got) / n


def images_written(view) -> int:
    return sum(r.get("images", 0) for r in view["records"])
