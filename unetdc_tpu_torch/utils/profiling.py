"""The port's tracer: stage timers, spans, counters and the `--profile`
trace (port of the JAX package's `utils/profiling.py`, extended).

Stage totals: every pipeline stage wrapped in `stage_timer` adds its wall
time to a per-stage total, always, reported by `stage_report` in the JAX
package's format.

Spans and counters are recorded only while a torch.profiler session is
active in the process, on whichever thread (`tracing()`): `--profile`, or a
benchmark's traced window. Outside one a span or counter site costs one
flag check and records nothing, and `stage_timer` keeps its totals alone.
While tracing:
  - a span (`span`, `stage_timer`, `sync`) records its name, its start and
    end on `time.perf_counter_ns()` (the clock onto which a device trace
    can be mapped), its thread, its parent span and the ids of the unit it
    belongs to (`call`, `batch`, `image`; `epoch`, `step`), inherited from
    the parent. The parent is the innermost open span of the thread, else
    the open root span (`root=True`), so the spans of a worker thread hang
    under the call that started it;
  - a device span (`device_span`) holds a device time in ms, read from
    CUDA events by its caller;
  - a counter (`count`) records a number with the ids of the open span;
  - a stage is also a `record_function` range, so it shows in the Chrome
    trace that `profile_trace(log_dir)` writes into LOG_DIR.
Records go to bounded in-memory buffers, read with `spans` and `counts`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler

_STAGE_TOTALS: Dict[str, float] = defaultdict(float)
_STAGE_COUNTS: Dict[str, int] = defaultdict(int)
_lock = threading.Lock()  # the pipeline times stages from several threads

_MAX_RECORDS = 1 << 17  # per buffer; the oldest records go first
_SPANS: "deque[Span]" = deque(maxlen=_MAX_RECORDS)
_COUNTS: "deque[Count]" = deque(maxlen=_MAX_RECORDS)
_SIDS = itertools.count(1)
_CALLS = itertools.count()
_local = threading.local()  # .stack: the thread's open spans
_ROOT: List[Optional["Span"]] = [None]  # the open root span
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """True while a torch.profiler session is active in the process. The
    flag is module-global (torch.profiler sets it whatever the activities),
    so every thread sees it; `torch._C._autograd._profiler_enabled()` is
    per thread and would leave the pipeline's worker threads untraced."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _open() -> Optional["Span"]:
    """The span a new record hangs under on this thread."""
    stack = _stack()
    return stack[-1] if stack else _ROOT[0]


def _ids(**ids) -> dict:
    return {k: v for k, v in ids.items() if v is not None}


class Span:
    """One span; a context manager while open, a record once closed.
    Times are `time.perf_counter_ns()`; `device_ms` is set on device
    spans, whose t0 and t1 are both the time the device time was read."""

    __slots__ = ("name", "t0", "t1", "thread", "sid", "parent", "ids",
                 "device_ms", "_root", "_prev")

    def __init__(self, name: str, ids: dict, root: bool = False,
                 device_ms: Optional[float] = None):
        self.name = name
        self.ids = ids
        self.device_ms = device_ms
        self._root = root
        self.sid = next(_SIDS)
        self.thread = threading.get_ident()
        top = _open()
        self.parent = top.sid if top is not None else None
        if top is not None:
            self.ids = {**top.ids, **ids}
        if root and "call" not in self.ids:
            self.ids["call"] = next(_CALLS)

    def __enter__(self):
        if self._root:
            self._prev, _ROOT[0] = _ROOT[0], self
        _stack().append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self._root:
            _ROOT[0] = self._prev
        _SPANS.append(self)
        return False


class Count:
    """One counter record: `n` of `name` at time `t` (perf_counter_ns)."""

    __slots__ = ("name", "t", "n", "thread", "ids")

    def __init__(self, name: str, n: int):
        self.name = name
        self.n = n
        self.t = time.perf_counter_ns()
        self.thread = threading.get_ident()
        top = _open()
        self.ids = top.ids if top is not None else {}


def span(name: str, *, root: bool = False, call=None, batch=None,
         image=None, epoch=None, step=None):
    """A span while tracing, else a shared no-op context. A root span
    (the unit's outermost) is the parent of spans opened on threads that
    have none open, and gets a fresh `call` id unless given one."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, _ids(call=call, batch=batch, image=image, epoch=epoch,
                           step=step), root)


def sync(site: str, n: int = 1):
    """A point where the host blocks on the device: while tracing, a
    `sync` span (`site` in its ids) and `n` more `host_syncs`."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    _COUNTS.append(Count("host_syncs", n))
    return Span("sync", {"site": site})


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while tracing."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS.append(Count(name, n))


def record(name: str, t0_ns: int, t1_ns: int, **ids) -> None:
    """A span already timed by the caller (which checks `tracing()`)."""
    s = Span(name, _ids(**ids))
    s.t0, s.t1 = t0_ns, t1_ns
    _SPANS.append(s)


def device_span(name: str, ms: float) -> None:
    """A device time (ms, from CUDA events) under the open span."""
    s = Span(name, {}, device_ms=float(ms))
    s.t0 = s.t1 = time.perf_counter_ns()
    _SPANS.append(s)


def spans(name: Optional[str] = None) -> List[Span]:
    """The recorded spans (named `name`), oldest first."""
    return [s for s in list(_SPANS) if name is None or s.name == name]


def counts(name: Optional[str] = None) -> List[Count]:
    """The recorded counter records (named `name`), oldest first."""
    return [c for c in list(_COUNTS) if name is None or c.name == name]


def reset_trace() -> None:
    _SPANS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def stage_timer(name: str, **ids):
    """Accumulate wall time per pipeline stage; while tracing the stage is
    also a span (with `ids`) and a torch.profiler range."""
    t0 = time.perf_counter()
    if _autograd_profiler._is_profiler_enabled:
        from torch.profiler import record_function

        with record_function(name), Span(name, _ids(**ids)):
            yield
    else:
        yield
    dt = time.perf_counter() - t0
    with _lock:
        _STAGE_TOTALS[name] += dt
        _STAGE_COUNTS[name] += 1


def stage_report() -> str:
    lines = ["stage timings:"]
    with _lock:
        totals, counts_ = dict(_STAGE_TOTALS), dict(_STAGE_COUNTS)
    for name in sorted(totals, key=totals.get, reverse=True):
        tot = totals[name]
        n = counts_[name]
        lines.append(f"  {name:32s} {tot:8.3f}s total  "
                     f"{tot / max(n, 1) * 1000:8.1f}ms/call  x{n}")
    return "\n".join(lines)


def counter_report(since_ns: int = 0) -> str:
    """Each counter's total over the records since `since_ns`."""
    tot: Dict[str, int] = defaultdict(int)
    for c in counts():
        if c.t >= since_ns:
            tot[c.name] += c.n
    return "\n".join(["counters:"] + [f"  {name:32s} {tot[name]:10d}"
                                      for name in sorted(tot)])


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
