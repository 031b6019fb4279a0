"""The readers of the program's own spans and counters
(`harness/program_trace.py`, `metrics/*` with source `program_span` over
`unetdc_tpu_torch.utils.profiling`): each on a synthetic window of known
spans and counters, each None when its spans are absent or the program
has no tracer."""

import json
import time

import pytest
import torch.autograd.profiler

from bench_small import ROOT, core
from unetdc_tpu_torch.utils import profiling as P

NEW = {
    "image_wait_ms.quantify", "reports_ms.quantify", "engine_load_ms.quantify",
    "preprocess_ms.quantify", "forward_ms.quantify", "components_ms.quantify",
    "cc_sweeps.quantify", "data_wait_ms.train", "host_syncs.train",
    "sync_wait_ms.train", "prepare_ms.segment", "fetch_wait_ms.segment"}
MS = 1_000_000  # ns


def read(name, view):
    return core.load_module("metrics", name).read(view)


@pytest.fixture
def window(monkeypatch):
    """A window [t0, t0 + 1 s) some time from now; `at(ms)` is a time in
    it (ns); records outside it are made too and must be left out."""
    P.reset_trace()
    t0 = time.perf_counter() + 10.0
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)

    def at(ms):
        return int(t0 * 1e9) + int(ms * MS)

    def span(name, a_ms, b_ms, **ids):
        P.record(name, at(a_ms), at(b_ms), **ids)

    def dev(name, ms, when_ms):
        P.device_span(name, ms)
        s = P._SPANS[-1]
        s.t0 = s.t1 = at(when_ms)

    def count(name, n, when_ms):
        P.count(name, n)
        P._COUNTS[-1].t = at(when_ms)

    yield {"t0": t0, "window_s": 1.0, "records": [], "at": at,
           "span": span, "dev": dev, "count": count}
    P.reset_trace()


def test_the_new_metrics_read_program_spans_of_existing_layers():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    layers = {m["layer"] for m in spec["per_layer"] if m["name"] not in NEW}
    new = [m for m in spec["per_layer"] if m["name"] in NEW]
    assert {m["name"] for m in new} == NEW
    assert spec["per_layer"][-len(NEW):] == new  # appended, in order
    for m in new:
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["layer"] in layers and m["workloads"]


def test_quantify_readers(window):
    sp, dev, cnt = window["span"], window["dev"], window["count"]
    window["records"] = [{"images": 4}, {"images": 4}]
    for c, base in enumerate((0, 500)):
        sp("quantify.call", base, base + 400, call=c)
        sp("engine.load", base + 1, base + 51, call=c)       # 50 ms
        sp("quantify.reports", base + 300, base + 310)       # 10 + 20 ms
        sp("quantify.reports", base + 380, base + 400)
        for i in range(4):
            sp("quantify.image_wait", base + 60 + i, base + 62 + i)  # 2 ms
        for b in range(2):
            sp("quantify.dispatch", base + 100 + b, base + 110 + b)
            dev("dev.preprocess", 3.0 + b, base + 120)
            dev("dev.forward", 10.0, base + 120)
            dev("dev.components", 20.0 + 2 * b, base + 120)
            cnt("cc.sweeps", 1, base + 105)
            cnt("cc.sweeps", 2, base + 106)
    # outside the window: left out
    sp("quantify.call", -100, -50)
    sp("engine.load", -99, -60)
    cnt("cc.sweeps", 100, -10)
    dev("dev.forward", 99.0, 1200)
    assert read("engine_load_ms.quantify", window) == pytest.approx(50.0)
    assert read("reports_ms.quantify", window) == pytest.approx(30.0)
    assert read("image_wait_ms.quantify", window) == pytest.approx(2.0)
    assert read("preprocess_ms.quantify", window) == pytest.approx(3.5)
    assert read("forward_ms.quantify", window) == pytest.approx(10.0)
    assert read("components_ms.quantify", window) == pytest.approx(21.0)
    assert read("cc_sweeps.quantify", window) == pytest.approx(3.0)


def test_train_readers(window):
    sp, cnt = window["span"], window["count"]
    for s in range(4):
        t = 100 * s
        sp("train.data_wait", t, t + 0.5, step=s)
        sp("train.step", t + 10, t + 20, step=s)
        sp("sync", t + 2, t + 3)                       # 1 ms
        cnt("host_syncs", 10, t + 2)
    sp("sync", 401, 405)                               # the epoch's end
    cnt("host_syncs", 1, 401)
    assert read("data_wait_ms.train", window) == pytest.approx(0.5)
    assert read("host_syncs.train", window) == pytest.approx(41 / 4)
    assert read("sync_wait_ms.train", window) == pytest.approx(8 / 4)


def test_train_sync_readers_read_zero_when_nothing_syncs(window):
    window["span"]("train.step", 1, 2, step=0)
    assert read("host_syncs.train", window) == 0
    assert read("sync_wait_ms.train", window) == 0


def test_segment_readers(window):
    sp = window["span"]
    for c in range(5):
        t = 20 * c
        sp("library.call", t, t + 19, call=c)
        sp("library.prepare", t, t + 6)
        sp("library.forward", t + 6, t + 7)
        sp("library.fetch", t + 7, t + 19)
    assert read("prepare_ms.segment", window) == pytest.approx(6.0)
    assert read("fetch_wait_ms.segment", window) == pytest.approx(12.0)


def test_every_reader_is_none_without_its_spans(window):
    window["records"] = [{"images": 8}]
    for name in sorted(NEW):
        assert read(name, window) is None, name
    # the units alone: the spans each reader needs are still absent
    for unit in ("quantify.call", "quantify.dispatch", "library.call"):
        window["span"](unit, 1, 2)
    for name in sorted(NEW - {"host_syncs.train", "sync_wait_ms.train"}):
        assert read(name, window) is None, name


def test_every_reader_is_none_with_a_program_without_a_tracer(window,
                                                              monkeypatch):
    """The parent program's profiling module has no `spans`."""
    window["span"]("train.step", 1, 2, step=0)
    window["span"]("train.data_wait", 0, 1, step=0)
    window["records"] = [{"images": 8}]
    monkeypatch.delattr(P, "spans")
    for name in sorted(NEW):
        assert read(name, window) is None, name
