"""The port's tracer (`utils/profiling.py`): spans and counters recorded
only while a torch.profiler session is active, with their threads,
parents and unit ids, at the quantifier's, the trainer's and the
library's call sites; nothing recorded, no CUDA event made and no
`record_function` entered outside a session; the megastep's device
stages split `megastep_ms`."""

import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from unetdc_tpu_torch.utils import profiling as P

N_IMAGES, BATCH = 5, 2
STAGES = ("host_decode", "h2d_upload", "device_fetch", "host_write_artifacts",
          "host_csv")


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _clean():
    P.reset_trace()
    P.reset_stages()
    yield
    P.reset_trace()
    P.reset_stages()


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    from tests.torch_reference import make_decisive_checkpoint

    root = tmp_path_factory.mktemp("tracing")
    rng = np.random.RandomState(0)
    (root / "img").mkdir()
    for i in range(N_IMAGES):
        Image.fromarray((rng.rand(40, 48, 3) * 255).astype(np.uint8)).save(
            root / "img" / f"a{i}.png")
    make_decisive_checkpoint(str(root / "m.pth"), seed=1, img_size=32)
    return root


def _run_cli(root, monkeypatch, out="out"):
    """The batch CLI on the CPU at a 32-pixel network input (the CLI's 512
    costs seconds here)."""
    from unetdc_tpu_torch.cli.quantify_droplets_batch import main
    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine

    init = QuantifyEngine.__init__

    def small(self, *a, **k):
        init(self, *a, **k)
        self.img_size = 32

    monkeypatch.setattr(QuantifyEngine, "__init__", small)
    return main(["--img_dir", str(root / "img"), "--ckpt_path",
                 str(root / "m.pth"), "--out_dir", str(root / out),
                 "--batch", str(BATCH), "--device", "cpu",
                 "--skip_histogram"])


def test_tracing_is_on_exactly_inside_a_profiler_session_on_any_thread():
    """The predicate is torch's module-global profiler flag: True inside a
    session on the main thread and on a second one, False outside."""
    seen = []

    def look():
        seen.append(P.tracing())

    assert not P.tracing()
    with _profiler():
        look()
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    look()
    assert seen == [True, True, False]


def test_off_records_nothing_and_keeps_the_stage_totals(cli_inputs,
                                                        monkeypatch):
    """Without a session: no span or counter record, no CUDA event, no
    record_function; the stage totals count every stage as before."""
    import torch.profiler

    made = []

    class Event:
        def __init__(self, *a, **k):
            made.append("event")

    class RecordFunction:
        def __init__(self, *a, **k):
            made.append("record_function")

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.profiler, "record_function", RecordFunction)
    _run_cli(cli_inputs, monkeypatch)
    with P.span("x", step=1), P.sync("y"):
        P.count("z")
    assert P.spans() == [] and P.counts() == [] and made == []
    n_batches = -(-N_IMAGES // BATCH)
    assert {k: v for k, v in P._STAGE_COUNTS.items()} == {
        "host_decode": N_IMAGES, "h2d_upload": n_batches,
        "device_fetch": n_batches, "host_write_artifacts": n_batches,
        "host_csv": N_IMAGES}
    assert set(P.stage_totals()) == set(STAGES)
    assert all(v >= 0 for v in P.stage_totals().values())


def test_quantify_spans_carry_call_batch_and_image_ids(cli_inputs,
                                                       monkeypatch):
    t0 = time.perf_counter_ns()
    with _profiler():
        _run_cli(cli_inputs, monkeypatch)
    t1 = time.perf_counter_ns()
    spans = P.spans()
    assert spans and all(t0 <= s.t0 <= s.t1 <= t1 for s in spans)
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (root,) = by["quantify.call"]
    call = root.ids["call"]
    assert root.parent is None
    main = root.thread
    (load,) = by["engine.load"]
    assert load.parent == root.sid and load.thread == main
    assert len(by["quantify.reports"]) == 2
    assert all(s.parent == root.sid for s in by["quantify.reports"])
    for name in ("quantify.image_wait", "host_decode"):
        got = by[name]
        assert sorted(s.ids["image"] for s in got) == list(range(N_IMAGES))
        assert all(s.ids["call"] == call for s in got)
    assert all(s.thread == main for s in by["quantify.image_wait"])
    assert all(s.thread != main and s.parent == root.sid
               for s in by["host_decode"])
    n_batches = -(-N_IMAGES // BATCH)
    for name in ("quantify.dispatch", "device_fetch", "host_write_artifacts"):
        assert sorted(s.ids["batch"] for s in by[name]) == list(
            range(n_batches)), name
    assert all(s.thread != main for s in by["quantify.dispatch"])
    # spans hang under their parents on the same thread, or under the root
    sid = {s.sid: s for s in spans}
    for s in spans:
        if s is not root:
            parent = sid[s.parent]
            assert parent.thread == s.thread or parent is root
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1
    sweeps = P.counts("cc.sweeps")
    assert sorted({c.ids["batch"] for c in sweeps}) == list(range(n_batches))
    assert len(by["cc.sync"]) == len(sweeps)
    # every record is inside the root's call
    assert all(s.ids["call"] == call for s in spans)


def _spiral(n: int) -> np.ndarray:
    """A one-pixel-wide square spiral in an (n, n) mask: one component
    whose labels travel a turn per sweep."""
    m = np.zeros((n, n), np.uint8)
    y, x, lo, hi = 0, 0, 0, n - 1
    while lo <= hi:
        m[lo, lo:hi + 1] = 1
        m[lo:hi + 1, hi] = 1
        m[hi, lo:hi + 1] = 1
        if lo + 2 <= hi:
            m[lo + 2:hi + 1, lo] = 1
            m[lo + 2, lo:lo + 3] = 1
        lo, hi = lo + 2, hi - 2
    return m


def test_cc_sweeps_count_every_sweep_of_the_propagation():
    from unetdc_tpu_torch.ops import connected_components as CC

    m = torch.from_numpy(_spiral(24))[None].to(torch.bool)
    h, w = m.shape[-2:]
    idx = torch.arange(h * w, dtype=torch.int32).reshape(1, h, w)
    with _profiler():
        _, k = CC._propagate_counted(idx, m, h * w, 1, True)
    assert k >= 3
    assert sum(c.n for c in P.counts("cc.sweeps")) == k + 1
    syncs = P.spans("cc.sync")
    assert len(syncs) == k + 1 and all(s.t0 <= s.t1 for s in syncs)


def _pairs(root, n=6):
    r = np.random.RandomState(3)
    (root / "images").mkdir()
    (root / "masks").mkdir()
    for i in range(n):
        Image.fromarray((r.rand(40, 40, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"s{i}.png")
        Image.fromarray(((r.rand(40, 40) > 0.6) * 255).astype(np.uint8)
                        ).save(root / "masks" / f"s{i}.png")
    return str(root / "images"), str(root / "masks")


def test_train_epoch_spans_every_step(tmp_path):
    from unetdc_tpu_torch.data.dataset import SegmentationData, discover_pairs
    from unetdc_tpu_torch.train.trainer import Trainer, TrainConfig

    img, msk = _pairs(tmp_path)
    names, masks = discover_pairs(img, msk)
    data = SegmentationData(img, msk, names, masks, batch_size=2,
                            shuffle=True)
    tr = Trainer(TrainConfig(batch_size=2, img_size=32, compute_dtype="f32",
                             background_radius=10, augment=True,
                             save_last=False,
                             ckpt_path=str(tmp_path / "c.msgpack")),
                 device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        tr.run_epoch_train(data, 0)  # untraced: records nothing
        assert P.spans() == []
        with _profiler():
            tr.run_epoch_train(data, 1)
    finally:
        torch.set_num_threads(n)
    steps = len(data)
    (epoch,) = P.spans("train.epoch")
    assert epoch.ids["epoch"] == 1
    for name in ("train.data_wait", "train.device_batch", "train.augment",
                 "train.step"):
        got = P.spans(name)
        assert [s.ids["step"] for s in got] == list(range(steps)), name
        assert all(s.ids["epoch"] == 1 and s.parent == epoch.sid
                   for s in got), name
    sites = [s.ids["site"] for s in P.spans("sync")]
    assert sites.count("valid_upload") == steps
    assert sites.count("augment_draws") == steps
    assert sites[-1] == "sum_metrics"
    assert sum(c.n for c in P.counts("host_syncs")) >= steps + 1


def test_library_call_spans_share_one_call_id(monkeypatch):
    """`segmentation_deep_learning` with a stand-in engine (the real one
    runs a 512x512 forward): prepare, forward and fetch under one call."""
    from unetdc_tpu_torch import library as L

    class Engine:
        def forward_probs(self, x, mesh=None):
            assert x.shape == (1, 512, 512, 3)
            return torch.full((1, 512, 512, 1), 0.9)

    monkeypatch.setitem(L._MODEL_CACHE, ("stub.pth", "cpu"), Engine())
    img = (np.random.RandomState(0).rand(40, 30) * 255).astype(np.uint8)
    with _profiler():
        for _ in range(2):
            mask = L.segmentation_deep_learning(img, "stub.pth", 0.3,
                                                device="cpu")
    assert mask.shape == (40, 30) and (mask == 255).all()
    calls = P.spans("library.call")
    assert len(calls) == 2 and calls[0].ids["call"] != calls[1].ids["call"]
    for c in calls:
        kids = [s for s in P.spans() if s.parent == c.sid]
        assert [s.name for s in kids] == ["library.prepare",
                                          "library.forward", "library.fetch"]
        assert all(s.ids["call"] == c.ids["call"] for s in kids)


class _FakeEvent:
    """A CUDA event stand-in: elapsed_time is the difference of stamps."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_stages_split_megastep_ms_of_the_busiest_device():
    """`_to_host` turns each megastep's stage events into device spans that
    add up to the `megastep_ms` it records; under a mesh, those of the
    device with the largest sum."""
    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine

    def group(dev, t):  # start, preprocess end, forward end, end
        a, p, f, b = (_FakeEvent(v) for v in t)
        ends = [("dev.preprocess", p), ("dev.forward", f),
                ("dev.components", b)]
        return {"mask": torch.zeros(1, 2, 2), "_events": (dev, (a, b), ends)}

    eng = QuantifyEngine.__new__(QuantifyEngine)
    eng.megastep_ms = []
    with _profiler():
        eng._to_host([group("d0", (0, 2, 5, 9)), group("d1", (0, 1, 2, 4)),
                      group("d1", (4, 7, 9, 10))])
    assert eng.megastep_ms == [10.0]
    got = {s.name: s.device_ms for s in P.spans()}
    assert got == {"dev.preprocess": 4.0, "dev.forward": 3.0,
                   "dev.components": 3.0}
    assert sum(got.values()) == eng.megastep_ms[0]


def test_spans_keep_every_record_and_their_parents_under_threads():
    """Many threads open nested spans and stage timers at once (more
    threads than cores, a short switch interval): no record is lost, each
    inner span's parent is its own thread's outer span, and the stage
    totals count every call."""
    import os
    import sys

    n_threads, n_calls = 2 * (os.cpu_count() or 1) + 2, 50

    def work(i):
        for j in range(n_calls):
            with P.span("outer", step=j):
                with P.stage_timer("inner"):
                    P.count("c")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler(), P.span("root", root=True):
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_calls
    (root,) = P.spans("root")
    outer, inner = P.spans("outer"), P.spans("inner")
    assert len(outer) == len(inner) == total
    assert sum(c.n for c in P.counts("c")) == total
    sid = {s.sid: s for s in outer}
    assert len(sid) == total
    for s in inner:
        parent = sid[s.parent]
        assert parent.thread == s.thread
        assert parent.ids["step"] == s.ids["step"]
    assert all(s.parent == root.sid for s in outer)
    assert P._STAGE_COUNTS["inner"] == total


def test_counter_report_sums_each_counter_since_a_time():
    with _profiler():
        P.count("b", 2)
        t = time.perf_counter_ns()
        P.count("a")
        P.count("b", 3)
    assert P.counter_report(t).splitlines() == [
        "counters:", f"  {'a':32s} {1:10d}", f"  {'b':32s} {3:10d}"]
    assert P.counter_report().splitlines()[2].endswith(f"{5:10d}")
