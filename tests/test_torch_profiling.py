"""Stage timers and `--profile` of the port (`utils/profiling.py`), against
the JAX package's `utils/profiling.py`, and the batch CLI's profiled run
on the CPU."""

import json

import numpy as np

from unetdc_tpu_torch.utils import profiling as P

STAGES = ("host_decode", "h2d_upload", "device_fetch", "host_write_artifacts",
          "host_csv")


def test_stage_timer_accumulates():
    P.reset_stages()
    for _ in range(2):
        with P.stage_timer("a"):
            pass
    with P.stage_timer("b"):
        pass
    assert P._STAGE_COUNTS == {"a": 2, "b": 1}
    assert set(P.stage_totals()) == {"a", "b"}
    assert all(v >= 0 for v in P.stage_totals().values())
    P.reset_stages()
    assert P.stage_report() == "stage timings:"


def test_stage_report_format_matches_jax():
    from unetdc_tpu.utils import profiling as J

    totals = {"host_decode": 1.25, "device_fetch": 3.5, "host_csv": 0.0125}
    counts = {"host_decode": 16, "device_fetch": 2, "host_csv": 16}
    for mod in (P, J):
        mod.reset_stages()
        mod._STAGE_TOTALS.update(totals)
        mod._STAGE_COUNTS.update(counts)
    try:
        assert P.stage_report() == J.stage_report()
        assert P.stage_report().splitlines()[1].startswith("  device_fetch")
    finally:
        P.reset_stages()
        J.reset_stages()


def test_profile_trace_is_a_no_op_without_a_dir(tmp_path):
    with P.profile_trace(None):
        pass
    with P.profile_trace(""):
        pass
    assert not list(tmp_path.iterdir())


def test_batch_cli_profile_writes_trace_and_report(tmp_path, monkeypatch,
                                                   capsys):
    from PIL import Image

    from tests.torch_reference import make_decisive_checkpoint
    from unetdc_tpu_torch.cli.quantify_droplets_batch import main
    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine

    init = QuantifyEngine.__init__

    def small(self, *a, **k):  # the CLI's 512 input costs seconds here
        init(self, *a, **k)
        self.img_size = 32

    monkeypatch.setattr(QuantifyEngine, "__init__", small)
    rng = np.random.RandomState(0)
    (tmp_path / "img").mkdir()
    for i in range(3):
        Image.fromarray((rng.rand(40, 48, 3) * 255).astype(np.uint8)).save(
            tmp_path / "img" / f"a{i}.png")
    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=1, img_size=32)
    P.reset_stages()
    logdir = tmp_path / "prof"
    main(["--img_dir", str(tmp_path / "img"), "--ckpt_path", str(ckpt),
          "--out_dir", str(tmp_path / "out"), "--batch", "2",
          "--device", "cpu", "--skip_histogram", "--profile", str(logdir)])
    out = capsys.readouterr().out
    report = out[out.index("stage timings:"):out.index("All done")]
    for name in STAGES:
        assert f"  {name} " in report, name
    traces = list(logdir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"host_decode", "device_fetch"} <= names
    assert (tmp_path / "out" / "summary_per_image.csv").exists()
    P.reset_stages()


def test_stage_timer_keeps_every_update_under_threads():
    """Pipeline stages are timed from several threads at once; no update
    of the totals may be lost (more threads than cores, short switch
    interval)."""
    import os
    import sys
    import threading

    P.reset_stages()
    n_threads, n_calls = 2 * (os.cpu_count() or 1) + 2, 200

    def work():
        for _ in range(n_calls):
            with P.stage_timer("s"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert P._STAGE_COUNTS["s"] == n_threads * n_calls
    P.reset_stages()
