"""The port's GUIs (`unetdc_tpu_torch/gui/`) against the JAX package's:
the command builder's argv, the frozen `--cli` dispatch, and the Qt window
run headless under `tests/fake_pyside6.py` (validation error, error tail,
and a full run whose child is the port's CLI on the CPU)."""

import sys

import numpy as np
import pytest

import tests.fake_pyside6 as fake
from unetdc_tpu.gui.command import build_batch_command as jax_build
from unetdc_tpu_torch.gui import build_batch_command, entry

JAX_MODULE = "unetdc_tpu.cli.quantify_droplets_batch"
PORT_MODULE = "unetdc_tpu_torch.cli.quantify_droplets_batch"

SETTINGS = [
    dict(),
    dict(batch=4, prob_thresh=0.25, min_area=3),
    dict(px_per_micron=3.45),
    dict(px_per_micron=None, background_radius=30),
    dict(save_overlays=True),
    dict(skip_excel=True),
    dict(skip_histogram=True),
    dict(batch=16, prob_thresh=0.5, min_area=0, px_per_micron=1.0,
         save_overlays=True, background_radius=7, skip_excel=True,
         skip_histogram=True),
    dict(python="python3"),
]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("kw", SETTINGS, ids=lambda kw: ",".join(kw) or
                         "defaults")
def test_build_batch_command_is_the_jax_argv(kw, device):
    """The JAX package's argv with the module swapped and --device last."""
    paths = ("/data/imgs", "/models/ck.pth", "/tmp/out dir")
    want = jax_build(*paths, **kw)
    assert want[2] == JAX_MODULE
    want = want[:2] + [PORT_MODULE] + want[3:] + ["--device", device]
    assert build_batch_command(*paths, device=device, **kw) == want
    if device == "cuda":
        assert build_batch_command(*paths, **kw) == want


@pytest.mark.parametrize("args", [("", "/ck.pth", "/out"),
                                  ("/imgs", "", "/out"),
                                  ("", "", "")])
def test_build_batch_command_raises_as_jax(args):
    with pytest.raises(ValueError) as want:
        jax_build(*args)
    with pytest.raises(ValueError) as got:
        build_batch_command(*args)
    assert str(got.value) == str(want.value)


def test_frozen_head(monkeypatch):
    monkeypatch.setattr(sys, "frozen", True, raising=False)
    cmd = build_batch_command("/imgs", "/ck.pth", "/out", device="cpu")
    assert cmd[:3] == [sys.executable, "--cli", "quantify_droplets_batch"]
    assert cmd[3:] == jax_build("/imgs", "/ck.pth", "/out")[3:] + [
        "--device", "cpu"]
    # an explicit interpreter still spawns the module
    assert build_batch_command("/i", "/c", "/o", python="py")[:3] == [
        "py", "-m", PORT_MODULE]


def _images(d, n, h, w, seed):
    from PIL import Image

    rng = np.random.RandomState(seed)
    d.mkdir()
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        for _ in range(5):
            cy, cx = rng.randint(10, h - 10), rng.randint(10, w - 10)
            r = rng.randint(3, 8)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
            img[blob] = np.minimum(img[blob] + 180, 255)
        Image.fromarray(img).save(d / f"img{i}.png")


def test_entry_dispatches_cli_in_process(tmp_path, monkeypatch, capsys):
    """`--cli quantify_droplets_batch ... --device cpu` runs the port's CLI
    in this process and writes the artifact tree; the names map to the
    port's five CLIs; `--cli nonsense` exits 2 with the JAX message."""
    from tests.torch_reference import make_decisive_checkpoint
    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine

    assert entry._CLI_MODULES == {
        n: f"unetdc_tpu_torch.cli.{n}" for n in (
            "quantify_droplets_batch", "quantify_pipline", "quantify",
            "train", "train_dc_focal")}
    init = QuantifyEngine.__init__

    def small(self, *a, **k):  # a 512 input is seconds an image here
        init(self, *a, **k)
        self.img_size = 32

    monkeypatch.setattr(QuantifyEngine, "__init__", small)
    _images(tmp_path / "img", 2, 40, 48, seed=5)
    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=1, img_size=32)
    out = tmp_path / "out"
    entry.main(["--cli", "quantify_droplets_batch", "--img_dir",
                str(tmp_path / "img"), "--ckpt_path", str(ckpt),
                "--out_dir", str(out), "--batch", "2", "--skip_histogram",
                "--save_overlays", "--device", "cpu"])
    assert "All done" in capsys.readouterr().out
    for name in ("summary_per_image.csv", "all_droplets.csv",
                 "droplet_size_stats.csv", "predicted_masks/img0_pred.png",
                 "predicted_masks/img1_pred.png",
                 "overlays/img1_overlay.png"):
        assert (out / name).exists(), name

    with pytest.raises(SystemExit) as e:
        entry.main(["--cli", "quantify", "--help"])
    assert e.value.code == 0
    assert "--px_per_micron" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        entry.main(["--cli", "nonsense"])
    assert e.value.code == 2
    assert capsys.readouterr().err == (
        "unknown --cli target 'nonsense'; valid: quantify, "
        "quantify_droplets_batch, quantify_pipline, train, train_dc_focal\n")


@pytest.fixture
def qt(monkeypatch):
    fake.install(monkeypatch)
    return fake


def _run_qt(argv):
    from unetdc_tpu_torch.gui import qt_app

    with pytest.raises(SystemExit) as exc:
        qt_app.main(argv)
    return exc.value.code


def test_qt_validation_error_path(qt):
    def drive(app):
        qt.created_main_windows[-1].run_btn.click()  # all paths empty

    qt.exec_hook = drive
    assert _run_qt(["--device", "cpu"]) == 0
    win = qt.created_main_windows[-1]
    assert qt.message_boxes == [
        ("critical", "Error", "Images folder is required")]
    assert not hasattr(win, "worker")
    assert win.run_btn.isEnabled()


def test_qt_error_tail_path(qt, tmp_path):
    """A failing child CLI streams into the log pane and its last <= 20
    lines, with the traceback, surface as the error box."""
    _images(tmp_path / "imgs", 1, 24, 24, seed=1)
    bad = tmp_path / "garbage.pth"
    bad.write_bytes(b"this is not a checkpoint")

    def drive(app):
        win = qt.created_main_windows[-1]
        win.img_dir.setText(str(tmp_path / "imgs"))
        win.ckpt.setText(str(bad))
        win.out_dir.setText(str(tmp_path / "out"))
        win.run_btn.click()  # the fake QThread runs synchronously

    qt.exec_hook = drive
    assert _run_qt(["--device", "cpu"]) == 0
    win = qt.created_main_windows[-1]
    assert [b[:2] for b in qt.message_boxes] == [("critical", "Run failed")]
    tail = qt.message_boxes[0][2].split("\n")
    assert len(tail) <= 20
    assert any("Traceback" in ln or ln.lstrip().startswith("File ")
               for ln in tail), tail
    assert set(tail) <= set(win.log.lines)
    assert win.run_btn.isEnabled()


def test_qt_full_run_and_results_viewer(qt, tmp_path):
    """The click spawns `python -m unetdc_tpu_torch.cli.quantify_droplets_batch
    ... --device cpu`; the log gets its stdout, and the results tab the
    tables, histogram and overlay gallery of the artifacts it wrote."""
    from tests.torch_reference import make_decisive_checkpoint

    pytest.importorskip("matplotlib")
    _images(tmp_path / "imgs", 2, 96, 96, seed=3)
    ckpt = tmp_path / "ck.pth"
    make_decisive_checkpoint(str(ckpt), seed=0)
    out = tmp_path / "out"
    spawned = []

    def drive(app):
        win = qt.created_main_windows[-1]
        win.img_dir.setText(str(tmp_path / "imgs"))
        win.ckpt.setText(str(ckpt))
        win.out_dir.setText(str(out))
        win.batch.setValue(2)
        win.overlays.setChecked(True)
        win.excel.setChecked(False)
        win.run_btn.click()
        spawned.append(win.worker.cmd)

    qt.exec_hook = drive
    assert _run_qt(["--device", "cpu"]) == 0
    win = qt.created_main_windows[-1]
    assert spawned[0][1:3] == ["-m", PORT_MODULE]
    assert spawned[0][-2:] == ["--device", "cpu"]
    assert qt.message_boxes == []
    assert any("All done" in ln for ln in win.log.lines)
    assert win.run_btn.isEnabled()
    for name in ("summary_per_image.csv", "droplet_size_stats.csv",
                 "size_histogram.png"):
        assert (out / name).exists(), name
    assert win.summary_table.rows == 2
    assert win.summary_table.headers == [
        "filename", "droplet_count", "total_area_px"]
    assert win.summary_table.items[(0, 0)].text() == "img0.png"
    assert win.stats_table.rows >= 3
    assert win.hist_label.pixmap.path.endswith("size_histogram.png")
    labels = [w for w in win.gallery.inner.layout.items
              if isinstance(w, fake.QLabel)]
    assert len(labels) == 4  # (name + image) x 2 overlays
