"""The port's trainer CLIs and resume on the CPU, on the JAX tests' tiny
set: resuming from `.last` reproduces the uninterrupted run exactly, and
both train CLIs take the JAX CLIs' flags and defaults (plus `--device`)
and write the JAX CLIs' artifact names."""

import contextlib
import io
import json

import pytest
import torch

from tests.test_torch_trainer import KEYS, KW, _data, _fit, tiny  # noqa: F401
from unetdc_tpu_torch.data import dataset as TD
from unetdc_tpu_torch.train import trainer as TT


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side, and full-width models on all cores in each oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_port_resume_from_last_is_exact(tiny, tmp_path):
    """An interrupted and resumed port run (augmentation on) reproduces the
    uninterrupted run's epoch metrics exactly."""
    kw = dict(KW, augment=True)

    def make(tag, epochs, resume=False):
        return TT.Trainer(TT.TrainConfig(
            num_epochs=epochs, resume=resume, seed=4,
            ckpt_path=str(tmp_path / f"{tag}.msgpack"),
            history_jsonl=str(tmp_path / f"{tag}.jsonl"), **kw),
            device="cpu")

    _fit(make("full", 2), _data(TD, tiny))
    data = _data(TD, tiny)           # one data object, as one process
    _fit(make("part", 1), data)
    _, out = _fit(make("part", 2, resume=True), data)
    assert "Resumed from" in out and ".last" in out and "NOTE" not in out
    full = [json.loads(ln) for ln in
            (tmp_path / "full.jsonl").read_text().splitlines()]
    part = [json.loads(ln) for ln in
            (tmp_path / "part.jsonl").read_text().splitlines()]
    assert len(full) == len(part) == 2
    for a, b in zip(full, part):
        for k in ("epoch",) + KEYS:
            assert a[k] == b[k], (k, a, b)
    for p in tmp_path.glob("*.msgpack*"):   # ~0.75 GB of checkpoints
        p.unlink()


@pytest.mark.parametrize("which", ["train_dc_focal", "train"])
def test_train_clis_write_the_jax_artifacts(tiny, tmp_path, monkeypatch,
                                            which):
    import importlib

    jcli = importlib.import_module(f"unetdc_tpu.cli.{which}")
    tcli = importlib.import_module(f"unetdc_tpu_torch.cli.{which}")
    jd = {a.dest: a.default for a in jcli.build_parser()._actions}
    td = {a.dest: a.default for a in tcli.build_parser()._actions}
    assert {k: v for k, v in td.items() if k != "device"} == jd
    assert td["device"] == "cuda"
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main(["--image_dir", str(tiny / "images"), "--mask_dir",
                   str(tiny / "masks"), "--epochs", "1", "--batch", "2",
                   "--img_size", "32", "--precision", "f32", "--no_augment",
                   "--device", "cpu"])
    ck = jd["ckpt_path"]
    want = {ck, ck + ".meta.json", ck + ".opt", ck + ".last",
            ck + ".last.meta.json", ck + ".state.json", jd["val_masks_dir"],
            "accuracy_plot.png"}
    if which == "train_dc_focal":
        want |= {jd["test_masks_dir"], jd["diff_map_dir"],
                 jd["overlay_dir"], "loss_and_dice_focal_plot.png",
                 "confusion_matrix_.png"}
        assert "========== Test Results ==========" in buf.getvalue()
        assert len(list((tmp_path / jd["overlay_dir"]).iterdir())) == 2
    else:
        want |= {"loss_and_dice_plot.png"}
    assert {p.name for p in tmp_path.iterdir()} == want
    assert "Epoch 1/1 | Train Loss: " in buf.getvalue()
    for p in tmp_path.glob(ck + "*"):       # ~0.75 GB of checkpoints
        p.unlink()


def test_plateau_and_export_pth(tiny, tmp_path):
    """The opt-in plateau scheduler writes optax's `inject_hyperparams`
    layout (learning rate included) and resumes from it; `export_pth`
    writes a reference state dict that loads into the model."""
    from unetdc_tpu_torch.checkpoint import load_checkpoint, \
        load_pth_state_dict
    from unetdc_tpu_torch.models.unet import UNetDC

    ck = tmp_path / "p.msgpack"
    cfg = dict(KW, plateau_scheduler=True, ckpt_path=str(ck),
               export_pth=str(tmp_path / "p.pth"))
    _fit(TT.Trainer(TT.TrainConfig(num_epochs=1, **cfg), device="cpu"),
         _data(TD, tiny))
    opt = load_checkpoint(str(ck) + ".last")["opt"]
    assert set(opt) == {"count", "hyperparams", "hyperparams_states",
                        "inner_state"}
    assert float(opt["hyperparams"]["learning_rate"]) == pytest.approx(1e-3)
    assert int(opt["inner_state"]["0"]["count"]) == 3
    UNetDC().load_state_dict(load_pth_state_dict(str(tmp_path / "p.pth")))
    tr = TT.Trainer(TT.TrainConfig(num_epochs=1, resume=True, **cfg),
                    device="cpu")
    _, out = _fit(tr, _data(TD, tiny))
    assert "Resumed from" in out
    assert tr.opt.param_groups[0]["lr"] == pytest.approx(1e-3)
    assert float(tr.opt.state[tr.opt.param_groups[0]["params"][0]]["step"]) \
        == 3
    for p in tmp_path.glob("p.*"):          # ~0.9 GB of checkpoints
        p.unlink()
