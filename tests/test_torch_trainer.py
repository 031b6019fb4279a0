"""The port's Trainer against the JAX package's, on the CPU, on the JAX
tests' tiny set (tests/test_training.py): six 40x40 pairs, img 32, batch 2,
f32, augment off, shuffle on, from the same initial weights. Per-epoch
losses within 1e-3 relative, dice and accuracy within 1e-3 absolute; the
stdout lines identical in form; `.last` files crossing both ways (the exact
resume and the CLIs are in test_torch_train_cli.py)."""

import contextlib
import io
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from flax import serialization

from unetdc_tpu.data import dataset as JD
from unetdc_tpu.train import trainer as JT
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


KW = dict(model="unetdc", loss="focal_dice", patience=50, batch_size=2,
          img_size=32, compute_dtype="f32", background_radius=10,
          augment=False)
KEYS = ("train_loss", "val_loss", "train_dice", "val_dice", "train_acc",
        "val_acc")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    r = np.random.RandomState(3)
    (root / "images").mkdir()
    (root / "masks").mkdir()
    for i in range(6):
        Image.fromarray((r.rand(40, 40, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"s{i}.png")
        Image.fromarray(((r.rand(40, 40) > 0.6) * 255).astype(np.uint8)
                        ).save(root / "masks" / f"s{i}.png")
    return root


def _data(mod, root, shuffle=True):
    img, msk = str(root / "images"), str(root / "masks")
    names, masks = mod.discover_pairs(img, msk)
    return (mod.SegmentationData(img, msk, names, masks, batch_size=2,
                                 shuffle=shuffle),
            mod.SegmentationData(img, msk, names[:2], masks[:2],
                                 batch_size=2))


def _fit(trainer, data):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hist = trainer.fit(*data)
    return {k: list(map(float, v)) for k, v in hist.items()}, buf.getvalue()


def _only_last(src, dst):
    """A fresh checkpoint dir holding only `src`'s `.last` bundle (all a
    resume needs); checkpoints of the full-width model are ~0.75 GB a
    directory, so each is removed once read."""
    dst.mkdir()
    shutil.copy(src / "b.msgpack.last", dst / "b.msgpack.last")
    shutil.rmtree(src)


@pytest.fixture(scope="module")
def runs(tiny):
    """JAX: 2 epochs. Port: 2 epochs from JAX's initial weights; then 1
    more resumed from JAX's `.last`. JAX loads the port's `.last`."""
    out = {}
    jdir, pdir = tiny / "jax", tiny / "port"
    jt = JT.Trainer(JT.TrainConfig(num_epochs=2,
                                   ckpt_path=str(jdir / "b.msgpack"), **KW))
    init = jax.tree_util.tree_map(np.asarray, jt.variables)
    out["jax"] = _fit(jt, _data(JD, tiny))
    out["jax_final"] = jax.tree_util.tree_map(np.asarray, jt.variables)
    out["jax_opt"] = jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(jt.opt_state))
    rdir = tiny / "port_from_jax"
    _only_last(jdir, rdir)

    pt = TT.Trainer(TT.TrainConfig(num_epochs=2,
                                   ckpt_path=str(pdir / "b.msgpack"), **KW),
                    device="cpu")
    pt.variables = init
    out["port"] = _fit(pt, _data(TD, tiny))
    out["port_final"] = (pt.variables, pt.opt_state_dict())
    jdir2 = tiny / "jax_from_port"
    _only_last(pdir, jdir2)

    # the port resumes JAX's run (its epoch-2 bundle) ...
    pr = TT.Trainer(TT.TrainConfig(num_epochs=2, resume=True,
                                   ckpt_path=str(rdir / "b.msgpack"), **KW),
                    device="cpu")
    _fit(pr, _data(TD, tiny))            # loads; no epoch left to run
    out["port_loaded"] = (pr.variables, pr.opt_state_dict())
    pr.cfg.num_epochs = 3
    out["port_resumed"] = _fit(pr, _data(TD, tiny))
    shutil.rmtree(rdir)
    # ... and JAX loads the port's (no epoch left to run)
    jr = JT.Trainer(JT.TrainConfig(num_epochs=2, resume=True,
                                   ckpt_path=str(jdir2 / "b.msgpack"), **KW))
    out["jax_loaded_out"] = _fit(jr, _data(JD, tiny))[1]
    out["jax_loaded"] = (
        jax.tree_util.tree_map(np.asarray, jr.variables),
        jax.tree_util.tree_map(np.asarray,
                               serialization.to_state_dict(jr.opt_state)))
    shutil.rmtree(jdir2)
    return out


def _equal_trees(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_follows_jax_for_two_epochs(runs):
    (jh, _), (ph, _) = runs["jax"], runs["port"]
    assert len(jh["train_loss"]) == len(ph["train_loss"]) == 2
    for k in KEYS:
        if k.endswith("loss"):
            np.testing.assert_allclose(ph[k], jh[k], rtol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(ph[k], jh[k], atol=1e-3, err_msg=k)


def test_stdout_lines_identical_in_form(runs):
    def form(text):
        return [re.sub(r"\d+\.\d{4}", "#.####", ln)
                for ln in text.splitlines()]

    assert form(runs["port"][1]) == form(runs["jax"][1])
    assert "Model saved!" in runs["port"][1]


def test_port_resumes_a_jax_last(runs):
    """Weights and Adam state restored equal to JAX's at the end of epoch
    2; the resumed third epoch runs and stays near the second."""
    v, opt = runs["port_loaded"]
    _equal_trees(v, runs["jax_final"])
    _equal_trees(opt, runs["jax_opt"])
    ph, pout = runs["port_resumed"]
    assert "Resumed from" in pout and ".last at epoch 2" in pout
    assert "Epoch 3/3" in pout and len(ph["train_loss"]) == 1
    np.testing.assert_allclose(ph["train_loss"], runs["port"][0][
        "train_loss"][-1:], rtol=0.2)


def test_jax_resumes_a_port_last(runs):
    """The JAX trainer restores the port's epoch-2 bundle: weights and
    optax state equal to what the port held."""
    assert "Resumed from" in runs["jax_loaded_out"]
    assert ".last at epoch 2" in runs["jax_loaded_out"]
    v, opt = runs["jax_loaded"]
    pv, popt = runs["port_final"]
    _equal_trees(v, pv)
    _equal_trees(opt, popt)
