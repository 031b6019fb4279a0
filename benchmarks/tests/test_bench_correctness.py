"""`correct` decided as a run decides it, at sizes a CPU test run can
hold, with the look for a card skipped: true on the program as it is,
false with the timed path broken underneath (each fault a cell can have),
and the control's readings over the cell's limits."""

import pytest
import torch

import bench_small


def test_quantify_is_correct(monkeypatch):
    res = bench_small.run_small("unetdc.quantify", monkeypatch)
    assert res["correct"], res["checks"]


def test_quantify_answer_altered(monkeypatch):
    """A droplet's area altered where the table is produced."""
    from unetdc_tpu_torch.pipelines import quantify_batch as qb

    orig = qb.props_to_dataframe

    def altered(props, count, px):
        df = orig(props, count, px)
        if len(df):
            df.loc[0, "area"] += 1
        return df

    monkeypatch.setattr(qb, "props_to_dataframe", altered)
    res = bench_small.run_small("unetdc.quantify", monkeypatch)
    assert not res["correct"]
    assert res["checks"]["table_mismatch"]["value"] >= 1


def test_quantify_half_batch_left_out(monkeypatch):
    """The megastep runs on the first half of each batch only; the rest
    is left as zeros."""
    from unetdc_tpu_torch.pipelines import engine as eng

    orig = eng.QuantifyEngine._megastep

    def half(self, imgs, *a, **k):
        h = imgs.shape[0] // 2
        out = orig(self, torch.cat([imgs[:h], imgs[:h]]), *a, **k)
        out["mask"][h:] = 0
        return out

    monkeypatch.setattr(eng.QuantifyEngine, "_megastep", half)
    res = bench_small.run_small("unetdc.quantify", monkeypatch)
    assert not res["correct"]


def test_segment_is_correct_and_an_altered_mask_is_not(monkeypatch):
    res = bench_small.run_small("unetdc.segment", monkeypatch, n=2)
    assert res["correct"], res["checks"]
    from unetdc_tpu_torch.ops import resize

    orig = resize.resize_mask_linear_round

    def altered(mask, out_hw):
        out = orig(mask, out_hw).clone()
        out[:16, :16] = 1 - out[:16, :16]
        return out

    monkeypatch.setattr(resize, "resize_mask_linear_round", altered)
    res = bench_small.run_small("unetdc.segment", monkeypatch, n=2)
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["unetdc.train", "unet.train"])
def test_train_is_correct(cell, monkeypatch):
    res = bench_small.run_small(cell, monkeypatch)
    assert res["correct"], res["checks"]


def test_train_state_unchanged(monkeypatch):
    """Each step returns the parameters unchanged (no optimizer step)."""
    from unetdc_tpu_torch.train import trainer

    orig = trainer.Trainer.train_step

    def frozen(self, x, m, valid, valid_np=None):
        step = self.opt.step
        self.opt.step = lambda *a, **k: None
        try:
            return orig(self, x, m, valid, valid_np)
        finally:
            self.opt.step = step

    monkeypatch.setattr(trainer.Trainer, "train_step", frozen)
    res = bench_small.run_small("unetdc.train", monkeypatch)
    assert not res["correct"]
    # no leaf moved: the worst leaf (one at or over the median norm) reads 1
    assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_left_out(monkeypatch):
    """The step sees the first half of each batch; the loss is the mean
    over it."""
    from unetdc_tpu_torch.train import trainer

    orig = trainer.Trainer.train_step

    def half(self, x, m, valid, valid_np=None):
        h = x.shape[0] // 2
        return orig(self, x[:h], m[:h], valid[:h],
                    None if valid_np is None else valid_np[:h])

    monkeypatch.setattr(trainer.Trainer, "train_step", half)
    res = bench_small.run_small("unetdc.train", monkeypatch)
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["unetdc.segment", "unetdc.train",
                                  "unet.train"])
def test_the_control_is_not_correct(cell):
    """The control's readings (the reference with fp8 conv operands in
    the program's place) pass at least one of the cell's limits."""
    import control

    torch.set_num_threads(4)
    wl = bench_small.small_workload(cell, n=2)
    vals = control.reading(cell, bench_small.SEED, "control", "cpu", wl,
                           bench_small.small_config(wl))
    assert any(vals[k] > lim for k, lim in wl["limits"].items()), vals


def test_the_quantify_control_is_not_correct():
    """The quantifier's control is the program's own --int8 path."""
    import control

    torch.set_num_threads(4)
    wl = bench_small.small_workload("unetdc.quantify")
    vals = control.reading("unetdc.quantify", bench_small.SEED, "control",
                           "cpu", wl, bench_small.small_config(wl))
    assert any(vals[k] > lim for k, lim in wl["limits"].items()), vals
