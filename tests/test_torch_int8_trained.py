"""The port's trained-checkpoint int8 contract
(`unetdc_tpu_torch/utils/int8_trained_eval.py`) against the JAX
package's: the synthetic droplet set draws the same numbers in the same
order (images, masks and held-out images equal), and a tiny run (16
images at 32x32, one epoch, on the CPU) returns the JAX module's five
keys with values in range. The run's numbers at full size come from the
card (chip_smoke's `int8_trained` line)."""

import math
import os

import numpy as np

from unetdc_tpu.utils import int8_trained_eval as J
from unetdc_tpu_torch.io.native import decode_rgb
from unetdc_tpu_torch.utils import int8_trained_eval as T

KEYS = {"int8_trained_agreement", "int8_trained_agreement_min",
        "int8_trained_count_match_rate", "int8_trained_count_mean_abs_diff",
        "trained_val_dice"}


def test_droplet_dataset_equals_jax(tmp_path):
    for mod, sub in ((T, "t"), (J, "j")):
        mod.make_droplet_dataset(str(tmp_path / sub), n=6, size=48, seed=3)
    for kind in ("images", "masks"):
        names = sorted(os.listdir(tmp_path / "j" / kind))
        assert sorted(os.listdir(tmp_path / "t" / kind)) == names
        assert len(names) == 6
        for n in names:
            a = decode_rgb(tmp_path / "t" / kind / n)
            np.testing.assert_array_equal(
                a, decode_rgb(tmp_path / "j" / kind / n), err_msg=n)
            if kind == "masks":
                assert set(np.unique(a)) <= {0, 255}
    # the held-out images continue the JAX function's draws
    rng = np.random.RandomState(1000)
    yy, xx = np.mgrid[:32, :32]
    want = []
    for _ in range(3):
        img = (rng.rand(32, 32, 3) * 60 + 40).astype(np.uint8)
        for _ in range(rng.randint(12, 24)):
            cy, cx = rng.randint(8, 24), rng.randint(8, 24)
            r = rng.randint(3, 10)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            img[blob] = np.minimum(img[blob] + 170, 255)
        want.append(img)
    np.testing.assert_array_equal(T.eval_images(3, 32, 1000),
                                  np.stack(want))


def test_tiny_train_and_eval_on_cpu(tmp_path):
    out = T.train_and_eval_int8(str(tmp_path), n_images=16, size=32,
                                epochs=1, n_eval=16, device="cpu")
    assert set(out) == KEYS
    assert 0.0 <= out["int8_trained_agreement_min"] \
        <= out["int8_trained_agreement"] <= 1.0
    assert out["int8_trained_count_match_rate"] in {i / 16 for i in
                                                    range(17)}
    assert out["int8_trained_count_mean_abs_diff"] >= 0.0
    assert math.isnan(out["trained_val_dice"]) or \
        0.0 <= out["trained_val_dice"] <= 1.0
    assert (tmp_path / "best.msgpack").exists()
