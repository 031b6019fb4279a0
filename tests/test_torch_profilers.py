"""The port's profilers (`unetdc_tpu_torch/utils/{device_profile,
forward_profile,epoch_wall}.py`) against the JAX package's tools, on the
CPU at small sizes: the synthetic inputs equal, the JAX tools' keys and
rows, the FLOP accounting held to the JAX tools and to XLA's cost
analysis."""

import ast
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from unetdc_tpu.utils import epoch_wall as jax_epoch_wall
from unetdc_tpu.utils import forward_profile as jax_fp
from unetdc_tpu_torch.utils import device_profile as DP
from unetdc_tpu_torch.utils import epoch_wall as EW
from unetdc_tpu_torch.utils import forward_profile as FP

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two torch threads: the full-width model trains and profiles here,
    beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_keys(path, func, target):
    """The keys of the JAX tool's result, read from its source: the string
    keys that `func` stores into `target[...]` or puts in a dict literal
    assigned to `target`; with target "out", also the names of the
    (name, op, input) stage tuples."""
    tree = ast.parse(Path(path).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store) \
                and getattr(n.value, "id", None) == target \
                and isinstance(n.slice, ast.Constant):
            keys.add(n.slice.value)
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict) \
                and any(getattr(t, "id", None) == target for t in n.targets):
            keys |= {k.value for k in n.value.keys}
        if isinstance(n, ast.Tuple) and n.elts and isinstance(
                n.elts[0], ast.Constant) and isinstance(n.elts[0].value, str) \
                and len(n.elts) == 3 and target == "out":
            keys.add(n.elts[0].value)
    return keys


@pytest.mark.parametrize("n,h,w,seed,gray", [(2, 32, 48, 0, False),
                                             (1, 40, 40, 3, True),
                                             (3, 64, 24, 7, False)])
def test_make_blob_images_byte_equal_to_bench(n, h, w, seed, gray):
    got = DP.make_blob_images(n, h, w, seed=seed, gray=gray)
    want = bench.make_blob_images(n, h, w, seed=seed, gray=gray)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,size,seed", [(3, 32, 0), (2, 48, 5)])
def test_make_droplet_dataset_pixel_equal_to_jax(tmp_path, n, size, seed):
    from PIL import Image

    got = EW.make_droplet_dataset(str(tmp_path / "port"), n, size, size,
                                  seed=seed)
    want = jax_epoch_wall.make_droplet_dataset(str(tmp_path / "jax"), n,
                                               size, size, seed=seed)
    assert got[2] == want[2]
    for name in got[2]:
        for g, w in ((got[0], want[0]), (got[1], want[1])):
            a = np.array(Image.open(Path(g) / name))
            b = np.array(Image.open(Path(w) / name))
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_packbits_equals_numpy():
    m = np.random.RandomState(0).randint(0, 3, (3, 5, 7)).astype(np.uint8)
    np.testing.assert_array_equal(
        DP.packbits(torch.from_numpy(m)).numpy(),
        np.stack([np.packbits(x.reshape(-1) != 0) for x in m]))


def test_profile_stages_keys_on_cpu():
    """The JAX tool's stage and derived keys (forward_pallas and its
    totals under the port's kernel names), finite and >= 0; no MFU
    against the H100 peak from a CPU time."""
    res = DP.profile_stages(batch=1, size=32, iters=2, verbose=False,
                            int8=True, device="cpu")
    jax_keys = _jax_keys(
        ROOT / "unetdc_tpu/utils/device_profile.py", "profile_stages", "out")
    rename = {"forward_pallas": "forward_kernels",
              "total_pallas": "total_kernels",
              "img_per_s_device_pallas": "img_per_s_device_kernels"}
    keys = {rename.get(k, k) for k in jax_keys} - {"forward_mfu"}
    assert {"rolling_ball", "resize_u8", "forward_bf16", "thresh+maskresize",
            "cc+regionprops", "packbits", "forward_kernels", "forward_int8",
            "total", "total_int8", "forward_flops"} <= keys
    assert keys <= set(res)
    for k in keys:
        assert math.isfinite(res[k]) and res[k] >= 0, k
    assert "forward_mfu" not in res and res["device"] == "cpu"
    assert res["forward_flops"] == DP.forward_flops(1, 32)
    assert res["total_kernels"] == pytest.approx(
        res["total"] - res["forward_bf16"] + res["forward_kernels"])
    for name, rec in res["stages"].items():
        assert rec["event_ms"] == pytest.approx(res[name] * 1e3)
        assert rec["device_ms"] is None, name


def _shapes_only_init(model, rng=None, input_shape=(1, 64, 64, 3)):
    """`unetdc_tpu.models.unet.init_params` with every variable 1: the
    FLOP accounting needs the shapes alone, and flax's eager init of the
    full-width model takes ~25 s here."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(input_shape), train=False))
    return jax.tree_util.tree_map(lambda s: jnp.ones(s.shape, s.dtype),
                                  shapes)


def _jax_rows(monkeypatch, batch, size):
    """The JAX tool's rows, its looped-jit timing stubbed out (the rows'
    FLOP accounting is computed from shapes alone)."""
    from unetdc_tpu.models import unet

    monkeypatch.setattr(unet, "init_params", _shapes_only_init)
    monkeypatch.setattr(jax_fp, "_loop_jit", lambda op, n: None)
    monkeypatch.setattr(jax_fp, "_time_once", lambda fn, x: 0.0)
    monkeypatch.setattr(jax_fp, "_measure", lambda *a, **k: 1e-3)
    rows = jax_fp.profile_forward(batch=batch, size=size, iters=1,
                                  verbose=False)
    return {k: v for k, v in rows.items() if not k.startswith("_")}


def _flops(gflop_values):
    return round(math.fsum(gflop_values) * 1e9)


def test_forward_profile_rows_cover_the_jax_rows(monkeypatch):
    """Every port row maps to JAX rows, every JAX row is covered once, and
    the useful FLOPs agree exactly: in all, per mapped group (the stem and
    K1 together cover JAX's enc1 and pool1 rows), and with
    `forward_flops`."""
    jrows = _jax_rows(monkeypatch, 2, 32)
    rows = FP.profile_forward(batch=2, size=32, iters=1, verbose=False,
                              device="cpu")
    prows = {k: v for k, v in rows.items() if not k.startswith("_")}
    assert list(prows) == list(FP.JAX_ROWS)
    covered = [j for js in FP.JAX_ROWS.values() for j in js]
    assert sorted(covered) == sorted(jrows) and len(set(covered)) == len(
        covered)
    total = sum(r["useful_flops"] for r in prows.values())
    assert total == DP.forward_flops(2, 32)
    assert total == _flops(r["useful_gflop"] for r in jrows.values())
    assert _flops(r["useful_gflop"] for r in prows.values()) == total
    stem, k1 = list(FP.JAX_ROWS)[:2]
    groups = [((stem, k1), FP.JAX_ROWS[stem] + FP.JAX_ROWS[k1])] + [
        ((p,), js) for p, js in list(FP.JAX_ROWS.items())[2:]]
    for ports, jaxs in groups:
        assert sum(prows[p]["useful_flops"] for p in ports) == _flops(
            jrows[j]["useful_gflop"] for j in jaxs), ports
    for name, r in prows.items():
        assert r["ms"] >= 0 and r["traffic_mb"] > 0, name
        assert r["exec_gflop"] >= r["useful_gflop"] > 0, name
        assert r["bound"] is None and r["mfu"] is None, name  # CPU
    k2 = prows["upconv1+dec1+out_conv+sigmoid (K2)"]
    assert k2["exec_gflop"] == pytest.approx(
        FP.k2_exec_flops(2, 32, 32) / 1e9, rel=1e-12)
    assert rows["_whole_forward_ms"] > 0 and rows["_sum_of_layers_ms"] > 0
    json.dumps(DP.clean(rows))


def test_k2_tile_plan_matches_the_kernel_source():
    """`K2_TILE` is the tile plan of the bf16 K2 in csrc/fused_conv.cu."""
    src = (ROOT / "unetdc_tpu_torch/csrc/fused_conv.cu").read_text()
    k2 = src[src.index("namespace k2 {"):]
    k2 = k2[:k2.index("}  // namespace k2")]
    for name, value in FP.K2_TILE.items():
        assert re.search(rf"\b{name} = {value}\b", k2), name
    # at 512x512 the tiles issue 1.25x the network's FLOPs
    useful = 8 * (2 * 512 * 512 * (128 * 64 + 9 * 128 * 64 + 9 * 64 * 64
                                   + 64))
    assert FP.k2_exec_flops(8, 512, 512) / useful == pytest.approx(
        1.2509, abs=1e-4)


def _valid_tap_flops(S, widths=(64, 128, 256, 512, 1024), cin=3,
                     dil=(1, 2, 4, 8, 16)):
    """The network's FLOPs counting only the 3x3 taps that fall inside the
    image (what XLA's cost analysis counts for a padded conv)."""
    def taps(n, d):
        return sum(0 <= o + k * d < n for o in range(n) for k in (-1, 0, 1))

    f, c = 0, cin
    for i, wd in enumerate(widths):
        f += 2 * taps(S >> i, dil[i]) ** 2 * (c * wd + wd * wd)
        c = wd
    for i in range(len(widths) - 2, -1, -1):
        wd = widths[i]
        f += 2 * (S >> (i + 1)) ** 2 * c * wd * 4
        f += 2 * taps(S >> i, 1) ** 2 * 3 * wd * wd
        c = wd
    return f + 2 * S * S * c


@pytest.mark.parametrize("size,ratio", [(32, 0.76663), (64, 0.80433),
                                        (512, 0.94009)])
def test_forward_flops_against_xla_cost_analysis(size, ratio):
    """XLA's cost analysis of the JAX forward counts only the conv taps
    inside the image, plus its elementwise ops; the port counts every tap
    (the network's MACs). Measured here: XLA / port = 0.7666 at 32x32,
    0.8043 at 64x64 and 0.9401 at 512x512 (the dilated convs of the small
    maps lose most of their taps to the padding), and XLA is 1.000-1.07x
    the in-image tap count."""
    from unetdc_tpu.models.unet import UNetDC, fold_batchnorm
    from unetdc_tpu.utils.device_profile import forward_flops as xla_flops

    v = _shapes_only_init(UNetDC())
    xla = xla_flops(UNetDC(use_bn=False, dtype=jnp.bfloat16),
                    fold_batchnorm(v), jnp.zeros((1, size, size, 3)))
    port = DP.forward_flops(1, size)
    assert port == DP.unet_forward_flops(size, size)
    assert xla / port == pytest.approx(ratio, abs=1e-4)
    assert 1.0 <= xla / _valid_tap_flops(size) <= 1.07


def test_epoch_wall_main_prints_the_jax_keys(capsys):
    rc = EW.main(n_train=8, n_val=8, size=64, batch=4, epochs=2,
                 device="cpu")
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_keys = _jax_keys(
        ROOT / "unetdc_tpu/utils/epoch_wall.py", "main", "result")
    assert "wall_over_device_train" in jax_keys and len(jax_keys) == 15
    assert jax_keys <= set(res) and res["device"] == "cpu"
    assert rc == (0 if res["pass"] else 1)
    assert res["pass"] == (res["wall_over_device_train"] <= 2.0)
    assert [w["epoch"] for w in res["epoch_walls"]] == [0, 1]
    for k in jax_keys - {"epoch_walls", "pass"}:
        assert math.isfinite(res[k]) and res[k] > 0, k
