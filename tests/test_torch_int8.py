"""The port's int8 forward (slice 5) against the JAX package's
`models/unet_int8.py` and its int8 engine, on the CPU.

Weights: a full-width UNetDC from a seed (the JAX quantizer fixes enc1 at
64 channels); input: 2 images at 64x64.

The JAX package's fast forward applies the 2x2 transposed convs upconv4..2
through `lax.conv_transpose`, which flips the kernel spatially against
the reference's ConvTranspose2d (`test_jax_upconv_transpose_flips_kernel`
shows it). The port computes the reference network, so the comparisons
below give the JAX functions the upconv4..2 kernels flipped back: then
they compute the same network, and the port must match them to the stated
tolerances (ROADMAP queue C records the fault).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_reference import make_decisive_checkpoint

DIL = (1, 2, 4, 8, 16)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flip_up(tree, key="k"):
    """Copy of a JAX param tree with the upconv4..2 kernels flipped."""
    tree = dict(tree)
    for n in (4, 3, 2):
        d = dict(tree[f"upconv{n}"])
        d[key] = d[key][::-1, ::-1]
        tree[f"upconv{n}"] = d
    return tree


@pytest.fixture(scope="module")
def model():
    """(JAX folded params, the port's folded params, x, JAX f32 fast
    params with the flip undone)."""
    from unetdc_tpu.models.unet import UNetDC, fold_batchnorm, init_params
    from unetdc_tpu.models.unet_fast import build_fast_params
    from unetdc_tpu_torch.checkpoint.convert import variables_to_state_dict
    from unetdc_tpu_torch.models import unet as TU

    v = init_params(UNetDC(use_bn=True, dtype=jnp.float32),
                    jax.random.PRNGKey(3), (1, 32, 32, 3))
    jf = fold_batchnorm(v)["params"]
    tf = TU.fold_batchnorm(variables_to_state_dict(v))
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    return jf, tf, x, _flip_up(build_fast_params(jf, dtype=jnp.float32))


@pytest.fixture(scope="module")
def jax_calib(model):
    from unetdc_tpu.models import unet_int8 as J

    jf, _, x, fp = model
    p, m = jax.jit(lambda f, a: J.forward_calib(f, a, DIL))(fp, jnp.asarray(x))
    return np.asarray(p), np.asarray(m)


def test_jax_upconv_transpose_flips_kernel():
    """The fault in the JAX package's fast path: `_upconv_t` equals the
    reference ConvTranspose2d only with the kernel flipped in p and q."""
    import torch.nn.functional as F
    from unetdc_tpu.models.unet_fast import _upconv_t

    rng = np.random.RandomState(1)
    x = rng.randn(1, 3, 4, 5).astype(np.float32)
    w = rng.randn(5, 6, 2, 2).astype(np.float32)  # (I, O, p, q), torch
    ref = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(w), stride=2
                             ).permute(0, 2, 3, 1).numpy()
    k = np.transpose(w, (2, 3, 0, 1))
    b = np.zeros(6, np.float32)
    as_built = np.asarray(_upconv_t(jnp.asarray(x), {"k": k, "b": b}))
    flipped = np.asarray(_upconv_t(jnp.asarray(x),
                                   {"k": k[::-1, ::-1].copy(), "b": b}))
    assert not np.allclose(as_built, ref, atol=1e-3)
    np.testing.assert_allclose(flipped, ref, atol=1e-5)


def test_quantizer_equals_jax(model, jax_calib):
    """Given the same maxima, int8 weights, m and c are the JAX package's
    bit for bit after the layout mapping (pair layout for enc1, dec1 and
    out_conv; upconv1's 256 column scales)."""
    from unetdc_tpu.models import unet_int8 as J
    from unetdc_tpu.models.unet_fast import _pair_kernel
    from unetdc_tpu_torch.models import unet_int8 as P

    jf, tf, _, _ = model
    mx = jax_calib[1]
    qj = J.build_int8_params(jf, mx)
    qt = P.build_int8_params(tf, mx)
    assert qt["in_inv"] == qj["in_inv"]
    for name, groups in (("enc1", ([3], [64])), ("dec1", ([64, 64], [64]))):
        for j, g in enumerate(groups):
            np.testing.assert_array_equal(
                _pair_kernel(qt[name][f"k{j}"], g), qj[name][f"k{j}"])
            for v in ("m", "c"):
                np.testing.assert_array_equal(
                    np.tile(qt[name][f"{v}{j}"], 2), qj[name][f"{v}{j}"])
    for name in ("enc2", "enc3", "enc4", "bottleneck", "dec4", "dec3",
                 "dec2", "upconv4", "upconv3", "upconv2", "upconv1"):
        assert qt[name].keys() == qj[name].keys()
        for k in qj[name]:
            np.testing.assert_array_equal(qt[name][k], qj[name][k],
                                          err_msg=f"{name}.{k}")
    assert qt["upconv1"]["m"].shape == (256,)
    ko = qj["out_conv"]["k"]  # (1, 1, 128, 2) pair
    np.testing.assert_array_equal(ko[0, 0, :64, 0], qt["out_conv"]["k"][
        0, 0, :, 0])
    np.testing.assert_array_equal(ko[0, 0, 64:, 1], qt["out_conv"]["k"][
        0, 0, :, 0])
    np.testing.assert_array_equal(np.tile(qt["out_conv"]["sw"], 2),
                                  qj["out_conv"]["sw"])


def test_forward_calib(model, jax_calib):
    """Calibration: probabilities within 1e-6 of the port's plain f32
    forward; maxima within 1e-5 relative of JAX's forward_calib (flip
    undone) and of the same forward in float64."""
    from unetdc_tpu_torch.models import unet_int8 as P
    from unetdc_tpu_torch.models.unet_fast import (build_fast_params,
                                                   forward_folded)
    from unetdc_tpu_torch.ops import fused_conv as fc

    _, tf, x, _ = model
    fp = build_fast_params(tf, torch.float32)
    probs, mx = P.forward_calib(fp, torch.from_numpy(x))
    plain = forward_folded(fp, torch.from_numpy(x), DIL,
                           fc.conv3x3_relu_pool_plain, fc.dec1_head_plain)
    assert float((probs - plain).abs().max()) <= 1e-6
    np.testing.assert_allclose(probs.numpy(), jax_calib[0], atol=1e-6)
    np.testing.assert_allclose(mx.numpy(), jax_calib[1], rtol=1e-5)
    fp64 = build_fast_params(tf, torch.float64)
    fp64["head"] = {k: v.double() for k, v in fp64["head"].items()}
    _, mx64 = P.forward_calib(fp64, torch.from_numpy(x).double())
    np.testing.assert_allclose(mx.numpy(), mx64.numpy(), rtol=1e-5)
    assert (mx.numpy() > 0).all()


def test_forward_int8_equals_jax(model, jax_calib):
    """forward_int8 fed JAX's maxima: probabilities within 1e-6 of JAX's
    forward_int8 (flip undone) and an equal 0.3 mask; also within 1e-2 of
    the f32 forward."""
    from unetdc_tpu.models import unet_int8 as J
    from unetdc_tpu_torch.models import unet_int8 as P

    jf, tf, x, _ = model
    mx = jax_calib[1]
    qj = jax.tree_util.tree_map(jnp.asarray,
                                _flip_up(J.build_int8_params(jf, mx)))
    ref = np.asarray(jax.jit(lambda q, a: J.forward_int8(q, a, DIL))(
        qj, jnp.asarray(x)))
    dp = P.prepare_int8_params(P.build_int8_params(tf, mx))
    got = P.forward_int8(dp, torch.from_numpy(x), DIL).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_array_equal(got > 0.3, ref > 0.3)
    assert np.abs(got - jax_calib[0]).max() < 1e-2


def test_forward_int8_spmd_equals_jax_sharded_int8_engine(model, jax_calib):
    """The height-sharded int8 forward on a (2, 2) CPU mesh: byte-equal to
    the port's unsharded forward_int8, and within 1e-6 (an equal 0.3 mask)
    of the JAX int8 engine's forward on its (2, 2) virtual-device mesh
    with shard_space (flip undone), from the same maxima.

    The JAX int8 program does not compile with the input sharded over the
    height (XLA's SPMD partitioner pads an int8 halo with an operand of
    another type; ROADMAP queue C), so JAX gets the input sharded over the
    batch and its partitioner places the rest."""
    from unetdc_tpu.core.mesh import batch_sharding
    from unetdc_tpu.core.mesh import make_mesh as jax_mesh
    from unetdc_tpu.models.unet import UNetDC, init_params
    from unetdc_tpu.pipelines.engine import QuantifyEngine as JaxEngine
    from unetdc_tpu_torch.checkpoint.convert import variables_to_state_dict
    from unetdc_tpu_torch.core.mesh import make_mesh
    from unetdc_tpu_torch.models import unet_int8 as P
    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine

    _, _, x, _ = model
    mx = jax_calib[1]
    v = init_params(UNetDC(use_bn=True, dtype=jnp.float32),
                    jax.random.PRNGKey(3), (1, 32, 32, 3))
    jm = jax_mesh(2, 2)
    jeng = JaxEngine(v, quantize="int8", img_size=64, mesh=jm,
                     shard_space=True)
    jeng._finalize_int8(mx)
    jeng.params = _flip_up(jeng.params)
    with pytest.raises(jax.errors.JaxRuntimeError, match="Pad"):
        jeng.forward_probs(jax.device_put(
            jnp.asarray(x), batch_sharding(jm, 4, space_dim=1)))
    ref = np.asarray(jeng.forward_probs(jax.device_put(
        jnp.asarray(x), batch_sharding(jm, 4))))
    eng = QuantifyEngine(variables_to_state_dict(v), quantize="int8",
                         img_size=64, device="cpu",
                         mesh=make_mesh(2, 2, devices="cpu"),
                         shard_space=True)
    eng._finalize_int8(mx)
    got = eng.forward_probs(torch.from_numpy(x))
    plain = P.forward_int8(P.prepare_int8_params(
        P.build_int8_params(eng._folded, mx)), torch.from_numpy(x), DIL)
    assert torch.equal(got, plain)
    assert got.shape == ref.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    np.testing.assert_array_equal(got.numpy() > 0.3, ref > 0.3)


def test_requant_is_one_rounding():
    """The JAX requantization on the CPU rounds the multiply-add once
    (a fused multiply-add); the port's float64 form gives its int8s."""
    from unetdc_tpu.models import unet_int8 as J
    from unetdc_tpu_torch.models.unet_int8 import _requant

    rng = np.random.RandomState(2)
    r = rng.randint(-300000, 300000, (2048, 64)).astype(np.int32)
    m = rng.uniform(1e-5, 1e-3, 64).astype(np.float32)
    c = (rng.randn(64) * 3).astype(np.float32)
    for lo in (0.0, -127.0):
        ref = np.asarray(jax.jit(lambda a, b, d: J._requant(a, b, d, lo))(
            r, m, c))
        got = _requant(torch.from_numpy(r), torch.from_numpy(m).double(),
                       torch.from_numpy(c).double(), lo).numpy()
        np.testing.assert_array_equal(got, ref)


def test_calibration_sidecar_roundtrip_and_cross_package(tmp_path):
    from unetdc_tpu.models import unet_int8 as J
    from unetdc_tpu_torch.models import unet_int8 as P

    assert P.TAGS == J.TAGS
    p = tmp_path / "c.npz"
    m = np.linspace(0.1, 9.0, len(P.TAGS)).astype(np.float32)
    P.save_calibration(p, m)
    np.testing.assert_array_equal(P.load_calibration(p), m)
    np.testing.assert_array_equal(J.load_calibration(p), m)
    J.save_calibration(p, m * 2)
    np.testing.assert_array_equal(P.load_calibration(p), m * 2)
    with pytest.raises(ValueError, match="expected"):
        P.save_calibration(p, m[:-1])
    np.savez(p, maxima=m, tags=np.array(P.TAGS[:-1] + ("bogus",)))
    with pytest.raises(ValueError, match="different"):
        P.load_calibration(p)
    np.savez(p, maxima=m * np.float32(-1), tags=np.array(P.TAGS))
    with pytest.raises(ValueError, match="corrupt"):
        P.load_calibration(p)


def _sd():
    """The `model` fixture's weights as a state dict."""
    from unetdc_tpu_torch.checkpoint.convert import variables_to_state_dict
    from unetdc_tpu.models.unet import UNetDC, init_params

    v = init_params(UNetDC(use_bn=True, dtype=jnp.float32),
                    jax.random.PRNGKey(3), (1, 32, 32, 3))
    return variables_to_state_dict(v)


def test_engine_calibrates_lazily_and_over_batches(model, tmp_path):
    """No sidecar -> params appear at the first forward; calibrate_int8
    takes the elementwise max over batches and saves the sidecar; a fresh
    engine with the sidecar is calibrated at construction."""
    from unetdc_tpu_torch.models import unet_int8 as P
    from unetdc_tpu_torch.models.unet_fast import build_fast_params
    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine

    _, tf, _, _ = model
    sd = _sd()
    side = tmp_path / "scales.npz"
    eng = QuantifyEngine(sd, img_size=32, quantize="int8",
                         calib_path=str(side), device="cpu")
    assert eng.params is None
    r = np.random.RandomState(0)
    dark = (r.rand(1, 32, 32, 3) * 0.05).astype(np.float32)
    bright = r.rand(1, 32, 32, 3).astype(np.float32)
    fp = build_fast_params(tf, torch.float32)
    each = [P.forward_calib(fp, torch.from_numpy(b))[1].numpy()
            for b in (dark, bright)]
    eng.calibrate_int8([dark, bright], preprocessed=True)
    np.testing.assert_array_equal(eng.calib_maxima, np.maximum(*each))
    np.testing.assert_array_equal(P.load_calibration(side),
                                  eng.calib_maxima)
    eng2 = QuantifyEngine(sd, img_size=32, quantize="int8",
                          calib_path=str(side), device="cpu")
    assert eng2.params is not None
    np.testing.assert_array_equal(eng2.calib_maxima, eng.calib_maxima)
    lazy = QuantifyEngine(sd, img_size=32, quantize="int8", device="cpu")
    probs = lazy.forward_probs(torch.from_numpy(bright))
    assert lazy.params is not None and probs.shape == (1, 32, 32, 1)
    np.testing.assert_array_equal(lazy.calib_maxima, each[1])
    with pytest.raises(ValueError):
        QuantifyEngine(sd, img_size=127, quantize="int8", device="cpu")
    with pytest.raises(ValueError):
        QuantifyEngine(sd, img_size=128, quantize="fp4", device="cpu")


def test_pipeline_calibrates_on_canonical_sorted_subset(tmp_path):
    from PIL import Image

    from unetdc_tpu_torch.pipelines.engine import load_engine
    from unetdc_tpu_torch.pipelines.quantify_batch import (
        BatchQuantifyPipeline, list_images)

    ckpt = str(tmp_path / "dec.pth")
    make_decisive_checkpoint(ckpt, seed=0, img_size=64)
    d = tmp_path / "imgs"
    d.mkdir()
    raw = (np.random.RandomState(3).rand(3, 64, 64, 3) * 200).astype(
        np.uint8)
    for i in (2, 0, 1):  # written out of order
        Image.fromarray(raw[i]).save(d / f"img{i}.png")
    eng = load_engine(ckpt, quantize="int8", device="cpu")
    eng.img_size = 64
    pipe = BatchQuantifyPipeline(eng, str(tmp_path / "out"), batch=2,
                                 background_radius=20)
    pipe._maybe_calibrate(list_images(str(d)))
    assert eng.params is not None
    eng2 = load_engine(ckpt, quantize="int8", device="cpu")
    eng2.img_size = 64
    eng2.calibrate_int8(raw[:2], background_radius=20)
    np.testing.assert_array_equal(eng.calib_maxima, eng2.calib_maxima)


def test_cli_int8_flags(tmp_path):
    from unetdc_tpu_torch.cli.quantify_droplets_batch import (build_parser,
                                                              main)
    from PIL import Image

    a = build_parser().parse_args(["--img_dir", "x", "--int8",
                                   "--int8_calib", "none"])
    assert a.int8 and a.int8_calib == "none"
    assert build_parser().parse_args(["--img_dir", "x"]).int8_calib == "auto"
    with pytest.raises(SystemExit):
        main(["--img_dir", "x", "--int8", "--precision", "f32",
              "--device", "cpu"])
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.RandomState(4)
    for i in range(2):
        Image.fromarray((rng.rand(40, 48, 3) * 255).astype(np.uint8)).save(
            d / f"i{i}.png")
    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=3, img_size=32)
    pipe = main(["--img_dir", str(d), "--ckpt_path", str(ckpt), "--out_dir",
                 str(tmp_path / "out"), "--batch", "1", "--int8",
                 "--device", "cpu", "--skip_histogram", "--skip_excel"])
    assert pipe.engine.quantize == "int8"
    assert (tmp_path / "m.pth.int8calib.npz").exists()
    assert (tmp_path / "out" / "predicted_masks" / "i1_pred.png").exists()


def test_int8_end_to_end_matches_jax_engine(tmp_path):
    """The e2e fixture of tests/test_int8.py (96x112 images, img_size 128,
    decisive checkpoint) through the JAX int8 engine (flip undone) and the
    port's, with one shared sidecar: equal masks and byte-equal CSVs."""
    from PIL import Image

    from unetdc_tpu.pipelines.engine import load_engine as j_load
    from unetdc_tpu.pipelines.quantify_batch import (
        BatchQuantifyPipeline as JPipe)
    from unetdc_tpu_torch.pipelines.engine import load_engine
    from unetdc_tpu_torch.pipelines.quantify_batch import (
        BatchQuantifyPipeline, list_images)

    ckpt = str(tmp_path / "dec.pth")
    make_decisive_checkpoint(ckpt, seed=0)
    rng = np.random.RandomState(7)
    imgs = (rng.rand(2, 96, 112, 3) * 60).astype(np.uint8)
    yy, xx = np.mgrid[:96, :112]
    for b in range(2):
        for _ in range(6):
            cy, cx = rng.randint(10, 86), rng.randint(10, 102)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.randint(3, 9) ** 2
            imgs[b][blob] = np.minimum(imgs[b][blob] + 180, 255)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(2):
        Image.fromarray(imgs[i]).save(d / f"img{i}.png")
    side = str(tmp_path / "shared.int8calib.npz")
    kw = dict(batch=2, prob_thresh=0.3, min_area=1, px_per_micron=3.45,
              background_radius=50)
    eng = load_engine(ckpt, quantize="int8", calib_path=side, device="cpu")
    eng.img_size = 128
    BatchQuantifyPipeline(eng, str(tmp_path / "port"), **kw).run(
        str(d), progress=False)
    jeng = j_load(ckpt, quantize="int8", calib_path=side)
    assert jeng.params is not None  # the port's sidecar pinned the scales
    np.testing.assert_array_equal(jeng.calib_maxima, eng.calib_maxima)
    jeng.params = _flip_up(jeng.params)
    jeng.img_size = 128
    JPipe(jeng, str(tmp_path / "jax"), **kw).run(str(d), progress=False)
    n = 0
    for p in list_images(str(d)):
        a = (tmp_path / "port" / f"{p.stem}_droplets.csv").read_bytes()
        b = (tmp_path / "jax" / f"{p.stem}_droplets.csv").read_bytes()
        assert a == b, p.name
        n += a.count(b"\n") - 1
        ma = np.array(Image.open(tmp_path / "port" / "predicted_masks"
                                 / f"{p.stem}_pred.png"))
        mb = np.array(Image.open(tmp_path / "jax" / "predicted_masks"
                                 / f"{p.stem}_pred.png"))
        np.testing.assert_array_equal(ma, mb, err_msg=p.name)
    assert n > 0
