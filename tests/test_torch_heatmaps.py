"""The port's heatmap ops, engines, pipelines and CLIs (slice 5) against the
JAX package's, on the CPU, in f32, on the fixture of
tests/test_heatmap_pipelines.py (2 images at 96x112 with a bright ROI disk,
a decisive checkpoint, img_size 128).

Tolerances: every op equal to the JAX package's (masks, rings, box and ring
sums, thresholds, float32 maps to the bit); the spatial density map of the
v1 engine within 1 level of 255. Also: a channel-equal batch uploaded as
(B,H,W) gives the outputs of its (B,H,W,3) form (the JAX engines cannot
take it), and two colliding centroids resolve to the higher table slot.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import jax
import jax.numpy as jnp

from tests.torch_reference import make_decisive_checkpoint

IMG_SIZE = 128
T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "ref.pth"
    make_decisive_checkpoint(str(path))
    return str(path)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """tests/test_heatmap_pipelines.py's images."""
    from PIL import Image

    rng = np.random.RandomState(11)
    d = tmp_path_factory.mktemp("imgs")
    for i in range(2):
        img = (rng.rand(96, 112, 3) * 50).astype(np.uint8)
        yy, xx = np.mgrid[:96, :112]
        disk = (yy - 48) ** 2 + (xx - 56) ** 2 <= 40 ** 2
        img[disk] = np.minimum(img[disk] + 90, 255)
        for _ in range(5):
            cy, cx = rng.randint(20, 76), rng.randint(25, 87)
            r = rng.randint(3, 7)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
            img[blob & disk] = 255
        Image.fromarray(img).save(d / f"img{i:02d}.png")
    return str(d)


@pytest.fixture(scope="module")
def imgs(image_dir):
    from unetdc_tpu_torch.io.images import decode_rgb
    from unetdc_tpu_torch.pipelines.quantify_batch import list_images

    return np.stack([decode_rgb(p) for p in list_images(image_dir)])


def _gray_images(seed, n=6, h=96, w=112):
    """Blurred disk-on-noise gray images of varied contrast."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = (rng.rand(h, w) * rng.randint(20, 120)).astype(np.float32)
        yy, xx = np.mgrid[:h, :w]
        r = rng.randint(10, 45)
        img[(yy - h // 2) ** 2 + (xx - w // 2) ** 2 <= r ** 2] += \
            rng.randint(30, 130)
        out.append(np.clip(ndi.gaussian_filter(img, 2), 0, 255))
    return np.stack(out).astype(np.uint8)


# ---------------------------------------------------------------- ops --
def test_gaussian_blur_and_otsu_match_jax():
    from unetdc_tpu.ops.filters import gaussian_blur as j_blur
    from unetdc_tpu.ops.threshold import otsu_threshold as j_otsu
    from unetdc_tpu_torch.ops.filters import gaussian_blur
    from unetdc_tpu_torch.ops.threshold import otsu_threshold

    g = _gray_images(0, n=40)
    ours = gaussian_blur(T(g))
    for i in (0, 17, 39):
        np.testing.assert_array_equal(
            ours[i].numpy(), np.asarray(j_blur(jnp.asarray(g[i]))))
    t = otsu_threshold(T(g)).numpy()
    ref = np.asarray(jax.vmap(j_otsu)(jnp.asarray(g)))
    np.testing.assert_array_equal(t, ref)


def test_generate_roi_mask_matches_jax(imgs):
    from unetdc_tpu.ops.roi import generate_roi_mask as j_roi
    from unetdc_tpu.ops.roi import moments_centroid as j_mc
    from unetdc_tpu_torch.ops.roi import generate_roi_mask, moments_centroid

    rgb = np.concatenate([imgs, np.repeat(_gray_images(1, 4)[..., None], 3,
                                          -1)])
    ours = generate_roi_mask(T(rgb))
    ref = np.asarray(jax.vmap(j_roi)(jnp.asarray(rgb)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ref.any() and not ref.all()
    cy, cx = moments_centroid(ours)
    jcy, jcx = jax.vmap(j_mc)(jnp.asarray(ref))
    np.testing.assert_array_equal(cy.numpy(), np.asarray(jcy))
    np.testing.assert_array_equal(cx.numpy(), np.asarray(jcx))


@pytest.mark.parametrize("op", ["contour_scan", "contour_spreading_4",
                                "contour_spreading_8",
                                "contour_shrinking_box", "remove_objects",
                                "calculate_contours_centroid"])
def test_contour_ops_match_jax(op):
    import unetdc_tpu.ops.contours as J
    import unetdc_tpu_torch.ops.contours as P

    g = _gray_images(2, n=3)
    g[1, 40:50, :] = 0  # a dark band the floods run along
    thresh = 40
    if op == "remove_objects":
        m = (np.random.RandomState(3).rand(3, 48, 56) > 0.7)
        ours = P.remove_objects(T(m), 4, 4096).numpy()
        ref = np.stack([np.asarray(J.remove_objects(jnp.asarray(x), 4))
                        for x in m])
    elif op == "calculate_contours_centroid":
        m = g > thresh
        m[2] = False  # the empty-mask fallback
        cy, cx = P.calculate_contours_centroid(T(m))
        ref = np.stack([np.stack([np.asarray(v) for v in
                                  J.calculate_contours_centroid(
                                      jnp.asarray(x))]) for x in m])
        ours = np.stack([cy.numpy(), cx.numpy()], 1)
    else:
        ours = getattr(P, op)(T(g), thresh).numpy()
        ref = np.stack([np.asarray(getattr(J, op)(jnp.asarray(x), thresh))
                        for x in g])
    np.testing.assert_array_equal(ours, ref)


def _density_inputs(seed):
    """(mask_thresh, roi, centroid-size image, ring centre) with droplets
    from scipy labels, 2 images at 96x112."""
    rng = np.random.RandomState(seed)
    h, w = 96, 112
    yy, xx = np.mgrid[:h, :w]
    roi = np.stack([(yy - 48) ** 2 + (xx - 56) ** 2 <= r ** 2
                    for r in (40, 33)])
    m = (rng.rand(2, h, w) > 0.8) & roi
    csi = np.zeros((2, h, w), np.float32)
    for i in range(2):
        lab, n = ndi.label(m[i])
        for k in range(1, n + 1):
            ys, xs = np.nonzero(lab == k)
            csi[i, int(ys.mean() + 0.5), int(xs.mean() + 0.5)] = len(ys)
    cy = np.array([47.25, 50.0], np.float32)
    cx = np.array([55.5, 61.0], np.float32)
    return m, roi, csi, cy, cx


@pytest.mark.parametrize("op", ["density_maps", "get_targets",
                                "radial_centroid_count_map",
                                "gaussian_density_map"])
def test_density_ops_match_jax(op):
    import unetdc_tpu.ops.density as J
    import unetdc_tpu_torch.ops.density as P

    m, roi, csi, cy, cx = _density_inputs(4)
    if op == "density_maps":
        ours = P.density_maps(T(m), T(roi), T(csi), 15)
        ref = [J.density_maps(jnp.asarray(m[i]), jnp.asarray(roi[i]),
                              jnp.asarray(csi[i]), 15) for i in range(2)]
    elif op == "get_targets":
        ours = P.get_targets(T(m), T(roi), T(csi), 3, T(cy), T(cx))
        ref = jax.vmap(lambda a, b, c, y, x: J.get_targets(
            a, b, c, 3, y, x))(m, roi, csi, cy, cx)
    elif op == "radial_centroid_count_map":
        rng = np.random.RandomState(5)
        ys = (rng.rand(2, 64) * 96).astype(np.float32)
        xs = (rng.rand(2, 64) * 112).astype(np.float32)
        ys[:, :4] = cy[:, None] + np.float32(3.0)  # on a ring bound-ish
        xs[:, :4] = cx[:, None] + np.float32(4.0)
        valid = rng.rand(2, 64) > 0.2
        ours = [P.radial_centroid_count_map(T(roi), T(ys), T(xs),
                                            T(valid), 10, T(cy), T(cx))]
        ref = [jax.vmap(lambda a, y, x, v, c0, c1:
                        J.radial_centroid_count_map(a, y, x, v, 10, c0, c1))(
            roi, ys, xs, valid, cy, cx)]
    else:
        ours = [P.gaussian_density_map(T(m), T(roi), 21)]
        ref = [np.stack([np.asarray(J.gaussian_density_map(
            jnp.asarray(m[i]), jnp.asarray(roi[i]), 21)) for i in range(2)])]
    if op == "density_maps":
        ref = [np.stack([np.asarray(r[j]) for r in ref]) for j in range(4)]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert any(np.asarray(b).any() for b in ref)


@pytest.mark.parametrize("op", ["otsu_binarize", "segmentation_two_thresholds",
                                "density_map", "get_target",
                                "min_max_density", "component_areas"])
def test_remaining_ops_match_jax(op):
    """The ported ops the engines do not call, against the JAX package's."""
    import unetdc_tpu.ops.density as JD
    import unetdc_tpu_torch.ops.density as PD

    m, roi, csi, cy, cx = _density_inputs(8)
    if op == "otsu_binarize":
        from unetdc_tpu.ops.threshold import otsu_binarize as j_op
        from unetdc_tpu_torch.ops.threshold import otsu_binarize

        g = _gray_images(9, n=4)
        ours, ref = otsu_binarize(T(g)), jax.vmap(j_op)(jnp.asarray(g))
    elif op == "segmentation_two_thresholds":
        from unetdc_tpu.ops.threshold import (
            segmentation_two_thresholds as j_op)
        from unetdc_tpu_torch.ops.threshold import segmentation_two_thresholds

        g = _gray_images(10, n=3)
        ours = segmentation_two_thresholds(T(g), 90, 40)
        ref = np.stack([np.asarray(j_op(jnp.asarray(x), 90, 40)) for x in g])
    elif op == "density_map":
        ours = PD.density_map(T(m), T(roi), 15)
        ref = np.stack([np.asarray(JD.density_map(
            jnp.asarray(m[i]), jnp.asarray(roi[i]), 15)) for i in range(2)])
    elif op == "get_target":
        ours = PD.get_target(T(m), T(roi), 3, T(cy), T(cx))
        ref = jax.vmap(lambda a, b, y, x: JD.get_target(a, b, 3, y, x))(
            m, roi, cy, cx)
    elif op == "min_max_density":
        dm = PD.density_map(T(m), T(roi), 15)
        empty = np.zeros_like(roi[0])
        for i in range(2):
            jm = np.asarray(JD.density_map(jnp.asarray(m[i]),
                                           jnp.asarray(roi[i]), 15))
            assert PD.min_max_mean_sd_density(dm[i], T(roi[i])) \
                == JD.min_max_mean_sd_density(jm, roi[i])
            assert PD.min_max_mean_median_density(dm[i], T(roi[i])) \
                == JD.min_max_mean_median_density(jm, roi[i])
        assert PD.min_max_mean_median_density(dm[0], T(empty)) == (0, 0, 0, 0)
        return
    else:
        from unetdc_tpu.ops.connected_components import (
            component_areas as j_op)
        from unetdc_tpu_torch.ops.connected_components import component_areas

        lab = np.stack([ndi.label(x)[0] for x in m]).astype(np.int32)
        assert lab.max() > 32  # labels past num_segments are dropped
        for n in (32, 4096):
            np.testing.assert_array_equal(
                component_areas(T(lab), n).numpy(),
                np.stack([np.asarray(j_op(jnp.asarray(x), n)) for x in lab]))
        return
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert np.asarray(ref).any() and not np.asarray(ref).all()


def test_ring_bounds_match_jax_linspace():
    """Ring bounds and ring ids equal JAX's as its engines compute them
    (batched under vmap), also for centres whose distances are square
    roots of integers (pixels exactly on a bound). XLA on the CPU compiles
    dx**2 + dy**2 to a fused multiply-add at 600x800 but not at every
    small shape, so the distances themselves are held equal at 600x800 and
    within one float32 ulp elsewhere."""
    from unetdc_tpu.ops.density import _ring_index as j_ring
    from unetdc_tpu_torch.ops.density import _ring_index

    rng = np.random.RandomState(6)
    for nb, (h, w) in ((3, (60, 70)), (10, (96, 112)), (10, (600, 800))):
        m = (rng.rand(4, h, w) > 0.3)
        m[3] = (np.mgrid[:h, :w][0] - 48) ** 2 \
            + (np.mgrid[:h, :w][1] - 56) ** 2 <= 1700
        cy = np.array([30, 12.5, 0, 48], np.float32)
        cx = np.array([35, 20, w - 1, 56], np.float32)
        rid, d, max_d, bounds = _ring_index(T(m), T(cy), T(cx), nb)
        jr, jd, jm, jb = jax.jit(jax.vmap(
            lambda a, b, c: j_ring(a, b, c, nb)))(m, cy, cx)
        np.testing.assert_array_equal(bounds.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(rid.numpy(), np.asarray(jr))
        if h == 600:
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        else:
            np.testing.assert_allclose(d.numpy(), np.asarray(jd),
                                       rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("cap", [1024, 5])
def test_remove_small_batch_matches_scipy_and_jax(cap):
    """Components >= 4 px kept (8-connected); with cap 5 the components
    ranked past the cap pass through unexamined, as in the JAX package."""
    from unetdc_tpu.ops.connected_components import (
        remove_small_batch_counted as j_rsb)
    from unetdc_tpu_torch.ops.connected_components import (
        remove_small_batch_counted)

    m = (np.random.RandomState(42).rand(3, 48, 48) > 0.72).astype(np.uint8)
    ours, n = remove_small_batch_counted(T(m), 4, cap, connectivity=2)
    ref, jn = j_rsb(jnp.asarray(m), 4, cap, connectivity=2)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    for i in range(3):
        lab, k = ndi.label(m[i], structure=np.ones((3, 3)))
        assert int(n[i]) == k
        areas = np.bincount(lab.ravel())
        keep = (areas >= 4) | (np.arange(k + 1) > cap)
        keep[0] = False
        np.testing.assert_array_equal(ours[i].numpy(), keep[lab])
    if cap == 5:
        assert int(n.max()) > cap


@pytest.mark.parametrize("hw", [(40, 48), (1300, 24)])
def test_presieve_tables_match_jax(hw):
    """want_presieve: all_area, all_sum-0/1 (f32) and all_count equal the
    JAX package's, on the unsplit and the split coordinate plans."""
    from unetdc_tpu.ops.connected_components import (
        quantify_mask_batch as j_q)
    from unetdc_tpu_torch.ops.connected_components import quantify_mask_batch

    m = (np.random.RandomState(7).rand(2, *hw) > 0.6).astype(np.uint8)
    ours = quantify_mask_batch(T(m), 3, 64, connectivity=1,
                               want_presieve=True)
    ref = j_q(jnp.asarray(m), jnp.int32(3), 64, connectivity=1,
              want_presieve=True)
    for k in ("all_area", "all_sum-0", "all_sum-1", "all_count", "count",
              "area"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_centroid_collision_takes_highest_slot():
    from unetdc_tpu_torch.pipelines.heatmaps import centroid_size_from_stats

    area = torch.tensor([[4, 9, 7, 0, 5]], dtype=torch.int32)
    # slots 0, 1, 2 all round to pixel (2, 3); slot 4 to (0, 0)
    s0 = torch.tensor([[8, 18, 16, 0, 1]], dtype=torch.int32)
    s1 = torch.tensor([[12, 27, 22, 0, 1]], dtype=torch.int32)
    img = centroid_size_from_stats({"area": area, "sum-0-lo": s0,
                                    "sum-1-lo": s1}, (4, 5), 5)
    assert img[0, 2, 3] == 7 and img[0, 0, 0] == 5
    assert int((img > 0).sum()) == 2


# ------------------------------------------------------------ engines --
def _jax_engine(cls, ckpt, **kw):
    from unetdc_tpu.checkpoint import (load_pth_state_dict,
                                       torch_state_dict_to_variables)

    eng = cls(torch_state_dict_to_variables(load_pth_state_dict(ckpt)),
              compute_dtype=jnp.float32, **kw)
    eng.img_size = IMG_SIZE
    return eng


def _port_engine(cls, ckpt, **kw):
    from unetdc_tpu_torch.pipelines.engine import load_state_dict

    eng = cls(load_state_dict(ckpt), compute_dtype=torch.float32,
              device="cpu", **kw)
    eng.img_size = IMG_SIZE
    return eng


BI_KW = dict(kernel_size=15, nb_layers=3, contour_thresh=60,
             contour_min_size=20)
RUN_KW = dict(prob_thresh=0.3, min_area=1, background_radius=20)


@pytest.fixture(scope="module")
def v1_runs(ckpt, imgs):
    from unetdc_tpu.pipelines import heatmaps as JH
    from unetdc_tpu_torch.pipelines import heatmaps as PH

    ref = _jax_engine(JH.HeatmapV1Engine, ckpt).run_batch(
        imgs, imgs.shape[1:3], **RUN_KW)
    eng = _port_engine(PH.HeatmapV1Engine, ckpt)
    return ref, eng.run_batch(imgs, imgs.shape[1:3], **RUN_KW), eng


@pytest.fixture(scope="module")
def bi_runs(ckpt, imgs):
    from unetdc_tpu.pipelines import heatmaps as JH
    from unetdc_tpu_torch.pipelines import heatmaps as PH

    ref = _jax_engine(JH.BlobInspectorEngine, ckpt, **BI_KW).run_batch(
        imgs, imgs.shape[1:3], **RUN_KW)
    eng = _port_engine(PH.BlobInspectorEngine, ckpt, **BI_KW)
    return ref, eng.run_batch(imgs, imgs.shape[1:3], **RUN_KW), eng


def test_heatmap_v1_engine_matches_jax(v1_runs):
    ref, got, _ = v1_runs
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    for k in ("count", "total", "area", "sum-0-lo", "sum-1-lo"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["radial_u8"], ref["radial_u8"])
    assert ref["radial_u8"].any()
    diff = np.abs(got["spatial_u8"].astype(int) - ref["spatial_u8"])
    assert diff.max() <= 1
    assert not any(k.startswith("all_") for k in got)


def test_blobinspector_engine_matches_jax(bi_runs):
    ref, got, _ = bi_runs
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    h, w = got["mask"].shape[1:]
    roi = np.unpackbits(ref["roi_bits"], axis=-1)[:, :h * w].reshape(-1, h, w)
    np.testing.assert_array_equal(got["roi"], roi)
    assert roi.any() and not roi.all()
    for k in ("target_pct", "conv_pct"):
        assert got[k].dtype == np.float16
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ref["target_pct"].any() and ref["conv_pct"].any()


@pytest.mark.parametrize("which", ["v1", "blobinspector"])
def test_grayscale_upload_equals_rgb(which, ckpt, v1_runs, bi_runs):
    """A channel-equal batch uploaded as (B,H,W) (what the batch pipeline
    sends) gives the outputs of its (B,H,W,3) form."""
    _, _, eng = v1_runs if which == "v1" else bi_runs
    g = _gray_images(8, n=2, h=96, w=112)
    g[:, 30:60, 40:80] = 255
    a = eng.run_batch(np.repeat(g[..., None], 3, -1), (96, 112), **RUN_KW)
    b = eng.run_batch(g, (96, 112), **RUN_KW)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------- pipelines, CLIs --
def test_heatmap_pipelines_write_artifacts(ckpt, image_dir, tmp_path):
    from unetdc_tpu_torch.pipelines import heatmaps as PH
    from unetdc_tpu_torch.pipelines.quantify_batch import list_images

    pytest.importorskip("matplotlib")
    o1, o2 = tmp_path / "o1", tmp_path / "o2"
    pipe = PH.HeatmapV1Pipeline(_port_engine(PH.HeatmapV1Engine, ckpt),
                                str(o1), batch=2, background_radius=20)
    pipe.run(image_dir, progress=False)
    pipe.write_reports(skip_histogram=True)
    PH.BlobInspectorPipeline(
        _port_engine(PH.BlobInspectorEngine, ckpt, **BI_KW), str(o2),
        batch=2, px_per_micron=3.45, background_radius=20,
        save_overlays=True).run(image_dir, progress=False)
    assert (o1 / "summary_per_image.csv").exists()
    assert (o1 / "all_droplets.csv").exists()
    for p in list_images(image_dir):
        assert (o1 / "predicted_masks" / f"{p.stem}_pred.png").exists()
        assert (o1 / f"{p.stem}_droplets.csv").exists()
        for kind in ("radial", "spatial"):
            assert (o1 / f"{p.stem}_{kind}_density.png").exists()
        md = o2 / "predicted_masks"
        for suffix in ("_pred", "_mask_contour_debug",
                       "_target_density_heatmap_percentage",
                       "_convoluted_density_heatmap_percentage"):
            assert (md / f"{p.stem}{suffix}.png").exists(), suffix
        assert (o2 / f"{p.stem}_droplets.csv").exists()
        assert (o2 / "overlays" / f"{p.stem}_overlay.png").exists()


def test_heatmap_png_writer_names_matplotlib(monkeypatch):
    import builtins

    from unetdc_tpu_torch.pipelines import heatmaps as PH

    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(RuntimeError, match="matplotlib"):
        PH.save_heatmap(np.zeros((2, 2)), "x.png", "hot", 0, 1)


@pytest.mark.parametrize("cli", ["quantify_pipline", "quantify"])
def test_heatmap_clis_run_on_cpu(cli, image_dir, tmp_path):
    import importlib

    pytest.importorskip("matplotlib")
    mod = importlib.import_module(f"unetdc_tpu_torch.cli.{cli}")
    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=3, img_size=32)
    out = tmp_path / "out"
    argv = ["--img_dir", image_dir, "--ckpt_path", str(ckpt), "--out_dir",
            str(out), "--batch", "2", "--device", "cpu", "--precision",
            "f32", "--px_per_micron", "2.0"]
    pipe = mod.main(argv)
    assert pipe.engine.device.type == "cpu"
    assert (out / "img00_droplets.csv").exists()
    if cli == "quantify_pipline":
        assert (out / "img01_radial_density.png").exists()
        assert (out / "summary_per_image.csv").exists()
    else:
        assert (out / "predicted_masks"
                / "img01_convoluted_density_heatmap_percentage.png").exists()
