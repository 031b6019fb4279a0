"""The port's library surface (`unetdc_tpu_torch/library.py`) and the ops
behind it (single-image components, regionprops, float resizes, bit
depth and rolling ball) against the JAX package's on the same seeded
inputs, on the CPU (`device="cpu"`).

Integer outputs, labels, masks and lists are held to equality, and so is
the rolling ball (min/max of the same float32 sums in any grouping). The
float resizes are held at 1 ulp of their range (rtol 0, atol 2e-7 on
[0, 1] data: a library product may order the two nonzero terms of each
output otherwise than XLA's dot), the float regionprops columns and the
density maps at rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from tests.torch_reference import make_decisive_checkpoint
from unetdc_tpu import library as JL
from unetdc_tpu.ops import connected_components as JC
from unetdc_tpu.ops import regionprops as JR
from unetdc_tpu.ops import resize as JZ
from unetdc_tpu_torch import library as TL
from unetdc_tpu_torch.ops import bitdepth as TBD
from unetdc_tpu_torch.ops import connected_components as TC
from unetdc_tpu_torch.ops import regionprops as TR
from unetdc_tpu_torch.ops import resize as TZ

CPU = dict(device="cpu")


def _blobs(seed, shape=(48, 64), n=10):
    r = np.random.RandomState(seed)
    m = np.zeros(shape, bool)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for _ in range(n):
        m |= (yy - r.randint(0, shape[0])) ** 2 + \
            (xx - r.randint(0, shape[1])) ** 2 <= r.randint(2, 40)
    return m


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq_dict(ours, jx):
    assert sorted(ours) == sorted(jx)
    for k in jx:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(jx[k]),
                                      err_msg=k)


# ------------------------------------------------- connected components --
@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_label_roots_sieve_equal_jax(seed, conn):
    m = np.random.RandomState(seed).rand(40, 52) > 0.55
    tl, tn = TC.label(_t(m), conn)
    jl, jn = JC.label(jnp.asarray(m), conn)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tn) == int(jn) and tl.dtype == torch.int32
    np.testing.assert_array_equal(TC.propagate_roots(_t(m), conn).numpy(),
                                  np.asarray(JC.propagate_roots(
                                      jnp.asarray(m), conn)))
    for min_area, nseg in [(3, 1024), (1, int(jn) + 1), (5, 16)]:
        ts, tm = TC.sieve_small_components(tl, min_area, nseg)
        js, jm = JC.sieve_small_components(jl, min_area, nseg)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert int(tm) == int(jm)


@pytest.mark.parametrize("shape,conn,cap", [((40, 52), 1, 64),
                                            ((40, 52), 2, 8),
                                            ((1400, 3), 1, 32)])
def test_quantify_mask_equal_jax(shape, conn, cap):
    """The scatter path's tables, including split coordinate sums (a
    1400-row image exceeds the single-int32 bound) and a cap below the
    component count (the table is cut; 'total' says so)."""
    m = np.random.RandomState(3).rand(*shape) > 0.6
    _eq_dict(TC.quantify_mask(_t(m), 2, cap, conn),
             JC.quantify_mask(jnp.asarray(m), jnp.asarray(2), cap, conn))


def test_quantify_mask_adaptive_equal_jax():
    """More components than the starting cap: the cap doubles until it
    holds them all, as in JAX."""
    m = np.zeros((66, 66), bool)
    m[::2, ::2] = True                      # 1089 isolated pixels
    ours = TC.quantify_mask_adaptive(_t(m), 1, max_labels=256)
    jx = JC.quantify_mask_adaptive(jnp.asarray(m), 1, max_labels=256)
    _eq_dict(ours, jx)
    assert int(ours["count"]) == 1089 and ours["area"].shape == (2048,)


# ----------------------------------------------------------- regionprops --
def test_regionprops_equal_jax():
    lab = ndi.label(_blobs(5))[0].astype(np.int32)
    for cap in (int(lab.max()), 4):         # 4: labels above the cap drop
        ours = TR.regionprops_table(_t(lab), cap)
        jx = JR.regionprops_table(jnp.asarray(lab), cap)
        assert sorted(ours) == sorted(jx)
        for k in ("label", "area", "sum-0", "sum-1"):
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(jx[k]))
        for k in ("equivalent_diameter", "centroid-0", "centroid-1"):
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(jx[k]),
                                       rtol=1e-6, atol=0)
        np.testing.assert_array_equal(
            TR.centroid_size_image(_t(lab), cap).numpy(),
            np.asarray(JR.centroid_size_image(jnp.asarray(lab), cap)))
    with pytest.raises(ValueError, match="exact-int32 coordinate-sum"):
        TR.regionprops_table(torch.zeros(1300, 1300, dtype=torch.int32), 4)


def test_centroid_size_image_shared_pixel_takes_higher_label():
    """A ring and the dot at its centre have one centroid pixel: the
    higher label's area is written there, as JAX's in-order scatter
    does."""
    lab = np.zeros((21, 21), np.int32)
    yy, xx = np.mgrid[:21, :21]
    ring = ((yy - 10) ** 2 + (xx - 10) ** 2 <= 64) & \
        ((yy - 10) ** 2 + (xx - 10) ** 2 >= 36)
    lab[ring] = 2
    lab[10, 10] = 1
    ours = TR.centroid_size_image(_t(lab), 4).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(JR.centroid_size_image(jnp.asarray(lab), 4)))
    assert ours[10, 10] == ring.sum()


# ---------------------------------------------------------------- resize --
@pytest.mark.parametrize("src,dst", [((37, 53), (512, 512)),
                                     ((600, 800), (48, 64)),
                                     ((50, 40, 3), (24, 70))])
def test_float_resizes_equal_jax(src, dst):
    img = np.random.RandomState(sum(src)).rand(*src).astype(np.float32)
    for t_fn, j_fn in ((TZ.resize_linear, JZ.resize_linear),
                       (TZ.resize_area, JZ.resize_area)):
        np.testing.assert_allclose(t_fn(_t(img), dst).numpy(),
                                   np.asarray(j_fn(jnp.asarray(img), dst)),
                                   rtol=0, atol=2e-7)
    np.testing.assert_array_equal(TZ._area_weights(src[0], dst[0]),
                                  JZ._area_weights(src[0], dst[0]))
    mask = (img[..., 0] if img.ndim == 3 else img) > 0.5
    np.testing.assert_array_equal(
        TZ.resize_mask_linear_round(_t(mask), dst).numpy(),
        np.asarray(JZ.resize_mask_linear_round(jnp.asarray(mask), dst)))


# --------------------------------------------------- bit depth, rolling ball
def test_convert_to_8_bits_equal_jax(rng):
    rgba = (rng.rand(10, 12, 4) * 255).astype(np.uint8)
    cases = [(rng.rand(10, 12, 3) * 255).astype(np.uint8),
             (rng.rand(10, 12) * 120).astype(np.uint8),
             rgba, rgba.astype(np.float32) / 255.0,
             np.zeros((4, 5), np.uint8)]
    for img in cases:
        out = TL.convert_to_8_bits(img)
        np.testing.assert_array_equal(out, JL.convert_to_8_bits(img))
        assert out.dtype == np.uint8 and out.shape == img.shape[:2]


@pytest.mark.parametrize("shape,radius", [((24, 24), 4), ((96, 96), 50),
                                          ((30, 41), 12)])
def test_rolling_ball_equal_jax(shape, radius):
    img = (np.random.RandomState(radius).rand(*shape) * 255
           ).astype(np.float32)
    tb, tc = TL.rolling_ball(img, radius, **CPU)
    jb, jc = JL.rolling_ball(img, radius)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tc, jc)
    assert tb.dtype == np.float32


def test_rolling_ball_batched_and_chunked(monkeypatch):
    """Leading dims are images; a small tap chunk gives the same bits."""
    imgs = torch.from_numpy((np.random.RandomState(2).rand(3, 20, 26) * 255
                             ).astype(np.float32))
    bg, corr = TBD.rolling_ball_skimage(imgs, 7)
    monkeypatch.setattr(TBD, "_CHUNK_ELEMS", 1)
    for i in range(3):
        b1, c1 = TBD.rolling_ball_skimage(imgs[i], 7)
        assert torch.equal(b1, bg[i]) and torch.equal(c1, corr[i])


# --------------------------------------------------------- library glue --
def test_dots_labels_and_thresholds_equal_jax(rng):
    m = rng.rand(24, 24) > 0.6
    dots = TL.binary_to_dots(m)
    assert dots == JL.binary_to_dots(m)
    np.testing.assert_array_equal(TL.dots_to_binary(m, dots), m)
    assert TL.labeling_custom(m, dots, **CPU) == JL.labeling_custom(m, dots)
    assert TL.labeling_custom(m, [], **CPU) == []
    img = (rng.rand(32, 32) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        TL.segmentation_two_thresholds(img, 200, 100, **CPU),
        JL.segmentation_two_thresholds(img, 200, 100))


def _random_dots_labels(rng, n, k):
    labels = [int(v) for v in rng.randint(1, k + 1, n)]
    remap = {lab: i + 1 for i, lab in enumerate(sorted(set(labels)))}
    labels = [remap[lab] for lab in labels]
    dots = [[int(y), int(x)] for y, x in rng.randint(0, 64, (n, 2))]
    return dots, labels


@pytest.mark.parametrize("n,k,sieve", [(0, 1, 0), (40, 5, 2), (300, 40, 4),
                                       (1000, 200, 1)])
def test_list_glue_equal_jax(rng, n, k, sieve):
    """sieve_labels, the size family (last label dropped) and the centroid
    family give JAX's values (the reference's quirks included)."""
    dots, labels = _random_dots_labels(rng, n, k)
    assert TL.sieve_labels(dots, labels, sieve) == \
        JL.sieve_labels(dots, labels, sieve)
    for fn in ("mean_SD_size", "mean_median_size",
               "mean_median_min_max_size"):
        assert getattr(TL, fn)(labels) == getattr(JL, fn)(labels), fn
    for fn in ("calculate_centroids_sizes", "calculate_centroids"):
        np.testing.assert_array_equal(getattr(TL, fn)(dots, labels),
                                      getattr(JL, fn)(dots, labels))
    img = np.zeros((64, 64))
    np.testing.assert_array_equal(
        TL.calculate_centroids_sizes_image(dots, labels, img),
        JL.calculate_centroids_sizes_image(dots, labels, img))
    tc, td = TL.calculate_blobs_centroids_and_DTOC(dots, labels, 3.0, 5.0)
    jc, jd = JL.calculate_blobs_centroids_and_DTOC(dots, labels, 3.0, 5.0)
    np.testing.assert_array_equal(tc, jc)
    assert td == jd


def test_helpers_and_lists_equal_jax():
    for p in ("/a/b/c.png", "c.png", "C:\\x\\y.tif", "noext"):
        for fn in ("get_filename", "get_folder",
                   "get_filename_without_extension"):
            assert getattr(TL, fn)(p) == getattr(JL, fn)(p)
    for s in ("3.4", "x", "1e3", ""):
        assert TL.is_float(s) == JL.is_float(s)
    for fn in ("return_blobs_algorithms", "return_labeling_algorithms",
               "return_colormaps", "return_colors_dictionnary",
               "return_contouring_algorithms"):
        assert getattr(TL, fn)() == getattr(JL, fn)()


@pytest.mark.parametrize("fn", ["contour_scan", "contour_spreading_4",
                                "contour_spreading_8",
                                "contour_shrinking_box"])
def test_contours_equal_jax(fn):
    r = np.random.RandomState(8)
    img = (ndi.gaussian_filter(r.rand(40, 50), 3) * 255).astype(np.float32)
    img[18:24, 20:30] = 255
    th = float(np.percentile(img, 60))
    ours = getattr(TL, fn)(img, th, **CPU)
    np.testing.assert_array_equal(ours, getattr(JL, fn)(img, th))
    assert ours.any() and not ours.all()


def test_remove_objects_and_centroid_equal_jax():
    """remove_objects, also with more 8-connected components than the
    starting cap of 4096 (the cap doubles), and the contour centroid."""
    m = _blobs(9, (60, 80), n=25)
    for min_size in (1, 30):
        np.testing.assert_array_equal(TL.remove_objects(m, min_size, **CPU),
                                      JL.remove_objects(m, min_size))
    dense = np.zeros((132, 132), bool)
    dense[::2, ::2] = True                  # 4356 isolated pixels
    dense[:6, :6] = True
    ours = TL.remove_objects(dense, 2, **CPU)
    np.testing.assert_array_equal(ours, JL.remove_objects(dense, 2))
    assert ours.sum() == 36 + 7           # the block and its 7 touching dots
    assert TL.calculate_contours_centroid(m, **CPU) == \
        JL.calculate_contours_centroid(m)


def test_density_helpers_equal_jax():
    r = np.random.RandomState(12)
    contour = _blobs(12, (48, 64), n=4) | (np.arange(64) > 20)[None]
    thresh = (r.rand(48, 64) > 0.7) & contour
    csi = np.zeros((48, 64), np.float32)
    csi[r.randint(0, 48, 9), r.randint(0, 64, 9)] = r.randint(1, 40, 9)
    cy, cx = TL.calculate_contours_centroid(contour, **CPU)
    np.testing.assert_allclose(
        TL.get_target(thresh, contour, 4, cy, cx, **CPU),
        JL.get_target(thresh, contour, 4, cy, cx), rtol=1e-6)
    for a, b in zip(TL.get_targets(thresh, contour, csi, 3, cy, cx, **CPU),
                    JL.get_targets(thresh, contour, csi, 3, cy, cx)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(TL.density_map(thresh, contour, 9, **CPU),
                               JL.density_map(thresh, contour, 9), rtol=1e-6)
    maps = TL.density_maps(thresh, contour, csi, 9, **CPU)
    for a, b in zip(maps, JL.density_maps(thresh, contour, csi, 9)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert TL.min_max_mean_SD_density(maps[0], contour) == \
        JL.min_max_mean_SD_density(maps[0], contour)
    assert TL.min_max_mean_median_density(maps[0], contour) == \
        JL.min_max_mean_median_density(maps[0], contour)


# ----------------------------------------------- segmentation_deep_learning
@pytest.fixture(scope="module")
def decisive_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("lib") / "decisive.pth"
    make_decisive_checkpoint(str(path), seed=3, img_size=64)
    yield str(path)


def test_segmentation_deep_learning_equals_jax_f32(decisive_ckpt):
    """The f32 engines of both packages (JAX's fast=False forward has no
    flipped upconv) behind each library's cache: equal masks, for a
    grayscale and an RGB image."""
    from unetdc_tpu.pipelines.engine import load_engine as j_load
    from unetdc_tpu_torch.pipelines.engine import load_engine as t_load

    JL._MODEL_CACHE[decisive_ckpt] = j_load(decisive_ckpt, fast=False)
    TL._MODEL_CACHE[(decisive_ckpt, "cpu")] = t_load(
        decisive_ckpt, fast=False, device="cpu")
    try:
        r = np.random.RandomState(4)
        gray = (r.rand(40, 56) * 255).astype(np.uint8)
        rgb = (r.rand(30, 36, 3) * 255).astype(np.uint8)
        for img in (gray, rgb):
            ours = TL.segmentation_deep_learning(img, decisive_ckpt, **CPU)
            jx = JL.segmentation_deep_learning(img, decisive_ckpt)
            np.testing.assert_array_equal(ours, jx)
            assert 0 < (ours > 0).mean() < 1
    finally:
        JL._MODEL_CACHE.pop(decisive_ckpt, None)
        TL._MODEL_CACHE.pop((decisive_ckpt, "cpu"), None)


def test_segmentation_deep_learning_default_path(decisive_ckpt):
    """The port's own engine (bf16, cached by checkpoint and device):
    a 0/255 uint8 mask of the image's size."""
    img = (np.random.RandomState(5).rand(33, 47) * 255).astype(np.uint8)
    try:
        out = TL.segmentation_deep_learning(img, decisive_ckpt, **CPU)
        assert out.shape == (33, 47) and out.dtype == np.uint8
        assert set(np.unique(out)) <= {0, 255}
        eng = TL._MODEL_CACHE[(decisive_ckpt, "cpu")]
        assert eng.compute_dtype == torch.bfloat16
    finally:
        TL._MODEL_CACHE.pop((decisive_ckpt, "cpu"), None)
