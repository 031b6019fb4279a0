"""Preprocessing ops of the port against the JAX package, uint8-equal:
the cv2 ellipse footprint, the rolling-ball correction at radius 10 and 50,
and the cv2-exact uint8 resize at several sizes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unetdc_tpu.ops import morphology as JM
from unetdc_tpu.ops.resize import resize_linear_u8_cv2exact as j_resize
from unetdc_tpu.ops.rolling_ball import rolling_ball_correction_rgb as j_rb
from unetdc_tpu_torch.ops import morphology as TM
from unetdc_tpu_torch.ops.resize import resize_linear_u8_cv2exact
from unetdc_tpu_torch.ops.rolling_ball import (normalize_minmax_u8,
                                               rolling_ball_correction_rgb)


@pytest.mark.parametrize("ksize", [1, 2, 3, 10, 11, 20, 50])
def test_ellipse_kernel_matches_jax(ksize):
    np.testing.assert_array_equal(TM.ellipse_kernel(ksize),
                                  JM.ellipse_kernel(ksize))


def test_erode_dilate_match_jax():
    img = (np.random.RandomState(1).rand(30, 41) * 255).astype(np.uint8)
    k = JM.ellipse_kernel(8)
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(TM.erode(t, k).numpy(),
                                  np.asarray(JM.erode(jnp.asarray(img), k)))
    np.testing.assert_array_equal(TM.dilate(t, k).numpy(),
                                  np.asarray(JM.dilate(jnp.asarray(img), k)))


@pytest.mark.parametrize("radius,shape", [(10, (70, 90, 3)),
                                          (50, (48, 60, 1))])
def test_rolling_ball_matches_jax(radius, shape):
    """Radius 50 runs one channel: the JAX reference unrolls ~100 shifted
    mins per channel and compiles for tens of seconds on the CPU."""
    r = np.random.RandomState(radius)
    h, w, c = shape
    img = (r.rand(h, w, c) * 120).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    img[(yy - h // 2) ** 2 + (xx - w // 3) ** 2 < 80] += 100
    if c == 3:
        img[..., 2] = img[..., 1]  # one channel pair equal, one not
    ref = np.asarray(j_rb(jnp.asarray(img), radius))
    got = rolling_ball_correction_rgb(torch.from_numpy(img), radius).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    # batched (B, H, W, C) equals per-image
    both = rolling_ball_correction_rgb(
        torch.from_numpy(np.stack([img, img[::-1].copy()])), radius).numpy()
    np.testing.assert_array_equal(both[0], ref)


def test_normalize_constant_image():
    z = torch.full((1, 5, 6), 7, dtype=torch.uint8)
    assert int(normalize_minmax_u8(z).max()) == 0


@pytest.mark.parametrize("src,dst", [((600, 800), (512, 512)),
                                     ((96, 112), (64, 64)),
                                     ((512, 512), (600, 800)),
                                     ((64, 64), (96, 112)),
                                     ((37, 53), (128, 19)),
                                     ((50, 50), (50, 50))])
def test_resize_matches_jax(src, dst):
    r = np.random.RandomState(sum(src) + sum(dst))
    img = (r.rand(*src) * 255).astype(np.uint8)
    mask = (r.rand(*src) > 0.6).astype(np.uint8)
    for a in (img, mask):
        ref = np.asarray(j_resize(jnp.asarray(a), dst))
        got = resize_linear_u8_cv2exact(torch.from_numpy(a), dst).numpy()
        np.testing.assert_array_equal(got, ref)
    # leading batch dims resize plane by plane
    b = resize_linear_u8_cv2exact(torch.from_numpy(np.stack([img, img])), dst)
    np.testing.assert_array_equal(b[1].numpy(),
                                  np.asarray(j_resize(jnp.asarray(img), dst)))


def test_footprint_table_is_the_footprint_rows():
    """The table the wrapper hands the CUDA kernel holds exactly the rows
    of the plain version's footprint, in nested order (each run covers the
    one before it), with their reach, at every ksize 1..120."""
    from unetdc_tpu_torch.ops.rolling_ball import footprint_table

    for k in range(1, 121):
        t, (dy_min, dy_max, left, right) = footprint_table(k)
        a = k // 2
        rows = sorted((int(dy) + a, a - int(lo), a + int(hi) + 1)
                      for dy, lo, hi in t)
        assert rows == TM._footprint_rows(TM.ellipse_kernel(k))
        assert (np.diff(t[:, 1]) >= 0).all() and (np.diff(t[:, 2]) >= 0).all()
        assert (dy_min, dy_max, left, right) == (
            t[:, 0].min(), t[:, 0].max(), t[:, 1].max(), t[:, 2].max())


@pytest.mark.parametrize("ksize", [1, 2, 50, 51, 100, 1000, 16384])
def test_kernel_tile_fits(ksize):
    """The ring holds every output row a footprint spans, and the tile
    fits a block's shared memory."""
    from unetdc_tpu_torch.ops import rolling_ball as RB

    table, (dy_min, dy_max, left, right) = RB.footprint_table(ksize)
    ring, tw, rb = RB.kernel_tile(ksize)
    assert ring & (ring - 1) == 0 and ring >= dy_max - dy_min + 1 == ksize
    assert tw in (4, 8, 16, 32, 64, 128, 256) and rb >= 1
    assert RB._smem_bytes(len(table), ring, tw, left, right) \
        <= RB._SMEM_BYTES


def test_kernel_tile_refuses_what_does_not_fit():
    from unetdc_tpu_torch.ops.rolling_ball import MAX_KSIZE, kernel_tile

    with pytest.raises(ValueError, match=f"ksize <= {MAX_KSIZE}"):
        kernel_tile(MAX_KSIZE + 1)


def test_rolling_ball_on_the_cpu_is_the_plain_version():
    """A CPU tensor takes the plain chain (still held to JAX above): equal
    results, no kernel launch counted, no `rolling_ball.kernel` record."""
    from unetdc_tpu_torch.ops import cuda_build as cb
    from unetdc_tpu_torch.ops import rolling_ball as RB
    from unetdc_tpu_torch.utils import profiling

    r = np.random.RandomState(5)
    x = torch.from_numpy((r.rand(2, 3, 30, 41) * 255).astype(np.uint8))
    before = cb.LAUNCHES["rolling_ball"]
    profiling.reset_trace()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        got = RB.rolling_ball_correction(x.permute(0, 1, 3, 2), 9)
        assert not profiling.counts("rolling_ball.kernel")
    assert torch.equal(got, RB.rolling_ball_correction_plain(
        x.permute(0, 1, 3, 2), 9))
    assert cb.LAUNCHES["rolling_ball"] == before


def test_normalize_scale_is_reciprocal_times_255():
    """The plain version's scale is PyTorch's 255 / span, which is
    reciprocal(span) * 255 (two roundings), not one correctly rounded
    division: the CUDA kernel repeats that order. Checked at every span a
    uint8 plane can have, on every value."""
    for span in range(1, 256):
        x = torch.arange(span + 1, dtype=torch.uint8).view(1, 1, -1)
        scale = (np.float32(1) / np.float32(span)) * np.float32(255)
        want = np.clip(np.rint(np.arange(span + 1, dtype=np.float32)
                               * scale), 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(normalize_minmax_u8(x)[0, 0].numpy(),
                                      want)
    # one correctly rounded division would give other pixels
    s = np.arange(1, 256, dtype=np.float32)
    assert ((np.float32(1) / s) * np.float32(255) != np.float32(255) / s).any()
