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
