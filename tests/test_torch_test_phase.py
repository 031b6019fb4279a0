"""The port's test-phase pieces against the JAX package's, on the CPU:
true-nearest and float-bilinear uint8 resizes, difference maps, overlays
and color-region counts, and the summary table."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unetdc_tpu.ops import diffmap as JDM
from unetdc_tpu.ops import resize as JR
from unetdc_tpu_torch.ops import diffmap as TDM
from unetdc_tpu_torch.ops import resize as TR


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side, and full-width models on all cores in each oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("src,dst", [((32, 32), (40, 48)), ((40, 48),
                                                            (32, 32)),
                                     ((512, 512), (600, 800))])
def test_resize_nearest_exact(src, dst):
    a = (np.random.RandomState(0).rand(*src) * 255).astype(np.uint8)
    ref = np.asarray(JR.resize_nearest(jnp.asarray(a), dst))
    np.testing.assert_array_equal(TR.resize_nearest(torch.from_numpy(a),
                                                    dst).numpy(), ref)
    rgb = np.stack([a, a // 2, 255 - a], -1)
    ref3 = np.asarray(JR.resize_nearest(jnp.asarray(rgb), dst))
    got3 = TR.resize_nearest(torch.from_numpy(rgb), dst, dims=(0, 1))
    np.testing.assert_array_equal(got3.numpy(), ref3)


@pytest.mark.parametrize("src,dst", [((32, 32), (40, 48)), ((64, 64),
                                                            (600, 800))])
def test_resize_linear_u8_matches_jax(src, dst):
    """Both round floor(v + 0.5) after f32 products; the two libraries'
    products may round a value on a .5 tie differently, so at most 1 apart
    and on at most 1% of the pixels."""
    a = (np.random.RandomState(1).rand(*src, 3) * 255).astype(np.uint8)
    ref = np.asarray(JR.resize_linear_u8(jnp.asarray(a), dst)).astype(int)
    got = TR.resize_linear_u8(torch.from_numpy(a), dst).numpy().astype(int)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1
    assert np.mean(got != ref) <= 0.01


def test_diffmap_overlay_and_counts_exact():
    r = np.random.RandomState(2)
    t = (r.rand(40, 50) > 0.5).astype(np.uint8)
    p = (r.rand(40, 50) > 0.5).astype(np.uint8)
    ref = np.asarray(JDM.create_difference_map(jnp.asarray(t),
                                               jnp.asarray(p)))
    got = TDM.create_difference_map(torch.from_numpy(t), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), ref)
    img = (r.rand(40, 50, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        TDM.overlay_difference(torch.from_numpy(img), got).numpy(),
        np.asarray(JDM.overlay_difference(jnp.asarray(img),
                                          jnp.asarray(ref))))
    assert TDM.count_color_regions(got) == \
        JDM.count_color_regions(jnp.asarray(ref))


def test_model_summary_matches_jax():
    from unetdc_tpu.models.unet import UNetDC as J, init_params
    from unetdc_tpu.utils.summary import model_summary as jsum
    from unetdc_tpu_torch.models.unet import UNetDC
    from unetdc_tpu_torch.utils.summary import model_summary

    m = J(apply_sigmoid=False)
    ref = jsum(m, init_params(m, input_shape=(1, 64, 64, 3)), (1, 64, 64, 3))
    assert model_summary(UNetDC(apply_sigmoid=False), (1, 64, 64, 3)) == ref
