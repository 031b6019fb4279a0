"""The port's `quantify_mask_batch` against the JAX package's, exact: both
connectivities, empty masks, a mask with more than 4096 components, and
the split-plan output contracts ('sum-N-lo'/'-hi' with several chunks, and
'-lo16'/'-hi16') of tests/test_large_images.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import ndimage as ndi

from unetdc_tpu.ops.connected_components import (
    _coord_plan as j_plan, quantify_mask_batch as j_quantify)
from unetdc_tpu_torch.ops.connected_components import (
    _coord_plan, _out_base_bits, label_batch, quantify_mask_batch)


def _compare(masks, min_area, max_labels, connectivity):
    ref = jax.tree_util.tree_map(np.asarray, j_quantify(
        jnp.asarray(masks), jnp.int32(min_area), max_labels,
        connectivity=connectivity, impl="scatter"))
    got = {k: v.numpy() for k, v in quantify_mask_batch(
        torch.from_numpy(masks), min_area, max_labels,
        connectivity=connectivity).items()}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    return got


@pytest.mark.parametrize("connectivity", [1, 2])
def test_quantify_matches_jax(connectivity):
    r = np.random.RandomState(connectivity)
    masks = np.stack([(r.rand(60, 84) > 0.72).astype(np.uint8),
                      np.zeros((60, 84), np.uint8),
                      (r.rand(60, 84) > 0.4).astype(np.uint8)])
    for min_area in (1, 3):
        got = _compare(masks, min_area, 256, connectivity)
    assert got["count"][1] == 0 and got["total"][1] == 0


@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_batch_matches_scipy(connectivity):
    r = np.random.RandomState(10 + connectivity)
    m = (r.rand(3, 41, 57) < 0.55).astype(np.uint8)
    struct = (ndi.generate_binary_structure(2, 1) if connectivity == 1
              else np.ones((3, 3)))
    lab, n = label_batch(torch.from_numpy(m), connectivity)
    for b in range(3):
        ref, n_ref = ndi.label(m[b], structure=struct)
        assert int(n[b]) == n_ref
        np.testing.assert_array_equal(lab[b].numpy(), ref)


def test_quantify_more_than_4096_components():
    m = np.zeros((1, 140, 140), np.uint8)
    m[0, ::2, ::2] = 1  # 4900 single-pixel components
    m[0, 60:70, 60:80] = 1
    got = _compare(m, 1, 8192, 1)
    assert int(got["total"][0]) > 4096
    _compare(m, 2, 8192, 1)  # the sieve keeps only the block


def test_quantify_split_plan_base256():
    """2 x 40000: a 3-chunk split plan with byte limbs (sum-N-lo/hi)."""
    h, w = 2, 40000
    shifts, bits = _coord_plan(h, w)
    assert (shifts, bits) == j_plan(h, w) and _out_base_bits(h, w) == 8
    r = np.random.RandomState(5)
    m = (r.rand(1, h, w) < 0.45).astype(np.uint8)
    m[0, :, w // 2:w // 2 + 8000] = 1
    got = _compare(m, 2, 2 ** 14, 1)
    assert "sum-1-hi" in got


def test_quantify_lo16_contract():
    """1 x 2^20: base-65536 output limbs (sum-N-lo16/hi16)."""
    w = 2 ** 20
    r = np.random.RandomState(3)
    m = np.zeros((1, 1, w), np.uint8)
    for _ in range(40):
        a = r.randint(0, w - 20000)
        m[0, 0, a:a + r.randint(100, 20000)] = 1
    got = _compare(m, 1, 128, 1)
    assert "sum-1-lo16" in got and "sum-0-lo" not in got
