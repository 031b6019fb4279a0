"""Plain versions of the fused conv kernels (K1, K2) against the JAX
package's Pallas kernels in interpret mode, at the tolerances of
tests/test_pallas_conv.py: K1 atol 2e-5 / rtol 1e-5, the f32 head
atol 3e-6 / rtol 1e-5, bf16 |dprob| < 0.05 (the whole f32 forward: see
its test). The CUDA kernels themselves are
held to these plain versions on the card (test_torch_kernels_cuda.py,
chip_smoke.py).

The JAX fast path applies upconv4..2 flipped (`lax.conv_transpose`; ROADMAP
queue C), so the whole-forward tests give it the kernels flipped back
(`_flip_up`, as tests/test_torch_int8.py does), on weights where the flip
moves the output by far more than the tolerance (asserted)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unetdc_tpu.models import unet_fast as JF
from unetdc_tpu.models.unet import UNetDC, fold_batchnorm
from unetdc_tpu.ops.pallas_conv import pair_conv_pool, pair_mid_side
from unetdc_tpu_torch.checkpoint import variables_to_state_dict
from unetdc_tpu_torch.models import unet as TU
from unetdc_tpu_torch.models.unet_fast import build_fast_params, forward_folded
from unetdc_tpu_torch.ops import fused_conv as fc


@pytest.fixture(scope="module")
def variables():
    v = UNetDC().init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)),
                      train=False)
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module")
def decisive(tmp_path_factory):
    """Variables of a decisive checkpoint (logits centred and scaled by
    300): here the upconv flip moves the probabilities by ~0.06, against
    ~5e-6 with the init of `variables`."""
    from tests.torch_reference import make_decisive_checkpoint
    from unetdc_tpu.checkpoint import (load_pth_state_dict,
                                       torch_state_dict_to_variables)

    path = tmp_path_factory.mktemp("decisive") / "m.pth"
    make_decisive_checkpoint(str(path), seed=2, img_size=64)
    return torch_state_dict_to_variables(load_pth_state_dict(str(path)))


def _jax_fp(v, dtype):
    fp = JF.build_fast_params(fold_batchnorm(v)["params"], dtype=dtype)
    fp["_pa"] = JF.build_pallas_head_params(fold_batchnorm(v)["params"],
                                            dtype=dtype)
    return fp


def _flip_up(fp):
    """Copy of JAX fast params with the upconv4..2 kernels flipped back."""
    fp = dict(fp)
    for n in (4, 3, 2):
        fp[f"upconv{n}"] = dict(fp[f"upconv{n}"],
                                k=fp[f"upconv{n}"]["k"][::-1, ::-1])
    return fp


def _port_fp(v, dtype):
    return build_fast_params(TU.fold_batchnorm(variables_to_state_dict(v)),
                             dtype)


def test_k1_plain_matches_pallas_interpret():
    rng = np.random.RandomState(42)
    c = 64
    B, H, W = 2, 32, 48
    w = rng.randn(3, 3, c, c).astype(np.float32) * 0.2
    b = rng.randn(c).astype(np.float32) * 0.1
    x = np.maximum(rng.randn(B, H, W, c).astype(np.float32), 0)
    mid, side = pair_mid_side(w)
    y_ref, p_ref = pair_conv_pool(
        jnp.asarray(x.reshape(B, H, W // 2, 2 * c)), jnp.asarray(mid),
        jnp.asarray(side), jnp.asarray(np.concatenate([b, b])[None]),
        tile=8, interpret=True)
    y, p = fc.conv3x3_relu_pool(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b))
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(y_ref).reshape(B, H, W, c),
                               atol=2e-5, rtol=1e-5)
    # the pair pool emits (B, H/2, W/2, c) in standard layout
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref),
                               atol=2e-5, rtol=1e-5)


def test_k2_plain_matches_dec1_head_interpret(variables):
    """K2 alone: the plain head on dec2/enc1 activations against
    `pallas_conv.dec1_head` (f32)."""
    from unetdc_tpu.ops.pallas_conv import dec1_head

    rng = np.random.RandomState(7)
    B, H, W = 2, 32, 32
    dec2 = np.maximum(rng.randn(B, H // 2, W // 2, 128), 0).astype(np.float32)
    enc1 = np.maximum(rng.randn(B, H, W, 64), 0).astype(np.float32)
    jfp = _jax_fp(variables, jnp.float32)
    ref = dec1_head(jnp.asarray(dec2),
                    jnp.asarray(enc1.reshape(B, H, W // 2, 128)),
                    jfp["_pa"]["head"], interpret=True)
    ref = np.asarray(ref).reshape(B, H, W, 1)
    got = fc.dec1_head(torch.from_numpy(dec2), torch.from_numpy(enc1),
                       _port_fp(variables, torch.float32)["head"])
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 32, 32)])
def test_forward_matches_pallas_forward_f32(decisive, shape):
    x = np.random.RandomState(8).rand(*shape, 3).astype(np.float32)
    jfp = _jax_fp(decisive, jnp.float32)
    ref = np.asarray(JF.forward_folded_pallas(
        _flip_up(jfp), jnp.asarray(x), interpret=True))
    flipped = np.asarray(JF.forward_folded_pallas(
        jfp, jnp.asarray(x), interpret=True))
    # the test must see the flip: it moves the output by > 10x the atol
    assert np.abs(flipped - ref).max() > 10 * 2e-5
    got = forward_folded(_port_fp(decisive, torch.float32),
                         torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    # K1 and K2 alone meet test_pallas_conv's bounds (tests above); the whole
    # forward also runs eight library-conv blocks whose f32 summation order
    # differs between XLA and ATen (measured up to 5.9e-6 here), so it is
    # held at K1's atol
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_forward_bf16_close_to_pallas_f32(variables):
    x = np.random.RandomState(9).rand(1, 32, 48, 3).astype(np.float32)
    ref = np.asarray(JF.forward_folded_pallas(
        _flip_up(_jax_fp(variables, jnp.float32)), jnp.asarray(x),
        interpret=True))
    jb = np.asarray(JF.forward_folded_pallas(
        _flip_up(_jax_fp(variables, jnp.bfloat16)), jnp.asarray(x),
        interpret=True))
    got = forward_folded(_port_fp(variables, torch.bfloat16),
                         torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() < 0.05
    assert np.abs(got - jb).max() < 0.05


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(1, 8, 8, 32)
    with pytest.raises(ValueError):
        fc._check_k1(x, torch.zeros(3, 3, 32, 32), torch.zeros(32))
    with pytest.raises(TypeError):
        fc._check_k1(torch.zeros(1, 8, 8, 64, dtype=torch.float16),
                     torch.zeros(3, 3, 64, 64, dtype=torch.float16),
                     torch.zeros(64))
