"""The port's models against the JAX package's, f32 on the CPU: the
`nn.Module` UNetDC/UNet with BatchNorm (weights carried across by
`variables_to_state_dict`) against flax `apply`, and the BN-folded fast
forward (kernels K1/K2 by their plain versions) against
`unet_fast.forward_folded`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unetdc_tpu.models import unet_fast as JF
from unetdc_tpu.models.unet import UNet, UNetDC, fold_batchnorm
from unetdc_tpu_torch.checkpoint import (torch_state_dict_to_variables,
                                         variables_to_state_dict,
                                         variables_to_torch_state_dict)
from unetdc_tpu_torch.models import unet as TU
from unetdc_tpu_torch.models.unet_fast import build_fast_params, forward_folded


def _variables(cls, seed):
    """Flax variables with non-trivial BatchNorm statistics."""
    v = cls().init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    r = np.random.RandomState(seed)
    for blk in v["batch_stats"].values():
        for bn in blk.values():
            bn["mean"] = r.uniform(-0.5, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = r.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    return v


@pytest.mark.parametrize("jcls,tcls", [(UNetDC, TU.UNetDC), (UNet, TU.UNet)])
def test_module_matches_flax(jcls, tcls):
    v = _variables(jcls, 1)
    x = np.random.RandomState(2).rand(2, 32, 48, 3).astype(np.float32)
    ref = np.asarray(jcls().apply(v, jnp.asarray(x), train=False))
    m = tcls().eval()
    m.load_state_dict(variables_to_state_dict(v))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 32, 48, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=3e-6)


def test_state_dict_roundtrip():
    v = _variables(UNetDC, 3)
    sd = variables_to_torch_state_dict(v)
    back = torch_state_dict_to_variables(sd)
    for a, b in zip(jax.tree_util.tree_leaves(v),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(variables_to_state_dict(v)) == set(TU.UNetDC().state_dict())


def test_fold_batchnorm_matches_jax():
    v = _variables(UNetDC, 4)
    ref = fold_batchnorm(v)["params"]
    got = TU.fold_batchnorm(variables_to_state_dict(v))
    for blk in ("enc1", "bottleneck", "dec1"):
        for c in ("conv0", "conv1"):
            for k in ("kernel", "bias"):
                np.testing.assert_allclose(got[blk][c][k].numpy(),
                                           np.asarray(ref[blk][c][k]),
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 64, 32)])
def test_folded_forward_matches_jax_f32(shape):
    v = _variables(UNetDC, 5)
    x = np.random.RandomState(6).rand(*shape, 3).astype(np.float32)
    jfp = JF.build_fast_params(fold_batchnorm(v)["params"], dtype=jnp.float32)
    ref = np.asarray(JF.forward_folded(jfp, jnp.asarray(x)))
    fp = build_fast_params(TU.fold_batchnorm(variables_to_state_dict(v)),
                           torch.float32)
    with torch.no_grad():
        got = forward_folded(fp, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    # the JAX fast path sums in its pair layout (128-channel contractions
    # with structured zeros); its own test holds it to the module at
    # atol 2e-4 (tests/test_models.py), and so does this one
    np.testing.assert_allclose(got, ref, atol=2e-4)
