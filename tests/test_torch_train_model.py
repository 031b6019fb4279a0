"""The port's training-mode model against the JAX package's flax module, on
the CPU: train-mode logits and updated BatchNorm statistics from carried
weights (with and without a sample mask, f32 and bf16), parameter
gradients against `jax.grad`, `remat`, and the flax initializers."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unetdc_tpu.models.unet import UNetDC as JUNetDC
from unetdc_tpu_torch.checkpoint import (params_to_named,
                                         torch_state_dict_to_variables,
                                         variables_to_state_dict)
from unetdc_tpu_torch.models.unet import UNetDC, init_flax_


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several test processes side by
    side, and full-width models on all cores in each oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


SHAPE = (3, 32, 32, 3)


@pytest.fixture(scope="module")
def carried():
    """Flax variables (random init, non-trivial running statistics), one
    input batch and a sample mask that drops the last sample."""
    v = JUNetDC(apply_sigmoid=False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    r = np.random.RandomState(1)
    for blk in v["batch_stats"].values():
        for bn in blk.values():
            bn["mean"] = r.uniform(-0.2, 0.2, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = r.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    x = r.rand(*SHAPE).astype(np.float32)
    return v, x, np.array([True, True, False])


def _jax_train(v, x, mask, dtype):
    model = JUNetDC(apply_sigmoid=False, dtype=dtype)
    logits, mut = model.apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"],
                              sample_mask=None if mask is None
                              else jnp.asarray(mask))
    return np.asarray(logits), jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"])


def _port_train(v, x, mask, dtype):
    m = UNetDC(apply_sigmoid=False, compute_dtype=dtype).train()
    m.load_state_dict(variables_to_state_dict(v))
    with torch.no_grad():
        logits = m(torch.from_numpy(x), sample_mask=None if mask is None
                   else torch.from_numpy(mask)).numpy()
    return logits, torch_state_dict_to_variables(m.state_dict())[
        "batch_stats"]


@pytest.mark.parametrize("masked", [False, True])
def test_train_mode_f32_matches_flax(carried, masked):
    """f32: logits and the new running statistics within atol 1e-5 (the two
    sum in different orders; BatchNorm keeps values O(1))."""
    v, x, mask = carried
    mask = mask if masked else None
    ref, ref_stats = _jax_train(v, x, mask, jnp.float32)
    got, got_stats = _port_train(v, x, mask, torch.float32)
    assert got.shape == ref.shape == SHAPE[:3] + (1,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    for blk, bns in ref_stats.items():
        for bn, st in bns.items():
            for k in ("mean", "var"):
                np.testing.assert_allclose(got_stats[blk][bn][k], st[k],
                                           atol=1e-5, rtol=1e-5,
                                           err_msg=f"{blk}/{bn}/{k}")


def test_masked_sample_is_excluded(carried):
    """With the last sample masked out, the statistics (hence the kept
    samples' logits) equal those of the batch without it."""
    v, x, mask = carried
    got, stats = _port_train(v, x, mask, torch.float32)
    sub, sub_stats = _port_train(v, x[:2], None, torch.float32)
    np.testing.assert_allclose(got[:2], sub, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(stats["dec1"]["bn1"]["var"],
                               sub_stats["dec1"]["bn1"]["var"], rtol=1e-5)


def test_train_mode_bf16_matches_flax(carried):
    """bf16 convs, f32 BatchNorm: logits within 0.1 absolute (about one
    bf16 step at the logits' O(1-10) scale after 23 layers of bf16
    rounding done in different orders), and 95% of them within 0.02."""
    v, x, _ = carried
    ref, _ = _jax_train(v, x, None, jnp.bfloat16)
    got, _ = _port_train(v, x, None, torch.bfloat16)
    err = np.abs(got - ref)
    assert err.max() < 0.1, err.max()
    assert np.mean(err < 0.02) > 0.95, np.mean(err < 0.02)


def _loss_weights(shape):
    return np.random.RandomState(7).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_grads(carried):
    v, x, mask = carried
    model = JUNetDC(apply_sigmoid=False)
    w = jnp.asarray(_loss_weights(SHAPE[:3] + (1,)))

    def loss(p):
        logits, _ = model.apply({"params": p,
                                 "batch_stats": v["batch_stats"]},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"],
                                sample_mask=jnp.asarray(mask))
        return jnp.sum(logits * w)

    g = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, v["params"]))
    return params_to_named(jax.tree_util.tree_map(np.asarray, g))


def _port_grads(v, x, mask, remat):
    m = UNetDC(apply_sigmoid=False, remat=remat).train()
    m.load_state_dict(variables_to_state_dict(v))
    logits = m(torch.from_numpy(x), sample_mask=None if mask is None
               else torch.from_numpy(mask))
    (logits * torch.from_numpy(_loss_weights(SHAPE[:3] + (1,)))).sum() \
        .backward()
    return {n: p.grad.numpy() for n, p in m.named_parameters()}, m


def _is_pre_bn_bias(name):
    # a conv bias that feeds a BatchNorm: its true gradient is 0, so both
    # sides hold only rounding noise
    return name.endswith(".bias") and name.split(".")[1] in ("0", "3") \
        and not name.startswith(("upconv", "out_conv"))


def test_param_grads_match_jax(carried, jax_grads):
    """Every parameter gradient within 1e-4 relative L2 of jax.grad's
    (train mode, masked batch); pre-BatchNorm conv biases (true gradient 0)
    only within 1e-4 of the largest gradient's scale."""
    v, x, mask = carried
    got, _ = _port_grads(v, x, mask, remat=False)
    assert set(got) == set(jax_grads)
    scale = max(np.linalg.norm(g) for g in jax_grads.values())
    for n, ref in jax_grads.items():
        d = np.linalg.norm(got[n] - ref)
        if _is_pre_bn_bias(n):
            assert d < 1e-4 * scale, (n, d)
        else:
            assert d <= 1e-4 * np.linalg.norm(ref), (n, d,
                                                      np.linalg.norm(ref))


@pytest.mark.parametrize("masked", [False, True])
def test_remat_gives_same_grads_and_stats(carried, masked):
    """Recomputing the blocks in the backward pass changes neither the
    gradients nor the running statistics (updated once, not twice), on
    the fused BatchNorm path and on the masked one."""
    v, x, mask = carried
    mask = mask if masked else None
    g0, m0 = _port_grads(v, x, mask, remat=False)
    g1, m1 = _port_grads(v, x, mask, remat=True)
    for n in g0:
        np.testing.assert_allclose(g1[n], g0[n], rtol=1e-6, atol=1e-9,
                                   err_msg=n)
    for (n, a), (_, b) in zip(m0.named_buffers(), m1.named_buffers()):
        assert torch.equal(a, b), n


def test_flax_initializers():
    """Distributions of `init_flax_` against flax's: lecun_normal conv
    kernels (std sqrt(1/fan_in), truncated at 2 std), zero biases, BN 1/0,
    and the upconv's uniform bound sqrt(1/(2*I*O)) (0.0078 for 128->64)."""
    m = init_flax_(UNetDC(), torch.Generator().manual_seed(0))
    assert abs(math.sqrt(1 / (2 * 128 * 64)) - 0.0078) < 1e-4
    for n in ("upconv1", "upconv4"):
        w = getattr(m, n).weight.detach()
        i, o = w.shape[:2]
        bound = math.sqrt(1 / (2 * i * o))
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.99 * bound
        # uniform on [-b, b]: std b / sqrt(3)
        assert abs(float(w.std()) / (bound / math.sqrt(3)) - 1) < 0.02
        assert float(getattr(m, n).bias.detach().abs().max()) == 0
    jv = JUNetDC().init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)),
                        train=False)
    for blk, conv in (("enc2", "conv0"), ("dec3", "conv1")):
        idx = {"conv0": 0, "conv1": 3}[conv]
        w = getattr(m, blk)[idx].weight.detach().numpy()
        ref = np.asarray(jv["params"][blk][conv]["kernel"])
        fan_in = w[0].size
        assert abs(w.std() * math.sqrt(fan_in) - 1) < 0.02
        assert abs(ref.std() * math.sqrt(fan_in) - 1) < 0.02
        # truncated at 2 std of the underlying normal
        lim = 2 * math.sqrt(1 / fan_in) / 0.87962566103423978
        assert np.abs(w).max() <= lim and np.abs(ref).max() <= lim
        assert float(getattr(m, blk)[idx].bias.detach().abs().max()) == 0
    ju = np.asarray(jv["params"]["upconv1"]["kernel"])
    assert abs(np.abs(ju).max() / math.sqrt(1 / (2 * 128 * 64)) - 1) < 0.01
    assert float(m.enc1[1].weight.detach().min()) == 1.0
    assert float(m.enc1[1].running_var.min()) == 1.0


@pytest.mark.parametrize("d,size", [(16, 32), (16, 16), (4, 24), (2, 10)])
def test_phase_split_conv_equals_dilated_conv(d, size):
    """`_conv_phases` computes the dilated 3x3 conv (padding = dilation) as
    an undilated conv on the d*d phase sub-images: the same result (f32,
    summation order aside) and channels-last memory."""
    from unetdc_tpu_torch.models.unet import _conv_phases

    r = torch.Generator().manual_seed(d)
    x = torch.randn(2, 8, size, size, generator=r).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(5, 8, 3, 3, generator=r)
    ref = torch.nn.functional.conv2d(x, w, None, 1, d, d)
    got = _conv_phases(x, w, d)
    assert got.shape == ref.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                               rtol=1e-6)


def test_model_with_phase_split_bottleneck(carried, monkeypatch):
    """At 256x256 the bottleneck (dilation 16) sees 16x16 maps and takes
    the phase split; train-mode logits and the bottleneck's gradients equal
    the dilated conv's. In f64: the gradients behind the deep train-mode
    BatchNorms cancel ~1000-fold, so f32 would only show reduction order
    (logits atol 1e-10, gradient 1e-9 relative L2)."""
    import unetdc_tpu_torch.models.unet as U

    v = carried[0]
    x = np.random.RandomState(3).rand(1, 256, 256, 3).astype(np.float32)
    out = []
    for thr in (16, 10 ** 9):
        monkeypatch.setattr(U, "PHASE_MIN_DILATION", thr)
        m = UNetDC(apply_sigmoid=False, compute_dtype=torch.float64)
        m.load_state_dict(variables_to_state_dict(v))
        m = m.double().train()
        logits = m(torch.from_numpy(x).double())
        logits.square().mean().backward()
        out.append((logits.detach().numpy(), m.bottleneck[3].weight.grad))
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-10, rtol=0)
    g0, g1 = out[0][1], out[1][1]
    assert float((g0 - g1).norm() / g1.norm()) < 1e-9
