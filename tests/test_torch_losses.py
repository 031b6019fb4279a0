"""The port's losses and metrics against the JAX package's, on the CPU:
values and gradients with respect to the logits (through `jax.grad`),
logits up to +-30 for the training (logits-space) losses and per-sample
weights with zeros; confusion counts and pixel metrics exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unetdc_tpu.losses import losses as JL
from unetdc_tpu.losses import metrics as JM
from unetdc_tpu_torch.losses import losses as TL
from unetdc_tpu_torch.losses import metrics as TM

SHAPE = (4, 16, 16, 1)
ATOL = 1e-6


def _inputs(seed, scale):
    """Logits in +-3, a tenth of them in +-scale, the extremes and 0."""
    r = np.random.RandomState(seed)
    z = r.uniform(-3, 3, SHAPE)
    far = r.rand(*SHAPE) < 0.1
    z[far] = r.uniform(-scale, scale, int(far.sum()))
    z = z.astype(np.float32)
    z[0, :2, :2, 0] = [[scale, -scale], [0.0, scale]]
    t = (r.rand(*SHAPE) > 0.5).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0, 0.5], np.float32)      # a zero weight
    return z, t, w


def _value_and_grad_jax(fn, z, t, w):
    val, g = jax.value_and_grad(lambda zz: fn(zz, jnp.asarray(t),
                                              jnp.asarray(w)))(jnp.asarray(z))
    return float(val), np.asarray(g)


def _value_and_grad_port(fn, z, t, w):
    zt = torch.from_numpy(z).requires_grad_(True)
    val = fn(zt, torch.from_numpy(t), torch.from_numpy(w))
    val.backward()
    return float(val), zt.grad.numpy()


# (name, jax fn(z, t, w), port fn(z, t, w), logit scale)
LOGITS = [
    ("focal_dice_from_logits",
     lambda z, t, w: JL.focal_dice_loss_from_logits(z, t, weights=w),
     lambda z, t, w: TL.focal_dice_loss_from_logits(z, t, weights=w)),
    ("focal_dice_from_logits_ratio",
     lambda z, t, w: JL.focal_dice_loss_from_logits(
         z, t, alpha=0.7, gamma=3.0, ratio=0.6, weights=w),
     lambda z, t, w: TL.focal_dice_loss_from_logits(
         z, t, alpha=0.7, gamma=3.0, ratio=0.6, weights=w)),
    ("focal_from_logits",
     lambda z, t, w: JL.focal_loss_from_logits(z, t, weights=w),
     lambda z, t, w: TL.focal_loss_from_logits(z, t, weights=w)),
    ("focal_from_logits_sum",
     lambda z, t, w: JL.focal_loss_from_logits(z, t, reduction="sum") / 1e3,
     lambda z, t, w: TL.focal_loss_from_logits(z, t, reduction="sum") / 1e3),
    ("combined_from_logits",
     lambda z, t, w: JL.combined_loss_from_logits(z, t, weights=w),
     lambda z, t, w: TL.combined_loss_from_logits(z, t, weights=w)),
    ("combined_from_logits_unweighted",
     lambda z, t, w: JL.combined_loss_from_logits(z, t),
     lambda z, t, w: TL.combined_loss_from_logits(z, t)),
]
# probability-space losses (the evaluation surface), on sigmoid(z): kept
# to |z| <= 8, where the reference's clamped BCE is still finite in f32
PROBS = [
    ("dice", lambda p, t, w: JL.dice_loss(p, t, weights=w),
     lambda p, t, w: TL.dice_loss(p, t, weights=w)),
    ("combined", lambda p, t, w: JL.combined_loss(p, t),
     lambda p, t, w: TL.combined_loss(p, t)),
    ("focal", lambda p, t, w: JL.focal_loss(p, t),
     lambda p, t, w: TL.focal_loss(p, t)),
    ("focal_dice", lambda p, t, w: JL.focal_dice_loss(p, t),
     lambda p, t, w: TL.focal_dice_loss(p, t)),
]


@pytest.mark.parametrize("name,jfn,tfn", LOGITS, ids=[c[0] for c in LOGITS])
@pytest.mark.parametrize("scale", [8.0, 30.0])
def test_logits_losses_and_grads(name, jfn, tfn, scale):
    z, t, w = _inputs(1, scale)
    jv, jg = _value_and_grad_jax(jfn, z, t, w)
    tv, tg = _value_and_grad_port(tfn, z, t, w)
    assert np.isfinite(tv)
    np.testing.assert_allclose(tv, jv, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tg, jg, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,jfn,tfn", PROBS, ids=[c[0] for c in PROBS])
def test_probability_losses_and_grads(name, jfn, tfn):
    z, t, w = _inputs(2, 8.0)
    jv, jg = _value_and_grad_jax(
        lambda zz, tt, ww: jfn(jax.nn.sigmoid(zz), tt, ww), z, t, w)
    tv, tg = _value_and_grad_port(
        lambda zz, tt, ww: tfn(torch.sigmoid(zz), tt, ww), z, t, w)
    np.testing.assert_allclose(tv, jv, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tg, jg, atol=ATOL, rtol=0)


def test_dice_coef_weighted():
    z, t, w = _inputs(3, 4.0)
    p = 1 / (1 + np.exp(-z))
    ref = float(JL.dice_coef(jnp.asarray(t), jnp.asarray(p),
                             weights=jnp.asarray(w)))
    got = float(TL.dice_coef(torch.from_numpy(t), torch.from_numpy(p),
                             weights=torch.from_numpy(w)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_confusion_counts_and_pixel_metrics_exact(masked):
    r = np.random.RandomState(4)
    t = (r.rand(*SHAPE) > 0.6).astype(np.float32)
    p = r.rand(*SHAPE).astype(np.float32)
    p[0, 0, 0, 0] = 0.3                      # exactly at the threshold
    m = np.array([True, False, True, True]) if masked else None
    ref = np.asarray(JM.confusion_counts(
        jnp.asarray(t), jnp.asarray(p), 0.3,
        sample_mask=None if m is None else jnp.asarray(m)))
    got = TM.confusion_counts(torch.from_numpy(t), torch.from_numpy(p), 0.3,
                              sample_mask=None if m is None
                              else torch.from_numpy(m))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert TM.pixel_metrics(got) == JM.pixel_metrics(ref)
    for counts in ([5, 0, 0, 0], [0, 0, 0, 0], [0, 3, 0, 0], [1, 2, 3, 4]):
        assert TM.pixel_metrics(np.array(counts)) == \
            JM.pixel_metrics(np.array(counts))
    jcm = JM.calculate_metrics(t, p, 0.3)
    tcm = TM.calculate_metrics(t, p, 0.3)
    assert jcm[:4] == tcm[:4]
    np.testing.assert_array_equal(jcm[4], tcm[4])
