"""The plain reference against OpenCV/SciPy (where the reference scripts
use them) and against the port's plain path, at small sizes on the CPU;
and the seeded inference weights making masks that follow the droplets."""

import numpy as np
import pytest
import torch

import bench_small  # noqa: F401  (puts benchmarks/ on the path)
from reference import model as ref_model
from reference import ops as ref_ops
from traffic import droplet_images

cv2 = pytest.importorskip("cv2")


def _gray(seed=3, n=2, h=200, w=232):
    p = {"n": n, "height": h, "width": w, "droplets": [5, 40],
         "total_area_px": 3000, "area_px": [20, 900], "noise": 60,
         "brightness": 180}
    imgs, drops = droplet_images.make_images(p, seed)
    return np.stack([i[..., 0] for i in imgs]), drops


@pytest.mark.parametrize("ksize", [50, 7, 12])
def test_rolling_ball_equals_cv2(ksize):
    planes, _ = _gray()
    k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize))
    got = ref_ops.rolling_ball(torch.as_tensor(planes), ksize).numpy()
    for g, img in zip(got, planes):
        bg = cv2.morphologyEx(img, cv2.MORPH_OPEN, k)
        want = cv2.normalize(cv2.subtract(img, bg), None, 0, 255,
                             cv2.NORM_MINMAX)
        assert np.array_equal(g, want)


@pytest.mark.parametrize("src,out", [((1024, 1024), (512, 512)),
                                     ((512, 512), (1024, 1024)),
                                     ((256, 256), (512, 512)),
                                     ((512, 512), (256, 256))])
def test_resizes_equal_cv2(src, out):
    """The scales the pipelines drive: the image 1024 -> 512 and the mask
    back, and the test sizes."""
    planes, _ = _gray(h=src[0], w=src[1])
    got = ref_ops.resize_u8(torch.as_tensor(planes), out).numpy()
    for g, img in zip(got, planes):
        assert np.array_equal(g, cv2.resize(img, out[::-1]))
    m = (planes[0] > 100).astype(np.uint8)
    assert np.array_equal(ref_ops.resize_u8(torch.as_tensor(m), out).numpy(),
                          cv2.resize(m, out[::-1]))
    rgb = np.random.RandomState(0).rand(37, 53, 3).astype(np.float32)
    gotf = ref_ops.resize_float(torch.as_tensor(rgb), out).numpy()
    np.testing.assert_allclose(gotf, cv2.resize(rgb, out[::-1]), atol=2e-6)
    m = (planes[0] > 100).astype(np.uint8)
    got = ref_ops.resize_nearest(torch.as_tensor(m), out).numpy()
    assert np.array_equal(got, cv2.resize(m, out[::-1],
                                          interpolation=cv2.INTER_NEAREST))


def test_droplet_table_equals_scipy_label_order():
    from scipy import ndimage

    planes, _ = _gray()
    m = (planes[1] > 150).astype(np.uint8)
    t = ref_ops.droplet_table(m)
    lab, n = ndimage.label(m)
    assert len(t) == n
    for k in (1, n // 2, n):
        ys, xs = np.nonzero(lab == k)
        assert t[k - 1, 1] == len(ys)
        assert t[k - 1, 3] == pytest.approx(ys.mean())
        # raster order of each component's first pixel
    firsts = [np.flatnonzero((lab == k).ravel())[0] for k in range(1, n + 1)]
    assert firsts == sorted(firsts)


def test_reference_ops_equal_the_port():
    from unetdc_tpu_torch.ops.resize import resize_linear_u8_cv2exact
    from unetdc_tpu_torch.ops.rolling_ball import rolling_ball_correction

    planes, _ = _gray()
    x = torch.as_tensor(planes)
    assert torch.equal(ref_ops.rolling_ball(x, 50),
                       rolling_ball_correction(x[:, None], 50)[:, 0])
    assert torch.equal(ref_ops.resize_u8(x, (64, 80)),
                       resize_linear_u8_cv2exact(x, (64, 80)))


@pytest.mark.parametrize("model", ["unetdc", "unet"])
def test_reference_forward_equals_the_port_f32(model):
    from unetdc_tpu_torch.models.unet import UNet, UNetDC

    torch.manual_seed(0)
    m = (UNetDC if model == "unetdc" else UNet)().eval()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.5, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
    sd = {k: v for k, v in m.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    x = torch.rand(2, 3, 32, 32)
    with torch.no_grad():
        got = torch.sigmoid(ref_model.forward(sd, x, m.dilations))
        want = m(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_reference_train_step_equals_the_port_f32():
    """One f32 step of the port's trainer model and Adam against the
    reference's, from the same weights and batch (no augmentation)."""
    from reference import train as ref_train
    from unetdc_tpu_torch.losses.losses import focal_dice_loss_from_logits
    from unetdc_tpu_torch.models.unet import UNetDC

    from harness.weights import train_state_dict

    sd0 = train_state_dict(5, "cpu")
    m = UNetDC(apply_sigmoid=False)
    m.load_state_dict(sd0, strict=False)
    m.train()
    x = torch.rand(2, 3, 32, 32)
    t = (torch.rand(2, 1, 32, 32) > 0.7).float()
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    z = m(x.permute(0, 2, 3, 1))
    loss = focal_dice_loss_from_logits(z, t.permute(0, 2, 3, 1), ratio=0.3)
    opt.zero_grad()
    loss.backward()
    opt.step()
    params = {k: v.clone() for k, v in sd0.items()}
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    lr = ref_train.loss_fn("focal_dice", ref_model.forward(
        leaves, x, UNetDC.dilations, train=True), t)
    g = torch.autograd.grad(lr, list(leaves.values()))
    adam = ref_train.Adam({k: v.detach() for k, v in params.items()})
    adam.step(dict(zip(leaves, g)))
    assert float(lr) == pytest.approx(float(loss), rel=1e-5)
    got = dict(m.named_parameters())
    for k in ("enc1.0.weight", "bottleneck.3.weight", "dec1.4.bias",
              "out_conv.weight"):
        torch.testing.assert_close(adam.p[k], got[k].detach(), atol=2e-6,
                                   rtol=1e-5)


def test_seeded_weights_make_masks_that_follow_the_droplets():
    """At the cell's widths, on small droplet images, the reference mask's
    components are the drawn droplets' (within the few that touch)."""
    from scipy import ndimage

    from bench_small import core
    from harness.weights import inference_state_dict

    cfg = core.load_json("configs", "unetdc")
    planes, drops = _gray(seed=9, n=2, h=256, w=256)
    rb = ref_ops.rolling_ball(torch.as_tensor(planes), 50)
    x = rb.float()[:, None].expand(-1, 3, -1, -1) / 255.0
    sd = inference_state_dict(4, "cpu", x[:1], cfg["dilations"],
                              **cfg["synthetic_weights"])
    with torch.no_grad():
        p = torch.sigmoid(ref_model.forward(sd, x, cfg["dilations"]))[:, 0]
    for mask, d in zip((p > 0.3).numpy(), drops):
        truth = np.zeros(mask.shape, bool)
        yy, xx = np.mgrid[:256, :256]
        for cy, cx, r in d:
            truth |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        n_truth = ndimage.label(truth)[1]
        n_mask = ndimage.label(mask)[1]
        assert abs(n_mask - n_truth) <= max(2, 0.1 * n_truth)
        assert (mask & truth).sum() / (mask | truth).sum() > 0.6
