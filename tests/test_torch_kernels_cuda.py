"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels are built
from `unetdc_tpu_torch/csrc` at first use); on a host without a card they
skip. Run them with `python -m pytest -m cuda tests/test_torch_kernels_cuda.py`.
Shapes are deliberately not multiples of the kernels' tiles, so the ragged
edges are covered, and the main path's shapes (batch 8 at 512x512) run too.

The `ext` mode of K1 and K2 (row shards with real halo rows) is held
bit-equal: shards reassembled equal the unsharded kernel.

Tolerances: f32 kernels differ from cuDNN f32 only in summation order
(K1 atol 2e-5 / rtol 1e-5, K2 atol 3e-6 / rtol 1e-5, as the JAX package
holds its Pallas kernels); bf16 outputs may differ by one bf16 rounding step
where the f32 sums straddle a boundary; K3 and the rolling ball are integer
(and the rolling ball's normalisation in the plain version's float32 order)
and exact.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from unetdc_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _t(a, dev, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def _k1_case(dev, dtype, B, H, W, seed=0):
    from unetdc_tpu_torch.ops import fused_conv as fc

    r = np.random.RandomState(seed)
    x = _t(np.maximum(r.randn(B, H, W, 64), 0), dev, dtype)
    w = _t(r.randn(3, 3, 64, 64) * 0.1, dev, dtype)
    b = _t(r.randn(64) * 0.1, dev, torch.float32)
    y, p = fc.conv3x3_relu_pool(x, w, b)
    torch.cuda.synchronize()
    yr, pr = fc.conv3x3_relu_pool_plain(x, w, b)
    tol = (dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=1e-2, rtol=1e-2))
    torch.testing.assert_close(y.float(), yr.float(), **tol)
    torch.testing.assert_close(p.float(), pr.float(), **tol)


def _k2_case(dev, dtype, B, H, W, seed=1):
    from unetdc_tpu_torch.ops import fused_conv as fc

    r = np.random.RandomState(seed)
    dec2 = _t(np.maximum(r.randn(B, H // 2, W // 2, 128), 0), dev, dtype)
    enc1 = _t(np.maximum(r.randn(B, H, W, 64), 0), dev, dtype)
    head = {
        "w_up": _t(r.randn(2, 2, 128, 64) * 0.1, dev, dtype),
        "b_up": _t(r.randn(64) * 0.1, dev, torch.float32),
        "w0": _t(r.randn(3, 3, 128, 64) * 0.05, dev, dtype),
        "b0": _t(r.randn(64) * 0.1, dev, torch.float32),
        "w1": _t(r.randn(3, 3, 64, 64) * 0.05, dev, dtype),
        "b1": _t(r.randn(64) * 0.1, dev, torch.float32),
        "w_oc": _t(r.randn(64) * 0.2, dev, dtype),
        "b_oc": _t(r.randn(1) * 0.1, dev, torch.float32),
    }
    out = fc.dec1_head(dec2, enc1, head)
    torch.cuda.synchronize()
    ref = fc.dec1_head_plain(dec2, enc1, head)
    assert out.shape == (B, H, W, 1)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=3e-6, rtol=1e-5)
    else:
        assert float((out - ref).abs().max()) < 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(dev, dtype):
    _k1_case(dev, dtype, 2, 40, 56)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain(dev, dtype):
    _k2_case(dev, dtype, 2, 36, 40)


# K1's and K2's bf16 kernels walk 16x16 and 32x12 tiles on a persistent
# grid of one block per SM: ragged edges, one side below a tile, B = 1, and
# tile counts that do not divide over 132 SMs (K1: 180 tiles; K2: 270).
K1_SHAPES = [(1, 30, 22), (1, 6, 40), (2, 48, 10), (2, 144, 160)]
K2_SHAPES = [(1, 30, 26), (1, 10, 64), (2, 34, 8), (3, 176, 180)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_SHAPES, ids=str)
def test_k1_tilings(dev, dtype, shape):
    _k1_case(dev, dtype, *shape, seed=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K2_SHAPES, ids=str)
def test_k2_tilings(dev, dtype, shape):
    _k2_case(dev, dtype, *shape, seed=4)


def test_k1_main_path_shape(dev):
    _k1_case(dev, torch.bfloat16, 8, 512, 512, seed=5)


def test_k2_main_path_shape(dev):
    _k2_case(dev, torch.bfloat16, 8, 512, 512, seed=6)


def _shards(t, S, n):
    from unetdc_tpu_torch.core.mesh import halo

    return halo(list(torch.chunk(t, S, 1)), n, 1)


# ext mode: row shards with real halo rows; S = 1 is the ext launch with
# zero halos and both edge flags set, so S in (1, 2, 4) covers the four
# flag patterns (1,1), (1,0), (0,0), (0,1). Shard heights 40/S and 36/S
# are not multiples of the 16- and 32-row tiles, so tiles straddle seams.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("shape", [(2, 40, 56), (8, 512, 512)], ids=str)
def test_k1_ext_shards_bit_equal(dev, dtype, S, shape):
    from unetdc_tpu_torch.ops import fused_conv as fc

    B, H, W = shape
    r = np.random.RandomState(21)
    x = _t(np.maximum(r.randn(B, H, W, 64), 0), dev, dtype)
    w = _t(r.randn(3, 3, 64, 64) * 0.1, dev, dtype)
    b = _t(r.randn(64) * 0.1, dev, torch.float32)
    y, p = fc.conv3x3_relu_pool(x, w, b)
    parts = [fc.conv3x3_relu_pool(s, w, b, ext=True)
             for s in _shards(x, S, 1)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([q[0] for q in parts], 1), y)
    assert torch.equal(torch.cat([q[1] for q in parts], 1), p)
    s0 = _shards(x, S, 1)[0]
    yr, pr = fc.conv3x3_relu_pool_plain(s0, w, b, ext=True)
    tol = (dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=1e-2, rtol=1e-2))
    torch.testing.assert_close(parts[0][0].float(), yr.float(), **tol)
    torch.testing.assert_close(parts[0][1].float(), pr.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("shape", [(2, 72, 40), (8, 512, 512)], ids=str)
def test_k2_ext_shards_bit_equal(dev, dtype, S, shape):
    from unetdc_tpu_torch.ops import fused_conv as fc

    B, H, W = shape
    r = np.random.RandomState(22)
    dec2 = _t(np.maximum(r.randn(B, H // 2, W // 2, 128), 0), dev, dtype)
    enc1 = _t(np.maximum(r.randn(B, H, W, 64), 0), dev, dtype)
    head = {
        "w_up": _t(r.randn(2, 2, 128, 64) * 0.1, dev, dtype),
        "b_up": _t(r.randn(64) * 0.1, dev, torch.float32),
        "w0": _t(r.randn(3, 3, 128, 64) * 0.05, dev, dtype),
        "b0": _t(r.randn(64) * 0.1, dev, torch.float32),
        "w1": _t(r.randn(3, 3, 64, 64) * 0.05, dev, dtype),
        "b1": _t(r.randn(64) * 0.1, dev, torch.float32),
        "w_oc": _t(r.randn(64) * 0.2, dev, dtype),
        "b_oc": _t(r.randn(1) * 0.1, dev, torch.float32),
    }
    ref = fc.dec1_head(dec2, enc1, head)
    ds, es = _shards(dec2, S, 1), _shards(enc1, S, 2)
    flags = [(i == 0, i == S - 1) for i in range(S)]
    out = [fc.dec1_head(d, e, head, ext=True, edge_flags=f)
           for d, e, f in zip(ds, es, flags)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(out, 1), ref)
    for i in {0, S - 1}:
        pl = fc.dec1_head_plain(ds[i], es[i], head, ext=True,
                                edge_flags=flags[i])
        if dtype == torch.float32:
            torch.testing.assert_close(out[i], pl, atol=3e-6, rtol=1e-5)
        else:
            assert float((out[i] - pl).abs().max()) < 0.05


@pytest.mark.parametrize("cap", [5120, 9000, 20000])
def test_k3_matches_plain(dev, cap):
    from unetdc_tpu_torch.ops.component_tables import (
        component_tables, component_tables_plain)

    r = np.random.RandomState(2)
    for (b, h, w), plan in [((2, 64, 64), ((0, 8), 8)),
                            ((1, 50, 97), ((0, 8), 8)),
                            ((3, 41, 70), ((0, 5, 10), 5))]:
        lab = r.randint(0, cap + 140, (b, h, w)).astype(np.int32)
        lab[r.rand(b, h, w) < 0.5] = 0
        t = torch.from_numpy(lab).to(dev)
        got = component_tables(t, *plan, cap=cap)
        torch.cuda.synchronize()
        ref = component_tables_plain(t, *plan, cap=cap)
        assert torch.equal(got, ref), (b, h, w, plan, cap)


def _scipy_labels(seed, b, h, w, density=0.3):
    """Raster-ranked labels of seeded random masks (scipy.ndimage.label)."""
    from scipy import ndimage as ndi

    r = np.random.RandomState(seed)
    out = np.zeros((b, h, w), np.int32)
    for i in range(b):
        out[i] = ndi.label(r.rand(h, w) < density)[0]
    return out


def _k3_case(name):
    """(labels, cap) of one named K3 case; the plan is the engine's."""
    if name == "scipy":
        return _scipy_labels(7, 3, 120, 160), 5120
    if name == "w97":
        return _scipy_labels(8, 2, 61, 97), 5120
    if name == "w801":
        return _scipy_labels(9, 2, 37, 801), 5120
    if name == "b1":
        return _scipy_labels(10, 1, 200, 300), 8193
    if name == "whole_rows":
        lab = np.zeros((2, 50, 130), np.int32)
        lab[:, 10:20] = 3
        lab[1, 30:33] = 4095
        return lab, 5120
    if name == "background":
        return np.zeros((2, 64, 96), np.int32), 5120
    if name == "one_component":
        return np.ones((2, 90, 70), np.int32), 5120
    if name == "dropped":
        lab = _scipy_labels(11, 2, 100, 100, density=0.5)
        lab[:, ::7] = -5  # negative labels are dropped, as labels >= cap
        return lab, 300
    if name == "beyond_cluster":
        from unetdc_tpu_torch.ops.component_tables import cluster_max_cap

        lab = _scipy_labels(12, 2, 300, 300, density=0.3)
        cap = cluster_max_cap(2) + 1
        lab[:, 0, :8] = cap - 1  # the table's last row
        return lab, cap
    raise KeyError(name)


K3_CASES = ["scipy", "w97", "w801", "b1", "whole_rows", "background",
            "one_component", "dropped", "beyond_cluster"]


@pytest.mark.parametrize("name", K3_CASES)
def test_k3_cases(dev, name):
    """K3 exactly equal to its plain version on labels shaped like the
    main path's (runs of one label), ragged widths, B = 1, degenerate
    images and a table beyond the cluster's capacity."""
    from unetdc_tpu_torch.ops.component_tables import (
        component_tables, component_tables_plain)
    from unetdc_tpu_torch.ops.connected_components import _coord_plan

    lab, cap = _k3_case(name)
    t = torch.from_numpy(lab).to(dev)
    plan = _coord_plan(*lab.shape[1:], force_split=True)
    got = component_tables(t, *plan, cap=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, component_tables_plain(t, *plan, cap=cap))


def test_k3_main_path_shapes(dev):
    from unetdc_tpu_torch.ops.component_tables import (
        component_tables, component_tables_plain)

    for shape in [(8, 600, 800), (8, 512, 512)]:
        t = torch.from_numpy(_scipy_labels(13, *shape)).to(dev)
        got = component_tables(t)
        torch.cuda.synchronize()
        assert torch.equal(got, component_tables_plain(t)), shape


def test_k3_offset_view(dev):
    """A label tensor that starts off the 16-byte grid (scalar heads)."""
    from unetdc_tpu_torch.ops.component_tables import (
        component_tables, component_tables_plain)

    lab = _scipy_labels(14, 1, 2 * 40 * 64 + 1, 1)[0, :, 0]
    t = torch.from_numpy(lab).to(dev)[1:].view(2, 40, 64)
    assert t.data_ptr() % 16 == 4 and t.is_contiguous()
    got = component_tables(t)
    torch.cuda.synchronize()
    assert torch.equal(got, component_tables_plain(t))


def test_k3_never_takes_the_plain_version(dev, monkeypatch):
    from unetdc_tpu_torch.ops import component_tables as ct
    from unetdc_tpu_torch.ops import cuda_build as cb

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    lab = torch.from_numpy(_scipy_labels(15, 2, 40, 50)).to(dev)
    ref = ct.component_tables_plain(lab)
    monkeypatch.setattr(ct, "component_tables_plain", refuse)
    before = cb.LAUNCHES["component_tables"]
    got = ct.component_tables(lab)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert cb.LAUNCHES["component_tables"] == before + 1
    with pytest.raises(ValueError):
        ct.component_tables(lab.to(torch.int64))


def test_device_split_names_the_kernels(dev):
    """utils/device_profile.device_split on the card: a K1 call records its
    kernel by name (K1 in `kernel_ms`), a call that launches nothing gives
    0 after the one-kernel control records."""
    from unetdc_tpu_torch.ops import fused_conv as fc
    from unetdc_tpu_torch.utils.device_profile import device_split, kernel_ms

    x = torch.rand(2, 64, 64, 64, device=dev).to(torch.bfloat16)
    w = torch.rand(3, 3, 64, 64, device=dev).to(torch.bfloat16)
    b = torch.rand(64, device=dev)
    total, by_name, _ = device_split(
        lambda: fc.conv3x3_relu_pool(x, w, b), reps=3, warmup=1)
    assert total > 0 and set(kernel_ms(by_name)) == {"K1"}
    assert device_split(lambda: x, reps=2, warmup=0)[:2] == (0.0, {})


# The rolling ball: the main path's (8, 1, 1024, 1024) gray planes, the
# trainer's permuted (8, 3, 512, 512) view of HWC images, a (3, 600, 800)
# stack and (2, 1, 7, 13), smaller than every footprint but ksize 1 and 2.
RB_SHAPES = ["gray1024", "rgb512_view", "600x800", "7x13"]


def _rb_planes(name, kind, dev, seed):
    shape = {"gray1024": (8, 1, 1024, 1024), "rgb512_view": (8, 512, 512, 3),
             "600x800": (3, 600, 800), "7x13": (2, 1, 7, 13)}[name]
    r = np.random.RandomState(seed)
    if kind == "random":
        a = r.randint(0, 256, shape)
    elif kind == "constant":
        a = np.full(shape, 93)
    else:
        a = np.full(shape, 0 if kind == "zeros" else 255)
    t = torch.from_numpy(a.astype(np.uint8)).to(dev)
    return t.permute(0, 3, 1, 2) if name == "rgb512_view" else t


@pytest.mark.parametrize("shape", RB_SHAPES)
@pytest.mark.parametrize("radius", [1, 2, 10, 25, 50, 51, 100])
def test_rolling_ball_matches_plain(dev, radius, shape):
    """The kernel torch.equal to the plain chain on random, constant (span
    0), all-0 and all-255 planes."""
    from unetdc_tpu_torch.ops.rolling_ball import (
        rolling_ball_correction, rolling_ball_correction_plain)

    for i, kind in enumerate(["random", "constant", "zeros", "ones"]):
        x = _rb_planes(shape, kind, dev, radius + i)
        got = rolling_ball_correction(x, radius)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == torch.uint8
        assert torch.equal(got, rolling_ball_correction_plain(x, radius)), \
            (radius, shape, kind)


@pytest.mark.parametrize("radius", [300, 2100])
def test_rolling_ball_large_footprints(dev, radius):
    """Footprints that take narrow tiles (64 and 8 columns) and, at 2100,
    more than 48 KB of shared memory a block, on planes smaller than the
    footprint."""
    from unetdc_tpu_torch.ops.rolling_ball import (
        rolling_ball_correction, rolling_ball_correction_plain)

    r = np.random.RandomState(radius)
    x = torch.from_numpy(r.randint(0, 256, (2, 1, 37, 53)).astype(
        np.uint8)).to(dev)
    got = rolling_ball_correction(x, radius)
    torch.cuda.synchronize()
    assert torch.equal(got, rolling_ball_correction_plain(x, radius))


def test_rolling_ball_offset_view(dev):
    """Planes that start off any alignment, read through their strides."""
    from unetdc_tpu_torch.ops.rolling_ball import (
        rolling_ball_correction, rolling_ball_correction_plain)

    r = np.random.RandomState(16)
    t = torch.from_numpy(r.randint(0, 256, (2, 70, 91)).astype(np.uint8))
    x = t.to(dev)[:, 3:, 1:]
    got = rolling_ball_correction(x, 20)
    torch.cuda.synchronize()
    assert torch.equal(got, rolling_ball_correction_plain(x, 20))


def test_rolling_ball_counts_once_per_call(dev):
    """One launch counted and one `rolling_ball.kernel` record a call."""
    from unetdc_tpu_torch.ops import cuda_build as cb
    from unetdc_tpu_torch.ops.rolling_ball import rolling_ball_correction
    from unetdc_tpu_torch.utils import profiling

    x = _rb_planes("600x800", "random", dev, 17)
    rolling_ball_correction(x, 50)  # first use: build and table upload
    before = cb.LAUNCHES["rolling_ball"]
    profiling.reset_trace()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            rolling_ball_correction(x, 50)
        n = sum(c.n for c in profiling.counts("rolling_ball.kernel"))
    torch.cuda.synchronize()
    assert cb.LAUNCHES["rolling_ball"] == before + 3 and n == 3


def test_rolling_ball_never_takes_the_plain_version(dev, monkeypatch):
    from unetdc_tpu_torch.ops import morphology
    from unetdc_tpu_torch.ops import rolling_ball as rb

    x = _rb_planes("7x13", "random", dev, 18)
    ref = rb.rolling_ball_correction_plain(x, 50)

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(rb, "rolling_ball_correction_plain", refuse)
    monkeypatch.setattr(rb, "morph_open", refuse)
    monkeypatch.setattr(morphology, "_morph", refuse)
    got = rb.rolling_ball_correction(x, 50)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        rb.rolling_ball_correction(x.to(torch.float32), 50)
    with pytest.raises(ValueError, match="ksize <="):
        rb.rolling_ball_correction(x, rb.MAX_KSIZE + 1)
