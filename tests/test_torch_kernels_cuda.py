"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels are built
from `unetdc_tpu_torch/csrc` at first use); on a host without a card they
skip. Run them with `python -m pytest -m cuda tests/test_torch_kernels_cuda.py`.
Shapes are deliberately not multiples of the kernels' tiles, so the ragged
edges are covered.

Tolerances: f32 kernels differ from cuDNN f32 only in summation order
(K1 atol 2e-5 / rtol 1e-5, K2 atol 3e-6 / rtol 1e-5, as the JAX package
holds its Pallas kernels); bf16 outputs may differ by one bf16 rounding step
where the f32 sums straddle a boundary; K3 is integer and exact.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(dev, dtype):
    from unetdc_tpu_torch.ops import fused_conv as fc

    r = np.random.RandomState(0)
    x = _t(np.maximum(r.randn(2, 40, 56, 64), 0), dev, dtype)
    w = _t(r.randn(3, 3, 64, 64) * 0.1, dev, dtype)
    b = _t(r.randn(64) * 0.1, dev, torch.float32)
    y, p = fc.conv3x3_relu_pool(x, w, b)
    torch.cuda.synchronize()
    yr, pr = fc.conv3x3_relu_pool_plain(x, w, b)
    tol = (dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=1e-2, rtol=1e-2))
    torch.testing.assert_close(y.float(), yr.float(), **tol)
    torch.testing.assert_close(p.float(), pr.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain(dev, dtype):
    from unetdc_tpu_torch.ops import fused_conv as fc

    r = np.random.RandomState(1)
    B, H, W = 2, 36, 40
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
