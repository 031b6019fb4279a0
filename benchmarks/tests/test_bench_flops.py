"""The frozen operation and byte counts against the port's profiler and a
hand count."""

import pytest

import bench_small  # noqa: F401  (puts benchmarks/ on the path)

from flops import kernels, unet


def test_forward_flops_equal_the_port_profiler():
    from unetdc_tpu_torch.utils.device_profile import forward_flops

    for size in (64, 512):
        assert unet.forward_flops(size, size) * 8 == forward_flops(8, size)
    assert forward_flops(8, 512) == 3_082_712_776_704


def test_forward_flops_hand_count_small():
    # widths (2, 4), 4x4 input, 1 channel in: enc 2*16*9*(1*2+2*2),
    # bottleneck 2*4*9*(2*4+4*4), upconv 2*4*4*2*4, dec 2*16*9*(2*2*2+2*2),
    # head 2*16*2
    want = (2 * 16 * 9 * 6 + 2 * 4 * 9 * 24 + 2 * 4 * 4 * 2 * 4
            + 2 * 16 * 9 * 12 + 2 * 16 * 2)
    assert unet.forward_flops(4, 4, widths=(2, 4), cin=1) == want


def test_train_flops_are_three_forwards_less_the_stem_input_grad():
    f = unet.forward_flops(512, 512)
    assert unet.train_step_flops(8, 512, 512) == 8 * (
        3 * f - 2 * 512 * 512 * 9 * 3 * 64)


def test_kernel_counts():
    ops, byts = kernels.k1(8, 512, 512)
    assert ops == 154_618_822_656                      # 2*B*H*W*9*64*64
    assert byts == 2 * (2 * 8 * 512 * 512 * 64 + 8 * 256 * 256 * 64
                        + 9 * 64 * 64 + 64)
    ops, byts = kernels.k2(8, 512, 512)
    assert ops == pytest.approx(498.5e9, rel=1e-3)   # useful, not tiled
    assert kernels.bound_s(ops, byts) == pytest.approx(ops / 989.4e12)
    ops, byts = kernels.k3(8, 1024, 1024)
    assert kernels.k3_chunks(1024, 1024) == 2
    assert byts == 4 * 8 * 1024 * 1024 + 4 * 8 * 5120 * 5
    assert kernels.bound_s(ops, byts) == pytest.approx(byts / 3.35e12)
