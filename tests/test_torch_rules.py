"""Package rules of the port: it imports neither jax nor the JAX package,
and its entry points refuse to fall back to the CPU silently."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Import every module of unetdc_tpu_torch, plus chip_smoke.py, in a
    fresh interpreter: neither jax nor unetdc_tpu may be loaded."""
    code = r"""
import importlib, pkgutil, sys, runpy
sys.path.insert(0, {root!r})
import unetdc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unetdc_tpu_torch.__path__,
                                               "unetdc_tpu_torch.")]
for n in names:
    importlib.import_module(n)
runpy.run_path({smoke!r}, run_name="chip_smoke_import")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "unetdc_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 15, names
"""
    r = subprocess.run([sys.executable, "-c", code.format(
        root=str(ROOT), smoke=str(ROOT / "chip_smoke.py"))],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    from unetdc_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_engine_defaults_to_cuda(monkeypatch, tmp_path):
    from tests.torch_reference import make_decisive_checkpoint
    from unetdc_tpu_torch.pipelines.engine import load_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=1, img_size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_engine(str(ckpt))
    with pytest.raises(ValueError, match=".pth"):
        load_engine(str(tmp_path / "m.msgpack"), device="cpu")


def test_kernel_wrappers_take_plain_version_only_on_cpu(monkeypatch):
    """A CPU tensor runs the plain version and counts no launch; the
    kernel library is never built for it."""
    from unetdc_tpu_torch.ops import cuda_build as cb
    from unetdc_tpu_torch.ops import fused_conv as fc
    from unetdc_tpu_torch.ops.component_tables import component_tables

    def no_build():
        raise AssertionError("built the CUDA library for a CPU tensor")

    monkeypatch.setattr(cb, "lib", no_build)
    cb.reset_launches()
    x = torch.rand(1, 4, 4, 64)
    fc.conv3x3_relu_pool(x, torch.rand(3, 3, 64, 64), torch.rand(64))
    component_tables(torch.zeros(1, 4, 4, dtype=torch.int32))
    assert sum(cb.LAUNCHES.values()) == 0


def test_build_needs_nvcc(monkeypatch, tmp_path):
    from unetdc_tpu_torch.ops import cuda_build as cb

    monkeypatch.setattr(cb, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(cb.shutil, "which", lambda name: None)
    monkeypatch.setattr(cb, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cb.build()
    assert len(cb.source_hash()) == 16
