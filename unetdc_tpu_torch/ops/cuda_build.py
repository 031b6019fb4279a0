"""Build and load the port's CUDA kernels (`unetdc_tpu_torch/csrc/*.cu`).

The sources have a plain C interface (no PyTorch headers), so each compiles
in seconds: one `nvcc -c` per source, all started together, then one link
into a shared library that is loaded with ctypes. The library lands in
`unetdc_tpu_torch/_build/<hash>/`, keyed on a hash of the sources and the
flags, so a checkout builds once at first use and rebuilds after any source
change. Nothing here runs at import time: the CPU tests import every module
on a host without nvcc.

Each kernel wrapper counts its launches in `LAUNCHES` (one per launch,
nowhere else), so a run can show that the main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "libunetdc_kernels.so"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's usual home

LAUNCHES: Counter = Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "k1_conv3x3_relu_pool_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "k1_conv3x3_relu_pool_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "k2_dec1_head_bf16": [_P] * 11 + [_I, _I, _I, _P],
    "k2_dec1_head_f32": [_P] * 11 + [_I, _I, _I, _P],
    "k3_component_tables": [_P, _P, _I, _I, _I, _I, ctypes.c_uint64, _I,
                            _I, _P],
    "k3_cluster_max_cap": [_I],
}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), NVCC_DEFAULT):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns its
    path. A finished build is reused."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs, errors = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
            objs.append(str(obj))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp / LIB_NAME)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        out_dir.parent.mkdir(parents=True, exist_ok=True)
        try:
            os.replace(tmp, out_dir)
        except OSError:  # another process finished the same build first
            if not lib_path.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launcher returned a nonzero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
