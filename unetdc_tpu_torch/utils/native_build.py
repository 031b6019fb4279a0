"""Build and load the host C++ libraries of `native/` (`fastio.cpp`, the
PNG/JPEG codecs; `algo.cpp`, the priority-flood watershed).

A library is compiled at first use, never at import, with

    g++ -O3 -fPIC -shared -std=c++17 -o <out> native/<name>.cpp <libs>

into `unetdc_tpu_torch/_build/native/lib<name>-<hash>.so` (git-ignored;
the hash covers the source and the command, so an edited source builds
anew). Nothing is written into `native/`. Each build goes to a temporary
file of its own that is renamed into place, so processes and threads that
build at once do not see a half-written library. A build that fails
leaves `lib<name>-<hash>.failed` (the compiler's errors) beside it, and
later processes take that as the answer instead of running the compiler
again; delete the file to retry. `load` and the loaders made with `once`
hold one process-wide lock, so a library is built and bound once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence, TypeVar

NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_LOCK = threading.RLock()
T = TypeVar("T")


def once(fn: Callable[[], T]) -> Callable[[], T]:
    """fn() computed once per process under the module's lock (threads that
    ask at once wait for the first); `.cache_clear()` forgets the result."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper() -> T:
        with _LOCK:
            return cached()

    wrapper.cache_clear = cached.cache_clear
    return wrapper


def build(name: str, libs: Sequence[str] = ()) -> Path:
    """Compile native/<name>.cpp into BUILD_DIR (once per source and
    command) and return the library's path; raises when the compiler is
    missing or fails, now or in an earlier process (the `.failed`
    marker)."""
    src = NATIVE_DIR / f"{name}.cpp"
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    flags = list(CXXFLAGS)
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        [cxx] + flags + list(libs)).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    failed = out.with_suffix(".failed")
    if out.exists():
        return out
    if failed.exists():
        raise RuntimeError(f"building {src.name} failed before; see "
                           f"{failed}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmpname = tempfile.mkstemp(prefix=f"{out.name}.", suffix=".tmp",
                                   dir=BUILD_DIR)
    os.close(fd)
    tmp = Path(tmpname)
    try:
        try:
            r = subprocess.run([cxx, *flags, "-o", str(tmp), str(src),
                                *libs], capture_output=True, text=True,
                               timeout=300)
            err = r.stderr if r.returncode != 0 else None
        except subprocess.TimeoutExpired:
            err = "the compiler ran past 300 s"
        if err is not None:
            failed.write_text(err)
            raise RuntimeError(f"building {src.name} failed:\n{err}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def load(name: str, libs: Sequence[str] = (),
         prebuilt: Optional[Path] = None) -> Optional[ctypes.CDLL]:
    """ctypes handle of `prebuilt` when it loads, else of the library built
    from native/<name>.cpp; None when neither works (callers fall back to
    their Python path, as the JAX package's modules do)."""
    with _LOCK:
        return _load(name, libs, prebuilt)


def _load(name: str, libs: Sequence[str],
          prebuilt: Optional[Path]) -> Optional[ctypes.CDLL]:
    if prebuilt is not None and prebuilt.exists():
        try:
            return ctypes.CDLL(str(prebuilt))
        except OSError:
            pass
    try:
        return ctypes.CDLL(str(build(name, libs)))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
