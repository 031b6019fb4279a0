"""Shared machinery: where things are, how a name finds its file, seeds,
host spans, and the device record of a run."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "unetdc_tpu")


def load_json(kind: str, name: str) -> Dict:
    """benchmarks/<kind>/<name>.json."""
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """benchmarks/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_json() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def sub_seed(seed: int, stream: int) -> int:
    """A 62-bit seed of its own for each stream of a run's seed."""
    import numpy as np

    ss = np.random.SeedSequence([int(seed) % (1 << 64), 7919, stream])
    a, b = ss.generate_state(2)
    return ((int(a) << 32) | int(b)) >> 2


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (so `unetdc_tpu_torch` is not `unetdc_tpu`)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


class Spans:
    """Host spans (name, start, end on time.perf_counter), from any
    thread."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.items.append((name, t0, t1))

    def wrap(self, owner, attr: str, name: str):
        """Replace owner.attr by a version that records a span per call;
        returns an undo function."""
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            with self.span(name):
                return orig(*a, **k)

        setattr(owner, attr, wrapped)
        return lambda: setattr(owner, attr, orig)


class Context:
    """What an entry sees: the cell's workload and configuration, the
    run's seed, the device, a scratch directory under TMPDIR, host spans,
    and `keep` for what the check needs once the program's state is
    gone."""

    def __init__(self, workload: Dict, config: Dict, seed: int, device,
                 tmp: Path):
        self.workload = workload
        self.config = config
        self.seed = seed
        self.device = device
        self.tmp = tmp
        self.spans = Spans()
        self.keep: Dict = {}


def card_record(device_index: int = 0) -> Dict:
    """Name and power limit of the card, for the record."""
    import torch

    rec = {"kind": torch.cuda.get_device_name(device_index)}
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        rec["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        rec["power_limit"] = "unknown"
    return rec
