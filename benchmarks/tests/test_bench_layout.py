"""BENCHMARK.json against the limits of its format, and the harness finding
every cell, configuration, entry and metric by name."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from bench_small import BENCH, ROOT, core

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmarks"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_references():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert all(w["chips"] == 1 for w in cells.values())
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == \
        len(cells)
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).exists()
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in cells.values())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files_and_metrics(cell):
    import run

    wl = core.load_json("workloads", cell)
    assert wl["name"] == cell
    assert (BENCH / "entries" / f"{wl['entry']}.py").exists()
    assert core.load_json("configs", wl["config"])["name"] == wl["config"]
    e2e, layer = run.cell_metrics(cell, SPEC)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for name in e2e + layer:
        if name != "setup_s":
            assert hasattr(core.load_module("metrics", name), "read")


def test_an_added_cell_and_metric_need_no_edit(tmp_path, monkeypatch):
    """A new cell (a workload file), a new per-layer metric (a reader
    file) and their BENCHMARK.json entries run in a copy of the
    benchmark with no other file changed."""
    import bench_small

    copy = tmp_path / "benchmarks"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    wl = core.load_json("workloads", "unetdc.segment")
    wl["name"] = "unetdc.segment_gray"
    (copy / "workloads" / "unetdc.segment_gray.json").write_text(
        json.dumps(wl))
    (copy / "metrics" / "calls_per_s.segment.py").write_text(
        "def read(view):\n"
        "    return len(view['records']) / view['window_s']\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "unetdc.segment_gray",
                              "config": "unetdc", "traffic": "segment_gray",
                              "chips": 1, "why": "an added cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "unetdc.segment" in m.get("workloads", []):
            m["workloads"].append("unetdc.segment_gray")
    spec["per_layer"].append({"name": "calls_per_s.segment", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "library", "moves": "segment_p95_ms",
                              "workloads": ["unetdc.segment_gray"]})
    monkeypatch.setattr(core, "BENCH", copy)
    small = bench_small.small_workload("unetdc.segment", n=1)
    small["name"] = "unetdc.segment_gray"
    import run
    import time

    res = run.run_cell("unetdc.segment_gray", 7, 0.0, True, device="cpu",
                       spec=spec, workload=small,
                       t_start=time.perf_counter())
    assert res["correct"]
    # the device-trace readers find no trace on the CPU and report nothing
    assert set(res["metrics"]) == {"calls_per_s.segment"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_jax_in_the_sources():
    bad = []
    for path in BENCH.rglob("*.py"):
        for mod in _imports(path):
            if mod.split(".")[0] in core.FORBIDDEN:
                bad.append((str(path), mod))
    assert not bad


def test_no_jax_loaded_by_a_run(tmp_path):
    """Every module of the benchmark imported and one CPU-sized unit of
    each entry run in a fresh process: no jax, jaxlib, flax, optax or
    unetdc_tpu module is loaded (top-level names compared whole)."""
    code = f"""
import sys, pathlib, pytest
sys.path[:0] = [{str(BENCH / 'tests')!r}]
import bench_small
from bench_small import BENCH, core
import run, control
for p in BENCH.rglob('*.py'):
    rel = p.relative_to(BENCH)
    if rel.parts[0] in ('entries', 'metrics'):
        core.load_module(rel.parts[0], p.stem)
    elif rel.parts[0] in ('harness', 'reference', 'traffic', 'flops'):
        __import__('.'.join(rel.with_suffix('').parts))
mp = pytest.MonkeyPatch()
for cell in ('unetdc.segment', 'unetdc.train'):
    bench_small.run_small(cell, mp, n=1)
found = core.forbidden_modules(sys.modules)
assert 'unetdc_tpu_torch' in sys.modules
print('FOUND', found)
sys.exit(1 if found else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=900,
                         env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "FOUND []" in out.stdout


def test_run_exits_without_a_card():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "unetdc.segment", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_with_only_the_benchmark(tmp_path):
    """In a directory with only BENCHMARK.json and benchmarks/, a run (the
    look for a card skipped) fails on the missing program and prints no
    result."""
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.argv = ['run.py']; "
            "sys.path.insert(0, 'benchmarks'); import run; "
            "run.run_cell('unetdc.segment', 1, 0.0, False, device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "unetdc_tpu_torch" in out.stderr


def test_device_time_per_image_reads_the_trace():
    """device_ms_per_img: the traced device busy time over the images
    written; nothing without a trace (a CPU run)."""
    class Trace:
        def busy_s(self):
            return 0.5

    reader = core.load_module("metrics", "device_ms_per_img")
    view = {"records": [{"images": 64}, {"images": 36}], "trace": Trace()}
    assert reader.read(view) == 5.0
    assert reader.read({**view, "trace": None}) is None
    m = {x["name"]: x for x in SPEC["end_to_end"]}["device_ms_per_img"]
    assert m["source"] == "device_trace"
