"""Package rules of the port: it imports neither jax nor the JAX package,
and its entry points refuse to fall back to the CPU silently."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Import every module of unetdc_tpu_torch, plus chip_smoke.py, in a
    fresh interpreter: neither jax (flax, optax) nor unetdc_tpu may be
    loaded, nor sklearn or msgpack: the port carries its own split and
    msgpack codec."""
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
                                    "unetdc_tpu", "sklearn", "msgpack"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 68, names
for n in ("losses", "data.augment", "data.dataset", "train.trainer",
          "train.test_phase", "utils.summary", "cli.train",
          "cli.train_dc_focal", "checkpoint.native", "ops.diffmap",
          "ops.filters", "models.unet_int8", "ops.threshold", "ops.roi",
          "ops.density", "ops.contours", "pipelines.heatmaps",
          "cli.quantify_pipline", "cli.quantify", "core.mesh",
          "utils.profiling", "library", "io.native", "ops.bitdepth",
          "ops.blobs", "ops.edt", "ops.watershed", "ops.regionprops",
          "utils.int8_trained_eval", "utils.native_build", "gui",
          "gui.command", "gui.entry", "gui.qt_app", "gui.tk_app",
          "utils.device_profile", "utils.forward_profile",
          "utils.epoch_wall"):
    assert "unetdc_tpu_torch." + n in names, n
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


def test_engine_loads_jax_msgpack_checkpoint(tmp_path):
    """A msgpack checkpoint written by the JAX package's save_checkpoint
    loads into the port's engine (CPU), and its masks and droplet tables
    equal those of the same weights loaded as a .pth."""
    import numpy as np

    from tests.torch_reference import make_decisive_checkpoint
    from unetdc_tpu.checkpoint import (load_pth_state_dict,
                                       torch_state_dict_to_variables)
    from unetdc_tpu.checkpoint.native import save_checkpoint
    from unetdc_tpu_torch.pipelines.engine import load_engine

    pth = tmp_path / "m.pth"
    make_decisive_checkpoint(str(pth), seed=2, img_size=32)
    mp = tmp_path / "m.msgpack"
    save_checkpoint(str(mp), torch_state_dict_to_variables(
        load_pth_state_dict(str(pth))))
    r = np.random.RandomState(0)
    imgs = (r.rand(2, 40, 48, 3) * 255).astype(np.uint8)
    out = []
    for path in (pth, mp):
        eng = load_engine(str(path), fast=False, device="cpu")
        eng.img_size = 32
        out.append(eng.run_batch(imgs, (40, 48), background_radius=5))
    assert out[0]["mask"].any() and not out[0]["mask"].all()
    for k in out[0]:
        np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=k)
    pth.unlink()
    mp.unlink()


@pytest.mark.parametrize("which", ["trainer", "train_dc_focal", "train"])
def test_train_entry_points_default_to_cuda(monkeypatch, tmp_path, which):
    """Trainer and both train CLIs run on the card unless asked, and raise
    (no CPU fallback) when there is none, also on a mesh
    (--data_parallel); with --device cpu both CLIs train on a CPU mesh and
    write the checkpoint files (train_dc_focal with its test phase)."""
    import inspect

    from unetdc_tpu_torch.cli import train, train_dc_focal
    from unetdc_tpu_torch.core.mesh import Mesh
    from unetdc_tpu_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if which == "trainer":
        assert inspect.signature(Trainer).parameters["device"].default \
            == "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(TrainConfig(img_size=32))
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(TrainConfig(img_size=32, shard_space=True),
                    mesh=Mesh([["cuda", "cuda"]]), device="cpu")
        return
    cli = {"train": train, "train_dc_focal": train_dc_focal}[which]
    args = cli.build_parser().parse_args(["--image_dir", "x",
                                          "--mask_dir", "y"])
    assert args.device == "cuda"
    from PIL import Image
    import numpy as np

    for sub in ("img", "msk"):
        (tmp_path / sub).mkdir()
        for i in range(5):
            Image.fromarray(np.zeros((8, 8), np.uint8)).save(
                tmp_path / sub / f"{i}.png")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--image_dir", "img", "--mask_dir", "msk",
                  "--img_size", "32"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--image_dir", "img", "--mask_dir", "msk",
                  "--data_parallel", "2"])
    mesh_flags = ["--data_parallel", "2"] + (
        ["--shard_space", "2"] if which == "train_dc_focal" else [])
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # a full-width model
    try:
        trainer = cli.main(["--image_dir", "img", "--mask_dir", "msk",
                            "--img_size", "32", "--epochs", "1", "--batch",
                            "2", "--precision", "f32", "--no_augment",
                            "--device", "cpu"] + mesh_flags)
    finally:
        torch.set_num_threads(threads)
    sharded = which == "train_dc_focal"
    assert trainer.mesh.shape == {"data": 2, "space": 2 if sharded else 1}
    assert trainer.cfg.shard_space == sharded
    defaults = cli.build_parser().parse_args(["--image_dir", "x",
                                              "--mask_dir", "y"])
    ck = defaults.ckpt_path
    if sharded:  # the test phase ran under the mesh
        assert any((tmp_path / defaults.overlay_dir).iterdir())
    for suffix in ("", ".meta.json", ".opt", ".last", ".state.json"):
        assert (tmp_path / (ck + suffix)).exists(), suffix
    for p in tmp_path.glob(ck + "*"):       # ~0.75 GB of checkpoints
        p.unlink()


@pytest.mark.parametrize("cli", ["train_dc_focal", "train"])
def test_train_clis_data_parallel_needs_the_cards(monkeypatch, tmp_path,
                                                  cli):
    """--device cuda --data_parallel 2 on a host with one card raises the
    mesh's error before any training; nothing runs on the CPU instead."""
    import importlib

    from unetdc_tpu_torch.train import trainer as T

    def no_trainer(*a, **k):
        raise AssertionError("a trainer was built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(T.Trainer, "__init__", no_trainer)
    mod = importlib.import_module(f"unetdc_tpu_torch.cli.{cli}")
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        mod.main(["--image_dir", str(tmp_path), "--mask_dir", str(tmp_path),
                  "--data_parallel", "2"])


@pytest.mark.parametrize("cli", ["quantify_pipline", "quantify"])
def test_heatmap_clis_default_to_cuda(monkeypatch, tmp_path, cli):
    """Both heatmap CLIs run on the card unless asked, and raise (no CPU
    fallback) when there is none, also with --data_parallel (the mesh
    finds no card)."""
    import importlib

    from PIL import Image
    import numpy as np

    from tests.torch_reference import make_decisive_checkpoint

    mod = importlib.import_module(f"unetdc_tpu_torch.cli.{cli}")
    base = ["--img_dir", str(tmp_path / "img"), "--px_per_micron", "2"]
    assert mod.build_parser().parse_args(base).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "img").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        tmp_path / "img" / "a.png")
    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=1, img_size=32)
    argv = base + ["--ckpt_path", str(ckpt), "--out_dir",
                   str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        mod.main(argv + ["--data_parallel", "2"])


INFERENCE_CLIS = ["quantify_droplets_batch", "quantify_pipline", "quantify"]


def _small_engines(monkeypatch):
    """The CLIs build 512-input engines, seconds an image on the CPU; the
    CLI tests run them at 32."""
    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine

    init = QuantifyEngine.__init__

    def small(self, *a, **k):
        init(self, *a, **k)
        self.img_size = 32

    monkeypatch.setattr(QuantifyEngine, "__init__", small)


@pytest.mark.parametrize("cli", INFERENCE_CLIS)
def test_inference_clis_run_data_parallel_on_cpu(monkeypatch, tmp_path,
                                                 cli):
    """--data_parallel 2 --device cpu splits each batch over two CPU mesh
    slots and writes the same CSVs as the one-device run."""
    import importlib

    import numpy as np
    from PIL import Image

    from tests.torch_reference import make_decisive_checkpoint

    if cli != "quantify_droplets_batch":
        pytest.importorskip("matplotlib")
    _small_engines(monkeypatch)
    mod = importlib.import_module(f"unetdc_tpu_torch.cli.{cli}")
    rng = np.random.RandomState(4)
    (tmp_path / "img").mkdir()
    yy, xx = np.mgrid[:40, :48]
    for i in range(5):
        img = (rng.rand(40, 48, 3) * 60).astype(np.uint8)
        blob = (yy - rng.randint(8, 32)) ** 2 + (xx - rng.randint(8, 40)) \
            ** 2 <= rng.randint(3, 8) ** 2
        img[blob] = 240
        Image.fromarray(img).save(tmp_path / "img" / f"a{i}.png")
    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=1, img_size=32)
    runs = []
    for dp in ([], ["--data_parallel", "2"]):
        out = tmp_path / f"out{len(runs)}"
        pipe = mod.main(["--img_dir", str(tmp_path / "img"), "--ckpt_path",
                         str(ckpt), "--out_dir", str(out), "--batch", "4",
                         "--device", "cpu", "--px_per_micron", "2.0"]
                        + (["--skip_histogram"]
                           if cli == "quantify_droplets_batch" else [])
                        + dp)
        runs.append((out, pipe.engine))
    assert runs[0][1].mesh is None
    assert runs[1][1].mesh.shape == {"data": 2, "space": 1}
    csvs = sorted(p.name for p in runs[0][0].glob("*.csv"))
    assert len(csvs) >= 5
    for name in csvs:
        assert (runs[1][0] / name).read_bytes() == \
            (runs[0][0] / name).read_bytes(), name


@pytest.mark.parametrize("cli", INFERENCE_CLIS)
def test_inference_clis_data_parallel_needs_the_cards(monkeypatch, tmp_path,
                                                      cli):
    """--device cuda --data_parallel 2 on a host with one card raises the
    mesh's error; nothing runs on the CPU instead."""
    import importlib

    from unetdc_tpu_torch.pipelines import engine as E

    def no_engine(*a, **k):
        raise AssertionError("an engine was built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(E.QuantifyEngine, "__init__", no_engine)
    mod = importlib.import_module(f"unetdc_tpu_torch.cli.{cli}")
    (tmp_path / "img").mkdir()
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        mod.main(["--img_dir", str(tmp_path / "img"), "--px_per_micron",
                  "2.0", "--data_parallel", "2", "--out_dir",
                  str(tmp_path / "out")])


def test_kernel_wrappers_take_plain_version_only_on_cpu(monkeypatch):
    """A CPU tensor runs the plain version and counts no launch; the
    kernel library is never built for it."""
    from unetdc_tpu_torch.ops import cuda_build as cb
    from unetdc_tpu_torch.ops import fused_conv as fc
    from unetdc_tpu_torch.ops.component_tables import component_tables
    from unetdc_tpu_torch.ops.rolling_ball import rolling_ball_correction

    def no_build():
        raise AssertionError("built the CUDA library for a CPU tensor")

    monkeypatch.setattr(cb, "lib", no_build)
    cb.reset_launches()
    x = torch.rand(1, 4, 4, 64)
    fc.conv3x3_relu_pool(x, torch.rand(3, 3, 64, 64), torch.rand(64))
    component_tables(torch.zeros(1, 4, 4, dtype=torch.int32))
    rolling_ball_correction(torch.zeros(2, 1, 9, 7, dtype=torch.uint8), 5)
    assert sum(cb.LAUNCHES.values()) == 0


def test_build_needs_nvcc(monkeypatch, tmp_path):
    from unetdc_tpu_torch.ops import cuda_build as cb

    monkeypatch.setattr(cb, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(cb.shutil, "which", lambda name: None)
    monkeypatch.setattr(cb, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cb.build()
    assert len(cb.source_hash()) == 16


LIBRARY_CALLS = [
    ("segmentation_deep_learning", lambda L, ck, **k:
     L.segmentation_deep_learning(np.zeros((8, 8), np.uint8), ck, **k)),
    ("rolling_ball", lambda L, ck, **k:
     L.rolling_ball(np.zeros((8, 8), np.float32), 2, **k)),
    ("blobs_detection", lambda L, ck, **k:
     L.blobs_detection(np.zeros((24, 24), np.float32), 1, 2, 3, **k)),
    ("watershed_custom", lambda L, ck, **k:
     L.watershed_custom(np.pad(np.ones((66, 66), bool), 2), [[9, 9]],
                        **k)),
    ("labeling_custom", lambda L, ck, **k:
     L.labeling_custom(np.ones((8, 8), bool), [[1, 1]], **k)),
    ("remove_objects", lambda L, ck, **k:
     L.remove_objects(np.ones((8, 8), bool), 2, **k)),
    ("contour_scan", lambda L, ck, **k:
     L.contour_scan(np.ones((8, 8), np.float32), 0.5, **k)),
    ("density_map", lambda L, ck, **k:
     L.density_map(np.ones((8, 8), bool), np.ones((8, 8), bool), 3, **k)),
]


@pytest.mark.parametrize("name,call", LIBRARY_CALLS,
                         ids=[n for n, _ in LIBRARY_CALLS])
def test_library_entry_points_default_to_cuda(monkeypatch, tmp_path, name,
                                              call):
    """Library functions keep the reference's positional signature, take
    a keyword-only device defaulting to "cuda", raise without a card and
    run with device="cpu"."""
    import inspect

    import numpy as np  # noqa: F811

    from tests.torch_reference import make_decisive_checkpoint
    from unetdc_tpu_torch import library as L

    param = inspect.signature(getattr(L, name)).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default == "cuda"
    ckpt = None
    if name == "segmentation_deep_learning":
        ckpt = str(tmp_path / "m.pth")
        make_decisive_checkpoint(ckpt, seed=1, img_size=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(L, ckpt)
    if name != "segmentation_deep_learning":  # full width at 512: slow
        call(L, ckpt, device="cpu")


def _tree(d: Path) -> dict:
    return {p.relative_to(d): p.stat().st_mtime_ns for p in d.rglob("*")}


def test_native_libraries_build_outside_native(monkeypatch, tmp_path):
    """io/native and ops/watershed build their libraries from the tracked
    sources into unetdc_tpu_torch/_build/native/ (here a temporary one)
    and never write into native/: libfastio always (its .so is not
    tracked), libalgo when the tracked .so does not load."""
    from scipy import ndimage

    from unetdc_tpu_torch.io import native as N
    from unetdc_tpu_torch.ops import watershed as W
    from unetdc_tpu_torch.utils import native_build as NB

    before = _tree(NB.NATIVE_DIR)
    monkeypatch.setattr(NB, "BUILD_DIR", tmp_path / "native")
    N._load.cache_clear()
    W._load_algo.cache_clear()
    real_load = NB.load
    monkeypatch.setattr(NB, "load", lambda name, libs=(), prebuilt=None:
                        real_load(name, libs, prebuilt=None))
    try:
        assert N.native_available()
        assert W._load_algo() is not None
        built = sorted(p.name for p in (tmp_path / "native").iterdir())
        assert [n.split("-")[0] for n in built] == ["libalgo", "libfastio"]
        assert all(n.endswith(".so") for n in built)
        m = np.zeros((30, 30), bool)
        m[5:25, 5:12] = m[5:25, 15:25] = True
        h = -ndimage.distance_transform_edt(m)
        mk = np.zeros((30, 30), np.int32)
        mk[15, 8], mk[15, 20] = 1, 2
        np.testing.assert_array_equal(W.watershed(h, mk, m),
                                      W.watershed_python(h, mk, m))
    finally:
        N._load.cache_clear()
        W._load_algo.cache_clear()
    assert _tree(NB.NATIVE_DIR) == before


def _fake_native(monkeypatch, tmp_path, sources):
    """native_build pointed at tmp sources and a tmp build directory, with
    a count of the compiler runs."""
    import subprocess

    from unetdc_tpu_torch.utils import native_build as NB

    src = tmp_path / "src"
    src.mkdir()
    for name, text in sources.items():
        (src / f"{name}.cpp").write_text(text)
    monkeypatch.setattr(NB, "NATIVE_DIR", src)
    monkeypatch.setattr(NB, "BUILD_DIR", tmp_path / "build")
    runs = []
    real_run = subprocess.run

    def run(*a, **k):
        runs.append(a[0])
        return real_run(*a, **k)

    monkeypatch.setattr(NB.subprocess, "run", run)
    return NB, runs


def test_native_build_failure_is_remembered(monkeypatch, tmp_path):
    """A source that does not compile leaves a `.failed` marker; the next
    load (another process, here a fresh call) returns None without
    running the compiler again."""
    NB, runs = _fake_native(monkeypatch, tmp_path,
                            {"broken": "this is not C++\n"})
    assert NB.load("broken") is None
    assert len(runs) == 1
    files = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert len(files) == 1 and files[0].endswith(".failed")
    assert NB.load("broken") is None
    assert len(runs) == 1


def test_native_build_concurrent_threads(monkeypatch, tmp_path):
    """Threads that load one library at once get it built once, each a
    working handle, and leave no temporary file behind."""
    from concurrent.futures import ThreadPoolExecutor

    NB, runs = _fake_native(monkeypatch, tmp_path, {
        "tiny": 'extern "C" int seven() { return 7; }\n'})

    @NB.once
    def loader():
        return NB.load("tiny")

    with ThreadPoolExecutor(4) as ex:
        libs = list(ex.map(lambda _: loader(), range(8)))
    assert all(lib is not None and lib.seven() == 7 for lib in libs)
    assert len({id(lib) for lib in libs}) == 1
    assert len(runs) == 1
    files = [p.name for p in (tmp_path / "build").iterdir()]
    assert len(files) == 1 and files[0].endswith(".so")


def _main_calls(tmp_path):
    """(name, call) of the GUIs' and the profilers' entry points at their
    default device; the CLI dispatch gets a real checkpoint, since the
    engine loads it before it takes the device."""
    from tests.torch_reference import make_decisive_checkpoint
    from unetdc_tpu_torch.gui import entry, qt_app, tk_app
    from unetdc_tpu_torch.utils import (device_profile, epoch_wall,
                                        forward_profile)

    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=1, img_size=32)
    (tmp_path / "img").mkdir()
    return {
        "qt_app": lambda: qt_app.main([]),
        "tk_app": lambda: tk_app.main([]),
        "entry_gui": lambda: entry.main([]),
        "entry_cli": lambda: entry.main([
            "--cli", "quantify_droplets_batch", "--img_dir",
            str(tmp_path / "img"), "--ckpt_path", str(ckpt), "--out_dir",
            str(tmp_path / "out")]),
        "device_profile": lambda: device_profile.main(["--size", "32"]),
        "forward_profile": lambda: forward_profile.main(["--size", "32"]),
        "epoch_wall": lambda: epoch_wall.main(n_train=2, n_val=2, size=32),
    }


MAINS = ["qt_app", "tk_app", "entry_gui", "entry_cli", "device_profile",
         "forward_profile", "epoch_wall"]


@pytest.mark.parametrize("name", MAINS)
def test_gui_and_profiler_mains_default_to_cuda(monkeypatch, tmp_path,
                                                name):
    """Both GUIs, the frozen entry (GUI and `--cli` dispatch) and the three
    profilers run on the card unless asked, and raise without one before
    any window, dataset or run: nothing falls back to the CPU."""
    import tests.fake_pyside6 as fake

    fake.install(monkeypatch)
    call = _main_calls(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert fake.created_main_windows == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["img", "m.pth"]
