"""End to end: the port's batch quantifier (f32, on the CPU) against the JAX
package's on the same decisive checkpoints and images (the fixture of
tests/test_pipeline_e2e.py). Per-image and master CSVs must be byte-equal
and the decoded mask PNGs pixel-equal. Also: the port CLI runs in-process
on the CPU, and refuses to run without a GPU unless asked for the CPU.
"""

import numpy as np
import pytest
import torch

from tests.torch_reference import make_decisive_checkpoint

IMG_SIZE = 64
PX_PER_UM = 3.45


@pytest.fixture(scope="module", params=[0, 11])
def ckpt(tmp_path_factory, request):
    path = tmp_path_factory.mktemp("ckpt") / f"ref{request.param}.pth"
    make_decisive_checkpoint(str(path), seed=request.param, img_size=IMG_SIZE)
    return str(path)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    rng = np.random.RandomState(7)
    d = tmp_path_factory.mktemp("imgs")
    yy, xx = np.mgrid[:96, :112]
    for i in range(3):
        img = (rng.rand(96, 112, 3) * 60).astype(np.uint8)
        for _ in range(6):
            cy, cx = rng.randint(10, 86), rng.randint(10, 102)
            r = rng.randint(3, 9)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
            img[blob] = np.minimum(img[blob] + 180, 255)
        Image.fromarray(img).save(d / f"img{i:02d}.png")
    # a second original size: a grayscale-as-RGB image
    g = (rng.rand(80, 72) * 200).astype(np.uint8)
    Image.fromarray(np.stack([g] * 3, -1)).save(d / "img99.png")
    return str(d)


def _run_jax(ckpt, image_dir, out):
    from unetdc_tpu.pipelines.engine import load_engine
    from unetdc_tpu.pipelines.quantify_batch import BatchQuantifyPipeline

    engine = load_engine(ckpt, fast=False)
    engine.img_size = IMG_SIZE
    pipe = BatchQuantifyPipeline(
        engine, str(out), batch=2, prob_thresh=0.3, min_area=2,
        px_per_micron=PX_PER_UM, save_overlays=True, background_radius=20)
    pipe.run(image_dir, progress=False)
    pipe.write_reports(skip_histogram=True)


def _run_port(ckpt, image_dir, out):
    from unetdc_tpu_torch.pipelines.engine import load_engine
    from unetdc_tpu_torch.pipelines.quantify_batch import BatchQuantifyPipeline

    engine = load_engine(ckpt, fast=False, device="cpu")
    engine.img_size = IMG_SIZE
    pipe = BatchQuantifyPipeline(
        engine, str(out), batch=2, prob_thresh=0.3, min_area=2,
        px_per_micron=PX_PER_UM, save_overlays=True, background_radius=20)
    pipe.run(image_dir, progress=False)
    pipe.write_reports(skip_histogram=True)
    return engine


def test_port_pipeline_matches_jax(ckpt, image_dir, tmp_path):
    from PIL import Image

    from unetdc_tpu_torch.pipelines.quantify_batch import list_images

    _run_jax(ckpt, image_dir, tmp_path / "jax")
    engine = _run_port(ckpt, image_dir, tmp_path / "port")
    assert engine.device.type == "cpu"
    for name in ("summary_per_image.csv", "all_droplets.csv",
                 "all_droplets_noexcel.csv", "droplet_size_stats.csv"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    n_droplets = 0
    for p in list_images(image_dir):
        a = (tmp_path / "port" / f"{p.stem}_droplets.csv").read_bytes()
        b = (tmp_path / "jax" / f"{p.stem}_droplets.csv").read_bytes()
        assert a == b, p.name
        n_droplets += a.count(b"\n") - 1
        ma = np.array(Image.open(tmp_path / "port" / "predicted_masks"
                                 / f"{p.stem}_pred.png"))
        mb = np.array(Image.open(tmp_path / "jax" / "predicted_masks"
                                 / f"{p.stem}_pred.png"))
        np.testing.assert_array_equal(ma, mb, err_msg=p.name)
        ov = tmp_path / "port" / "overlays" / f"{p.stem}_overlay.png"
        assert np.array(Image.open(ov)).shape == (*ma.shape, 3)
    assert n_droplets > 0  # the fixture really segments something


def test_engine_overflow_rerun_matches_large_cap(ckpt):
    """Exceeding max_labels re-runs the batch at a doubled cap; results
    equal a large-cap engine's exactly."""
    from unetdc_tpu_torch.checkpoint import load_pth_state_dict
    from unetdc_tpu_torch.pipelines.engine import QuantifyEngine

    sd = load_pth_state_dict(ckpt)
    rng = np.random.RandomState(9)
    imgs = (rng.rand(2, 96, 112, 3) * 60).astype(np.uint8)
    yy, xx = np.mgrid[:96, :112]
    for b in range(2):
        for _ in range(8):
            cy, cx = rng.randint(10, 86), rng.randint(10, 102)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.randint(3, 9) ** 2
            imgs[b][blob] = np.minimum(imgs[b][blob] + 180, 255)
    kw = dict(prob_thresh=0.3, min_area=1, background_radius=20)
    big = QuantifyEngine(sd, compute_dtype=torch.float32, max_labels=4096,
                         img_size=IMG_SIZE, device="cpu")
    out_big = big.run_batch(imgs, (96, 112), **kw)
    assert int(out_big["total"].max()) > 2
    small = QuantifyEngine(sd, compute_dtype=torch.float32, max_labels=2,
                           img_size=IMG_SIZE, device="cpu")
    out_small = small.run_batch(imgs, (96, 112), **kw)
    np.testing.assert_array_equal(out_small["mask"], out_big["mask"])
    for k in ("count", "total"):
        np.testing.assert_array_equal(out_small[k], out_big[k])
    for i in range(2):
        n = int(out_big["count"][i])
        for k in ("area", "sum-0-lo", "sum-1-lo"):
            np.testing.assert_array_equal(out_small[k][i][:n],
                                          out_big[k][i][:n], err_msg=k)
    with pytest.raises(RuntimeError, match="max_labels"):
        small.fetch_batch({k: torch.from_numpy(v) for k, v in
                           out_big.items()}, (96, 112))


def test_cli_smoke_cpu(tmp_path, image_dir):
    """The port CLI in-process at the reference's 512 input, on the CPU:
    the whole artifact tree appears."""
    from unetdc_tpu_torch.cli.quantify_droplets_batch import main

    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=3, img_size=32)
    out = tmp_path / "out"
    main(["--img_dir", image_dir, "--ckpt_path", str(ckpt), "--out_dir",
          str(out), "--batch", "4", "--device", "cpu", "--precision", "f32",
          "--save_overlays", "--px_per_micron", "2.0", "--skip_histogram"])
    for name in ("summary_per_image.csv", "all_droplets.csv",
                 "all_droplets_noexcel.csv"):
        assert (out / name).exists(), name
    for stem in ("img00", "img01", "img02", "img99"):
        assert (out / "predicted_masks" / f"{stem}_pred.png").exists()
        assert (out / f"{stem}_droplets.csv").exists()
        assert (out / "overlays" / f"{stem}_overlay.png").exists()


def test_cli_without_cpu_flag_raises_on_cpu_host(tmp_path, image_dir,
                                                 monkeypatch):
    from unetdc_tpu_torch.cli.quantify_droplets_batch import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = tmp_path / "m.pth"
    make_decisive_checkpoint(str(ckpt), seed=3, img_size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--img_dir", image_dir, "--ckpt_path", str(ckpt),
              "--out_dir", str(tmp_path / "out")])
