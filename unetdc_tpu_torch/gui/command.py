"""CLI command construction shared by both GUIs; the port's copy of the
JAX package's `gui/command.py`, targeting the port's batch CLI module."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from unetdc_tpu_torch.device import resolve_device


def gui_device(argv=None) -> str:
    """The GUIs' `--device {cuda,cpu}` (default cuda), checked at start:
    without a GPU the default raises now, as the CLI would, rather than
    let every run fail (or quietly use the CPU)."""
    p = argparse.ArgumentParser("Droplet quantifier GUI")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the quantifier runs (default: the GPU)")
    device = p.parse_known_args(argv)[0].device  # Qt keeps its own flags
    resolve_device(device)
    return device


def build_batch_command(
    img_dir: str,
    ckpt_path: str,
    out_dir: str,
    batch: int = 8,
    prob_thresh: float = 0.3,
    min_area: int = 1,
    px_per_micron: Optional[float] = None,
    save_overlays: bool = False,
    background_radius: int = 50,
    skip_excel: bool = False,
    skip_histogram: bool = False,
    python: Optional[str] = None,
    device: str = "cuda",
) -> List[str]:
    """Validated argv for the port's batch quantification CLI: the JAX
    package's argv with the module swapped and `--device <device>` last.

    A PyInstaller one-file build has no `python -m` to spawn, so the
    frozen executable re-invokes itself with a `--cli <name>` prefix that
    `gui/entry.py` dispatches in-process."""
    if not img_dir:
        raise ValueError("Images folder is required")
    if not ckpt_path:
        raise ValueError("Checkpoint path is required")
    if python is None and getattr(sys, "frozen", False):
        head = [sys.executable, "--cli", "quantify_droplets_batch"]
    else:
        head = [python or sys.executable, "-m",
                "unetdc_tpu_torch.cli.quantify_droplets_batch"]
    cmd = head + [
        "--img_dir", str(img_dir),
        "--ckpt_path", str(ckpt_path),
        "--out_dir", str(out_dir),
        "--batch", str(int(batch)),
        "--prob_thresh", str(prob_thresh),
        "--min_area", str(int(min_area)),
        "--background_radius", str(int(background_radius)),
    ]
    if px_per_micron is not None:
        cmd += ["--px_per_micron", str(px_per_micron)]
    if save_overlays:
        cmd.append("--save_overlays")
    if skip_excel:
        cmd.append("--skip_excel")
    if skip_histogram:
        cmd.append("--skip_histogram")
    return cmd + ["--device", str(device)]
