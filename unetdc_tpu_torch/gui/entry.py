"""Entry point of a frozen (one-file) build of the port's Qt GUI; the
counterpart of the JAX package's `packaging/gui_entry.py`.

A frozen app has no `python -m` to spawn, so the executable doubles as the
CLI: the GUI builds worker commands as `<exe> --cli quantify_droplets_batch
...` (`gui/command.py`) and `main` dispatches them in-process before any
toolkit loads. Without `--cli` it starts the Qt GUI.

    python -m unetdc_tpu_torch.gui.entry --cli quantify_droplets_batch ...
    python -m unetdc_tpu_torch.gui.entry [--device {cuda,cpu}]
"""

from __future__ import annotations

import importlib
import sys

_CLI_MODULES = {
    name: f"unetdc_tpu_torch.cli.{name}"
    for name in ("quantify_droplets_batch", "quantify_pipline", "quantify",
                 "train", "train_dc_focal")
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--cli"]:
        name = argv[1] if len(argv) >= 2 else ""
        mod_name = _CLI_MODULES.get(name)
        if mod_name is None:
            sys.stderr.write(
                f"unknown --cli target {name!r}; valid: "
                f"{', '.join(sorted(_CLI_MODULES))}\n")
            raise SystemExit(2)
        importlib.import_module(mod_name).main(argv[2:])
        return

    from unetdc_tpu_torch.gui.qt_app import main as gui_main

    gui_main(argv)


if __name__ == "__main__":
    main()
