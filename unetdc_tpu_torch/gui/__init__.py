"""GUI front-ends of the port (the JAX package's `gui` surface).

Both GUIs are thin shells over the port's batch CLI: they build an
argument list and run `python -m unetdc_tpu_torch.cli.quantify_droplets_batch`
in a child process, streaming its stdout (the CLI's stdout format is a
stable API). Toolkits are imported inside `main()`, so headless installs
never load them. `gui/entry.py` is the frozen executable's entry: it
dispatches `--cli <name> ...` in-process before any toolkit loads.
"""

from unetdc_tpu_torch.gui.command import build_batch_command  # noqa: F401
