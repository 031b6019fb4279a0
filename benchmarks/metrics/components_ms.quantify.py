"""Device time of the megastep's last stage: threshold, mask resize,
labelling with its per-sweep host syncs, K3 tables and assembly (the
program's device span `dev.components`, CUDA events), ms per megastep."""

from harness.program_trace import mean_ms


def read(view):
    return mean_ms(view, "dev.components")
