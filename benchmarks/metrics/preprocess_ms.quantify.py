"""Device time of the megastep's first stage, rolling ball and the resize
in (the program's device span `dev.preprocess`, CUDA events), ms per
megastep."""

from harness.program_trace import mean_ms


def read(view):
    return mean_ms(view, "dev.preprocess")
