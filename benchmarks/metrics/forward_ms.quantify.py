"""Device time of the megastep's forward with K1/K2 (the program's device
span `dev.forward`, CUDA events), ms per megastep."""

from harness.program_trace import mean_ms


def read(view):
    return mean_ms(view, "dev.forward")
