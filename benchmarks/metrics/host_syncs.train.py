"""Points where the training loop's host thread blocks on the device (the
program counter `host_syncs`), per step (`train.step`); 0 when none."""

from harness.program_trace import count_per_unit


def read(view):
    return count_per_unit(view, "host_syncs", "train.step",
                          none_is_zero=True)
