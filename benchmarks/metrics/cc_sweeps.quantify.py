"""Sweeps of the connected-components propagation, each ending in one host
sync (the program counter `cc.sweeps`), per batch dispatched
(`quantify.dispatch`)."""

from harness.program_trace import count_per_unit


def read(view):
    return count_per_unit(view, "cc.sweeps", "quantify.dispatch")
