"""The engine's `megastep_ms` (CUDA events around each batch's megastep,
the propagation's host syncs included): mean over every batch."""

from harness.reduce import megastep_ms


def read(view):
    return megastep_ms(view)
