"""The trainer waiting for its next batch (the program span
`train.data_wait`, the batch Prefetcher's next()), ms per step."""

from harness.program_trace import mean_ms


def read(view):
    return mean_ms(view, "train.data_wait")
