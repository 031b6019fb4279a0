"""Host time blocked on the device in the training loop (the program's
`sync` spans), ms per step (`train.step`); 0 when none."""

from harness.program_trace import per_unit


def read(view):
    return per_unit(view, "sync", "train.step", none_is_zero=True)
