"""The engine set-up of each CLI call (the program span `engine.load`:
checkpoint read, BatchNorm fold, parameter build and upload), ms per CLI
call (`quantify.call`)."""

from harness.program_trace import per_unit


def read(view):
    return per_unit(view, "engine.load", "quantify.call")
