"""The library call's input side (the program span `library.prepare`:
float image, grayscale broadcast, the blocking pageable upload, the resize
in), ms per call (`library.call`)."""

from harness.program_trace import per_unit


def read(view):
    return per_unit(view, "library.prepare", "library.call")
