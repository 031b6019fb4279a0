"""The main thread of the batch CLI waiting for a decoded image (the
program span `quantify.image_wait`, the decode Prefetcher's next()), ms
per image written."""

from harness.program_trace import images_written, spans, total_ms


def read(view):
    got, n = spans(view, "quantify.image_wait"), images_written(view)
    return total_ms(got) / n if got and n else None
