"""The CLI's `host_decode` stage timer (utils/profiling.stage_totals), ms
per image: PNG decode on the prefetch thread."""

from harness.reduce import stage_ms_per_image


def read(view):
    return stage_ms_per_image(view, "host_decode")
