"""The CLI's `host_write_artifacts` stage timer, ms per image: masks,
droplet tables and their queueing on the writer threads."""

from harness.reduce import stage_ms_per_image


def read(view):
    return stage_ms_per_image(view, "host_write_artifacts")
