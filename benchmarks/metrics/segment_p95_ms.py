"""95th percentile of the host-clock time of every library call in the
window (the mask returned on the host)."""

import numpy as np


def read(view):
    ms = [r["ms"] for r in view["records"]]
    return float(np.percentile(ms, 95)) if ms else None
