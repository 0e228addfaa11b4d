"""The 99th percentile (nearest rank) of every request due in the
window, from when it was due to when its answer was on the host; a
request never answered counts as +inf (online cells; host clock)."""
import math

import numpy as np


def read(rec):
    if rec.kind != "open_loop" or rec.latency_s is None \
            or rec.latency_s.size == 0:
        return None
    lat = np.sort(rec.latency_s)
    return float(lat[math.ceil(0.99 * lat.size) - 1]) * 1e3
