"""95th percentile of the latencies of the images completed inside the
window (linear interpolation), in ms."""

import numpy as np

SOURCE = "host_clock"


def read(rec):
    if "pixels" not in rec.work or not rec.latencies_s:
        return None
    return 1e3 * float(np.percentile(rec.latencies_s, 95))
