"""The 95th percentile of the latency of all requests in the window, in
ms (numpy's linear rule)."""

import numpy as np


def read(c):
    lat = c.window.latency
    return float(np.percentile(np.asarray(lat, np.float64), 95)) * 1e3 if lat else None
