"""Host time the device did not hide, per request: the traced window
less the union of the device's busy intervals, over the requests, in
ms. The log also gives it for the requests at or over the 95th
percentile of the traced latencies, the ones that set the tail."""

import numpy as np


def read(c):
    t = c.trace
    if t is None or not t.requests:
        return None
    req = np.asarray(t.exposed(), np.float64)
    tail = req[req[:, 0] >= np.percentile(req[:, 0], 95)]
    c.notes.append(f"host exposed in the {len(tail)} requests at or over the traced p95: "
                   f"{tail[:, 1].mean() * 1e3:.3f} ms of their {tail[:, 0].mean() * 1e3:.3f} ms")
    return (t.window_s - t.busy_s) / t.requests * 1e3
