"""DP cells of every request completed in the window over the window's
time, in billions a second (the cells counted from the inputs by the
driver: ``portbench/cells.py``)."""


def read(c):
    w = c.window
    return w.cells / w.seconds / 1e9 if w.latency and w.seconds > 0 else None
