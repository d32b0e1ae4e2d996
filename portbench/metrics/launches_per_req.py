"""Kernel launches per request: every ``ops`` module's kernel counters
(keys ending in ``kernel``) over the window, over the requests."""


def read(c):
    if not c.requests:
        return None
    return sum(v for k, v in c.window.counts.items() if k.endswith("kernel")) / c.requests
