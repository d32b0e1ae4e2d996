"""Device idle time inside requests that no program phase names, per
request: the idle gaps inside request spans whose middle no
``genomics/`` span covers, summed over the requests, in ms. Silent when
the window holds no program span."""

from portbench import spans


def read(c):
    t = c.trace
    if t is None or not t.requests or not spans.program(t):
        return None
    return spans.unattributed_ns(t) / t.requests / 1e6
