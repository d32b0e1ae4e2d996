"""Moves to alignments on the host: the time the program's
``genomics/*.classify`` spans cover inside requests, over the requests,
in ms. Silent when the window holds no program span."""

from portbench import spans


def read(c):
    t = c.trace
    if t is None or not t.requests or not spans.program(t):
        return None
    return spans.union_s(spans.in_requests(t, lambda n: n.endswith(".classify"))) \
        / t.requests * 1e3
