"""Python's cyclic collector inside requests: the time the program's
``genomics/gc.gen*`` spans cover inside requests, over the requests, in
ms; 0.0 when the program recorded spans but no collection ran. Silent
when the window holds no program span."""

from portbench import spans


def read(c):
    t = c.trace
    if t is None or not t.requests or not spans.program(t):
        return None
    gc = spans.in_requests(t, lambda n: n.startswith(spans.PREFIX + "gc.gen"))
    return spans.union_s(gc) / t.requests * 1e3
