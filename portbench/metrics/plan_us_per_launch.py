"""The host plan of a launch: the time the program's ``genomics/*.plan``
spans cover inside requests (a wrapper's strip height, occupancy and
length checks; a range's pipeline plan, pinned copy, workspace and ring;
a call's host checks) over the kernel launches the ``ops`` modules'
counters give for the window (``launches_per_req``'s count), in µs.
Silent when the window holds no program span or no launch."""

from portbench import spans


def read(c):
    t = c.trace
    if t is None or not spans.program(t):
        return None
    launches = sum(v for k, v in c.window.counts.items() if k.endswith("kernel"))
    if not launches:
        return None
    plans = spans.in_requests(t, lambda n: n.endswith(".plan"))
    return spans.union_s(plans) / launches * 1e6
