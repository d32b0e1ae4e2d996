"""How much of the device's idle time inside requests no program phase
names: of the idle gaps inside request spans, the share (by duration)
whose middle no ``genomics/`` span covers, in %. A check of the spans'
coverage: removing a named phase's time raises it. Silent when the
window holds no program span."""

from portbench import spans


def read(c):
    t = c.trace
    if t is None or not spans.program(t):
        return None
    total = sum(e - s for s, e in spans.idle_gaps(t))
    if total <= 0:
        return 0.0
    return 100.0 * spans.unattributed_ns(t) / total
