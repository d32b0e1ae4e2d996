"""The program's own spans in a traced window: ``genomics/<module>.<phase>``
ranges and ``genomics/gc.gen<N>`` collections, which the program records
only while a ``torch.profiler`` session records.

Readers of ``Trace.host``, ``Trace.busy()`` and the harness's request
spans; nothing here imports the program. Every function takes a
:class:`portbench.devtrace.Trace`.
"""

from __future__ import annotations

import bisect

from portbench.devtrace import REQUEST

PREFIX = "genomics/"


def requests(t) -> list[tuple[int, int]]:
    """(start_ns, end_ns) of every request span, in order."""
    return sorted((s, e) for s, e, n in t.host if n == REQUEST)


def program(t) -> list[tuple[int, int, str]]:
    """Every program span of the trace, in start order."""
    return [x for x in t.host if x[2].startswith(PREFIX)]


def in_requests(t, accept) -> list[tuple[int, int, str]]:
    """The program spans whose name ``accept`` takes that lie wholly
    inside a request span."""
    req = requests(t)
    starts = [s for s, _ in req]
    out = []
    for s, e, n in program(t):
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and e <= req[k][1] and accept(n):
            out.append((s, e, n))
    return out


def union(spans) -> list[tuple[int, int]]:
    """The union of ``(start, end, ...)`` intervals, merged and in order."""
    out: list[list[int]] = []
    for s, e, *_ in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_s(spans) -> float:
    """Seconds the spans cover, each instant once (a span nested in
    another of the same kind is not counted twice)."""
    return sum(e - s for s, e in union(spans)) / 1e9


def idle_gaps(t) -> list[tuple[int, int]]:
    """The device's idle intervals inside request spans."""
    busy = t.busy()
    ends = [e for _, e in busy]
    out = []
    for rs, re in requests(t):
        at, k = rs, bisect.bisect_right(ends, rs)
        while k < len(busy) and busy[k][0] < re:
            if busy[k][0] > at:
                out.append((at, busy[k][0]))
            at = max(at, busy[k][1])
            k += 1
        if re > at:
            out.append((at, re))
    return out


def covered(intervals: list[tuple[int, int]], x: float) -> bool:
    """Whether ``x`` lies in one of the merged, ordered ``intervals``."""
    k = bisect.bisect_right(intervals, (x, float("inf"))) - 1
    return k >= 0 and intervals[k][0] <= x <= intervals[k][1]


def unattributed_ns(t) -> int:
    """Nanoseconds of the device's idle gaps inside requests whose middle
    no program span covers."""
    named = union(program(t))
    return sum(e - s for s, e in idle_gaps(t) if not covered(named, (s + e) / 2))
