"""Reading a ``torch.profiler`` run: the device's busy intervals, kernel
time by name, the harness's request spans, and what the host was doing
while the device sat idle.

Every event comes from the profiler's own records (CUPTI for the
device), all on its one clock, so host spans and device intervals line
up.
"""

from __future__ import annotations

import heapq

REQUEST = "portbench/request"


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without namespaces or its argument list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for k, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and k and name[k - 1] != " ":
            name = name[:k]
            break
    return name[:width]


class Trace:
    """The events of one traced window.

    ``device``: (start_ns, end_ns, name) of every kernel, copy and set on
    the device; ``host``: (start_ns, end_ns, name) of every host event
    (the harness's spans, torch operators, runtime calls).
    """

    def __init__(self, device: list, host: list):
        self.device = sorted(device)
        self.host = sorted(host)
        req = [(s, e) for s, e, n in self.host if n == REQUEST]
        self.requests = len(req)
        self.t0 = min((s for s, _ in req), default=0)
        self.t1 = max((e for _, e in req), default=0)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            item = (e.start_ns(), e.start_ns() + max(e.duration_ns(), 0), e.name())
            if "CUDA" not in str(e.device_type()):
                host.append(item)
            elif not (e.is_user_annotation() or item[2].startswith("portbench/")):
                device.append(item)  # (a user annotation is a host span on the device's row)
        return cls(device, host)

    @property
    def window_s(self) -> float:
        """From the first request's start to the last one's end."""
        return max(self.t1 - self.t0, 0) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        """The union of the device intervals, clipped to the window."""
        out: list[list[int]] = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def exposed(self) -> list[tuple[float, float]]:
        """(seconds, host-exposed seconds) of each request: its span, and
        the part of it in which the device was idle."""
        busy = self.busy()
        out, k = [], 0
        for s, e in sorted((s, e) for s, e, n in self.host if n == REQUEST):
            while k < len(busy) and busy[k][1] <= s:
                k += 1
            cover, j = 0, k
            while j < len(busy) and busy[j][0] < e:
                cover += min(e, busy[j][1]) - max(s, busy[j][0])
                j += 1
            out.append(((e - s) / 1e9, (e - s - cover) / 1e9))
        return out

    def kernel_s(self, match) -> float:
        """Summed device seconds of the events whose name ``match``
        accepts, inside the window."""
        return sum(min(e, self.t1) - max(s, self.t0) for s, e, n in self.device
                   if match(n) and min(e, self.t1) > max(s, self.t0)) / 1e9

    def by_name(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]
        (names without namespaces and argument lists)."""
        tot: dict[str, float] = {}
        for s, e, n in self.device:
            d = min(e, self.t1) - max(s, self.t0)
            if d > 0:
                n = short_name(n)
                tot[n] = tot.get(n, 0.0) + d / 1e9
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle time of the device by what the host was doing: each gap
        between busy intervals is named by the innermost host event that
        covers its middle; [name, seconds] summed by name."""
        edges = [self.t0] + [t for iv in self.busy() for t in iv] + [self.t1]
        gaps = sorted((s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s)
        tot: dict[str, float] = {}
        heap: list = []  # (-start, end, name) of host events begun so far
        k = 0
        for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (s + e) / 2
            while k < len(self.host) and self.host[k][0] <= mid:
                hs, he, hn = self.host[k]
                heapq.heappush(heap, (-hs, he, hn))
                k += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "(no host event)"
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e9
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
