"""Observability: phase timers, spinners, profiler traces (counterpart of
``genomics_rs_tpu/utils/profiling.py`` on ``torch.profiler``).

* :class:`PhaseTimer` — wall-clock spans logged in the reference's
  "Time taken to ..." style. A span that names a CUDA device ends
  behind ``torch.cuda.synchronize()``, so it times the device work and
  not just its enqueue.
* :func:`trace` — a ``torch.profiler`` capture gated by
  ``GENOMICS_TORCH_TRACE=<dir>`` (Chrome trace JSON).
* :func:`annotate` — a ``torch.profiler`` range (``record_function``'s
  C++ form) while a profiler session records, a shared no-op context
  otherwise. The program's phase spans go through it, named
  ``genomics/<module>.<phase>`` with ``<phase>`` one of :data:`PHASES`;
  they mark phases of a request, never a whole call, so an idle gap of
  the device in a trace is named by what the host was doing.
* A ``gc.callbacks`` hook, installed once when this module is first
  imported: while a profiler session records, each collection of
  Python's cyclic collector is a ``genomics/gc.gen<N>`` range.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import os
import time

import torch

log = logging.getLogger(__name__)


class PhaseTimer:
    """Wall-clock phase timer with optional work-unit throughput.

    ``device``: when it is a CUDA device, each span synchronizes it
    before reading the clock at both ends.
    """

    def __init__(self, name: str, device=None):
        self.name = name
        self.spans: dict[str, float] = {}
        dev = torch.device(device) if device is not None else None
        self._sync = dev is not None and dev.type == "cuda"
        self._dev = dev

    def _barrier(self):
        if self._sync:
            torch.cuda.synchronize(self._dev)

    @contextlib.contextmanager
    def span(self, phase: str, cells: float | None = None):
        self._barrier()
        t0 = time.perf_counter()
        try:
            with annotate(f"{self.name}/{phase}"):
                yield
            self._barrier()
        finally:
            dt = time.perf_counter() - t0
            self.spans[phase] = self.spans.get(phase, 0.0) + dt
            extra = f", {cells / dt:.3g} cells/s" if cells and dt > 0 else ""
            log.info(
                "[%s] Time taken to %s: %d us (%d ms)%s",
                self.name,
                phase,
                int(dt * 1e6),
                int(dt * 1e3),
                extra,
            )

    def total(self) -> float:
        return sum(self.spans.values())


@contextlib.contextmanager
def spinner(message: str, done: str):
    """Terminal spinner (reference spinoff parity): animated only on a
    TTY, replaced by the success message when the block completes."""
    import sys
    import threading

    tty = sys.stderr.isatty()
    stop = threading.Event()

    def spin():
        frames = "⠋⠙⠹⠸⠼⠴⠦⠧⠇⠏"
        i = 0
        while not stop.is_set():
            sys.stderr.write(f"\r{frames[i % len(frames)]} {message}")
            sys.stderr.flush()
            i += 1
            stop.wait(0.1)

    t = None
    if tty:
        t = threading.Thread(target=spin, daemon=True)
        t.start()
    ok = False
    try:
        yield
        ok = True
    finally:
        if t is not None:
            stop.set()
            t.join(timeout=1)
            if ok:
                sys.stderr.write(f"\r\x1b[K✓ {done}\n")
            else:
                sys.stderr.write(f"\r\x1b[K✗ {message}\n")
            sys.stderr.flush()


#: the phases a program span may name: ``encode`` (host bytes to device
#: batches), ``plan`` (a launch's host plan, workspace and buffers),
#: ``launch`` (the launch call), ``wait`` (the host blocked on the device:
#: an error-word read, ``.cpu()``, ``synchronize``), ``walk`` (the host
#: side of a walk: staging, resumes, read-back), ``classify`` (moves to
#: an alignment) and ``readback`` (results to the host).
PHASES = ("encode", "plan", "launch", "wait", "walk", "classify", "readback")

_OFF = contextlib.nullcontext()

#: the range a span opens while a session records: ``record_function``'s
#: C++ form (2.3 µs a span against ``record_function``'s 12.6 µs under a
#: CPU and CUDA session, on an H100 machine's host).
_RANGE = torch._C._profiler._RecordFunctionFast


def annotate(name: str):
    """A named range in a ``torch.profiler`` trace while a session
    records (on the profiler's clock, nested in the thread's open
    ranges); otherwise one shared ``nullcontext``: no clock read and no
    allocation, under 1 µs a span with the ``with`` statement."""
    if torch.autograd._profiler_enabled():
        return _RANGE(name)
    return _OFF


#: the range of the collection under way, if one was opened (collections
#: do not nest).
_GC_OPEN: list = []


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection is a ``genomics/gc.gen<N>``
    range while the profiler records; returns at once otherwise."""
    if phase == "start":
        if torch.autograd._profiler_enabled():
            rf = _RANGE(f"genomics/gc.gen{info['generation']}")
            rf.__enter__()
            _GC_OPEN.append(rf)
    elif _GC_OPEN:
        _GC_OPEN.pop().__exit__(None, None, None)


_gc_span.genomics_gc_span = True
# Once per process, whatever imports this module again (a reload, a
# load by file path): a second hook would nest a second range.
if not any(getattr(cb, "genomics_gc_span", False) for cb in gc.callbacks):
    gc.callbacks.append(_gc_span)


@contextlib.contextmanager
def trace(name: str = "genomics"):
    """Capture a ``torch.profiler`` trace (CPU + CUDA activities) into
    ``$GENOMICS_TORCH_TRACE/<name>/trace.json`` when that variable is
    set; a no-op otherwise."""
    trace_dir = os.environ.get("GENOMICS_TORCH_TRACE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(trace_dir, name)
    os.makedirs(out, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace -> %s", path)
