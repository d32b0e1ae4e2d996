"""The readers of the program's spans (``spans.py`` and the metrics
``plan_us_per_launch``, ``classify_ms``, ``gc_ms``,
``idle_unattributed_pct`` and ``idle_unattributed_ms``) on hand-placed
traces (CPU), and the spans on
the device trace's clock (``cuda`` marker; skips without a card)."""

import numpy as np
import pytest

from portbench import harness, spans
from portbench.devtrace import REQUEST, Trace

MS = 1_000_000
READERS = ("plan_us_per_launch", "classify_ms", "gc_ms", "idle_unattributed_pct",
           "idle_unattributed_ms")
#: the window's launch counters: four kernel launches and two plain calls.
COUNTS = {"gotoh_pallas.COUNTS.kernel": 3, "gotoh_banded.COUNTS.kernel": 1,
          "gotoh_stream.COUNTS.plain": 2}


def read(name, trace, counts=COUNTS):
    w = harness.Window()
    w.counts = dict(counts)
    return harness.load_module("metrics", name).read(harness.MetricContext(w, trace, 1.0, 0.0))


def hand_trace(program=True):
    """Two requests of 100 ms; the device busy 21-60 and 121-150 ms."""
    host = [(0, 100 * MS, REQUEST), (100 * MS, 200 * MS, REQUEST),
            (12 * MS, 13 * MS, "aten::empty"), (150 * MS, 200 * MS, "portbench/results")]
    if program:
        host += [(10 * MS, 20 * MS, "genomics/gotoh_pallas.plan"),
                 (20 * MS, 21 * MS, "genomics/gotoh_pallas.launch"),
                 (30 * MS, 34 * MS, "genomics/gotoh_banded.plan"),
                 (60 * MS, 90 * MS, "genomics/traceback.classify"),
                 (70 * MS, 75 * MS, "genomics/gc.gen0"),
                 (110 * MS, 116 * MS, "genomics/gotoh_pallas.plan"),
                 (116 * MS, 121 * MS, "genomics/gotoh_pallas.launch"),
                 (150 * MS, 170 * MS, "genomics/traceback.classify"),
                 (195 * MS, 205 * MS, "genomics/gotoh_pallas.plan")]  # leaves its request
    dev = [(21 * MS, 60 * MS, "warp_pipe_kernel"), (121 * MS, 150 * MS, "rowblock_kernel")]
    return Trace(dev, host)


def test_the_readers_values_on_a_hand_placed_trace():
    t = hand_trace()
    # 20 ms of plan inside requests over the four kernel launches.
    assert read("plan_us_per_launch", t) == pytest.approx((10 + 4 + 6) / 4 * 1e3)
    assert read("classify_ms", t) == pytest.approx((30 + 20) / 2)
    assert read("gc_ms", t) == pytest.approx(5 / 2)
    # Gaps 0-21, 60-100, 100-121 and 150-200 ms: the last one's middle
    # (175 ms) lies in no program span.
    assert spans.idle_gaps(t) == [(0, 21 * MS), (60 * MS, 100 * MS), (100 * MS, 121 * MS),
                                  (150 * MS, 200 * MS)]
    assert read("idle_unattributed_pct", t) == pytest.approx(100 * 50 / 132)
    assert read("idle_unattributed_ms", t) == pytest.approx(50 / 2)


def test_nested_spans_of_one_kind_count_once():
    t = hand_trace()
    t.host = sorted(t.host + [(65 * MS, 80 * MS, "genomics/traceback.classify")])
    assert read("classify_ms", t) == pytest.approx((30 + 20) / 2)


def test_plan_is_silent_without_a_launch():
    t = hand_trace()
    assert read("plan_us_per_launch", t, {"gotoh_stream.COUNTS.plain": 2}) is None
    assert read("gc_ms", t, {}) is not None


def test_gc_reads_zero_when_no_collection_ran():
    t = hand_trace()
    t.host = [x for x in t.host if not x[2].startswith("genomics/gc.")]
    assert read("gc_ms", t) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_the_readers_are_silent_without_program_spans(name):
    assert read(name, hand_trace(program=False)) is None
    assert read(name, None) is None


def test_idle_unattributed_stays_a_share():
    r = np.random.default_rng(3)
    for _ in range(200):
        edges = np.sort(r.integers(0, 1000, 2 * int(r.integers(1, 6))))
        host = [(int(a) * MS, int(b) * MS, REQUEST) for a, b in zip(edges[::2], edges[1::2])]
        for _ in range(int(r.integers(1, 12))):
            s = int(r.integers(0, 1000))
            host.append((s * MS, (s + int(r.integers(0, 200))) * MS, "genomics/x.plan"))
        dev = []
        for _ in range(int(r.integers(0, 12))):
            s = int(r.integers(0, 1000))
            dev.append((s * MS, (s + int(r.integers(1, 100))) * MS, "k"))
        v = read("idle_unattributed_pct", Trace(dev, host))
        assert 0.0 <= v <= 100.0
        assert read("idle_unattributed_ms", Trace(dev, host)) >= 0.0


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_program_spans_share_the_device_clock_and_stay_off_the_device_row(card):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from genomics_rs_tpu_torch.utils.profiling import annotate

    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(REQUEST):
            with annotate("genomics/devtrace.wait"):
                torch.cuda._sleep(20_000_000)
                torch.cuda.synchronize(card)
    t = Trace.from_profiler(prof)
    assert not [n for _, _, n in t.device if n.startswith("genomics/")]
    (hs, he), = [(s, e) for s, e, n in t.host if n == "genomics/devtrace.wait"]
    sleeps = [(s, e) for s, e, n in t.device if "spin" in n or "sleep" in n]
    assert sleeps, [n for _, _, n in t.device]
    for s, e in sleeps:
        assert hs <= s < e <= he
    assert read("idle_unattributed_pct", t) is not None
