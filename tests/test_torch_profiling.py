"""The port's program spans (``genomics_rs_tpu_torch/utils/profiling.py``)
on the CPU: ``annotate`` is a shared no-op unless a ``torch.profiler``
session records, spans nest and carry their names, errors pass through,
the collector's hook is installed once and records each collection, and
the CPU routes of ``align_banded``, ``classify_moves`` and
``allpairs_scores`` give the same answers traced and untraced (and the
JAX package's) while emitting only ``genomics/<module>.<phase>`` names.
"""

import gc
import importlib.util
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.models.banded import align_banded as jax_align_banded
from genomics_rs_tpu.ops.traceback import classify_moves as jax_classify_moves
from genomics_rs_tpu.parallel import allpairs as jax_ap
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu.sequence import SequenceContainer as JaxContainer
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models.banded import align_banded
from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_SUB
from genomics_rs_tpu_torch.ops.traceback import classify_moves, classify_moves_batch
from genomics_rs_tpu_torch.parallel.allpairs import allpairs_scores
from genomics_rs_tpu_torch.sequence import Sequence, SequenceContainer
from genomics_rs_tpu_torch.utils import profiling
from genomics_rs_tpu_torch.utils.profiling import PHASES, PhaseTimer, annotate
from tests.test_torch_align import _fields
from tests.test_torch_allpairs import _corpus
from tests.test_torch_banded import _similar

SCORES = (1, -2, -1, -5)
#: a program span's name: a phase of a module, or a collection.
NAME = re.compile(r"^genomics/(?:[a-z0-9_]+\.(?:%s)|gc\.gen[0-2])$" % "|".join(PHASES))


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def genomics_events(prof) -> list:
    return [e for e in prof.events() if e.name.startswith("genomics/")]


def hooks() -> list:
    return [cb for cb in gc.callbacks if getattr(cb, "genomics_gc_span", False)]


def test_off_annotate_is_the_shared_null_context_and_records_nothing():
    assert not torch.autograd._profiler_enabled()
    assert annotate("genomics/x.plan") is annotate("genomics/y.launch") is profiling._OFF
    with annotate("genomics/x.plan"):
        pass
    span = annotate("genomics/x.wait")  # entered off, left while a session records
    span.__enter__()
    with cpu_profile() as prof:
        span.__exit__(None, None, None)
        with record_function("outer"):
            torch.ones(3).sum()
    assert genomics_events(prof) == []
    assert any(e.name == "outer" for e in prof.events())


def test_on_spans_are_recorded_by_name_inside_an_outer_range():
    with cpu_profile() as prof:
        with record_function("portbench/request"):
            with annotate("genomics/gotoh_pallas.plan"):
                torch.zeros(4)
            with annotate("genomics/gotoh_pallas.launch"):
                with annotate("genomics/gotoh_pallas.wait"):
                    torch.ones(2).sum()
    ev = {e.name: e for e in genomics_events(prof)}
    assert set(ev) == {"genomics/gotoh_pallas.plan", "genomics/gotoh_pallas.launch",
                       "genomics/gotoh_pallas.wait"}
    assert ev["genomics/gotoh_pallas.plan"].cpu_parent.name == "portbench/request"
    assert ev["genomics/gotoh_pallas.launch"].cpu_parent.name == "portbench/request"
    assert ev["genomics/gotoh_pallas.wait"].cpu_parent.name == "genomics/gotoh_pallas.launch"
    plan = ev["genomics/gotoh_pallas.plan"].time_range
    launch = ev["genomics/gotoh_pallas.launch"].time_range
    assert plan.end <= launch.start


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_an_exception_inside_a_span_propagates_as_itself(on):
    err = ValueError("boom")
    with cpu_profile() if on else profiling._OFF:
        with pytest.raises(ValueError) as got:
            with annotate("genomics/traceback.classify"):
                raise err
    assert got.value is err
    timer = PhaseTimer("t")
    with pytest.raises(KeyError, match="inner"):
        with timer.span("phase"):
            raise KeyError("inner")
    assert "phase" in timer.spans


def test_the_collector_hook_is_installed_once_and_records_a_collection():
    assert len(hooks()) == 1
    spec = importlib.util.spec_from_file_location("profiling_again", profiling.__file__)
    again = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(again)
    assert len(hooks()) == 1 and again.annotate("genomics/x.plan") is again._OFF
    gc.collect()
    with cpu_profile() as prof:
        with record_function("outer"):
            gc.collect()
    gen2 = [e for e in genomics_events(prof) if e.name == "genomics/gc.gen2"]
    assert len(gen2) == 1 and gen2[0].cpu_parent.name == "outer"
    assert profiling._GC_OPEN == []


def test_the_collector_hook_opens_nothing_when_not_recording(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_RANGE", lambda name: opened.append(name))
    gc.collect()
    assert opened == [] and profiling._GC_OPEN == []


def traced(fn):
    """``fn()`` untraced, then under a CPU profiler session: both
    answers and the program span names of the traced call."""
    plain = fn()
    with cpu_profile() as prof:
        with record_function("portbench/request"):
            got = fn()
    return plain, got, [e.name for e in genomics_events(prof)]


def test_align_banded_cpu_route_spans_and_answers():
    a, b = _similar(np.random.default_rng(5), 320, 300, indels=4)
    plain, got, names = traced(lambda: align_banded(
        Sequence("s1", a), Sequence("s2", b), Scores.from_tuple(SCORES), band=1024,
        device="cpu"))
    want = jax_align_banded(JaxSequence("s1", a), JaxSequence("s2", b), JaxScores(*SCORES),
                            band=1024, interpret=True)
    assert _fields(plain) == _fields(got) == _fields(want)
    assert {"genomics/banded.encode", "genomics/traceback.classify"} <= set(names)
    assert names.count("genomics/traceback.classify") == 1
    assert all(NAME.match(n) for n in names), names


def test_classify_moves_spans_and_answers():
    rng = np.random.default_rng(9)
    a = "".join(rng.choice(list("ACGT"), 60))
    b = a[:20] + a[24:50] + "GATTACA" + a[50:]
    # A path from (m, n) to (0, 0): diagonals, then gaps on both axes.
    m, n = len(a), len(b)
    codes = np.array([DIR_SUB] * (n - 5) + [DIR_INS] * 5 + [DIR_DEL] * (m - n + 5), np.uint8)
    plain, got, names = traced(lambda: classify_moves(codes, m, n, 17, Sequence("a", a),
                                                      Sequence("b", b)))
    want = jax_classify_moves(codes, m, n, 17, JaxSequence("a", a), JaxSequence("b", b))
    assert _fields(plain) == _fields(got) == _fields(want)
    assert names == ["genomics/traceback.classify"]
    _, batch, names = traced(lambda: classify_moves_batch(
        codes[None], [codes.size], [m], [n], [17], [(Sequence("a", a), Sequence("b", b))]))
    assert [_fields(r) for r in batch] == [_fields(got)]
    assert names == ["genomics/traceback.classify"]


def test_allpairs_scores_cpu_route_spans_and_answers():
    seqs = _corpus(3)
    plain, got, names = traced(lambda: allpairs_scores(
        SequenceContainer([Sequence(k, s) for k, s in seqs]), Scores.from_tuple(SCORES),
        device="cpu"))
    want = jax_ap.allpairs_scores(JaxContainer([JaxSequence(k, s) for k, s in seqs]),
                                  JaxScores(*SCORES), engine="scan")
    assert np.array_equal(plain.matrix, got.matrix)
    assert np.array_equal(got.matrix, want.matrix)
    assert {"genomics/allpairs.encode", "genomics/allpairs.readback",
            "genomics/batch.readback"} <= set(names)
    assert all(NAME.match(n) for n in names), names
