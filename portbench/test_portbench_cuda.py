"""The cells on the card, each a short run with its check (``cuda``
marker; they skip without a card). Run on the card with
``python -m pytest -m cuda portbench/``."""

import time

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.load_json(harness.REPO / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    result, checks = harness.run(cell, 2**31 + 4242, 2.0, False, t_proc=time.perf_counter(),
                                 device=str(card), log=lambda s: None)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu" and result["attempted"] >= 1


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    from portbench.control import readings

    rec = readings("cov10-allpairs", 2**31 + 4243, 1.0, True)
    assert rec["program"]["wrong_answers"] == 0 and rec["control"]["wrong_answers"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("local,band,dirs", [(False, None, True), (False, 1024, True),
                                             (True, None, False)])
def test_reference_graph_replay_equals_the_cpu_fill(card, local, band, dirs):
    import numpy as np

    from portbench import reference as R

    r = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for m in (3_000, 2_777):
        a = alpha[r.integers(0, 4, m)]
        b = np.delete(a, r.integers(0, m, 300))
        b[r.integers(0, b.size, 100)] = alpha[r.integers(0, 4, 100)]
        pairs.append((a.tobytes(), b.tobytes()))
    tab = R.dna_table(1, -2)
    got = R.fill(*R.pad_batch(pairs, card), tab, -1, -5, local, band=band, dirs=dirs)
    want = R.fill(*R.pad_batch(pairs, "cpu"), tab, -1, -5, local, band=band, dirs=dirs)
    for key in ("score", "start_i", "start_j"):
        assert np.array_equal(got[key], want[key])
    if dirs:
        assert bool((got["dirs"].cpu() == want["dirs"]).all())
