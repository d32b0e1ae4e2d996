"""The stream8 tier (K8) of the port on the CPU against the JAX package:
``gotoh_scores_stream8`` (on the CPU, the warp-strip pipeline's plain
version ``gotoh_stream_plain`` at scores only) against JAX
``gotoh_scores_stream8(interpret=True)`` on the cases of
``tests/test_stream8.py`` (multicycle, exact cycle and ragged, asymmetric
pads, local no match and self-match, window overlap, single pair) with
classic and kimura scores, ``score_pairs(engine="stream8")`` with empty
sequences and at B = 2, a bucket that ``pipeline_groups`` splits (the
pipeline's host side driven by a stand-in launch), the error word's
readers, and ``reads --engine stream8`` against ``--engine auto`` and the
JAX CLI. Local start cells are compared in full; the JAX kernel's global
starts are (m, n) by contract. The DP is int32: every comparison is exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops.gotoh_stream8 import gotoh_scores_stream8 as jax_stream8
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops import gotoh_segmented as gseg
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import gotoh_stream8 as gs8
from genomics_rs_tpu_torch.parallel import batch
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence
from tests.test_torch_reads import (  # noqa: F401
    KIMURA,
    _reads,
    _write_inputs,
    one_torch_thread,
    run_both_clis,
)
from tests.test_torch_segmented import assert_same, port_scores, scan_scores

#: tests/test_stream8.py's two scoring grids, and a kimura set.
SCORES = (1, -2, -1, -5)
ALT_SCORES = (2, -3, -2, -4)


def _batch(rng, B, lo, hi, Lm, Ln):
    """tests/test_stream8.py's inputs: random bases, lengths lo..hi."""
    ms = rng.integers(lo, hi + 1, B).astype(np.int32)
    ns = rng.integers(lo, hi + 1, B).astype(np.int32)
    s1b = np.stack([Sequence("a", "".join(rng.choice(list("ACGT"), m))).encoded(Lm, PAD_S1)
                    for m in ms])
    s2b = np.stack([Sequence("b", "".join(rng.choice(list("ACGT"), n))).encoded(Ln, PAD_S2)
                    for n in ns])
    return s1b, s2b, ms, ns


def _check(s1b, s2b, ms, ns, score_t, is_local):
    want = jax_stream8(s1b, s2b, ms, ns, JaxScores(*score_t), is_local=is_local, interpret=True)
    got = port_scores(gs8.gotoh_scores_stream8, s1b, s2b, ms, ns, score_t, is_local)
    assert_same(got, want)


@pytest.mark.parametrize("score_t", [SCORES, ALT_SCORES, KIMURA],
                         ids=["classic", "alt", "kimura"])
@pytest.mark.parametrize("is_local", [False, True])
def test_stream8_multicycle(score_t, is_local):
    """More than one 8-row cycle in JAX (B = 20), mixed tiny-to-full lengths."""
    rng = np.random.default_rng(7)
    _check(*_batch(rng, 20, 3, 120, 120, 120), score_t, is_local)


@pytest.mark.parametrize("is_local", [False, True])
def test_stream8_exact_cycle_and_ragged(is_local):
    rng = np.random.default_rng(11)
    for B in (8, 9):
        _check(*_batch(rng, B, 10, 100, 100, 100), SCORES, is_local)


@pytest.mark.parametrize("is_local", [False, True])
def test_stream8_asymmetric_pads(is_local):
    rng = np.random.default_rng(13)
    _check(*_batch(rng, 10, 5, 60, 64, 700), KIMURA, is_local)


def test_stream8_local_no_match_and_selfmatch():
    """An all-mismatch pair (every cell 0: the keep-last best is (0, m, n))
    stacked with a perfect self-match."""
    seq = "ACGT" * 40
    s1b = np.stack([Sequence("a", "A" * 120).encoded(256, PAD_S1),
                    Sequence("a", seq).encoded(256, PAD_S1)])
    s2b = np.stack([Sequence("b", "T" * 100).encoded(256, PAD_S2),
                    Sequence("b", seq).encoded(256, PAD_S2)])
    ms, ns = np.array([120, 160], np.int32), np.array([100, 160], np.int32)
    got = port_scores(gs8.gotoh_scores_stream8, s1b, s2b, ms, ns, SCORES, True)
    assert [list(x) for x in got] == [[0, 160], [120, 160], [100, 160]]
    _check(s1b, s2b, ms, ns, SCORES, True)


@pytest.mark.parametrize("is_local", [False, True])
def test_stream8_window_overlap(is_local):
    """JAX's wrapped-window case (m + n past one segment stride): 9 pairs
    of 990-1,100 bases, over four of the port's 256-row strips."""
    rng = np.random.default_rng(42)
    _check(*_batch(rng, 9, 990, 1100, 1100, 1100), SCORES, is_local)


def test_stream8_single_pair_takes_the_segmented_route():
    """B = 1 runs K7's route and count, as JAX falls back to the segmented
    kernel; both counts move only on their own route."""
    rng = np.random.default_rng(5)
    args = _batch(rng, 1, 100, 150, 256, 256)
    before = dict(gseg.COUNTS), dict(gs8.COUNTS)
    for is_local in (False, True):
        _check(*args, SCORES, is_local)
    assert gseg.COUNTS["plain"] - before[0]["plain"] == 2
    assert gs8.COUNTS == before[1]
    two = _batch(rng, 2, 100, 150, 256, 256)
    port_scores(gs8.gotoh_scores_stream8, *two, SCORES, False)
    assert gs8.COUNTS["plain"] == before[1]["plain"] + 1
    assert gseg.COUNTS["plain"] - before[0]["plain"] == 2


def test_stream8_matches_scan_with_empty_sequences():
    """Empty sequences (a JAX fallback to K7) run on this route too."""
    rng = np.random.default_rng(6)
    args = _batch(rng, 12, 0, 200, 256, 256)
    args[2][:2] = 0
    args[3][5] = 0
    for is_local in (False, True):
        got = port_scores(gs8.gotoh_scores_stream8, *args, KIMURA, is_local)
        assert_same(got, scan_scores(*args, KIMURA, is_local))


@pytest.mark.parametrize("is_local", [False, True])
def test_score_pairs_stream8_two_pairs_and_empty(is_local):
    """``score_pairs(engine="stream8")`` at B = 2 (the least batch the route
    takes) and on a batch with empty sequences on both sides: == JAX's
    stream8 (interpret mode) and the scan oracle."""
    rng = np.random.default_rng(19)
    for args in (_batch(rng, 2, 40, 300, 384, 384), _batch(rng, 6, 0, 150, 256, 256)):
        if len(args[2]) > 2:
            args[2][1], args[3][3], args[2][4], args[3][4] = 0, 0, 0, 0
        got = [np.asarray(x, np.int64) for x in batch.score_pairs(
            *args, Scores.from_tuple(KIMURA), is_local, engine="stream8", device="cpu")]
        assert_same(got, scan_scores(*args, KIMURA, is_local))
        want = jax_stream8(*args, JaxScores(*KIMURA), is_local=is_local, interpret=True)
        assert_same(got, want)


@pytest.mark.parametrize("is_local", [False, True])
def test_stream8_split_bucket_launches_once_a_group(monkeypatch, is_local):
    """A bucket whose ring does not fit the budget runs as one launch for
    each of ``pipeline_groups``' pair ranges, each counted on K8's route
    (not K3's): the pipeline's host side (``run_stream`` with K8's counts)
    driven by a stand-in launch that fills its range by the plain version
    through the pointers it is given. The scores == JAX's and the scan
    oracle's."""
    rng = np.random.default_rng(23)
    s1b, s2b, ms, ns = _batch(rng, 7, 600, 640, 640, 768)
    rows = gs.stream_rows(ms, ns, 640, False)
    monkeypatch.setattr(gp, "PIPE_RING_BYTES", 3 * 8 * 769)  # three ring slots
    groups = gp.pipeline_groups(ms, 768, rows)
    assert len(groups) > 1
    sc = Scores.from_tuple(SCORES)
    launched = []

    def as_array(p, n):
        return np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(p.value))

    def launch(s1c, s2c, plan, work, ring, dirs, res, B, Lm, Ln, *rest):
        assert dirs is None
        m_n = as_array(plan, 2 * B)
        fill = gs.gotoh_stream_plain(
            torch.from_numpy(as_array(s1c, B * Lm).reshape(B, Lm).astype(np.uint8)),
            torch.from_numpy(as_array(s2c, B * Ln).reshape(B, Ln).astype(np.uint8)),
            m_n[:B], m_n[B:], sc, is_local, counts={"plain": 0})
        as_array(res, 3 * B)[:] = torch.stack(fill[:3], 1).reshape(-1).numpy()
        launched.append(B)
        return 0

    class Lib:
        gotoh_stream_launch = staticmethod(launch)

    before = gs8.COUNTS["kernel"], gs.COUNTS["kernel"]
    fill = gs.run_stream(Lib, torch.from_numpy(s1b), torch.from_numpy(s2b), ms.astype(np.int64),
                         ns.astype(np.int64), sc, is_local, False, rows, 64, gp.SPIN_NS, None,
                         gs8.COUNTS, "gotoh_stream8")
    assert launched == [hi - lo for lo, hi in groups]
    assert (gs8.COUNTS["kernel"] - before[0], gs.COUNTS["kernel"] - before[1]) == (len(groups), 0)
    assert int(fill.err) == 0
    got = [x.numpy().astype(np.int64) for x in fill[:3]]
    assert_same(got, scan_scores(s1b, s2b, ms, ns, SCORES, is_local))
    assert_same(got, jax_stream8(s1b, s2b, ms, ns, JaxScores(*SCORES), is_local=is_local,
                                 interpret=True))


def test_stream8_error_word_is_read_with_the_scores(monkeypatch):
    """The fill returns its error word unread; ``gotoh_scores_stream8`` and
    ``score_pairs`` read it with the scores and raise when it is set (the
    plain version's word set by hand here)."""
    real = gs.gotoh_stream_plain

    def with_err(*a, **kw):
        return real(*a, **kw)._replace(err=torch.ones((), dtype=torch.int32))

    monkeypatch.setattr(gs, "gotoh_stream_plain", with_err)
    rng = np.random.default_rng(29)
    s1b, s2b, ms, ns = _batch(rng, 3, 20, 90, 128, 128)
    t1, t2 = torch.from_numpy(s1b), torch.from_numpy(s2b)
    assert int(gs8.gotoh_stream8_fill(t1, t2, ms, ns, Scores(), False).err) == 1
    with pytest.raises(RuntimeError, match="passed its bound"):
        gs8.gotoh_scores_stream8(t1, t2, ms, ns, Scores(), False)
    with pytest.raises(RuntimeError, match="passed its bound"):
        batch.score_pairs(s1b, s2b, ms, ns, Scores(), False, engine="stream8", device="cpu")
    # B = 1 runs K7's kernel, whose word is always clear.
    assert int(gs8.gotoh_stream8_fill(t1[:1], t2[:1], ms[:1], ns[:1], Scores(), False).err) == 0


@pytest.mark.parametrize("kind", ["global", "local"])
def test_cli_reads_stream8_matches_auto_and_jax(tmp_path, capsys, monkeypatch, kind):
    qs, rs = _reads(43, 7, 200, 400)
    q, r, cfg = _write_inputs(tmp_path, qs, rs, KIMURA)
    argv = ["-c", cfg, "reads", "-q", q, "-r", r, "-a", kind]
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, "scores.tsv",
                         ["--engine", "stream8"])
    assert runs["port"] == runs["jax"]
    from genomics_rs_tpu_torch import cli

    auto = tmp_path / "auto.tsv"
    assert cli.main(argv + ["-o", str(auto), "--device", "cpu"]) == 0
    assert auto.read_bytes() == runs["port"][1]
