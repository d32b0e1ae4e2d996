"""The pallas tier (K9) of the port on the CPU against the JAX package:
``gotoh_scores_pallas_batch`` (the strip pipeline's plain version) against
JAX ``gotoh_scores_pallas_batch(interpret=True)`` on the case of
``tests/test_pallas.py::test_pallas_batch_scores``; ``gotoh_strips_plain``
at strip heights 1, 3, 16 and 32 against the scan oracle (empty
sequences, all-mismatch local pairs); the pipeline's host plan; scores
past the JAX kernels' drift headroom; and the CLI: ``reads --engine
pallas``, ``align-matrix --engine pallas`` and ``msa --engine pallas``
against the JAX CLI's scan engine. The DP is int32: every comparison is
exact.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops.gotoh_pallas import gotoh_scores_pallas_batch as jax_pallas_batch
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.parallel import allpairs as ap
from genomics_rs_tpu_torch.parallel import batch
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, SequenceContainer
from tests.test_torch_allpairs import _corpus, _stdout_without_timing, _write_corpus
from tests.test_torch_reads import (  # noqa: F401
    CLASSIC,
    KIMURA,
    _reads,
    _write_inputs,
    one_torch_thread,
    run_both_clis,
)
from tests.test_torch_segmented import assert_same, port_scores, random_batch, scan_scores

SCORES = (1, -2, -1, -5)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [SCORES, KIMURA], ids=["classic", "kimura"])
def test_pallas_batch_matches_jax_interpret(is_local, score_t):
    """tests/test_pallas.py's batch: B = 5, 256 x 128, lengths from 10."""
    rng = np.random.default_rng(13)
    args = random_batch(rng, 5, 256, 128, lo=10)
    want = jax_pallas_batch(*args, JaxScores(*score_t), is_local, interpret=True)
    assert_same(port_scores(gp.gotoh_scores_pallas_batch, *args, score_t, is_local), want)


def _edge_batch(rng):
    """Empty sequences on each side and both, one-base pairs, all-mismatch
    pairs (A against T: every local cell 0, the best (0, m, n)) and random
    pairs, in one (40, 48) bucket."""
    ms = [0, 7, 0, 1, 40, 33, 40, 19]
    ns = [5, 0, 0, 1, 48, 21, 1, 48]
    s1 = np.full((len(ms), 40), PAD_S1, np.uint8)
    s2 = np.full((len(ms), 48), PAD_S2, np.uint8)
    for b, (m, n) in enumerate(zip(ms, ns)):
        if b in (4, 5):
            s1[b, :m], s2[b, :n] = ord("A"), ord("T")
        else:
            s1[b, :m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m)]
            s2[b, :n] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    return s1, s2, np.array(ms, np.int32), np.array(ns, np.int32)


@pytest.mark.parametrize("rows_per_strip", [1, 3, 16, 32])
@pytest.mark.parametrize("is_local", [False, True])
def test_strips_plain_matches_scan(is_local, rows_per_strip):
    rng = np.random.default_rng(21 + rows_per_strip)
    args = _edge_batch(rng)
    got = port_scores(gp.gotoh_strips_plain, *args, KIMURA, is_local,
                      rows_per_strip=rows_per_strip)
    assert_same(got, scan_scores(*args, KIMURA, is_local))
    if is_local:  # the all-mismatch pairs
        assert [int(x[4]) for x in got] == [0, 40, 48]
        assert [int(x[5]) for x in got] == [0, 33, 21]


def test_strips_plain_heights_agree_on_a_larger_batch():
    """Strip seams at rows that are multiples of nothing, every height
    equal to one strip (the whole table)."""
    rng = np.random.default_rng(2)
    args = random_batch(rng, 6, 200, 150, lo=0)
    for is_local in (False, True):
        whole = port_scores(gp.gotoh_strips_plain, *args, CLASSIC, is_local, rows_per_strip=256)
        for H in (7, 32, 100):
            assert_same(port_scores(gp.gotoh_strips_plain, *args, CLASSIC, is_local,
                                    rows_per_strip=H), whole)
    with pytest.raises(ValueError, match="rows_per_strip"):
        port_scores(gp.gotoh_strips_plain, *args, CLASSIC, False, rows_per_strip=0)


def test_pipeline_plan_levels_and_ring():
    """Tickets level by level, pairs by strip count; ring slots from the
    grid, capped by the warp pipeline's ring budget (``PIPE_RING_BYTES``,
    the plan's default)."""
    ms, ns = np.array([600, 10, 255, 256]), np.array([5, 6, 7, 8])
    plan, nlevels, total, blocks, nslots = gp.pipeline_plan(ms, ns, 64, 256, resident=4)
    strips = [3, 1, 1, 2]
    assert (nlevels, total, blocks) == (3, 7, 4)
    B = 4
    strip0 = plan[2 * B : 3 * B + 1]
    level_start = plan[3 * B + 1 : 3 * B + 2 + nlevels]
    by_strips = plan[3 * B + 2 + nlevels : 4 * B + 2 + nlevels]
    slots = plan[5 * B + 2 + nlevels :]
    assert list(strip0) == [0, 3, 4, 5, 7]
    assert list(level_start) == [0, 4, 6, 7]
    assert list(by_strips) == [0, 3, 1, 2]
    assert list(slots) == [min(s - 1, 2) for s in strips] and nslots == 3
    _, _, _, _, capped = gp.pipeline_plan(np.array([1 << 20]), np.array([1 << 20]), 1 << 20,
                                          256, resident=5000)
    assert capped == gp.PIPE_RING_BYTES // (8 * ((1 << 20) + 1))


@pytest.mark.parametrize("Lm,rows,want", [
    (0, 256, 32), (31, 256, 32), (32, 256, 64), (100, 256, 128), (200, 256, 256),
    (300, 256, 256), (300, 512, 512), (8191, 256, 256), (700, 32, 32), (700, 64, 64),
])
def test_pipe_rows_are_compiled_heights(Lm, rows, want):
    """The warp-strip pipeline's strip height is 32 x RT for a compiled RT
    (1, 2, 4, 8, 16): the asked height, or the least that holds a short
    bucket's Lm + 1 rows."""
    got = gp.pipe_rows(Lm, rows)
    assert got == want and got // 32 in gp.LANE_ROWS and got % 32 == 0
    assert gp.strip_height(Lm + 1) >= min(Lm + 1, gp.PIPE_MAX_ROWS)


def test_pipeline_plan_band_rows_from_one():
    """The band fill's plan counts rows 1..m (ceil(m / H) strips, not
    (m + H) // H); ring slots a pair stay min(strips - 1, k)."""
    ms, ns = np.array([512, 513, 1, 1024, 1600]), np.array([500, 510, 1, 1000, 1600])
    plan, nlevels, total, blocks, nslots = gp.pipeline_plan(ms, ns, 2559, 512, resident=6,
                                                            row0=1)
    strips = [1, 2, 1, 2, 4]
    assert list(gp.strip_counts(ms, 512, 1)) == strips
    assert (nlevels, total, blocks) == (4, 10, 6)
    B = 5
    slots = plan[5 * B + 2 + nlevels :]
    k = -(-blocks // B) + 1
    assert list(slots) == [min(s - 1, k) for s in strips] and nslots == sum(slots)
    assert list(gp.strip_counts(ms, 512)) == [2, 2, 1, 3, 4]  # rows 0..m (K9)


def test_pipeline_plan_cuts_the_grid_to_what_runs():
    """A warp beyond the strips that can sweep at once only spins: the
    grid is cut to min(strips, slots + 1) a pair (the 1 Mb pair at the
    warp pipeline's ring: its slots + 1), and to ``inflight`` when given."""
    ms, ns = np.array([1_078_175]), np.array([1_076_816])
    Ln = 1_076_863
    _, _, total, blocks, nslots = gp.pipeline_plan(
        ms, ns, Ln, 256, 2772, inflight=gp.strips_in_flight(ns + 1, 0))
    assert nslots == gp.ring_budget(Ln) == gp.PIPE_RING_BYTES // (8 * (Ln + 1)) < total - 1
    assert blocks == nslots + 1
    assert list(gp.strips_in_flight([29_893, 2_208], [0, 128])) == [470, 14]
    ms, ns = np.array([1000, 1000, 50]), np.array([900, 900, 900])
    _, _, total, blocks, _ = gp.pipeline_plan(ms, ns, 1023, 64, 100, inflight=[3, 4, 5])
    assert total == 16 + 16 + 1 and blocks == 3 + 4 + 1


def test_pipeline_groups_keep_two_slots_a_pair(monkeypatch):
    """A bucket whose pairs cannot all hold two ring slots at once splits
    into launches that can; no pair of three or more strips gets one slot
    (its strips would write the slot they read)."""
    Ln, rows = 767, 64
    monkeypatch.setattr(gp, "PIPE_RING_BYTES", 5 * 8 * (Ln + 1))  # five slots
    ms = np.array([700, 0, 130, 1, 257, 700, 513])  # 11, 1, 3, 1, 5, 11, 9 strips
    groups = gp.pipeline_groups(ms, Ln, rows)
    assert groups == [(0, 4), (4, 6), (6, 7)]
    got = []
    for lo, hi in groups:
        plan, nlevels, _, _, nslots = gp.pipeline_plan(ms[lo:hi], ms[lo:hi], Ln, rows, resident=3)
        got.append(list(plan[5 * (hi - lo) + 2 + nlevels :]))
        assert nslots <= 5
    assert got == [[2, 0, 2, 0], [2, 2], [4]]
    assert gp.pipeline_groups(np.array([10, 20]), Ln, rows) == [(0, 2)]  # one strip each: no slot
    monkeypatch.setattr(gp, "PIPE_RING_BYTES", 8 * (Ln + 1))
    with pytest.raises(ValueError, match="PIPE_RING_BYTES"):
        gp.pipeline_groups(ms, Ln, rows)
    with pytest.raises(ValueError, match="PIPE_RING_BYTES"):
        gp.pipeline_plan(ms, ms, Ln, rows, resident=3)


def test_drift_magnitude_scores_match_scan():
    """Scores past the JAX kernels' int32 drift headroom (K x rate >=
    2**30). The port has no guard (it computes only true cells) and gives
    the scan oracle's answer; the JAX wrapper's guard does not fire either,
    as its jit traces the scores (``drift_rate_or_none`` is None there)."""
    big = (1 << 21, -(1 << 21), -(1 << 20), -(1 << 20))
    rate = gp.drift_rate_or_none(Scores.from_tuple(big))
    assert rate == 6 * (1 << 20) + 1 and (128 + 128 + 1) * rate >= 1 << 30
    assert gp.drift_rate_or_none(object()) is None
    rng = np.random.default_rng(4)
    args = random_batch(rng, 3, 128, 128)
    for is_local in (False, True):
        want = scan_scores(*args, big, is_local)
        assert_same(port_scores(gp.gotoh_scores_pallas_batch, *args, big, is_local), want)
        assert_same(jax_pallas_batch(*args, JaxScores(*big), is_local, interpret=True), want)


def test_wrappers_keep_devices_apart_and_count():
    s = torch.zeros((1, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        gp._pallas_cuda(s, s, [1], [1], Scores(), False)
    before = dict(gp.COUNTS)
    gp.gotoh_scores_pallas_batch(s, s, [1], [1], Scores())
    assert gp.COUNTS == {"kernel": before["kernel"], "plain": before["plain"] + 1}
    assert gp.concrete_lengths_or_none(torch.tensor([3, 4]), [5, 6])[1].tolist() == [5, 6]
    assert gp.concrete_lengths_or_none(torch.empty(2, device="meta"), [1, 2]) is None


def test_allpairs_pallas_engine_matches_auto():
    seqs = _corpus(8, (90, 300, 280, 130))
    c = SequenceContainer([Sequence(n, s) for n, s in seqs])
    for is_local in (False, True):
        want = ap.allpairs_scores(c, Scores(), is_local=is_local, device="cpu")
        before = gp.COUNTS["plain"]
        got = ap.allpairs_scores(c, Scores(), is_local=is_local, engine="pallas", device="cpu")
        assert np.array_equal(got.matrix, want.matrix)
        pairs = [(i, j) for j in range(4) for i in range(j + 1)]
        buckets = ap.bucketize_pairs(pairs, [len(s) for _, s in seqs])
        assert gp.COUNTS["plain"] - before == len(buckets) > 1  # one call a bucket
    with pytest.raises(ValueError, match="unknown engine"):
        batch.score_pairs(np.zeros((1, 8), np.uint8), np.zeros((1, 8), np.uint8), [1], [1],
                          Scores(), engine="bogus", device="cpu")


@pytest.mark.parametrize("kind", ["global", "local"])
def test_cli_reads_pallas_matches_auto_and_jax(tmp_path, capsys, monkeypatch, kind):
    qs, rs = _reads(47, 7, 20, 300)
    q, r, cfg = _write_inputs(tmp_path, qs, rs, CLASSIC)
    argv = ["-c", cfg, "reads", "-q", q, "-r", r, "-a", kind, "--both-strands"]
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, "scores.tsv",
                         ["--engine", "pallas"])
    assert runs["port"] == runs["jax"]
    from genomics_rs_tpu_torch import cli

    auto = tmp_path / "auto.tsv"
    assert cli.main(argv + ["-o", str(auto), "--device", "cpu"]) == 0
    assert auto.read_bytes() == runs["port"][1]


@pytest.mark.parametrize("kind", ["global", "local"])
def test_cli_align_matrix_pallas_matches_jax_scan(tmp_path, capsys, monkeypatch, kind):
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    fasta_dir, cfg = _write_corpus(tmp_path, _corpus(9, (100, 260, 120, 300)), KIMURA)
    runs = {}
    for name, mod, extra in (("jax", jax_cli, ["--engine", "scan"]),
                             ("port", cli, ["--engine", "pallas", "--device", "cpu"])):
        argv = ["-c", cfg, "align-matrix", "-a", kind, "-f", fasta_dir,
                "-o", str(tmp_path / f"{name}.tsv")]
        assert mod.main(argv + extra) == 0
        runs[name] = (_stdout_without_timing(capsys.readouterr().out),
                      (tmp_path / f"{name}.tsv").read_bytes())
    assert runs["port"] == runs["jax"]


def test_cli_msa_pallas_matches_jax_scan(tmp_path, capsys, monkeypatch):
    from genomics_rs_tpu import cli as jax_cli
    from genomics_rs_tpu_torch import cli

    monkeypatch.setenv("GENOMICS_TPU_JAX_CACHE", str(tmp_path / "jaxcache"))
    fasta_dir, cfg = _write_corpus(tmp_path, _corpus(10, (110, 140, 120, 100, 130)), CLASSIC)
    outs = {}
    for name, mod, extra in (("jax", jax_cli, ["--engine", "scan"]),
                             ("port", cli, ["--engine", "pallas", "--device", "cpu"])):
        out = tmp_path / f"{name}.fasta"
        argv = ["-c", cfg, "msa", "-f", fasta_dir, "--format", "fasta", "-o", str(out)]
        assert mod.main(argv + extra) == 0
        stdout = capsys.readouterr().out.replace(str(out), "OUT")
        outs[name] = (stdout.split("\x1b[0m", 1)[1], out.read_bytes())
    assert "multiple sequence alignment" in outs["port"][0]
    assert outs["port"] == outs["jax"]
