"""The segmented tier (K7) of the port on the CPU against the JAX package:
``gotoh_scores_segmented`` (the warp-strip kernel's plain version, strips
of 32 x R rows) against JAX ``gotoh_scores_segmented(interpret=True)`` on
the cases of ``tests/test_segmented.py`` and against the scan oracle
(``batch_scores``) on random batches; ``route_engine`` against the pick of
JAX's ``score_pairs`` on its device (the backend probe monkeypatched, as
``tests/test_segmented.py`` does); and ``reads --engine segmented``
against ``--engine auto`` and the JAX CLI. The DP is int32: every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops.gotoh_segmented import gotoh_scores_segmented as jax_segmented
from genomics_rs_tpu.parallel.batch import batch_scores
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops import gotoh_segmented as gseg
from genomics_rs_tpu_torch.parallel import batch
from tests.test_torch_reads import (  # noqa: F401
    CLASSIC,
    KIMURA,
    _reads,
    _write_inputs,
    one_torch_thread,
    run_both_clis,
)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
#: tests/test_segmented.py's scores, and a kimura set.
SEG = (1, -2, -1, -5)


def random_batch(rng, B, Lm, Ln, lo=2):
    """``tests/test_segmented.py``'s inputs: random bases, lengths lo..L."""
    ms = rng.integers(lo, Lm + 1, B).astype(np.int32)
    ns = rng.integers(lo, Ln + 1, B).astype(np.int32)
    s1b = np.full((B, Lm), 0xFE, np.uint8)
    s2b = np.full((B, Ln), 0xFF, np.uint8)
    for i in range(B):
        s1b[i, : ms[i]] = BASES[rng.integers(0, 4, ms[i])]
        s2b[i, : ns[i]] = BASES[rng.integers(0, 4, ns[i])]
    return s1b, s2b, ms, ns


def port_scores(fn, s1b, s2b, ms, ns, score_t, is_local, **kw):
    out = fn(torch.from_numpy(s1b), torch.from_numpy(s2b), ms, ns, Scores.from_tuple(score_t),
             is_local, **kw)
    return [np.asarray(x.numpy(), np.int64) for x in out]


def scan_scores(s1b, s2b, ms, ns, score_t, is_local):
    r = batch_scores(s1b, s2b, ms, ns, JaxScores(*score_t), is_local)
    return [np.asarray(x, np.int64) for x in (r.score, r.start_i, r.start_j)]


def assert_same(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64)), (got, want)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize(
    "B,Lm,Ln,score_t",
    [(5, 300, 200, SEG), (12, 700, 900, SEG), (3, 120, 50, SEG), (5, 300, 200, KIMURA)],
    ids=["5x300x200", "12x700x900", "3x120x50", "5x300x200-kimura"],
)
def test_segmented_matches_jax_interpret(is_local, B, Lm, Ln, score_t):
    rng = np.random.default_rng(B * Lm + Ln)
    args = random_batch(rng, B, Lm, Ln)
    want = jax_segmented(*args, JaxScores(*score_t), is_local, interpret=True)
    assert_same(port_scores(gseg.gotoh_scores_segmented, *args, score_t, is_local), want)


@pytest.mark.parametrize("rows_per_lane,B,Lm,Ln", [(8, 16, 384, 256), (4, 7, 130, 384)])
@pytest.mark.parametrize("is_local", [False, True])
def test_segmented_matches_scan_random(is_local, rows_per_lane, B, Lm, Ln):
    """Random batches (B <= 16, L <= 384) with empty sequences: the route,
    and the plain version at the kernel's strip height (256 rows) and at
    128 rows."""
    rng = np.random.default_rng(3 + is_local)
    args = random_batch(rng, B, Lm, Ln, lo=0)
    want = scan_scores(*args, KIMURA, is_local)
    assert_same(port_scores(gp.gotoh_strips_plain, *args, KIMURA, is_local,
                            rows_per_strip=32 * rows_per_lane), want)
    if rows_per_lane == gseg.ROWS_PER_LANE:
        assert_same(port_scores(gseg.gotoh_scores_segmented, *args, KIMURA, is_local), want)


def test_cpu_route_counts_plain_calls():
    rng = np.random.default_rng(1)
    before = dict(gseg.COUNTS)
    port_scores(gseg.gotoh_scores_segmented, *random_batch(rng, 2, 40, 40), CLASSIC, False)
    assert gseg.COUNTS == {"kernel": before["kernel"], "plain": before["plain"] + 1}
    s = torch.zeros((1, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        gseg.warp_strip_cuda(s, s, [1], [1], Scores(), False)


#: (B, Lm, Ln, is_local): every tier boundary of the JAX router.
ROUTE_GRID = [(B, Lm, Ln, loc)
              for B in (1, 2, 9)
              for Lm, Ln in ((128, 256), (256, 256), (384, 128), (1024, 1024), (1152, 640),
                             (2048, 4096), (8192, 8192), (8320, 1024), (16384, 16384))
              for loc in (False, True)]


def jax_pick(monkeypatch, B, Lm, Ln, is_local) -> str:
    """The engine JAX's ``score_pairs`` runs on its device for this bucket."""
    import genomics_rs_tpu.parallel.batch as jb

    picked = {}

    def fake(name):
        def f(s1b, s2b, ms, ns, scores, is_local, interpret=False, **kw):
            picked["engine"] = name
            return np.zeros(len(ms)), np.zeros(len(ms)), np.zeros(len(ms))
        return f

    for mod, fn, name in (("gotoh_shortread", "gotoh_scores_shortread", "shortread"),
                          ("gotoh_segmented", "gotoh_scores_segmented", "segmented"),
                          ("gotoh_stream8", "gotoh_scores_stream8", "stream8"),
                          ("gotoh_stream", "gotoh_scores_stream", "stream"),
                          ("gotoh_pallas", "gotoh_scores_pallas_batch", "pallas")):
        monkeypatch.setattr(f"genomics_rs_tpu.ops.{mod}.{fn}", fake(name))
    monkeypatch.setattr(jb.jax, "default_backend", lambda: "tpu")
    ms, ns = np.full(B, Lm - 3, np.int32), np.full(B, Ln - 5, np.int32)
    jb.score_pairs(np.zeros((B, Lm), np.uint8), np.zeros((B, Ln), np.uint8), ms, ns,
                   JaxScores(), is_local, engine="auto")
    return picked["engine"]


def test_route_engine_matches_jax_router(monkeypatch):
    for B, Lm, Ln, loc in ROUTE_GRID:
        ms, ns = np.full(B, Lm - 3), np.full(B, Ln - 5)
        assert batch.route_engine(B, Lm, Ln, loc, ms, ns) == jax_pick(monkeypatch, B, Lm, Ln, loc), (
            B, Lm, Ln, loc)


def test_route_engine_short_buckets_k6_does_not_take():
    """Differences by design: a short bucket with an empty sequence or
    ``Ln % 16 != 0`` goes to the segmented kernel (JAX sends it to its
    short-read wrapper); the answers are equal."""
    assert batch.route_engine(4, 128, 256, False, [5, 0, 3, 9], [4, 4, 4, 4]) == "segmented"
    assert batch.route_engine(4, 128, 200, True, [5, 1, 3, 9], [4, 4, 4, 4]) == "segmented"
    assert batch.route_engine(4, 128, 256, True, [5, 1, 3, 9], [4, 4, 4, 4]) == "shortread"
    rng = np.random.default_rng(12)
    args = random_batch(rng, 6, 128, 200, lo=0)
    for is_local in (False, True):
        got = batch.score_pairs(*args, Scores(), is_local, engine="auto", device="cpu")
        assert_same(got, scan_scores(*args, Scores().as_tuple(), is_local))


@pytest.mark.parametrize("kind", ["local", "global"])
def test_cli_reads_segmented_matches_auto_and_jax(tmp_path, capsys, monkeypatch, kind):
    qs, rs = _reads(41, 7, 20, 300)
    q, r, cfg = _write_inputs(tmp_path, qs, rs, KIMURA)
    argv = ["-c", cfg, "reads", "-q", q, "-r", r, "-a", kind, "--both-strands"]
    # The JAX CLI takes its CPU route (auto: the scan engine).
    runs = run_both_clis(tmp_path, capsys, monkeypatch, argv, "scores.tsv",
                         ["--engine", "segmented"])
    assert runs["port"] == runs["jax"]
    from genomics_rs_tpu_torch import cli

    auto = tmp_path / "auto.tsv"
    assert cli.main(argv + ["-o", str(auto), "--device", "cpu"]) == 0
    assert auto.read_bytes() == runs["port"][1]
