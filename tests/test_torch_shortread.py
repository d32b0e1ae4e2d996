"""The port's short-read fill (K6's plain version) and batched walk on
``device="cpu"`` against the JAX package: ``gotoh_scores_shortread``
against JAX ``gotoh_scores_shortread(..., interpret=True)`` (scores,
start cells, rows16 codes at every true cell), ``walk_batch`` against
JAX ``walk_batch`` on the rows16 and diag16 layouts, ``classify_batch``
and ``_batch_cigars`` against JAX's, and the ``score_pairs`` router.
Every result is an integer: equality throughout.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops import traceback_batch as jax_tb
from genomics_rs_tpu.ops.gotoh_shortread import gotoh_scores_shortread as jax_shortread
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_segmented as gseg
from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import traceback_batch as tb
from genomics_rs_tpu_torch.parallel import batch
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence
from tests.test_torch_reads import one_torch_thread  # noqa: F401

CLASSIC = (1, -2, -1, -5)
KIMURA = (2, -3, -2, -4, -1)
BASES = np.frombuffer(b"ACGT", np.uint8)


def _batch(seed, B, L1, L2, related=True, lengths=()):
    """Padded (B, L1), (B, L2) byte batches with true lengths >= 1;
    odd pairs share a prefix, so paths hold long match runs. ``lengths``
    sets the first pairs' (m, n) after pair 0 (which fills its bucket);
    by default pair 1 is (1, 1)."""
    rng = np.random.default_rng(seed)
    ms = rng.integers(1, L1 + 1, B)
    ns = rng.integers(1, L2 + 1, B)
    ms[0], ns[0] = L1, L2  # one pair fills its bucket
    for b, (m, n) in enumerate(lengths or [(1, 1)], 1):
        ms[b], ns[b] = m, n
    s1 = np.full((B, L1), PAD_S1, np.uint8)
    s2 = np.full((B, L2), PAD_S2, np.uint8)
    for b in range(B):
        s1[b, : ms[b]] = BASES[rng.integers(0, 4, ms[b])]
        s2[b, : ns[b]] = BASES[rng.integers(0, 4, ns[b])]
        if related and b % 2:
            k = min(ms[b], ns[b])
            s2[b, :k] = s1[b, :k]
            flip = np.nonzero(rng.random(k) < 0.1)[0]
            s2[b, flip] = BASES[rng.integers(0, 4, flip.size)]
    return s1, s2, ms.astype(np.int32), ns.astype(np.int32)


def _tie_batch(seed, B, L1, L2):
    """Both sides of each pair repeat one unit of 1-4 bases, so local bests
    tie on many rows and columns; lengths as :func:`_batch`'s."""
    rng = np.random.default_rng(seed)
    s1, s2, ms, ns = _batch(seed, B, L1, L2, related=False)
    for b in range(B):
        unit = BASES[rng.integers(0, 4, int(rng.integers(1, 5)))]
        s1[b, : ms[b]], s2[b, : ns[b]] = np.resize(unit, ms[b]), np.resize(unit, ns[b])
    return s1, s2, ms, ns


def _true_codes(codes, ms, ns):
    """Every true cell's 2-bit code, (i, j) row-major, per pair."""
    codes = np.asarray(codes).astype(np.int64)
    out = []
    for b in range(len(ms)):
        j = np.arange(ns[b])
        words = codes[b, : ms[b]][:, j // 16]
        out.append((words >> (2 * (j % 16))) & 3)
    return out


@pytest.mark.parametrize("emit_dirs", [False, True], ids=["scores", "dirs"])
@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_shortread_plain_matches_jax_interpret(emit_dirs, is_local, score_t):
    s1, s2, ms, ns = _batch(11, 7, 64, 48)
    got = gsr.gotoh_scores_shortread(
        torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, Scores.from_tuple(score_t),
        is_local, emit_dirs=emit_dirs)
    want = jax_shortread(s1, s2, ms, ns, JaxScores(*score_t), is_local,
                         emit_dirs=emit_dirs, interpret=True)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    if emit_dirs:
        assert got[3].shape == (7, 64, 3) and got[3].dtype == torch.int32
        for g, w in zip(_true_codes(got[3].numpy(), ms, ns), _true_codes(want[3], ms, ns)):
            assert np.array_equal(g, w)


def _jax_equal(s1, s2, ms, ns, score_t, is_local):
    """The plain version == JAX's interpret-mode kernel: scores, start
    cells and codes at every true cell."""
    got = gsr.gotoh_scores_shortread(
        torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, Scores.from_tuple(score_t),
        is_local, emit_dirs=True)
    want = jax_shortread(s1, s2, ms, ns, JaxScores(*score_t), is_local, emit_dirs=True,
                         interpret=True)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(_true_codes(got[3].numpy(), ms, ns), _true_codes(want[3], ms, ns)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("L1,L2", [(32, 16), (32, 256), (128, 160), (128, 256), (160, 16),
                                   (160, 160), (160, 256)])
@pytest.mark.parametrize("is_local", [False, True])
def test_shortread_plain_matches_jax_at_kernel_edges(L1, L2, is_local):
    """The shapes where the sub-warp kernel's lanes and words end: pairs of
    one row and one column, a pair filling the bucket, rows ending inside a
    lane (m < L1, not a multiple of G x RT) and columns ending inside a
    16-code word."""
    lengths = [(1, 1), (1, L2), (L1, 1), (L1 - 3, L2 - 5 if L2 > 16 else 7), (17, 9)]
    _jax_equal(*_batch(40 + L1 + L2, 8, L1, L2, lengths=lengths), KIMURA, is_local)


@pytest.mark.parametrize("L1,L2", [(128, 256), (160, 160)])
def test_shortread_plain_matches_jax_on_local_ties(L1, L2):
    """Repeated sequences: local bests tie on many rows and columns, and
    the plain version keeps JAX's (larger value, then i, then j)."""
    _jax_equal(*_tie_batch(60 + L1, 8, L1, L2), CLASSIC, True)


@pytest.mark.parametrize("is_local", [False, True])
def test_k6_codes_equal_the_shared_cell_on_ties(is_local):
    """The kernel computes its cells by ``gotoh_stream_body.cuh``'s
    ``gotoh_cell``, K3's cell, and tests its codes against the pre-floor
    max as K3 does. Its plain version (``gotoh_stream_plain``) gives the
    same codes as K6's plain version at every interior true cell on
    tie-heavy batches, and the same global scores and positive local
    bests."""
    s1, s2, ms, ns = _tie_batch(71, 9, 128, 160)
    sc = Scores.from_tuple(KIMURA)
    t1, t2 = torch.from_numpy(s1), torch.from_numpy(s2)
    k6 = gsr.gotoh_shortread_plain(t1, t2, ms, ns, sc, is_local, emit_dirs=True)
    k3 = gs.gotoh_stream_plain(t1, t2, ms, ns, sc, is_local, emit_dirs=True)
    d3 = k3.dirs.numpy().astype(np.int64)
    for b, want in enumerate(_true_codes(k6[3].numpy(), ms, ns)):
        i = np.arange(1, ms[b] + 1)[:, None]
        j = np.arange(1, ns[b] + 1)[None, :]
        k = i + j
        assert np.array_equal((d3[b, k // 16, i] >> (2 * (k % 16))) & 3, want)
    v6, v3 = k6[0].numpy(), k3.score.numpy()
    assert np.array_equal(v6, v3)
    if is_local:
        pos = v6 > 0
        assert np.array_equal(k6[1].numpy()[pos], k3.start_i.numpy()[pos])
        assert np.array_equal(k6[2].numpy()[pos], k3.start_j.numpy()[pos])


def test_group_size_at_the_paths_shapes():
    """G (lanes a pair) and RT (rows a lane) for the reads' shapes: 152 rows
    (``reads``, bench.py's batch), 128 (``map``), 256 (the tier's bound)
    and small batches; G x RT holds the rows with the least compiled RT."""
    for rows in (1, 5, 32, 100, 128, 150, 152, 160, 200, 256):
        G = gsr.group_size(rows)
        assert G in gsr.GROUP_SIZES
        for g in gsr.GROUP_SIZES:
            rt = gsr.lane_rows(rows, g)
            assert rt in gsr.LANE_ROWS and g * rt >= rows
            assert all(g * r < rows for r in gsr.LANE_ROWS if r < rt)
    assert [gsr.group_size(r) for r in (1, 128, 152, 160, 161, 256)] == [8, 8, 8, 8, 32, 32]
    assert [gsr.lane_rows(r, gsr.group_size(r)) for r in (1, 128, 152, 256)] == [4, 16, 20, 8]
    with pytest.raises(ValueError, match="lanes a pair"):
        gsr.lane_rows(128, 4)
    with pytest.raises(ValueError, match="rows pass"):
        gsr.lane_rows(257, 8)


def test_shortread_local_empty_alignment():
    """A pair with no positive cell is the empty alignment: score 0 at
    (m, n), as the JAX wrapper gives it."""
    s1 = np.full((2, 32), PAD_S1, np.uint8)
    s2 = np.full((2, 16), PAD_S2, np.uint8)
    s1[0, :5], s2[0, :4] = np.frombuffer(b"AAAAA", np.uint8), np.frombuffer(b"CCCC", np.uint8)
    s1[1, :3], s2[1, :3] = np.frombuffer(b"ACG", np.uint8), np.frombuffer(b"ACG", np.uint8)
    ms, ns = np.array([5, 3]), np.array([4, 3])
    sc = Scores.from_tuple(CLASSIC)
    got = gsr.gotoh_scores_shortread(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc, True)
    want = jax_shortread(s1, s2, ms, ns, JaxScores(*CLASSIC), True, interpret=True)
    assert [x.tolist() for x in got] == [np.asarray(w).tolist() for w in want]
    assert [int(x[0]) for x in got] == [0, 5, 4]


@pytest.mark.parametrize(
    "L1,L2,ms,ns,emit_dirs,match",
    [(32, 272, [3], [3], False, "multiple of 16 up to 256"),
     (32, 40, [3], [3], False, "multiple of 16"),
     (48, 32, [3], [3], True, "32-row code chunk"),
     (32, 32, [0], [3], False, "lengths outside"),
     (32, 32, [3], [33], False, "lengths outside")],
)
def test_shortread_rejects_what_the_kernel_does_not_take(L1, L2, ms, ns, emit_dirs, match):
    s1 = torch.zeros((1, L1), dtype=torch.uint8)
    s2 = torch.zeros((1, L2), dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        gsr.gotoh_scores_shortread(s1, s2, ms, ns, Scores(), False, emit_dirs=emit_dirs)


@pytest.mark.parametrize("is_local", [False, True])
def test_walk_batch_rows16_matches_jax(is_local):
    s1, s2, ms, ns = _batch(21, 9, 64, 64)
    sc, jsc = Scores.from_tuple(CLASSIC), JaxScores(*CLASSIC)
    score, si, sj, codes = gsr.gotoh_scores_shortread(
        torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc, is_local, emit_dirs=True)
    max_steps = 64 + 64 + 1
    got = tb.walk_batch(codes, si, sj, sc, is_local, "rows16", max_steps)
    want = jax_tb.walk_batch(codes.numpy(), si.numpy(), sj.numpy(), jsc, is_local,
                             "rows16", max_steps)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert got[0].shape == (9, max_steps) and got[0].dtype == np.uint8
    assert all(got[4])
    if not is_local:
        assert not got[2].any() and not got[3].any()


@pytest.mark.parametrize("is_local", [False, True])
def test_walk_batch_diag16_matches_jax(is_local):
    """K3's per-pair bitmaps (B, KW, V) are JAX's diag16 layout."""
    s1, s2, ms, ns = _batch(22, 5, 128, 128)
    sc, jsc = Scores.from_tuple(KIMURA), JaxScores(*KIMURA)
    fill = gs.gotoh_stream_fill(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc,
                                is_local, emit_dirs=True)
    max_steps = 257
    got = tb.walk_batch(fill.dirs, fill.start_i, fill.start_j, sc, is_local, "diag16", max_steps)
    want = jax_tb.walk_batch(fill.dirs.numpy(), fill.start_i.numpy(), fill.start_j.numpy(),
                             jsc, is_local, "diag16", max_steps)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_walk_batch_rejects_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        tb.walk_batch(torch.zeros((1, 2, 2), dtype=torch.int32), [1], [1], Scores(), False,
                      "rows4", 5)


@pytest.mark.parametrize("layout", ["rows16", "diag16"])
def test_walk_batch_empty(layout):
    moves, counts, i_f, j_f, done = tb.walk_batch(
        torch.zeros((0, 32, 2), dtype=torch.int32), [], [], Scores(), True, layout, 9)
    assert moves.shape == (0, 9) and moves.dtype == np.uint8
    assert counts.size == i_f.size == j_f.size == done.size == 0


@pytest.mark.parametrize("with_paths", [False, True])
@pytest.mark.parametrize("encoded", [False, True])
def test_classify_batch_matches_jax(with_paths, encoded):
    s1, s2, ms, ns = _batch(23, 8, 64, 64)
    sc = Scores.from_tuple(CLASSIC)
    score, si, sj, codes = gsr.gotoh_scores_shortread(
        torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc, False, emit_dirs=True)
    moves, counts, *_ = tb.walk_batch(codes, si, sj, sc, False, "rows16", 129)
    qs = [Sequence(f"q{b}", s1[b, : ms[b]].tobytes().decode()) for b in range(8)]
    rs = [Sequence(f"r{b}", s2[b, : ns[b]].tobytes().decode()) for b in range(8)]
    jqs = [JaxSequence(q.name, q.sequence) for q in qs]
    jrs = [JaxSequence(r.name, r.sequence) for r in rs]
    enc = (s1, s2, ms, ns) if encoded else None
    args = (moves, counts, si.numpy(), sj.numpy(), score.numpy())
    got, gcig = tb.classify_batch(*args, qs, rs, with_paths=with_paths, encoded=enc)
    want, wcig = jax_tb.classify_batch(*args, jqs, jrs, with_paths=with_paths, encoded=enc)
    assert gcig == wcig
    assert any("I" in c or "D" in c for c in gcig)
    for a, b in zip(got, want):
        assert (a.score, a.matches, a.mismatches, a.gap_extensions, a.opening_gaps) == (
            b.score, b.matches, b.mismatches, b.gap_extensions, b.opening_gaps)
        assert [(c.value, i, j) for c, i, j in a.alignment] == [
            (c.value, i, j) for c, i, j in b.alignment]


def test_batch_cigars_matches_jax():
    rng = np.random.default_rng(3)
    cigc = rng.integers(1, 4, (6, 20)).astype(np.uint8)
    counts = np.array([0, 1, 20, 7, 13, 2])
    assert tb._batch_cigars(cigc, counts) == jax_tb._batch_cigars(cigc, counts)


def test_score_pairs_routes_short_buckets_to_k6():
    s1, s2, ms, ns = _batch(24, 6, 128, 128)
    before = dict(gsr.COUNTS), dict(gs.COUNTS), dict(gseg.COUNTS)
    auto = batch.score_pairs(s1, s2, ms, ns, Scores(), True, device="cpu")
    assert gsr.COUNTS["plain"] == before[0]["plain"] + 1
    short = batch.score_pairs(s1, s2, ms, ns, Scores(), True, engine="shortread", device="cpu")
    stream = batch.score_pairs(s1, s2, ms, ns, Scores(), True, engine="stream", device="cpu")
    assert gs.COUNTS["plain"] == before[1]["plain"] + 1
    for a, b, c in zip(auto, short, stream):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    # An empty sequence or a wide bucket goes to the segmented tier (K7),
    # as the JAX router tiers a local bucket of Lm <= 8192.
    ns0 = ns.copy()
    ns0[2] = 0
    batch.score_pairs(s1, s2, ms, ns0, Scores(), True, device="cpu")
    wide = np.full((6, 384), PAD_S2, np.uint8)
    wide[:, :128] = s2
    batch.score_pairs(s1, wide, ms, ns, Scores(), True, device="cpu")
    assert gseg.COUNTS["plain"] == before[2]["plain"] + 2
    assert gs.COUNTS["plain"] == before[1]["plain"] + 1
    assert gsr.COUNTS["plain"] == before[0]["plain"] + 2
