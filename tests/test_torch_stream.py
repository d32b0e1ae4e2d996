"""The port's batched fill (K3's plain version) and batched walker (K4's
plain version) against the JAX package, on the CPU.

``gotoh_stream_plain`` is held against the JAX stream kernel
(``gotoh_scores_stream(interpret=True)``) and the scan oracle
(``parallel.batch.batch_scores``); its dirs, walked by
``walk_many_plain``, against ``gotoh_stream_fill_dirs`` +
``walk_many(interpret=True)``, down to the code at every true cell.
The DP is int32, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops.gotoh_stream import gotoh_scores_stream as jax_scores_stream
from genomics_rs_tpu.ops.gotoh_stream import gotoh_stream_fill_dirs as jax_fill_dirs
from genomics_rs_tpu.ops import traceback_pallas as jax_tp
from genomics_rs_tpu.parallel.batch import batch_scores
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import traceback_device as td
from genomics_rs_tpu_torch.ops import traceback_walker as tw
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CLASSIC = (1, -2, -1, -5)
KIMURA = (2, -3, -2, -4, -1)


def _batch(rng, ms, ns, Lm, Ln, related=True):
    """Padded (B, Lm), (B, Ln) byte batches; ``related`` pairs share a
    base string (shifted), so paths hold long matches and gaps."""
    B = len(ms)
    s1 = np.full((B, Lm), PAD_S1, np.uint8)
    s2 = np.full((B, Ln), PAD_S2, np.uint8)
    for b in range(B):
        base = BASES[rng.integers(0, 4, max(Lm, Ln) + 40)]
        s1[b, : ms[b]] = base[: ms[b]]
        other = base[17 : 17 + ns[b]].copy() if related else BASES[rng.integers(0, 4, ns[b])]
        flip = rng.random(ns[b]) < 0.08
        other[flip] = BASES[rng.integers(0, 4, int(flip.sum()))]
        s2[b, : ns[b]] = other
    return s1, s2, np.asarray(ms, np.int32), np.asarray(ns, np.int32)


def _port(s1, s2, ms, ns, score_t, is_local):
    out = gs.gotoh_scores_stream(
        torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, Scores.from_tuple(score_t), is_local
    )
    return [x.numpy() for x in out]


def _scan(s1, s2, ms, ns, score_t, is_local):
    r = batch_scores(s1, s2, ms, ns, JaxScores(*score_t), is_local)
    return [np.asarray(x) for x in (r.score, r.start_i, r.start_j)]


def _same(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64)), (got, want)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_stream_plain_matches_jax_stream_and_scan(is_local, score_t):
    """Mixed lengths inside one (256, 256) bucket."""
    rng = np.random.default_rng(11 + is_local)
    batch = _batch(rng, [256, 200, 131, 250], [240, 256, 180, 97], 256, 256)
    got = _port(*batch, score_t, is_local)
    want = jax_scores_stream(*batch, JaxScores(*score_t), is_local, interpret=True)
    _same(got, [np.asarray(x) for x in want])
    _same(got, _scan(*batch, score_t, is_local))


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_stream_plain_edge_cases_match_jax(is_local, score_t):
    """Zero-length sequences (the JAX wrapper's fallbacks) and B = 1."""
    rng = np.random.default_rng(5)
    batch = _batch(rng, [0, 5, 128, 3, 0], [7, 0, 100, 128, 0], 128, 128, related=False)
    got = _port(*batch, score_t, is_local)
    _same(got, _scan(*batch, score_t, is_local))
    _same(got, [np.asarray(x) for x in jax_scores_stream(
        *batch, JaxScores(*score_t), is_local, interpret=True)])
    one = _batch(rng, [120], [128], 128, 128)
    _same(_port(*one, score_t, is_local), _scan(*one, score_t, is_local))


def _codes(words: np.ndarray, rows: int, cols: int, koff: int) -> np.ndarray:
    """Codes at cells (i <= rows, j <= cols) of a diag16 bitmap whose
    word rows start at ``koff``."""
    i = np.arange(rows + 1)[:, None]
    k = i + np.arange(cols + 1)[None, :]
    return (words[koff + k // 16, i].astype(np.int64) >> (2 * (k % 16))) & 3


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_stream_dirs_and_walk_many_match_jax(is_local, score_t):
    """KW >= 34 for the JAX walker's DMA window: Lm = 384, Ln = 256."""
    rng = np.random.default_rng(21 + is_local)
    batch = _batch(rng, [384, 300, 200], [256, 250, 180], 384, 256)
    ms, ns = batch[2], batch[3]
    jr = jax_fill_dirs(*batch, JaxScores(*score_t), is_local=is_local, interpret=True)
    pr = gs.gotoh_stream_fill_dirs(
        torch.from_numpy(batch[0]), torch.from_numpy(batch[1]), ms, ns,
        Scores.from_tuple(score_t), is_local,
    )
    _same((pr.score, pr.start_i, pr.start_j),
          [np.asarray(x) for x in (jr.score, jr.start_i, jr.start_j)])
    jdirs = np.asarray(jr.dirs)
    B, KW = len(ms), pr.KW
    for t in range(B):
        assert np.array_equal(
            _codes(pr.dirs[t].numpy(), ms[t], ns[t], 0),
            _codes(jdirs, ms[t], ns[t], t * (jr.L1 // 16)),
        )
    jw = jax.device_get(jax_tp.walk_many(
        jr.dirs, np.asarray(jr.start_i, np.int32), np.asarray(jr.start_j, np.int32),
        np.arange(B, dtype=np.int32) * (jr.L1 // 16), KW=jr.KW, max_steps=1024,
        interpret=True,
    ))
    pw = tw.walk_many(pr.dirs.view(B * KW, -1), pr.start_i, pr.start_j,
                      np.arange(B) * KW, KW, max_steps=1024)
    for t in range(B):
        assert np.array_equal(
            tw.unpack_moves(pw[0][t], int(pw[1][t])), jax_tp.unpack_moves(jw[0][t], int(jw[1][t]))
        )
        assert [int(x[t]) for x in pw[1:]] == [int(x[t]) for x in jw[1:]]
        assert bool(pw[4][t])


def _pack(codes2d: np.ndarray) -> np.ndarray:
    """Per-cell codes[k, lane] -> int32 words[k//16, lane]."""
    KW = codes2d.shape[0] // 16
    packed = np.zeros((KW, codes2d.shape[1]), dtype=np.int64)
    for t in range(16):
        packed |= codes2d[t::16][:KW].astype(np.int64) << (2 * t)
    return packed.astype(np.uint32).view(np.int32)


def test_walk_many_plain_loffs_matches_jax():
    """Group-stacked bitmaps: nonzero word-row and lane offsets, walks
    that end on a stop code, on the origin and on a full buffer."""
    rng = np.random.default_rng(9)
    KW, V = 40, 512
    codes = rng.choice(4, size=(3 * KW * 16, V), p=[0.45, 0.25, 0.25, 0.05])
    dirs = _pack(codes)
    koffs = np.array([0, KW, 2 * KW, 7], np.int32)
    loffs = np.array([0, 130, 256, 3], np.int32)
    li = np.array([100, 200, 250, 60], np.int32)
    sj = np.array([300, 150, 20, 400], np.int32)
    for max_steps in (1024, 48):
        jw = jax.device_get(jax_tp.walk_many(
            jax.numpy.asarray(dirs), li, sj, koffs, KW=KW, max_steps=max_steps,
            interpret=True, loffs=loffs,
        ))
        pw = tw.walk_many(torch.from_numpy(dirs.copy()), li, sj, koffs, KW, max_steps,
                          loffs=loffs)
        for t in range(len(li)):
            assert np.array_equal(
                tw.unpack_moves(pw[0][t], int(pw[1][t])),
                jax_tp.unpack_moves(jw[0][t], int(jw[1][t])),
            )
            assert [int(x[t]) for x in pw[1:]] == [int(x[t]) for x in jw[1:]]
        # each walk equals walk_block over its own view
        for t in range(len(li)):
            view = torch.from_numpy(dirs[koffs[t] : koffs[t] + KW, loffs[t] :].copy())
            moves, count, i_f, j_f, done = td.walk_block(view, li[t], sj[t], 0, max_steps)
            assert np.array_equal(tw.unpack_moves(pw[0][t], int(pw[1][t])), moves.numpy()[:count])
            assert (int(pw[1][t]), int(pw[2][t]), int(pw[3][t]), bool(pw[4][t])) == (
                count, i_f, j_f, done)


def test_walk_many_outside_bitmap_raises():
    dirs = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(IndexError):
        tw.walk_many(dirs, [10], [60], [0], 4, max_steps=64)
    with pytest.raises(ValueError, match="koffs and loffs"):
        tw.walk_many(dirs, [1], [1], [-1], 4, max_steps=64)
    with pytest.raises(ValueError, match="walk_full"):
        tw.walk_many(dirs, [1], [1], [0], 4, max_steps=tw.MAX_STEPS_CAP + 16)


def test_wrappers_keep_devices_apart():
    """The kernel wrappers take CUDA tensors only and K4's plain version
    a CPU bitmap only; nothing falls back."""
    s = torch.zeros((1, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        gs._stream_cuda(s, s, [1], [1], Scores(), False)
    dirs = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tw._walk_many_cuda(dirs, [1], [1], [0], 4, 64)
    with pytest.raises(ValueError, match="CPU bitmap"):
        tw.walk_many_plain(dirs.to("meta"), [1], [1], [0], 4, 64)


def test_cpu_route_counts_plain_calls():
    before = dict(gs.COUNTS), dict(tw.COUNTS)
    rng = np.random.default_rng(3)
    s1, s2, ms, ns = _batch(rng, [100, 90], [80, 128], 128, 128)
    res = gs.gotoh_stream_fill_dirs(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns,
                                    Scores(), False)
    tw.walk_many(res.dirs.view(2 * res.KW, -1), res.start_i, res.start_j,
                 [0, res.KW], res.KW, 512)
    assert gs.COUNTS == {"kernel": before[0]["kernel"], "plain": before[0]["plain"] + 1}
    assert tw.COUNTS["many_plain"] == before[1]["many_plain"] + 1
    assert tw.COUNTS["many_kernel"] == before[1]["many_kernel"]


def test_lengths_are_checked():
    s = torch.zeros((2, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside"):
        gs.gotoh_stream_plain(s, s, [129, 1], [1, 1], Scores())
    with pytest.raises(ValueError, match="shape"):
        gs.gotoh_stream_plain(s, s, [1], [1], Scores())
