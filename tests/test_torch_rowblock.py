"""The port's row-block fill (plain version, CPU) against the JAX kernel.

``genomics_rs_tpu_torch.ops.gotoh_rowblock.gotoh_rowblock`` on CPU
tensors runs the plain PyTorch version; the JAX side runs
``gotoh_rowblock_pallas`` in interpret mode on the same numpy inputs.
Everything is integer DP, so every comparison is exact equality:
scores, local best, bottom rows, column checkpoints at consumed lanes,
and direction codes unpacked at every cell of the block.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops.gotoh_rowblock import gotoh_rowblock_pallas
from genomics_rs_tpu.ops.gotoh_tile import global_boundary_top as jax_top
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
from genomics_rs_tpu_torch.ops.gotoh_numpy import gotoh_tables_numpy
from genomics_rs_tpu_torch.ops.gotoh_scan import NEG_INF
from genomics_rs_tpu_torch.ops.gotoh_tile import (
    global_boundary_left,
    global_boundary_top,
)
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CLASSIC = (1, -2, -1, -5)
KIMURA = (2, -3, -2, -4, -1)


def _codes(dirs: np.ndarray, li: int, j: int) -> int:
    k = li + j
    return (int(dirs[k // 16, li]) >> (2 * (k % 16))) & 3


def _inputs(rng, R, m, n, Ln, i0):
    """Block rows i0+1..i0+R of a length-m s1 (padded), s2 padded to Ln."""
    s1 = np.full(R, PAD_S1, np.uint8)
    rows = max(0, min(R, m - i0))
    s1[:rows] = BASES[rng.integers(0, 4, rows)]
    s2 = np.full(Ln, PAD_S2, np.uint8)
    s2[:n] = BASES[rng.integers(0, 4, n)]
    return s1, s2


def _both(s1, s2, top, m, n, i0, score_t, is_local, left=None, **emit):
    jres = gotoh_rowblock_pallas(
        s1, s2, top, np.int32(m), np.int32(n), np.int32(i0),
        JaxScores(*score_t), is_local, left=left, interpret=True, **emit,
    )
    tres = rb.gotoh_rowblock(
        torch.from_numpy(s1.copy()), torch.from_numpy(s2.copy()),
        torch.from_numpy(np.asarray(top).copy()), m, n, i0,
        Scores.from_tuple(score_t), is_local,
        left=None if left is None else torch.from_numpy(np.asarray(left).copy()),
        **emit,
    )
    return jres, tres


def _assert_equal(jres, tres, R, n, B, is_local, emit):
    assert int(jres.score_at_mn) == int(tres.score_at_mn)
    assert [int(x) for x in jres.best] == [int(x) for x in tres.best]
    if emit.get("emit_bottom", True):
        assert np.array_equal(np.asarray(jres.bottom), tres.bottom.numpy())
    else:
        assert tres.bottom is None
    if emit.get("emit_cols"):
        cj, ct = np.asarray(jres.cols), tres.cols.numpy()
        assert cj.shape == ct.shape
        V = cj.shape[2]
        for c in range(cj.shape[0]):
            if c * V <= n:
                assert np.array_equal(cj[c, :, 1 : R + 1], ct[c, :, 1 : R + 1]), c
    if emit.get("emit_dirs"):
        dj, dt = np.asarray(jres.dirs), tres.dirs.numpy()
        assert dj.shape == dt.shape
        for li in range(R + 1):
            for j in range(B + 1):
                assert _codes(dj, li, j) == _codes(dt, li, j), (li, j)


ALL = dict(emit_dirs=True, emit_bottom=True, emit_cols=True)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_rowblock_plain_matches_jax_all_outputs(is_local, score_t):
    rng = np.random.default_rng(21)
    R, m, n, Ln = 200, 200, 300, 384
    s1, s2 = _inputs(rng, R, m, n, Ln, 0)
    top = np.asarray(jax_top(0, Ln, JaxScores(*score_t)))
    jres, tres = _both(s1, s2, top, m, n, 0, score_t, is_local, **ALL)
    _assert_equal(jres, tres, R, n, Ln, is_local, ALL)
    assert rb.COUNTS["plain"] > 0


@pytest.mark.parametrize("is_local", [False, True])
def test_rowblock_plain_non_final_block(is_local):
    """R < m - i0 < V: lanes past row R must not alias the (m, n) probe
    or enter the local argmax; a second block chains on the bottom."""
    rng = np.random.default_rng(9)
    R, m, n, Ln = 100, 500, 300, 384
    s1_all = np.full(5 * R, PAD_S1, np.uint8)
    s1_all[:m] = BASES[rng.integers(0, 4, m)]
    _, s2 = _inputs(rng, R, m, n, Ln, 0)
    top = np.asarray(jax_top(0, Ln, JaxScores(*CLASSIC)))
    for b in range(2):
        i0 = b * R
        jres, tres = _both(
            s1_all[i0 : i0 + R], s2, top, m, n, i0, CLASSIC, is_local,
            emit_dirs=True,
        )
        _assert_equal(
            jres, tres, R, n, Ln, is_local, dict(emit_dirs=True, emit_bottom=True)
        )
        top = np.asarray(jres.bottom)


@pytest.mark.parametrize("is_local", [False, True])
def test_rowblock_plain_final_block_probe(is_local):
    """Row m inside a later block: score_at_mn and the local best in
    global coordinates, dirs without the bottom row."""
    rng = np.random.default_rng(4)
    R, m, n, Ln = 255, 400, 200, 256
    i0 = R
    s1, s2 = _inputs(rng, R, m, n, Ln, i0)
    top = np.zeros((3, Ln + 1), np.int32)
    top[0] = np.arange(Ln + 1) * -1 - 7  # a plausible carried row
    top[1] = -3 - np.arange(Ln + 1) % 5
    top[2] = -9
    emit = dict(emit_dirs=True, emit_bottom=False)
    jres, tres = _both(s1, s2, top, m, n, i0, CLASSIC, is_local, **emit)
    _assert_equal(jres, tres, R, n, Ln, is_local, emit)


def _true_column(a: str, b: str, scores, is_local: bool, j: int) -> np.ndarray:
    """(3, len(a)) I/S/D of column j at rows 1..len(a), int32 -inf."""
    I, S, D = gotoh_tables_numpy(a, b, scores, is_local)
    col = np.stack([I[1:, j], S[1:, j], D[1:, j]])
    return np.where(col < -(1 << 40), NEG_INF, col).astype(np.int32)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_rowblock_plain_left_window(is_local, score_t):
    """A fill whose column-0 boundary is streamed in (``left``): equal to
    the JAX kernel, and its codes equal the full fill's in the window."""
    rng = np.random.default_rng(33)
    R, n, jc = 120, 300, 128
    s1, s2 = _inputs(rng, R, R, n, 384, 0)
    a = s1.tobytes().decode()
    b = s2[:n].tobytes().decode()
    ts = Scores.from_tuple(score_t)
    left = _true_column(a, b, ts, is_local, jc)
    top_full = global_boundary_top(0, 384, ts, device="cpu").numpy()
    Bw = n - jc
    emit = dict(emit_dirs=True, emit_bottom=True, emit_cols=True)
    jres, tres = _both(
        s1, s2[jc : jc + Bw].copy(), top_full[:, jc : jc + Bw + 1].copy(),
        R, Bw, 0, score_t, is_local, left=left, **emit,
    )
    _assert_equal(jres, tres, R, Bw, Bw, is_local, emit)

    full = rb.gotoh_rowblock(
        torch.from_numpy(s1.copy()), torch.from_numpy(s2.copy()),
        torch.from_numpy(top_full), R, n, 0, ts, is_local,
        emit_dirs=True, emit_bottom=False,
    )
    dw, df = tres.dirs.numpy(), full.dirs.numpy()
    for li in range(R + 1):
        for j in range(jc + 1, n + 1):
            assert _codes(df, li, j) == _codes(dw, li, j - jc), (li, j)


def test_boundaries_match_jax():
    from genomics_rs_tpu.ops.gotoh_tile import global_boundary_left as jax_left

    for st in (CLASSIC, KIMURA):
        js, ts = JaxScores(*st), Scores.from_tuple(st)
        assert np.array_equal(
            np.asarray(jax_top(5, 40, js)), global_boundary_top(5, 40, ts, device="cpu").numpy()
        )
        assert np.array_equal(
            np.asarray(jax_left(7, 30, js)), global_boundary_left(7, 30, ts, device="cpu").numpy()
        )


def test_scores_round_trip():
    for st in (CLASSIC, KIMURA):
        assert Scores.from_tuple(JaxScores(*st).as_tuple()).as_tuple() == st


def test_kimura_encoding_matches_jax():
    from genomics_rs_tpu.ops import subst as jax_subst

    from genomics_rs_tpu_torch.ops import subst

    b = np.arange(256, dtype=np.uint8)
    ts = Scores.from_tuple(KIMURA)
    assert np.array_equal(subst.KIMURA_ENC, jax_subst.KIMURA_ENC)
    assert np.array_equal(
        subst.encode_chars(torch.from_numpy(b), ts).numpy(),
        np.asarray(jax_subst.encode_chars(b, JaxScores(*KIMURA))),
    )
    for v in (0xFD, 0xFF):
        assert subst.sentinel(v, ts) == jax_subst.sentinel(v, JaxScores(*KIMURA))
