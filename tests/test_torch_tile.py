"""The tile fill (K5's plain version ``tile_fill`` and its entry
``gotoh_tile_pallas`` on CPU tensors) and ``gotoh_fill_pallas`` against
the JAX package: ``tile_fill`` and ``gotoh_tile_pallas(interpret=True)``
on ``tests/test_pallas_tile.py``'s stacked row blocks and on a 2 x 2
tiling with column offsets, and the whole-table fill score-only and with
dirs. Integer DP: exact equality throughout.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops import gotoh_pallas as jgp
from genomics_rs_tpu.ops import gotoh_tile as jtile
from genomics_rs_tpu.ops.gotoh_scan import gotoh_fill_scan
from genomics_rs_tpu.sequence import Sequence as JaxSequence
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops.gotoh_tile import (
    global_boundary_left,
    global_boundary_top,
    tile_fill,
)
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence

CLASSIC = (1, -2, -1, -5)
KIMURA = (1, -2, -1, -5, -1)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain fill runs thousands of small torch ops; torch's thread
    pool only contends with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _enc(s, L, pv):
    return Sequence("x", s).encoded(pad_to=L, pad_value=pv)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ints(xs):
    return tuple(int(x) for x in xs)


def _codes(dirs, cells):
    """Codes of packed (Kp/16, V) words at tile cells [(li, j), ...]."""
    d = np.asarray(dirs)
    return [(int(d[(li + j) // 16, li]) >> (2 * ((li + j) % 16))) & 3 for li, j in cells]


@pytest.mark.parametrize("is_local", [False, True])
def test_stacked_row_blocks_match_jax(is_local):
    """``test_pallas_tile.py``'s case: a 150 x 101 table as three 64-row
    blocks, each block's bottom the next one's top."""
    sc, jsc = Scores(*CLASSIC), JaxScores(*CLASSIC)
    rng = np.random.default_rng(41)
    m, n, R, Lm, Ln = 150, 101, 64, 192, 128
    a = "".join(rng.choice(list("ACGT"), m))
    b = "".join(rng.choice(list("ACGT"), n))
    s1e, s2e = _enc(a, Lm, PAD_S1), _enc(b, Ln, PAD_S2)
    top = global_boundary_top(0, Ln, sc, device=CPU)
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtile.global_boundary_top(0, Ln, jsc)))
    best, at_mn = (-(2**31), 0, 0), -(2**31)
    for blk in range(Lm // R):
        i0 = blk * R
        left = global_boundary_left(i0, R, sc, device=CPU)
        args = (s1e[i0 : i0 + R], s2e, top.numpy(), left.numpy())
        want = jtile.tile_fill(*args, jsc, is_local, np.int32(i0), np.int32(0), np.int32(m),
                               np.int32(n))
        want_k = jgp.gotoh_tile_pallas(*args, np.int32(m), np.int32(n), np.int32(i0),
                                       np.int32(0), jsc, is_local, emit_dirs=False,
                                       emit_bottom=True, emit_right=True, interpret=True)
        got = tile_fill(*map(_t, args), sc, is_local, i0, 0, m, n)
        kern = gp.gotoh_tile_pallas(*map(_t, args), m, n, i0, 0, sc, is_local, emit_dirs=False,
                                    emit_bottom=True, emit_right=True)
        for res in (got, kern):
            bottom, right = res.bottom.numpy(), res.right.numpy()
            np.testing.assert_array_equal(bottom, np.asarray(want.bottom))
            np.testing.assert_array_equal(bottom, np.asarray(want_k.bottom))
            np.testing.assert_array_equal(right, np.asarray(want.right))
            np.testing.assert_array_equal(right, np.asarray(want_k.right))
            # best: tile_fill's in both modes (the JAX kernel tracks it
            # only in local mode)
            assert _ints(res.best) == _ints(want.best)
            if is_local:
                assert _ints(res.best) == _ints(want_k.best)
        assert int(got.at_mn) == int(kern.score_at_mn) == int(want.at_mn) == int(
            want_k.score_at_mn)
        at_mn = max(at_mn, int(got.at_mn))
        best = max(best, _ints(got.best))
        top = got.bottom
    ref = gotoh_fill_scan(s1e, s2e, np.int32(m), np.int32(n), jsc, is_local)
    if is_local:
        assert best == (int(ref.score), int(ref.start_i), int(ref.start_j))
    else:
        assert at_mn == int(ref.score)


@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
@pytest.mark.parametrize("is_local", [False, True])
def test_two_by_two_tiling_matches_jax(is_local, score_t):
    """Tiles (p, c) of a 2 x 2 tiling with j0 > 0 for c = 1: top from the
    tile above, left from the tile to the left, as the sequence-parallel
    pipeline hands them on; bottom, right, best and (m, n) equal JAX's
    ``tile_fill`` and, on every tile, the kernel in interpret mode."""
    sc, jsc = Scores(*score_t), JaxScores(*score_t)
    rng = np.random.default_rng(43)
    m, n, R, B = 90, 75, 48, 40
    a = "".join(rng.choice(list("ACGTN"), m))
    b = "".join(rng.choice(list("ACGTN"), n))
    s1e, s2e = _enc(a, 2 * R, PAD_S1), _enc(b, 2 * B, PAD_S2)
    bottoms = {}
    merged, at_mn = (-(2**31), 0, 0), -(2**31)
    for p in range(2):
        left = global_boundary_left(p * R, R, sc, device=CPU)
        for c in range(2):
            i0, j0 = p * R, c * B
            top = global_boundary_top(j0, B, sc, device=CPU) if p == 0 else bottoms[c]
            args = (s1e[i0 : i0 + R], s2e[j0 : j0 + B], top.numpy(), left.numpy())
            want = jtile.tile_fill(*args, jsc, is_local, np.int32(i0), np.int32(j0),
                                   np.int32(m), np.int32(n))
            want_k = jgp.gotoh_tile_pallas(*args, np.int32(m), np.int32(n), np.int32(i0),
                                           np.int32(j0), jsc, is_local, emit_dirs=True,
                                           emit_bottom=True, emit_right=True, interpret=True)
            got = gp.gotoh_tile_pallas(*map(_t, args), m, n, i0, j0, sc, is_local,
                                       emit_dirs=True, emit_bottom=True, emit_right=True)
            for name in ("bottom", "right"):
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(want, name)), err_msg=name)
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(want_k, name)), err_msg=name)
            assert _ints(got.best) == _ints(want.best), (p, c)
            if is_local:
                assert _ints(got.best) == _ints(want_k.best), (p, c)
            assert int(got.score_at_mn) == int(want.at_mn) == int(want_k.score_at_mn)
            cells = [(li, j) for li in range(1, R + 1) for j in range(1, B + 1)
                     if i0 + li <= m and j0 + j <= n]
            assert _codes(got.dirs, cells) == _codes(want_k.dirs, cells), (p, c)
            bottoms[c] = got.bottom
            left = got.right
            merged = max(merged, _ints(got.best))
            at_mn = max(at_mn, int(got.score_at_mn))
    ref = gotoh_fill_scan(s1e, s2e, np.int32(m), np.int32(n), jsc, is_local)
    if is_local:
        assert merged == (int(ref.score), int(ref.start_i), int(ref.start_j))
    else:
        assert at_mn == int(ref.score)


def test_empty_tiles_match_tile_fill():
    """A tile wholly past n and one wholly below m hold no true cell: best
    is (INT_MIN, i0 + R, j0 + B) and (m, n) is INT_MIN, as JAX's
    ``tile_fill`` gives."""
    sc, jsc = Scores(*CLASSIC), JaxScores(*CLASSIC)
    rng = np.random.default_rng(5)
    R, B = 20, 24
    s1 = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, R)]
    s2 = np.full(B, PAD_S2, np.uint8)
    top = rng.integers(-30, 5, (3, B + 1)).astype(np.int32)
    left = rng.integers(-30, 5, (3, R)).astype(np.int32)
    for i0, j0, m, n in ((40, 100, 70, 90), (40, 10, 30, 90)):
        for is_local in (False, True):
            want = jtile.tile_fill(s1, s2, top, left, jsc, is_local, np.int32(i0), np.int32(j0),
                                   np.int32(m), np.int32(n))
            got = gp.gotoh_tile_pallas(_t(s1), _t(s2), _t(top), _t(left), m, n, i0, j0, sc,
                                       is_local, emit_dirs=False, emit_bottom=True,
                                       emit_right=True)
            assert _ints(got.best) == _ints(want.best) == (-(2**31), i0 + R, j0 + B)
            assert int(got.score_at_mn) == int(want.at_mn) == -(2**31)
            np.testing.assert_array_equal(got.bottom.numpy(), np.asarray(want.bottom))
            np.testing.assert_array_equal(got.right.numpy(), np.asarray(want.right))


def test_tile_entry_counts_plain_calls():
    sc = Scores(*CLASSIC)
    s = torch.full((8,), ord("A"), dtype=torch.uint8)
    before = dict(gp.TILE_COUNTS)
    gp.gotoh_tile_pallas(s, s, global_boundary_top(0, 8, sc, device=CPU),
                         global_boundary_left(0, 8, sc, device=CPU), 8, 8, 0, 0, sc, False,
                         emit_dirs=False)
    assert gp.TILE_COUNTS == {"kernel": before["kernel"], "plain": before["plain"] + 1}


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("score_t", [CLASSIC, KIMURA], ids=["classic", "kimura"])
def test_fill_pallas_score_only_matches_jax(is_local, score_t):
    """Score-only: the whole table as one K5 tile with the global streams."""
    sc, jsc = Scores(*score_t), JaxScores(*score_t)
    rng = np.random.default_rng(13)
    m, n, Lm, Ln = 150, 90, 256, 128
    a = "".join(rng.choice(list("ACGT"), m))
    b = "".join(rng.choice(list("ACGT"), n))
    s1e, s2e = _enc(a, Lm, PAD_S1), _enc(b, Ln, PAD_S2)
    want = jgp.gotoh_fill_pallas(s1e, s2e, np.int32(m), np.int32(n), jsc, is_local,
                                 emit_dirs=False, interpret=True)
    got = gp.gotoh_fill_pallas(_t(s1e), _t(s2e), m, n, sc, is_local, emit_dirs=False)
    assert _ints((got.score, got.start_i, got.start_j)) == _ints(
        (want.score, want.start_i, want.start_j))
    assert tuple(got.dirs.shape) == (0, 0)


@pytest.mark.parametrize("is_local", [False, True])
def test_fill_pallas_dirs_match_jax(is_local):
    """With dirs: the per-cell codes ``dirs[i + j, i]`` (and the packed
    words) at every true cell equal JAX's, and so do score and start."""
    sc, jsc = Scores(*CLASSIC), JaxScores(*CLASSIC)
    rng = np.random.default_rng(23)
    a = "".join(rng.choice(list("ACGT"), 40))
    b = "".join(rng.choice(list("ACGT"), 37))
    s1e = JaxSequence("a", a).encoded(pad_to=48)
    s2e = JaxSequence("b", b).encoded(pad_to=48, pad_value=PAD_S2)
    want = jgp.gotoh_fill_pallas(s1e, s2e, 40, 37, jsc, is_local, interpret=True)
    got = gp.gotoh_fill_pallas(_t(s1e), _t(s2e), 40, 37, sc, is_local)
    packed = gp.gotoh_fill_pallas(_t(s1e), _t(s2e), 40, 37, sc, is_local, packed_dirs=True)
    assert _ints((got.score, got.start_i, got.start_j)) == _ints(
        (want.score, want.start_i, want.start_j))
    assert got.dirs.dtype == torch.uint8 and got.dirs.shape == np.asarray(want.dirs).shape
    wd, gd = np.asarray(want.dirs), got.dirs.numpy()
    cells = [(i, j) for i in range(41) for j in range(38)]
    assert [gd[i + j, i] for i, j in cells] == [wd[i + j, i] for i, j in cells]
    assert _codes(packed.dirs, cells) == [int(wd[i + j, i]) for i, j in cells]
