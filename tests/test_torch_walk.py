"""The port's traceback walker (CPU route) against the JAX walkers.

``walk_block`` is the port's plain walker, and ``device_walk`` routes a
CPU bitmap to it. They are held against the JAX ``walk_block`` and
``walk_pallas(interpret=True)`` on the same bitmaps, including bitmaps
filled by the JAX kernel and walked by the port and the other way
round. ``walk_kernel`` (the CUDA walker) takes CUDA bitmaps only; the
card tests hold it equal to ``walk_block``. Exact equality throughout.
"""

import numpy as np
import pytest
import torch

import jax

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops.gotoh_rowblock import gotoh_rowblock_pallas
from genomics_rs_tpu.ops.gotoh_tile import global_boundary_top as jax_top
from genomics_rs_tpu.ops import traceback_device as jax_td
from genomics_rs_tpu.ops import traceback_pallas as jax_tp
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import traceback_device as td
from genomics_rs_tpu_torch.ops import traceback_walker as tw
from genomics_rs_tpu_torch.ops.gotoh_rowblock import gotoh_rowblock
from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_top
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
SC = (1, -2, -1, -5)


def _pack(codes2d: np.ndarray) -> np.ndarray:
    """Per-cell codes[k, lane] -> int32 words[k//16, lane]."""
    K, V = codes2d.shape
    KW = K // 16
    packed = np.zeros((KW, V), dtype=np.int64)
    for t in range(16):
        packed |= codes2d[t::16][:KW].astype(np.int64) << (2 * t)
    return packed.astype(np.uint32).view(np.int32)


def _jax_ref(dirs, li, j, i0, max_steps=4096, j0=0):
    moves, count, i_f, j_f, done = jax_td.walk_block(
        jax.numpy.asarray(dirs), np.int32(li), np.int32(j), np.int32(i0),
        max_steps=max_steps, j0=np.int32(j0),
    )
    return np.asarray(moves)[: int(count)], int(i_f), int(j_f), bool(done)


def _port_block(dirs, li, j, i0, max_steps=4096, j0=0):
    moves, count, i_f, j_f, done = td.walk_block(
        torch.from_numpy(np.asarray(dirs).copy()), li, j, i0,
        max_steps=max_steps, j0=j0,
    )
    return moves.numpy()[:count], i_f, j_f, done


def _same(a, b):
    assert np.array_equal(a[0], b[0])
    assert tuple(a[1:]) == tuple(b[1:])


def _filled(is_local: bool, seed: int):
    """A (KW >= 34, 1024) bitmap from the JAX kernel and its start cell."""
    rng = np.random.default_rng(seed)
    R, m, n, Ln = 100, 100, 480, 512
    base = BASES[rng.integers(0, 4, Ln + 40)]
    s1 = np.full(R, PAD_S1, np.uint8)
    s1[:m] = base[:m]
    s2 = np.full(Ln, PAD_S2, np.uint8)
    s2[:n] = base[20 : n + 20]
    js = JaxScores(*SC)
    res = gotoh_rowblock_pallas(
        s1, s2, jax_top(0, Ln, js), np.int32(m), np.int32(n), np.int32(0),
        js, is_local, emit_dirs=True, emit_bottom=False, interpret=True,
    )
    if is_local:
        _, si, sj = (int(x) for x in res.best)
    else:
        si, sj = m, n
    return np.asarray(res.dirs), (s1, s2, m, n), si, sj


@pytest.mark.parametrize("is_local", [False, True])
def test_port_walks_jax_bitmap(is_local):
    dirs, _, si, sj = _filled(is_local, 3)
    assert dirs.shape[0] >= jax_tp.PKW
    want = _jax_ref(dirs, si, sj, 0)
    assert want[3]  # the path terminates inside the table
    _same(_port_block(dirs, si, sj, 0), want)
    # walk_pallas (packed words + scalars), unpacked, against walk_block.
    jw, jc, ji, jj, jd = jax_tp.walk_pallas(
        jax.numpy.asarray(dirs), np.int32(si), np.int32(sj), np.int32(0),
        max_steps=1024, interpret=True,
    )
    jc = int(jc)
    nw = -(-jc // 16)
    _same(
        _port_block(dirs, si, sj, 0, max_steps=1024),
        (jax_tp.unpack_moves(np.asarray(jw)[:nw], jc), int(ji), int(jj), bool(jd)),
    )


@pytest.mark.parametrize("is_local", [False, True])
def test_jax_walks_port_bitmap(is_local):
    _, (s1, s2, m, n), si, sj = _filled(is_local, 3)
    ts = Scores.from_tuple(SC)
    res = gotoh_rowblock(
        torch.from_numpy(s1.copy()), torch.from_numpy(s2.copy()),
        global_boundary_top(0, s2.shape[0], ts, device="cpu"), m, n, 0, ts, is_local,
        emit_dirs=True, emit_bottom=False,
    )
    dirs = res.dirs.numpy()
    codes, i_f, j_f, done = td.device_walk(res.dirs, si, sj, 0, max_steps=64)
    _same((codes, i_f, j_f, done), _jax_ref(dirs, si, sj, 0))


def test_random_walks_match_jax_walkers():
    rng = np.random.default_rng(0)
    for _ in range(4):
        V, KW = 256, 48
        dirs = rng.integers(0, 2**31, size=(KW, V), dtype=np.int32)
        li = int(rng.integers(1, V - 1))
        j = int(rng.integers(1, KW * 16 - li - 1))
        i0 = int(rng.integers(0, 3))
        want = _jax_ref(dirs, li, j, i0)
        _same(_port_block(dirs, li, j, i0), want)
        codes, i_f, j_f, done = jax_tp.walk_full(
            jax.numpy.asarray(dirs), li, j, i0, max_steps=4096, interpret=True
        )
        _same((codes, int(i_f), int(j_f), bool(done)), want)


def test_buffer_resume_matches_jax_walk_full():
    """Stop-free codes force a long walk; max_steps=128 forces the
    resume loop with partial packed words; the walk exits upward."""
    rng = np.random.default_rng(1)
    V, KW = 256, 64
    dirs = _pack(rng.integers(0, 3, size=(KW * 16, V), dtype=np.int64))
    li, j, i0 = 254, 700, 3
    want = _jax_ref(dirs, li, j, i0)
    assert len(want[0]) > 300 and not want[3] and want[1] == i0 - 1
    got = td.device_walk(torch.from_numpy(dirs.copy()), li, j, i0, max_steps=128)
    _same(got, want)
    jcodes, ji, jj, jd = jax_tp.walk_full(
        jax.numpy.asarray(dirs), li, j, i0, max_steps=128, interpret=True
    )
    _same(got, (jcodes, int(ji), int(jj), bool(jd)))
    _same(
        td.device_walk(torch.from_numpy(dirs.copy()), li, j, i0, max_steps=48),
        want,
    )


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_window_left_exit_matches_jax(seed):
    """j0 > 0: a move onto local column 0 exits left (not done,
    j_final == 0, i_final >= i0)."""
    rng = np.random.default_rng(seed)
    V, KW = 256, 48
    # Mostly INS codes: the walk runs left and leaves the window there.
    codes2 = np.where(
        rng.random((KW * 16, V)) < 0.8, 1, rng.integers(0, 3, (KW * 16, V))
    )
    dirs = _pack(codes2)
    li, j, i0, j0 = 200, 300, 40, 1024
    want = _jax_ref(dirs, li, j, i0, j0=j0)
    assert not want[3] and want[2] == 0 and want[1] >= i0
    _same(_port_block(dirs, li, j, i0, j0=j0), want)
    _same(
        td.device_walk(torch.from_numpy(dirs.copy()), li, j, i0, max_steps=32, j0=j0),
        want,
    )
    jcodes, ji, jj, jd = jax_tp.walk_full(
        jax.numpy.asarray(dirs), li, j, i0, max_steps=4096, interpret=True, j0=j0
    )
    _same((jcodes, int(ji), int(jj), bool(jd)), want)


def test_resume_walk_raises_on_no_progress():
    def stuck_step(li, j):
        return np.full(8, 2, np.uint8), 5, 7, False

    with pytest.raises(RuntimeError, match="no progress"):
        td.resume_walk(stuck_step, start_li=5, start_j=7, i0=0)


def test_walk_kernel_rejects_oversized_buffer():
    dirs = torch.zeros((16, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="walk_full"):
        tw.walk_kernel(dirs, 0, 0, 0, max_steps=tw.MAX_STEPS_CAP + 16)


def test_walk_kernel_rejects_cpu_bitmap():
    dirs = torch.zeros((16, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA bitmap"):
        tw.walk_kernel(dirs, 0, 0, 0, max_steps=64)


def test_walk_outside_bitmap_raises():
    dirs = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(IndexError):
        td.walk_block(dirs, 10, 0, 0, max_steps=16)


def test_pack_unpack_moves():
    """Moves packed 16 per word (as the kernel stores them) unpack the
    same in both packages, partial last word included."""
    rng = np.random.default_rng(8)
    for count in (0, 5, 16, 37):
        moves = rng.integers(0, 4, count).astype(np.uint8)
        padded = np.zeros(48, np.int64)
        padded[:count] = moves
        words = _pack(padded[:, None])[:, 0]
        assert np.array_equal(tw.unpack_moves(words, count), moves)
        assert np.array_equal(jax_tp.unpack_moves(words, count), moves)
