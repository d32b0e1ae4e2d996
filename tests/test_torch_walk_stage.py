"""The staged chases of K2, K4 and K11 (``csrc/traceback_walk.cu``),
replayed on the host by ``ops/walk_stage``, against the plain walkers and
JAX's.

``staged_walk``, ``staged_walk_banded`` and ``staged_walk_many`` walk
only through copies of the kernel's boxes (its box geometry, ring depth,
window placement, reloads and register-decoded runs under the kernel's
caps), a word outside the current box reading as STOP codes. They are
held equal to ``walk_block``, ``walk_banded_plain``, ``walk_many_plain``,
JAX's ``walk_pallas(interpret=True)`` / ``walk_full``, JAX's banded walker
(``_walk_banded_jit``, through ``walk_banded`` on the CPU) and JAX's
``walk_many(interpret=True)``, on edge paths built for the boxes
(``walk_stage_cases.py``): K2's block exits (up in the middle of a SUB
run and off lane 0 after an INS run, left in SUB and INS runs, both at
once), gaps wider than the lane window both ways, paths along both band
edges, starts on word-row boundaries, resumes at max_steps of 1, 15, 16,
17 and 1,000, the all-INS bitmap, lane offsets, stop cells, and the
windows of a small checkpointed alignment. Exact equality throughout.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops import gotoh_banded as jgb
from genomics_rs_tpu.ops import traceback_device as jax_td
from genomics_rs_tpu.ops import traceback_pallas as jax_tp
from genomics_rs_tpu.ops.gotoh_stream import gotoh_stream_fill_dirs as jax_fill_dirs
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops import gotoh_banded as gb
from genomics_rs_tpu_torch.ops import gotoh_banded_batch as gbb
from genomics_rs_tpu_torch.models import longalign
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import traceback_device as td
from genomics_rs_tpu_torch.ops import traceback_walker as tw
from genomics_rs_tpu_torch.ops import walk_stage as ws
from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_INS, DIR_SUB
from genomics_rs_tpu_torch.sequence import Sequence
from walk_stage_cases import (
    BAND_EDGE_SPECS,
    band_edge_walk,
    band_path_bitmap,
    diag_edge_walks,
    exit_walks,
)

SOURCE = Path(ws.__file__).resolve().parent.parent / "csrc" / "traceback_walk.cu"
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _same(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))


def _pack(codes: np.ndarray) -> torch.Tensor:
    words = np.zeros((codes.shape[0] // 16, codes.shape[1]), np.uint32)
    for t in range(16):
        words |= codes[t::16].astype(np.uint32) << np.uint32(2 * t)
    return torch.from_numpy(words.view(np.int32))


def test_stage_constants_match_the_kernel_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert (const("DIAG_ROWS"), const("DIAG_RING")) == (ws.DIAG_ROWS, ws.DIAG_RING)
    assert "DIAG_LANES = 16 * DIAG_ROWS * DIAG_RING + 4;" in src
    assert ws.DIAG_LANES == 16 * ws.DIAG_ROWS * ws.DIAG_RING + 4
    assert (const("BAND_ROWS"), const("BAND_LANES"), const("BAND_RING"), const("BAND_ABOVE")) \
        == (ws.BAND_ROWS, ws.BAND_LANES, ws.BAND_RING, ws.BAND_ABOVE)
    assert "BAND_BITS = BAND_ROWS / 2;" in src and ws.BAND_BITS == ws.BAND_ROWS // 2
    assert const("META_SLOTS") == tw.META_SLOTS


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000])
def test_slide_bits_pack_the_deltas(n):
    deltas = np.random.default_rng(n).integers(0, 2, n)
    words = ws.slide_bits(deltas).view(np.uint32)
    assert words.size == -(-n // 32)
    q = np.arange(n)
    assert np.array_equal((words[q // 32] >> (q % 32)) & 1, deltas)


def _jax_band_walk(dirs, m, n, V):
    return np.asarray(jgb.walk_banded(dirs.numpy(), m, n, V))


@pytest.mark.parametrize("k", range(len(BAND_EDGE_SPECS)),
                         ids=[name for name, *_ in BAND_EDGE_SPECS])
def test_staged_band_edge_walks_match_plain_and_jax(k):
    """Whole walks: the replay == the plain walker == JAX's; a gap wider
    than the lane window leaves it (a reload), and the box ring starts
    once."""
    name, dirs, m, n = band_edge_walk(k)
    stats = ws._new_stats()
    got = ws.staged_walk_banded(dirs[None], [m], [n], 1024, stats=stats)[0]
    want = gb.walk_banded_plain(dirs, m, n, 1024)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _jax_band_walk(dirs, m, n, 1024))
    assert stats["restarts"] == 1
    if "wider than the window" in name:
        assert stats["reloads"] >= 1


@pytest.mark.parametrize("cap", [1, 15, 16, 17, 1000])
def test_staged_band_resumes_match_plain(cap):
    """Launches capped at max_steps resume from their meta (i, j, off), on
    the insertion gap and on a start at row 16k+15."""
    for k in (0, 6):
        name, dirs, m, n = band_edge_walk(k)
        got = ws.staged_walk_banded(dirs[None], [m], [n], 1024, max_steps=cap)[0]
        assert np.array_equal(got, gb.walk_banded_plain(dirs, m, n, 1024)), name


def test_staged_band_all_ins_bitmap_raises():
    dirs = torch.full((18, 256), 0x55555555, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="left the band"):
        ws.staged_walk_banded(dirs[None], [280], [100], 256, geom=(300, 290))


def _band_pair(rng, m, n_cut, indels=6):
    a = BASES[rng.integers(0, 4, m)]
    b = list(a)
    for _ in range(indels):
        p = int(rng.integers(0, len(b) - 20))
        if rng.random() < 0.5:
            del b[p : p + int(rng.integers(1, 4))]
        else:
            b[p:p] = list(BASES[rng.integers(0, 4, int(rng.integers(1, 4)))])
    b = np.asarray(b[:n_cut], np.uint8)
    return torch.from_numpy(a.copy()), torch.from_numpy(b.copy())


@pytest.mark.parametrize("m,n_cut,V", [(2600, 2590, 1024), (3000, 2000, 1024)],
                         ids=["sliding", "slope 2/3"])
def test_staged_band_walk_of_a_fill_matches_jax(m, n_cut, V):
    """A plain banded fill's walk: the replay == JAX's walker, for a band
    that slides with the diagonal and one that slides 2 rows in 3."""
    rng = np.random.default_rng(m)
    s1, s2 = _band_pair(rng, m, n_cut)
    n = s2.shape[0]
    _, dirs = gb.gotoh_banded(s1, s2, m, n, Scores(1, -2, -2, -5), V)
    got = ws.staged_walk_banded(dirs[None], [m], [n], V)[0]
    assert np.array_equal(got, _jax_band_walk(dirs, m, n, V))
    assert np.array_equal(got, gb.walk_banded_plain(dirs, m, n, V))


def test_staged_band_batch_under_one_geometry():
    """A K12-layout batch (plain fill): every walk under the batch's window
    geometry, whole and resumed, == the plain walker."""
    rng = np.random.default_rng(12)
    pairs = [_band_pair(rng, 2000 - d, 1990 - d, 2) for d in (0, 10, 50, 3)]
    ms = np.array([p[0].shape[0] for p in pairs])
    ns = np.array([p[1].shape[0] for p in pairs])
    s1 = torch.full((4, 2048), 0xFE, dtype=torch.uint8)
    s2 = torch.full((4, 2048), 0xFF, dtype=torch.uint8)
    for t, (a, b) in enumerate(pairs):
        s1[t, : a.shape[0]] = a
        s2[t, : b.shape[0]] = b
    groups = gbb.gotoh_banded_batch(s1, s2, ms, ns, Scores(), 256)
    geom = (groups[0].M, groups[0].N)
    for cap in (None, 700):
        got = ws.staged_walk_banded(groups[0].dirs, ms, ns, 256, geom=geom, max_steps=cap)
        for t in range(4):
            assert np.array_equal(got[t], gb.walk_banded_plain(groups[0].dirs[t], int(ms[t]),
                                                               int(ns[t]), 256, geom))


def test_replay_reads_only_staged_boxes(monkeypatch):
    """With the window test switched off, the insertion gap's walk reads
    words no box holds (STOP codes) and the replay fails."""
    monkeypatch.setattr(ws._Ring, "holds", lambda self, x: True)
    name, dirs, m, n = band_edge_walk(0)
    with pytest.raises((RuntimeError, IndexError)):
        ws.staged_walk_banded(dirs[None], [m], [n], 1024)


def test_band_path_bitmap_rejects_paths_off_the_band():
    with pytest.raises(ValueError, match="leaves the band"):
        band_path_bitmap([DIR_INS] * 1500 + [DIR_SUB] * 490, 2000, 1990, 1024)
    with pytest.raises(ValueError, match="not the origin"):
        band_path_bitmap([DIR_SUB] * 10, 100, 100, 1024)


def _jax_many(dirs, li, j, ko, KW, max_steps, lo):
    jw = jax.device_get(jax_tp.walk_many(
        jax.numpy.asarray(dirs.numpy()), np.asarray(li, np.int32), np.asarray(j, np.int32),
        np.asarray(ko, np.int32), KW=KW, max_steps=max_steps, interpret=True,
        loffs=np.asarray(lo, np.int32)))
    return [np.asarray(x) for x in jw]


@pytest.mark.parametrize("k", range(8))
def test_staged_many_edge_walks_match_plain_and_jax(k):
    """walk_stage_cases' K4 edge paths (word-row boundaries k = 16q, 16q+1,
    16q+15, a stop cell, a lane offset, 300 insertions, 300 deletions, li
    held at 0): the replay == walk_many_plain == JAX's walk_many, and the
    staged window never has to reload."""
    name, dirs, li, j, ko, KW, max_steps, lo = diag_edge_walks()[k]
    stats = ws._new_stats()
    got = ws.staged_walk_many(dirs, li, j, ko, KW, max_steps, lo, stats=stats)
    _same(got, tw.walk_many_plain(dirs, li, j, ko, KW, max_steps, lo))
    jw = _jax_many(dirs, li, j, ko, KW, max_steps, lo)
    assert np.array_equal(tw.unpack_moves(got[0][0], int(got[1][0])),
                          jax_tp.unpack_moves(jw[0][0], int(jw[1][0])))
    assert [int(x[0]) for x in got[1:]] == [int(x[0]) for x in jw[1:]]
    assert stats["reloads"] == 0 and stats["restarts"] == 1


@pytest.mark.parametrize("max_steps", [4096, 1, 15, 16, 17, 1000])
def test_staged_many_random_codes_match_plain(max_steps):
    """Mostly-SUB random codes with stop cells, word-row and lane offsets,
    on rows of 700 lanes and of 301, buffers
    that end mid-path: the replay == the plain version, no reload."""
    rng = np.random.default_rng(max_steps)
    for V in (700, 301):
        dirs = _pack(rng.choice(4, size=(100 * 16, V), p=[0.8, 0.09, 0.09, 0.02]))
        li = rng.integers(0, 280, 5)
        args = (li, rng.integers(0, 640 - li), [0, 40, 7, 55, 19], 40, max_steps)
        loffs = [0, 20, 3, 17, 1]
        stats = ws._new_stats()
        _same(ws.staged_walk_many(dirs, *args, loffs, stats=stats),
              tw.walk_many_plain(dirs, *args, loffs))
        assert stats["reloads"] == 0


@pytest.mark.parametrize("is_local", [False, True])
def test_staged_many_walks_a_stream_fill_like_jax(is_local):
    """K3's plain dirs fill walked by the replay == JAX's fill walked by its
    walk_many (KW >= 34 for its DMA window)."""
    rng = np.random.default_rng(21 + is_local)
    B, Lm, Ln = 3, 384, 256
    ms, ns = np.array([384, 300, 200], np.int32), np.array([256, 250, 180], np.int32)
    s1 = np.full((B, Lm), 0xFE, np.uint8)
    s2 = np.full((B, Ln), 0xFF, np.uint8)
    for b in range(B):
        base = BASES[rng.integers(0, 4, Lm + 40)]
        s1[b, : ms[b]] = base[: ms[b]]
        other = base[17 : 17 + ns[b]].copy()
        flip = rng.random(ns[b]) < 0.08
        other[flip] = BASES[rng.integers(0, 4, int(flip.sum()))]
        s2[b, : ns[b]] = other
    jr = jax_fill_dirs(s1, s2, ms, ns, JaxScores(1, -2, -1, -5), is_local=is_local,
                       interpret=True)
    pr = gs.gotoh_stream_fill_dirs(torch.from_numpy(s1), torch.from_numpy(s2), ms, ns,
                                   Scores(1, -2, -1, -5), is_local)
    KW = pr.KW
    got = ws.staged_walk_many(pr.dirs.view(B * KW, -1), pr.start_i, pr.start_j,
                              np.arange(B) * KW, KW, 1024)
    jw = jax.device_get(jax_tp.walk_many(
        jr.dirs, np.asarray(jr.start_i, np.int32), np.asarray(jr.start_j, np.int32),
        np.arange(B, dtype=np.int32) * (jr.L1 // 16), KW=jr.KW, max_steps=1024,
        interpret=True))
    for t in range(B):
        assert np.array_equal(tw.unpack_moves(got[0][t], int(got[1][t])),
                              jax_tp.unpack_moves(np.asarray(jw[0][t]), int(jw[1][t])))
        assert [int(x[t]) for x in got[1:]] == [int(x[t]) for x in jw[1:]]


def test_staged_many_raises_off_the_bitmap():
    dirs = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(IndexError):
        ws.staged_walk_many(dirs, [10], [60], [0], 4, max_steps=64)


@pytest.mark.parametrize("m", [1, 16, 127, 128, 129, 2049, 29_903])
def test_slide_words_cover_every_box(m):
    """K11's slides operand: the deltas' bits, then zero words up to the
    last box a walk of m rows enters (a box's slide words are copied
    whole)."""
    _, deltas, _ = gb.plan_streams(m, max(m - 7, 1), 256)
    bits = ws.slide_bits(deltas)
    words = ws.slide_words(deltas, m)
    last_box = ((m - 1) >> 4) // ws.BAND_ROWS
    assert words.size == max(bits.size, (last_box + 1) * ws.BAND_BITS)
    assert np.array_equal(words[: bits.size], bits) and not words[bits.size :].any()


def test_whole_walk_steps_cover_the_longest_path():
    assert gb.whole_walk_steps([10, 300], [7, 299]) == 600
    assert gb.whole_walk_steps([1_078_175], [1_076_786]) == 2_154_962


# ---- K2: the single walk, with its block exits ----

EXIT_CASES = exit_walks()


def _walk_ref(dirs, li, j, i0, max_steps, j0):
    """walk_block's result as (codes, count, i_final, j_final, done)."""
    moves, count, i_f, j_f, done = td.walk_block(dirs, li, j, i0, max_steps=max_steps, j0=j0)
    return moves.numpy()[:count], count, i_f, j_f, done


def _staged(dirs, li, j, i0, max_steps, j0, stats=None):
    words, count, i_f, j_f, done = ws.staged_walk(dirs, li, j, i0, max_steps, j0, stats=stats)
    return tw.unpack_moves(words, count), count, i_f, j_f, done


def _staged_full(dirs, li, j, i0, max_steps, j0):
    """The replay looped as walk_full loops the kernel."""
    def step(a, b):
        codes, _, i_f, j_f, done = _staged(dirs, a, b, i0, max_steps, j0)
        return codes, i_f, j_f, done

    return td.resume_walk(step, li, j, i0, windowed=j0 > 0)


def _jax_walk(dirs, li, j, i0, max_steps, j0):
    """JAX's walk_pallas (interpret mode), one launch, decoded."""
    jw, jc, ji, jj, jd = jax_tp.walk_pallas(
        jax.numpy.asarray(dirs.numpy()), np.int32(li), np.int32(j), np.int32(i0),
        max_steps=max_steps, interpret=True, j0=np.int32(j0))
    jc = int(jc)
    return jax_tp.unpack_moves(np.asarray(jw)[: -(-jc // 16)], jc), jc, int(ji), int(jj), bool(jd)


def _same_walk(got, want):
    assert np.array_equal(np.asarray(got[0], np.int64), np.asarray(want[0], np.int64))
    assert tuple(int(x) for x in got[1:]) == tuple(int(x) for x in want[1:])


@pytest.mark.parametrize("k", range(len(EXIT_CASES)), ids=[c[0] for c in EXIT_CASES])
def test_staged_walk_exits_match_plain_and_jax(k):
    """K2's edge cases, one launch: the replay == walk_block == JAX's
    walk_pallas, each ending as built (an up exit reports i0 - 1, a left
    exit j == 0), the ring started once and never reloaded."""
    name, dirs, li, j, i0, j0 = EXIT_CASES[k]
    stats = ws._new_stats()
    got = _staged(dirs, li, j, i0, 4096, j0, stats)
    want = _walk_ref(dirs, li, j, i0, 4096, j0)
    _same_walk(got, want)
    _same_walk(got, _jax_walk(dirs, li, j, i0, 4096, j0))
    if name.startswith("up exit") or name == "both exits on one move":
        assert got[2] == i0 - 1 and not got[4]
    elif name.startswith("left exit") or name.startswith("start on"):
        assert got[3] == 0 and got[2] >= i0 and not got[4]
    assert stats["restarts"] == 1 and stats["reloads"] == 0


@pytest.mark.parametrize("max_steps", [1, 15, 16, 17])
def test_staged_walk_resumes_match_plain_and_jax(max_steps):
    """Launches capped at max_steps resume from their final cell (a
    partial last word, runs cut by the buffer): the looped replay == one
    walk_block call; on the random paths also == JAX's walk_full."""
    for name, dirs, li, j, i0, j0 in EXIT_CASES:
        got = _staged_full(dirs, li, j, i0, max_steps, j0)
        want = _walk_ref(dirs, li, j, i0, 4096, j0)
        _same_walk((got[0], len(got[0])) + tuple(got[1:]), want)
        if name.startswith("a random path"):
            jcodes, ji, jj, jd = jax_tp.walk_full(jax.numpy.asarray(dirs.numpy()), li, j, i0,
                                                  max_steps=max_steps, interpret=True, j0=j0)
            _same_walk((jcodes, len(jcodes), ji, jj, jd), want)


@pytest.mark.parametrize("i0", [0, 7])
@pytest.mark.parametrize("k", range(8))
def test_staged_walk_edge_paths_match_plain(k, i0):
    """walk_stage_cases' K4 edge paths as K2 walks of the lane-offset view
    (word-row boundaries, a stop cell, 300-move gaps, li held at 0), at
    i0 = 0 (saturation) and i0 = 7 (an up exit off lane 0): the replay ==
    walk_block; without a lane offset also == JAX's walk_pallas."""
    name, dirs, li, j, _, _, max_steps, lo = diag_edge_walks()[k]
    view = dirs[:, lo[0]:].contiguous()
    got = _staged(view, li[0], j[0], i0, max_steps, 0)
    _same_walk(got, _walk_ref(view, li[0], j[0], i0, max_steps, 0))
    if lo[0] == 0:
        _same_walk(got, _jax_walk(view, li[0], j[0], i0, max_steps, 0))


@pytest.mark.parametrize("V,shift", [(256, 0), (301, 0), (700, 3)])
def test_staged_walk_random_codes_match_plain(V, shift):
    """Mostly-SUB random codes with stop cells from random starts, at
    block origins with and without exits: the replay == walk_block."""
    rng = np.random.default_rng(V + shift)
    dirs = _pack(rng.choice(4, size=(60 * 16, V), p=[0.8, 0.09, 0.09, 0.02]))
    for _ in range(6):
        li = int(rng.integers(0, min(V, 500)))
        j = int(rng.integers(0, 900 - li))
        i0, j0 = int(rng.integers(0, 3)) * 50, int(rng.integers(0, 2)) * (shift + 256)
        _same_walk(_staged(dirs, li, j, i0, 2048, j0), _walk_ref(dirs, li, j, i0, 2048, j0))


@pytest.mark.parametrize("case", ["blocks", "windows", "left exit"])
def test_staged_walk_checkpointed_windows_match_jax(monkeypatch, case):
    """The walks of a small checkpointed alignment on the CPU (row blocks
    of 64 rows: up exits; blocks of 1,023 rows with n > 2V: windows at
    captured columns, j0 > 0; a gap wider than the window: a left exit),
    recorded where the aligner makes them: the replay, looped as
    walk_full loops the kernel, == what walk_block returned there, and the
    first three == JAX's walk_full (its XLA walker under walk_pallas's
    DMA window of 34 word rows)."""
    rng = np.random.default_rng(71)
    if case == "blocks":
        a = "".join(rng.choice(list("ACGT"), 240))
        b = a[:100] + "".join(rng.choice(list("ACGT"), 9)) + a[100:230]
        rows = 64
    elif case == "windows":
        a = "".join(rng.choice(list("ACGT"), 1100))
        b = "".join(rng.choice(list("ACGT"), 7)) + a[:700] + a[712:] + a[:1000]
        rows = 1023
    else:
        a = "".join(rng.choice(list("ACGT"), 300))
        b = a[:150] + "".join(rng.choice(list("ACGT"), 2300)) + a[150:]
        rows = 1023
    walks = []

    def rec(dirs, li, j, i0, max_steps, j0=0):
        out = td.device_walk(dirs, li, j, i0, max_steps=max_steps, j0=j0)
        walks.append(((dirs, int(li), int(j), int(i0), int(max_steps), int(j0)), out))
        return out

    monkeypatch.setattr(longalign, "device_walk", rec)
    longalign.align_checkpointed(Sequence("a", a), Sequence("b", b), Scores(1, -2, -1, -5),
                                 block_rows=rows, device="cpu")
    assert walks
    kinds = {("window " if args[5] > 0 else "")
             + ("up" if out[1] < args[3] else "left" if args[5] > 0 and out[2] == 0 else "end")
             for args, out in walks}
    assert {"blocks": "up", "windows": "window up", "left exit": "window left"}[case] in kinds
    for t, ((dirs, li, j, i0, max_steps, j0), out) in enumerate(walks):
        got = _staged_full(dirs, li, j, i0, min(max_steps, tw.MAX_STEPS_CAP), j0)
        _same_walk((got[0], len(got[0])) + tuple(got[1:]), (out[0], len(out[0])) + tuple(out[1:]))
        if t < 3:
            jd = jax.numpy.asarray(dirs.numpy())
            if dirs.shape[0] >= jax_tp.PKW:
                ref = jax_tp.walk_full(jd, li, j, i0, max_steps=max_steps, interpret=True, j0=j0)
            else:  # under walk_pallas's DMA window JAX walks with its XLA walker
                ref = jax_td.device_walk(jd, li, j, i0, max_steps=max_steps, interpret=True,
                                         j0=j0)
            jcodes = np.asarray(ref[0])
            _same_walk((jcodes, len(jcodes)) + tuple(ref[1:]),
                       (out[0], len(out[0])) + tuple(out[1:]))
