"""K3 and the matrix fill on the warp-strip pipeline, on the CPU.

The kernel (``csrc/gotoh_warp_pipe.cuh`` with diag16 codes) runs only on
the card, so these tests hold its two new pieces to the plain versions
here:

* a numpy replay of one warp strip's visiting order (lane ``l`` holds rows
  ``first + l*RT .. first + l*RT + RT - 1``, and at step ``q`` takes column
  ``j = q - l``) with the kernel's step forms (row 0 computed from -inf fed
  from above, the boundary only off the straight-line step, where the code
  needs no STOP test but row 0's) and its rule for a diag16 word (a 32-bit
  register a row, shifted down two bits a cell with the code entering at
  the top, so it is whole and holds nothing older where ``(i+j) % 16 ==
  15``; stored there by the one row of the lane that completes a word this
  step, or at ``j == n`` shifted down by ``2 * (15 - (i+j) % 16)``; rows
  past ``m`` never) gives ``gotoh_stream_plain``'s and
  ``matrix_fill_plain``'s codes at every true cell, at RT = 4, 8 and 16;
* the host plan: ring slots, groups, the strip height.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models.aligner import _stream_group_pairs
from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import subst
from genomics_rs_tpu_torch.ops.traceback_walker import MAX_STEPS_CAP
from genomics_rs_tpu_torch.parallel import batch
from genomics_rs_tpu_torch.sequence import round_up

NEG = -(1 << 30)
BASES = np.frombuffer(b"ACGT", np.uint8)
PROT = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)


def replay_words(sub, m: int, n: int, g: int, h: int, is_local: bool, RT: int) -> dict:
    """The code words one pair's strips store, ``{(word row, i): word}``,
    replayed step by step in the warp strip's order. ``sub(i, j)`` is
    ``s(i, j)`` for true rows; a row past ``m`` (the straight-line step
    computes it) gets 0, as the kernel's reads give it some value."""
    H, hg = 32 * RT, h + g
    words: dict = {}
    ringA = ringM = None  # the strip above's bottom row, columns 0..n
    nst = (m + H) // H
    for s in range(nst):
        first = s * H
        Il = np.full((32, RT), NEG, np.int64)
        Pl, dM = Il.copy(), Il.copy()
        acc = np.zeros((32, RT), np.uint64)
        lastA, lastM = np.zeros(32, np.int64), np.zeros(32, np.int64)
        botA, botM = np.full(n + 1, NEG, np.int64), np.full(n + 1, NEG, np.int64)
        for q in range(n + 32):
            for l in reversed(range(32)):  # lane l reads lane l-1's last step
                j, i0 = q - l, first + l * RT
                kreal = min(RT, m - i0 + 1)
                if kreal <= 0 or not 0 <= j <= n:
                    continue
                if l == 0:
                    uA, uM = (NEG, NEG) if s == 0 else (ringA[j], ringM[j])
                else:
                    uA, uM = lastA[l - 1], lastM[l - 1]
                IN = 1 <= j < n  # the straight-line step
                kst = 15 - ((i0 + j) & 15)  # the row that completes a word
                kst = kst if kst < kreal else -1
                for k in range(RT):
                    if not IN and k >= kreal:
                        break
                    i = i0 + k
                    if not IN and i == 0:  # the top boundary
                        I, S = (0, 0) if j == 0 else (h + j * g, NEG)
                        D = S
                    else:
                        if not IN and j == 0:  # the left boundary
                            I, S, D = NEG, NEG, h + i * g
                        else:
                            I = max(Il[l, k] + g, Pl[l, k] + hg)
                            if is_local:
                                I = max(I, 0)
                            D = uA
                            S = (sub(i, j) if i <= m else 0) + dM[l, k]
                        dM[l, k] = uM
                    Q = max(I, S)
                    M0 = max(Q, D)
                    M, A = M0, max(Q + hg, D + g)
                    if is_local:
                        M, A = max(M, 0), max(A, 0)
                    Il[l, k], Pl[l, k] = I, max(S, D)
                    if not IN and i == 0 and j == 0:
                        Il[l, k] = NEG
                    uA, uM = A, M
                    if IN:
                        # The kernel's straight-line code tests no STOP:
                        # M0 is one of S, I, D, and >= 0 in local mode.
                        assert k >= kreal or (M0 in (S, I, D) and (not is_local or M0 >= 0))
                        code = 0 if M0 == S else 1 if M0 == I else 2
                        if is_local and k == 0 and i0 == 0:
                            code = 3
                    else:
                        stop = is_local and (M0 < 0 or (i == 0 and j != 0))
                        code = 3 if stop else 0 if M0 == S else 1 if M0 == I else 2 if M0 == D else 3
                    acc[l, k] = (int(acc[l, k]) >> 2) | (code << 30)  # the funnel shift
                    d = i + j
                    sp = d & 15
                    if (k == kst) if IN else (sp == 15 or j == n):
                        assert (d >> 4, i) not in words, "a word stored twice"
                        words[d >> 4, i] = int(acc[l, k]) >> (2 * (15 - sp))
                lastA[l], lastM[l] = uA, uM
                if l == 31 and s + 1 < nst:
                    botA[j], botM[j] = uA, uM
        ringA, ringM = botA, botM
    return words


def codes_of_words(words: dict, m: int, n: int) -> np.ndarray:
    i, j = np.meshgrid(np.arange(m + 1), np.arange(n + 1), indexing="ij")
    d = i + j
    w = np.vectorize(lambda a, b: words[a, b])(d >> 4, i)
    return (w >> (2 * (d & 15))) & 3


def codes_of_dirs(dirs: torch.Tensor, m: int, n: int) -> np.ndarray:
    i, j = np.meshgrid(np.arange(m + 1), np.arange(n + 1), indexing="ij")
    d = i + j
    w = dirs.numpy().astype(np.int64)[d >> 4, i]
    return (w >> (2 * (d & 15))) & 3


def dna_pair(rng, m: int, n: int, kind: str):
    if kind == "local_stop":  # all mismatches: every local cell floors to 0
        return np.full(m, ord("A"), np.uint8), np.full(n, ord("T"), np.uint8)
    base = BASES[rng.integers(0, 4, max(m, n) + 12)]
    other = base[5 : 5 + n].copy()
    flip = rng.random(n) < 0.15
    other[flip] = BASES[rng.integers(0, 4, int(flip.sum()))]
    return base[:m].copy(), other


#: (m, n, local, kimura); "ragged" has m + 1 past every strip height and a
#: multiple of none.
DNA_CASES = {
    "global": (150, 90, False, False),
    "local": (150, 90, True, False),
    "kimura": (140, 100, True, True),
    "one_row": (1, 40, False, False),
    "empty_s1": (0, 37, True, False),
    "empty_s2": (45, 0, False, False),
    "ragged": (530, 36, True, True),
    "local_stop": (70, 50, True, False),
}


@pytest.mark.parametrize("RT", [4, 8, 16])
@pytest.mark.parametrize("case", list(DNA_CASES))
def test_replayed_diag16_words_equal_k3_plain(RT, case):
    m, n, is_local, kimura = DNA_CASES[case]
    rng = np.random.default_rng(m * 7 + n)
    a, b = dna_pair(rng, m, n, case)
    Lm, Ln = max(round_up(m, 128), 128), max(round_up(n, 128), 128)
    s1 = np.full((1, Lm), 0xFE, np.uint8)
    s2 = np.full((1, Ln), 0xFF, np.uint8)
    s1[0, :m], s2[0, :n] = a, b
    sc = Scores(2, -3, -2, -4, -1 if kimura else None)
    want = gs.gotoh_stream_plain(torch.from_numpy(s1), torch.from_numpy(s2), [m], [n], sc,
                                 is_local, emit_dirs=True)
    c1 = subst.encode_chars(torch.from_numpy(s1), sc)[0].numpy()
    c2 = subst.encode_chars(torch.from_numpy(s2), sc)[0].numpy()

    def sub(i, j):
        x, y = int(c1[i - 1]), int(c2[j - 1])
        if x == y:
            return sc.s_match
        return sc.s_transition if kimura and (x ^ y) == 2 else sc.s_mismatch

    words = replay_words(sub, m, n, sc.g, sc.h, is_local, RT)
    got = codes_of_words(words, m, n)
    assert np.array_equal(got, codes_of_dirs(want.dirs[0], m, n))
    # Exactly the words that hold a true cell are stored.
    assert set(words) == {((i + j) >> 4, i) for i in range(m + 1) for j in range(n + 1)}
    if case == "local_stop":
        assert (got[0, 1:] == 3).all() and (got[1:, 0] == 3).all() and got[0, 0] == 0


@pytest.mark.parametrize("RT", [4, 8, 16])
@pytest.mark.parametrize("is_local", [False, True])
def test_replayed_diag16_words_equal_matrix_plain(RT, is_local):
    rng = np.random.default_rng(9 + RT)
    mx = subst.blosum62()
    m, n = 140 if RT == 4 else 90, 70
    s1 = torch.from_numpy(PROT[rng.integers(0, 20, (1, 256))])
    s2 = torch.from_numpy(PROT[rng.integers(0, 20, (1, 128))])
    code1 = gm.row_codes(s1, mx)
    prof = gm.matrix_profile_plain(s2, [n], mx)
    want = gm.matrix_fill_plain(code1, prof, [m], [n], -1, -11, is_local, emit_dirs=True)
    line, pf = code1[0].numpy(), prof[0].numpy().astype(np.int64)
    words = replay_words(lambda i, j: pf[line[i - 1], j - 1], m, n, -1, -11, is_local, RT)
    assert np.array_equal(codes_of_words(words, m, n), codes_of_dirs(want.dirs[0], m, n))


def test_one_strip_pair_takes_no_ring_slot():
    rows = 256
    ms, ns = np.array([100, 300, 255, 0, 600]), np.array([90, 280, 300, 5, 10])
    plan, nlevels, total, blocks, nslots = gp.pipeline_plan(ms, ns, 384, rows, 64)
    B = len(ms)
    slots = plan[-B:]
    assert list(slots) == [0, 1, 0, 0, 2]  # strips - 1, at most k
    assert nslots == 3 and total == 1 + 2 + 1 + 1 + 3 and nlevels == 3
    # The plan's strips are those of rows 0..m; a one-strip pair's strip
    # writes no slot (it has no successor).
    assert list(gp.strip_counts(ms, rows)) == [1, 2, 1, 1, 3]


def test_dirs_group_of_nine_genomes_fits_the_ring():
    """``align-matrix --alignments-out`` on 29.9 kb genomes: a group of 9
    bitmaps fits the 4 GiB group budget, and its 9 pairs run as one
    launch, each with its strips' slots (>= 2) in the ring."""
    L = 29_900
    Lc = round_up(L, 128)
    steps = min(round_up(2 * Lc + 1, 1024), MAX_STEPS_CAP)
    assert _stream_group_pairs(Lc, Lc, steps) == 9
    rows = gs.stream_rows(np.full(9, L), np.full(9, L), Lc, True)
    ms = ns = np.full(9, L)
    assert gp.pipeline_groups(ms, Lc, rows) == [(0, 9)]
    plan, _, total, blocks, nslots = gp.pipeline_plan(ms, ns, Lc, rows, 132 * 16)
    assert (plan[-9:] >= 2).all() and total == 9 * ((L + rows) // rows)
    assert nslots * 8 * (Lc + 1) <= gp.PIPE_RING_BYTES
    assert blocks <= total


def test_ring_that_does_not_fit_splits_the_bucket():
    """Seven pairs of up to 12 strips against a ring of five slots: the
    bucket splits into launches whose pairs each keep >= 2 slots (a pair
    of two strips needs one)."""
    rows, Ln = 64, 768
    ms = np.array([700, 0, 130, 1, 257, 700, 513])
    ns = np.array([650, 33, 0, 1, 700, 64, 511])
    budget = 5 * 8 * (Ln + 1)
    groups = gp.pipeline_groups(ms, Ln, rows, budget)
    assert len(groups) > 1 and groups[0][0] == 0 and groups[-1][1] == len(ms)
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    for lo, hi in groups:
        plan, *_, nslots = gp.pipeline_plan(ms[lo:hi], ns[lo:hi], Ln, rows, 3, ring_bytes=budget)
        strips = gp.strip_counts(ms[lo:hi], rows)
        slots = plan[-(hi - lo):]
        assert (slots >= np.minimum(strips - 1, 2)).all() and nslots <= 5


@pytest.mark.parametrize("dirs", [False, True])
def test_stream_rows_is_a_compiled_height(dirs):
    for Lm in (0, 31, 128, 151, 384, 1024, 29_952):
        ms = np.array([Lm, Lm // 2])
        rows = gs.stream_rows(ms, ms, Lm, dirs)
        assert rows // 32 in gp.LANE_ROWS and rows % 32 == 0
        assert rows >= min(gs.STREAM_ROWS, gp.strip_height(Lm + 1))


def test_stream_rows_follows_the_sweep():
    """The sweep's picks (PERF.md): 512 rows for the 55-pair genome corpus
    and 32,768 x 383 aa, 256 for call's 150-row reads in a 256-row bucket,
    and 256 for every bucket with codes."""
    L = np.full(55, 29_900)
    assert gs.stream_rows(L, L, 29_952, False) == 512
    assert gs.stream_rows(L[:9], L[:9], 29_952, True) == 256
    P = np.full(32_768, 383)
    assert gs.stream_rows(P, P, 384, False) == 512
    assert gs.stream_rows(P[:256], P[:256], 384, True) == 256
    reads, wins = np.full(4096, 150), np.full(4096, 380)
    assert gs.stream_rows(reads, wins, 256, False) == 256
    assert gs.stream_rows(reads, wins, 256, True) == 256
    assert gs.stream_rows([100], [90], 100, False) == 128  # one strip holds the bucket


def test_kernel_wrappers_take_only_cuda_tensors():
    s = torch.zeros((1, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gs._stream_cuda(s, s, [1], [1], Scores(), False)
    code1, prof = torch.zeros((1, 128), dtype=torch.int32), torch.zeros((1, 5, 128), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gm._matrix_cuda(code1, prof, [1], [1], -1, -11, False, False, "stream")


def test_error_word_raises_where_the_scores_are_read():
    rng = np.random.default_rng(3)
    s1 = torch.from_numpy(BASES[rng.integers(0, 4, (2, 128))])
    s2 = torch.from_numpy(BASES[rng.integers(0, 4, (2, 128))])
    fill = gs.gotoh_stream_fill(s1, s2, [100, 90], [120, 7], Scores(), False, emit_dirs=True)
    assert fill.err.dtype == torch.int32 and int(fill.err) == 0
    gs.StreamDirsResult(fill)  # a clear word reads
    bad = fill._replace(err=torch.ones((), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="passed its bound"):
        gs.StreamDirsResult(bad)
    with pytest.raises(RuntimeError, match="passed its bound"):
        batch._read([(bad.score, bad.start_i, bad.start_j, bad.err)])
    got = batch.score_pairs(s1.numpy(), s2.numpy(), [100, 90], [120, 7], Scores(),
                            engine="stream", device="cpu")
    assert [list(x) for x in got] == [list(x.numpy()) for x in fill[:3]]
