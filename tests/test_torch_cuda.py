"""CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (run them on a GPU
machine with ``python -m pytest --noconftest tests/test_torch_cuda.py``).
The CPU tests hold the plain versions equal to the JAX package; these
hold the kernels (K1–K4, K6 at every group size, ``walk_rows16``,
K10–K12, the query profile (at its tails and its widest alphabet) and the
matrix fill of K13–K15, the warp-strip
kernel of K7, the strip pipeline of K9 and its K16 entry, K8 on K3's
pipeline, and K1's tile form K5 with a two-shard pipeline on one card) equal to the plain versions, bit for
bit; K1 and K5 also at the edges of their strip pipeline (strip counts,
chunk widths, capped grids, a tight ring) and with a set error word; the
warp-strip pipeline of K9, K16, K3, the matrix fill, K10 and K12 at its
edges (strips that end mid-lane, one-row and empty pairs, local ties,
capped grids, a tight ring under a short wait bound, every strip height
with and without diag16 codes, an error word that comes back unread,
bands at column 0 and bands that slide, every band width that had its own
compiled form, mixed batches); the staged walks (K2 on its block exits,
edge paths and random codes, one launch and resumed, on both copy routes;
K4 on random codes,
TMA and 4-byte-copy rows and views, buffers ending mid-path, thousands of
short walks and ``walk_stage_cases``' edge paths; K11 on its edge paths
whole and resumed, rows of any width and one-launch batches); and the
suffix structures' torch ops on the card (the prefix-doubling suffix
array against host SA-IS, the lockstep FM-index search against the host
loop); and the scan engines and the device vote, torch ops on the card,
against their CPU runs and the host vote.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models.aligner import PairwiseAligner, align_batch, matrix_align_batch
from genomics_rs_tpu_torch.models.banded import align_banded
from genomics_rs_tpu_torch.ops import gotoh_banded as gb
from genomics_rs_tpu_torch.ops import gotoh_banded_batch as gbb
from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
from genomics_rs_tpu_torch.ops import gotoh_matrix_stream as gms
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
from genomics_rs_tpu_torch.ops import gotoh_segmented as gseg
from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops import gotoh_stream8 as gs8
from genomics_rs_tpu_torch.ops import traceback_batch as tb
from genomics_rs_tpu_torch.ops import traceback_device as td
from genomics_rs_tpu_torch.ops import traceback_walker as tw
from genomics_rs_tpu_torch.ops import subst
from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_top
from genomics_rs_tpu_torch.sequence import PAD_S2, Sequence
from walk_stage_cases import BAND_EDGE_SPECS, band_edge_walk, diag_edge_walks, exit_walks

pytestmark = pytest.mark.cuda

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes_at(dirs: np.ndarray, R: int, B: int) -> np.ndarray:
    li = np.arange(R + 1)[:, None]
    j = np.arange(B + 1)[None, :]
    k = li + j
    return (dirs[k // 16, li].astype(np.int64) >> (2 * (k % 16))) & 3


def _k1_inputs(rng, R, B, n, i0, sc, with_left, alphabet=BASES):
    s1 = torch.from_numpy(alphabet[rng.integers(0, len(alphabet), R)].copy())
    s2 = torch.from_numpy(np.concatenate(
        [alphabet[rng.integers(0, len(alphabet), n)], np.full(B - n, PAD_S2, np.uint8)]))
    top = global_boundary_top(7, B, sc, device="cpu")
    if i0 > 0:  # a carried row, not the table's first
        top = top + torch.from_numpy(rng.integers(-6, 3, (3, B + 1)).astype(np.int32))
    left = torch.from_numpy(rng.integers(-40, 5, (3, R)).astype(np.int32)) if with_left else None
    return s1, s2, top, left


def _k1_check(cuda, s1, s2, top, left, m, n, i0, sc, is_local, rows=None, max_blocks=None):
    """K1 on the card (at ``rows`` rows a strip, the grid capped at
    ``max_blocks``) == the plain version: every output, dirs at every
    cell of the block, and the error word clear."""
    R, B = s1.shape[0], s2.shape[0]
    emit = dict(emit_dirs=True, emit_bottom=True, emit_cols=True)
    want = rb.gotoh_rowblock(s1, s2, top, m, n, i0, sc, is_local, left=left, **emit)
    before = rb.COUNTS["kernel"]
    on_card = (s1.to(cuda), s2.to(cuda), top.to(cuda))
    left_card = None if left is None else left.to(cuda)
    if rows is None and max_blocks is None:  # the entry point
        got = rb.gotoh_rowblock(*on_card, m, n, i0, sc, is_local, left=left_card, **emit)
    else:  # the same launch at another strip height or on a capped grid
        got = rb.launch(*on_card, left_card, m, n, i0, 0, sc, is_local, True, True, True, False,
                        False, rb.COUNTS, rows or rb.PIPE_ROWS, max_blocks)
    torch.cuda.synchronize()
    assert rb.COUNTS["kernel"] == before + 1
    assert int(got.err) == 0
    assert int(got.score_at_mn) == int(want.score_at_mn)
    assert [int(x) for x in got.best] == [int(x) for x in want.best]
    assert torch.equal(got.bottom.cpu(), want.bottom)
    V = rb.lane_count(R)
    for c in range(want.cols.shape[0]):
        if c * V <= n:
            assert torch.equal(got.cols[c, :, 1 : R + 1].cpu(), want.cols[c, :, 1 : R + 1])
    assert np.array_equal(
        _codes_at(got.dirs.cpu().numpy(), R, B), _codes_at(want.dirs.numpy(), R, B)
    )
    return got


#: K1 shapes (R, B, n, m, i0): two strips at T = 256 with the probe below
#: the block; ragged strips (R + 1 not a multiple of T) holding (m, n);
#: three whole strips; one strip shorter than T.
K1_SHAPES = {"two_strips": (300, 512, 500, 1000, 300), "ragged": (1000, 700, 690, 1000, 0),
             "whole": (767, 320, 300, 900, 133), "short": (100, 300, 280, 100, 0)}


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("st", [None, -1])
@pytest.mark.parametrize("with_left", [False, True])
@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_rowblock_kernel_matches_plain(cuda, is_local, st, with_left, shape):
    R, B, n, m, i0 = K1_SHAPES[shape]
    rng = np.random.default_rng(1)
    sc = Scores(2, -3, -2, -4, st)
    s1, s2, top, left = _k1_inputs(rng, R, B, n, i0, sc, with_left)
    _k1_check(cuda, s1, s2, top, left, m, n, i0, sc, is_local)
    plan = rb.block_plan(R, B, rb.strip_rows(R), 1 << 20)
    assert plan.blocks == plan.strips == -(-(R + 1) // rb.strip_rows(R))


@pytest.mark.parametrize(
    "R,B,n,m,i0,is_local,st,with_left,rows,max_blocks",
    [
        (600, 63, 63, 600, 0, True, None, False, 128, None),  # B below PIPE_CHUNK
        (600, 64, 64, 600, 0, False, -1, True, 128, None),  # B at PIPE_CHUNK
        (600, 65, 65, 600, 0, True, -1, True, 128, None),  # B just past it
        (900, 400, 380, 950, 0, True, None, False, 128, 1),  # one block: tickets cycle
        (900, 400, 380, 700, 64, False, -1, True, 128, 2),  # two blocks, probe inside
        (1100, 300, 290, 1100, 0, True, -1, False, 512, None),  # V = 2048
        (200, 2100, 2090, 200, 0, False, None, True, 64, 3),  # two column checkpoints
    ],
)
def test_rowblock_kernel_strip_edges_match_plain(cuda, R, B, n, m, i0, is_local, st,
                                                 with_left, rows, max_blocks):
    """K1 at the pipeline's edges: a top row narrower than, as wide as and
    just wider than a published chunk, grids of 1–3 persistent blocks, strip
    heights 64–512, and column checkpoints past the first."""
    rng = np.random.default_rng(R + B)
    sc = Scores(2, -3, -2, -4, st)
    s1, s2, top, left = _k1_inputs(rng, R, B, n, i0, sc, with_left)
    _k1_check(cuda, s1, s2, top, left, m, n, i0, sc, is_local, rows, max_blocks)


def test_rowblock_kernel_tight_ring_matches_plain(cuda, monkeypatch):
    """A ring of two slots for 16 strips of 64 rows on a grid of 3 blocks:
    every slot is written again once its reader has released it."""
    R, B, n = 1023, 300, 290
    monkeypatch.setattr(gp, "RING_BYTES", 2 * 8 * (B + 1))
    assert rb.block_plan(R, B, 64, 3) == rb.BlockPlan(64, 16, 2, 3)
    rng = np.random.default_rng(6)
    sc = Scores(2, -3, -2, -4, -1)
    for is_local in (False, True):
        s1, s2, top, left = _k1_inputs(rng, R, B, n, 0, sc, True)
        _k1_check(cuda, s1, s2, top, left, R, n, 0, sc, is_local, 64, 3)


def test_rowblock_long_slot_waits_are_no_fault(cuda, monkeypatch):
    """Slot waits far longer than the waits' bound, behind strips that
    still sweep, are no fault: a two-slot ring for 32 strips of 64 rows on
    16 blocks, 12,000 columns wide, so strip s waits about a sweep of B
    columns for strip s - 1 to release its slot (and strip s + 1 as long
    again for strip s), under a bound of 1 ms. The fill equals the plain
    version with the error word clear. Under a bound of 1 ns the first
    wait trips it, and the result raises."""
    R, B, n = 2047, 12_000, 11_990
    monkeypatch.setattr(gp, "RING_BYTES", 2 * 8 * (B + 1))
    assert rb.block_plan(R, B, 64, 16) == rb.BlockPlan(64, 32, 2, 16)
    rng = np.random.default_rng(21)
    sc = Scores(2, -3, -2, -4, -1)
    s1, s2, top, _ = _k1_inputs(rng, R, B, n, 0, sc, False)
    want = rb.gotoh_rowblock(s1, s2, top, R, n, 0, sc, False)
    bound_ns = 1_000_000
    on_card = (s1.to(cuda), s2.to(cuda), top.to(cuda), None, R, n, 0, 0, sc, False, False, True,
               False, False, False, {"kernel": 0}, 64, 16)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    got = rb.launch(*on_card, spin_ns=bound_ns)
    end.record()
    torch.cuda.synchronize()
    assert int(got.err) == 0
    assert start.elapsed_time(end) > 3 * bound_ns / 1e6  # a strip's sweep outlasts the bound
    assert int(got.score_at_mn) == int(want.score_at_mn)
    assert torch.equal(got.bottom.cpu(), want.bottom)
    tripped = rb.launch(*on_card, spin_ns=1)
    with pytest.raises(RuntimeError, match="passed its bound"):
        rb.raise_on_err(tripped.err)


@pytest.mark.parametrize("case", ["equal_bests", "all_mismatch", "past_m"])
def test_rowblock_kernel_local_best_conventions(cuda, case):
    """Local bests: a motif repeated in every strip (equal bests in many
    strips: the last row wins), an all-mismatch table (every cell 0: the
    last true cell), and a block wholly past m (no true cell: the TPU
    kernel's lane-merge answer)."""
    R, B, n = 900, 200, 180
    sc = Scores()
    rng = np.random.default_rng(9)
    if case == "equal_bests":
        s1 = torch.from_numpy(np.frombuffer(b"ACGTTGCA" * 113, np.uint8)[:R].copy())
        s2 = torch.from_numpy(np.concatenate([np.frombuffer(b"ACGTTGCA", np.uint8),
                                              np.full(B - 8, PAD_S2, np.uint8)]))
        n, m, i0 = 8, R, 0
    elif case == "all_mismatch":
        s1 = torch.full((R,), ord("A"), dtype=torch.uint8)
        s2 = torch.from_numpy(np.concatenate([np.full(n, ord("C"), np.uint8),
                                              np.full(B - n, PAD_S2, np.uint8)]))
        m, i0 = R - 5, 0
    else:
        s1, s2, _, _ = _k1_inputs(rng, R, B, n, 0, sc, False)
        m, i0 = 500, 1000
    top = global_boundary_top(0, B, sc, device="cpu")
    got = _k1_check(cuda, s1, s2, top, None, m, n, i0, sc, True, 128, 2)
    if case == "equal_bests":
        assert int(got.best[1]) > 3 * 128  # the repeat in the last strips wins
    elif case == "all_mismatch":
        assert [int(x) for x in got.best] == [0, m, n]
    else:
        assert int(got.best[0]) == -(2**31)


def test_pipeline_error_word_raises_at_the_callers_read(cuda, monkeypatch):
    """A set error word (the kernel then leaves at once) raises where each
    caller reads its result: ``align`` (monolithic and checkpointed),
    ``sharded_gotoh_score`` and ``gotoh_fill_pallas``; no plain version
    runs instead."""
    from genomics_rs_tpu_torch.models.longalign import align_checkpointed
    from genomics_rs_tpu_torch.parallel import longseq
    from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh

    def failed_workspace(plan, dev):
        work = torch.zeros(plan.work_ints, dtype=torch.int32, device=dev)
        work[rb.ERR_INDEX] = 1
        return work

    monkeypatch.setattr(rb, "_workspace", failed_workspace)
    rng = np.random.default_rng(15)
    a = Sequence("a", BASES[rng.integers(0, 4, 700)].tobytes().decode())
    b = Sequence("b", BASES[rng.integers(0, 4, 650)].tobytes().decode())
    plain = rb.COUNTS["plain"], gp.TILE_COUNTS["plain"]
    with pytest.raises(RuntimeError, match="passed its bound"):
        PairwiseAligner(Scores(), device="cuda").align(a, b)
    for block_rows in (255, 1023):  # forward pass and windowed refills; one fill
        with pytest.raises(RuntimeError, match="passed its bound"):
            align_checkpointed(a, b, Scores(), block_rows=block_rows, device="cuda")
    s1 = torch.from_numpy(a.encoded(pad_to=768, pad_value=0xFE).copy())
    s2 = torch.from_numpy(b.encoded(pad_to=768, pad_value=PAD_S2).copy())
    with pytest.raises(RuntimeError, match="passed its bound"):
        longseq.sharded_gotoh_score(make_mesh(2, SEQ_AXIS, devices=[cuda, cuda]), s1, s2, 700,
                                    650, Scores(), True)
    with pytest.raises(RuntimeError, match="passed its bound"):
        gp.gotoh_fill_pallas(s1.to(cuda), s2.to(cuda), 700, 650, Scores(), False, emit_dirs=False)
    assert (rb.COUNTS["plain"], gp.TILE_COUNTS["plain"]) == plain


@pytest.mark.parametrize("j0", [0, 1024])
def test_walk_kernel_matches_plain(cuda, j0):
    rng = np.random.default_rng(2)
    dirs = torch.from_numpy(rng.integers(-(2**31), 2**31, (64, 300), dtype=np.int64).astype(np.int32))
    for li, j in ((250, 700), (10, 900), (299, 5)):
        want = td.device_walk(dirs, li, j, 3, max_steps=40, j0=j0)
        got = tw.walk_full(dirs.to(cuda), li, j, 3, max_steps=40, j0=j0)
        assert np.array_equal(got[0], want[0])
        assert tuple(got[1:]) == tuple(want[1:])


def _k2_views(dirs: torch.Tensor, cuda):
    """The bitmap on the card twice: as its own tensor (16-byte aligned:
    TMA boxes where V % 4 == 0 and V >= 196) and as a view 4 bytes into a
    larger buffer (4-byte cp.async copies)."""
    KW, V = dirs.shape
    flat = torch.zeros(KW * V + 1, dtype=torch.int32, device=cuda)
    flat[1:] = dirs.reshape(-1).to(cuda)
    return {"tma": dirs.to(cuda), "cp.async": flat[1:].view(KW, V)}


@pytest.mark.parametrize("route", ["tma", "cp.async"])
def test_walk_kernel_exits_match_plain(cuda, route):
    """K2 on walk_stage_cases' exit cases (up exits in a SUB run and off
    lane 0 after an INS run, left exits in SUB and INS runs, both at once,
    stop cells, done at i0 = 1, random paths), one launch and resumed at
    max_steps 1, 15, 16 and 17, on both copy routes: == walk_block, one
    count a launch."""
    for name, dirs, li, j, i0, j0 in exit_walks():
        want = td.device_walk(dirs, li, j, i0, max_steps=4096, j0=j0)
        view = _k2_views(dirs, cuda)[route]
        before = tw.COUNTS["kernel"]
        words, count, i_f, j_f, done = tw.walk_kernel(view, li, j, i0, 4096, j0)
        assert tw.COUNTS["kernel"] == before + 1
        assert np.array_equal(tw.unpack_moves(words, count), want[0]), name
        assert (i_f, j_f, done) == tuple(want[1:]), name
        for cap in (1, 15, 16, 17):
            got = tw.walk_full(view, li, j, i0, max_steps=cap, j0=j0)
            assert np.array_equal(got[0], want[0]) and tuple(got[1:]) == tuple(want[1:]), name


@pytest.mark.parametrize("route", ["tma", "cp.async"])
def test_walk_kernel_edge_paths_match_plain(cuda, route):
    """walk_stage_cases' K4 edge paths as K2 walks of the lane-offset view
    (word-row boundaries, a stop cell, 300-move gaps, li held at 0) at i0 =
    0 and 7, and mostly-SUB random codes on rows of 256, 301 and 700
    lanes with block origins inside, on both copy routes: == walk_block."""
    cases = [(dirs[:, lo[0]:].contiguous(), li[0], j[0], i0, 0)
             for _, dirs, li, j, _, _, _, lo in diag_edge_walks() for i0 in (0, 7)]
    rng = np.random.default_rng(33)
    for V in (256, 301, 700):
        dirs = _pack16(rng.choice(4, size=(60 * 16, V), p=[0.8, 0.09, 0.09, 0.02]))
        for _ in range(4):
            li = int(rng.integers(0, min(V, 500)))
            cases.append((dirs, li, int(rng.integers(0, 900 - li)), int(rng.integers(0, 3)) * 50,
                          int(rng.integers(0, 2)) * 300))
    for dirs, li, j, i0, j0 in cases:
        want = td.device_walk(dirs, li, j, i0, max_steps=4096, j0=j0)
        got = tw.walk_full(_k2_views(dirs, cuda)[route], li, j, i0, max_steps=4096, j0=j0)
        assert np.array_equal(got[0], want[0]) and tuple(got[1:]) == tuple(want[1:])


def _stream_batch(rng, ms, ns, Lm, Ln):
    B = len(ms)
    s1 = np.full((B, Lm), 0xFE, np.uint8)
    s2 = np.full((B, Ln), PAD_S2, np.uint8)
    for b in range(B):
        base = BASES[rng.integers(0, 4, max(Lm, Ln) + 20)]
        s1[b, : ms[b]] = base[: ms[b]]
        other = base[9 : 9 + ns[b]].copy()
        flip = rng.random(ns[b]) < 0.1
        other[flip] = BASES[rng.integers(0, 4, int(flip.sum()))]
        s2[b, : ns[b]] = other
    return torch.from_numpy(s1), torch.from_numpy(s2), np.array(ms), np.array(ns)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("st", [None, -1])
@pytest.mark.parametrize(
    "ms,ns,Lm,Ln",
    [([1100, 900, 0, 17], [1024, 1100, 30, 0], 1152, 1152), ([300], [250], 384, 256)],
    ids=["mixed", "one"],
)
def test_stream_kernel_matches_plain(cuda, is_local, st, ms, ns, Lm, Ln):
    """K3 scores, start cells and codes at every true cell."""
    rng = np.random.default_rng(4)
    s1, s2, ms, ns = _stream_batch(rng, ms, ns, Lm, Ln)
    sc = Scores(2, -3, -2, -4, st)
    want = gs.gotoh_stream_plain(s1, s2, ms, ns, sc, is_local, emit_dirs=True)
    got = gs.gotoh_stream_fill(s1.to(cuda), s2.to(cuda), ms, ns, sc, is_local, emit_dirs=True)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.cpu(), w)
    gd, wd = got.dirs.cpu().numpy(), want.dirs.numpy()
    for p in range(len(ms)):
        assert np.array_equal(_codes_at(gd[p], ms[p], ns[p]), _codes_at(wd[p], ms[p], ns[p]))


@pytest.mark.parametrize("is_local", [False, True])
def test_walk_many_kernel_matches_plain(cuda, is_local):
    """K4 over a K3 bitmap, and over random codes at lane offsets."""
    rng = np.random.default_rng(5)
    s1, s2, ms, ns = _stream_batch(rng, [1000, 700, 1100], [900, 1152, 40], 1152, 1152)
    res = gs.gotoh_stream_fill_dirs(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), is_local)
    B, KW = len(ms), res.KW
    flat = res.dirs.view(B * KW, -1)
    args = (res.start_i, res.start_j, np.arange(B) * KW, KW, 4096)
    got = tw.walk_many(flat, *args)
    want = tw.walk_many_plain(flat.cpu(), *args)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))
    assert all(got[4])
    dirs = torch.from_numpy(rng.integers(-(2**31), 2**31, (96, 700), dtype=np.int64).astype(np.int32))
    args = ([250, 10, 299], [300, 600, 5], [0, 20, 50], 40, 64)
    got = tw.walk_many(dirs.to(cuda), *args, loffs=[0, 300, 7])
    want = tw.walk_many_plain(dirs, *args, loffs=[0, 300, 7])
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))


@pytest.mark.parametrize("is_local", [False, True])
def test_align_batch_cuda_matches_cpu(cuda, is_local):
    rng = np.random.default_rng(6)
    a = "".join(rng.choice(list("ACGT"), 600))
    pairs = [(Sequence("a", a[k * 20 :]), Sequence("b", a[: 500 + k * 30])) for k in range(3)]
    want = align_batch(pairs, Scores(), is_local, device="cpu")
    got = align_batch(pairs, Scores(), is_local, device="cuda")
    assert [(r.score, r.alignment) for r in got] == [(r.score, r.alignment) for r in want]


@pytest.mark.parametrize("is_local", [False, True])
def test_align_cuda_matches_cpu(cuda, is_local):
    rng = np.random.default_rng(3)
    a = "".join(rng.choice(list("ACGT"), 700))
    b = a[:300] + "".join(rng.choice(list("ACGT"), 40)) + a[320:]
    sc = Scores()
    want = PairwiseAligner(sc, is_local, device="cpu").align(Sequence("a", a), Sequence("b", b))
    got = PairwiseAligner(sc, is_local, device="cuda").align(Sequence("a", a), Sequence("b", b))
    assert (got.score, got.alignment) == (want.score, want.alignment)


@pytest.mark.parametrize("is_local", [False, True])
def test_checkpointed_one_block_cuda_matches_cpu(cuda, is_local):
    """One block with n < 2V: one K1 launch with dirs, walked by K2, gives
    the CPU route's alignment; no plain version runs."""
    from genomics_rs_tpu_torch.models.longalign import align_checkpointed

    rng = np.random.default_rng(8)
    a = "".join(rng.choice(list("ACGT"), 900))
    b = "".join(rng.choice(list("ACGT"), 60)) + a[100:500] + a[530:880]
    pair = Sequence("a", a), Sequence("b", b)
    want = align_checkpointed(*pair, Scores(), is_local, block_rows=1023, device="cpu")
    before = rb.COUNTS["kernel"], rb.COUNTS["plain"], td.COUNTS["plain"]
    got = align_checkpointed(*pair, Scores(), is_local, block_rows=1023, device="cuda")
    assert got == want
    assert (rb.COUNTS["kernel"], rb.COUNTS["plain"], td.COUNTS["plain"]) == (
        before[0] + 1, before[1], before[2])


def _short_batch(rng, B, L1, L2, ties=False):
    """Reads and mutated copies, lengths 1..L, one pair filling the bucket,
    one of one row and one of one column; ``ties``: both sides repeat a
    unit of 1-4 bases (local bests tie on many rows and columns)."""
    ms = rng.integers(1, L1 + 1, B)
    ns = rng.integers(1, L2 + 1, B)
    ms[0], ns[0] = L1, L2
    ms[1], ns[2] = 1, 1
    s1 = np.full((B, L1), 0xFE, np.uint8)
    s2 = np.full((B, L2), PAD_S2, np.uint8)
    for b in range(B):
        if ties:
            unit = BASES[rng.integers(0, 4, int(rng.integers(1, 5)))]
            s1[b, : ms[b]], s2[b, : ns[b]] = np.resize(unit, ms[b]), np.resize(unit, ns[b])
            continue
        s1[b, : ms[b]] = BASES[rng.integers(0, 4, ms[b])]
        k = min(ms[b], ns[b])
        s2[b, :k] = s1[b, :k]
        s2[b, k : ns[b]] = BASES[rng.integers(0, 4, ns[b] - k)]
        flip = np.nonzero(rng.random(k) < 0.1)[0]
        s2[b, flip] = BASES[rng.integers(0, 4, flip.size)]
    return torch.from_numpy(s1), torch.from_numpy(s2), ms, ns


def _shortread_equal(cuda, s1, s2, ms, ns, sc, is_local):
    """K6 at the wrapper's group size and at every G, scores-only and with
    codes, == the plain version: scores, start cells and codes at every
    true cell; rows past m and words past n's stay zero."""
    want = gsr.gotoh_shortread_plain(s1, s2, ms, ns, sc, is_local, emit_dirs=True)
    c1, c2 = s1.to(cuda), s2.to(cuda)
    runs = [gsr.gotoh_scores_shortread(c1, c2, ms, ns, sc, is_local, emit_dirs=True),
            gsr.gotoh_scores_shortread(c1, c2, ms, ns, sc, is_local)]
    for G in gsr.GROUP_SIZES:
        runs += [gsr._shortread_cuda(c1, c2, ms, ns, sc, is_local, True, G),
                 gsr._shortread_cuda(c1, c2, ms, ns, sc, is_local, False, G)]
    torch.cuda.synchronize()
    wc = want[3].numpy().astype(np.int64)
    for got in runs:
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g.cpu(), w)
        if len(got) < 4:
            continue
        gc = got[3].cpu().numpy().astype(np.int64)
        for b in range(len(ms)):
            j = np.arange(ns[b])
            shift = 2 * (j % 16)
            assert np.array_equal((gc[b, : ms[b]][:, j // 16] >> shift) & 3,
                                  (wc[b, : ms[b]][:, j // 16] >> shift) & 3)
            assert not gc[b, ms[b]:].any() and not gc[b, :, (ns[b] - 1) // 16 + 1:].any()


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("st", [None, -1])
@pytest.mark.parametrize("L1,L2", [(256, 256), (64, 48), (32, 16), (128, 256), (160, 160),
                                   (224, 48)])
def test_shortread_kernel_matches_plain(cuda, is_local, st, L1, L2):
    """K6 scores, start cells and codes at every true cell, at the paths'
    shapes (128 x 256, 160 x 160) and where rows end inside a lane (224
    rows: G x RT = 256 at G = 8 and 32; m < L1 everywhere but pair 0)."""
    rng = np.random.default_rng(8)
    s1, s2, ms, ns = _short_batch(rng, 37, L1, L2)
    _shortread_equal(cuda, s1, s2, ms, ns, Scores(2, -3, -2, -4, st), is_local)


@pytest.mark.parametrize("L1,L2", [(128, 256), (160, 160), (64, 48)])
def test_shortread_kernel_local_ties_keep_the_contract(cuda, L1, L2):
    """Tie-heavy local batches: every G keeps the largest (v, i, j) as the
    plain version does."""
    rng = np.random.default_rng(9 + L1)
    s1, s2, ms, ns = _short_batch(rng, 41, L1, L2, ties=True)
    _shortread_equal(cuda, s1, s2, ms, ns, Scores(), True)


@pytest.mark.parametrize("is_local", [False, True])
def test_walk_rows16_kernel_matches_plain(cuda, is_local):
    rng = np.random.default_rng(9)
    s1, s2, ms, ns = _short_batch(rng, 300, 128, 128)
    sc = Scores()
    score, si, sj, codes = gsr.gotoh_scores_shortread(s1.to(cuda), s2.to(cuda), ms, ns, sc,
                                                      is_local, emit_dirs=True)
    got = tb.walk_batch(codes, si, sj, sc, is_local, "rows16", 257)
    want = tb.walk_batch(codes.cpu(), si.cpu(), sj.cpu(), sc, is_local, "rows16", 257)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert all(got[4])


@pytest.mark.parametrize("is_local", [False, True])
def test_walk_batch_diag16_cuda_matches_plain(cuda, is_local):
    """K4 under the walk_batch contract (the stop cell is the final cell)."""
    rng = np.random.default_rng(10)
    s1, s2, ms, ns = _stream_batch(rng, [300, 200, 280], [260, 300, 100], 384, 384)
    fill = gs.gotoh_stream_fill(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), is_local,
                                emit_dirs=True)
    args = (fill.start_i, fill.start_j, Scores(), is_local, "diag16", 769)
    got = tb.walk_batch(fill.dirs, *args)
    want = tb.walk_batch(fill.dirs.cpu(), *args)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))



def _pack16(codes: np.ndarray) -> torch.Tensor:
    """(16 K, V) codes -> (K, V) int32 words, 16 rows a word."""
    words = np.zeros((codes.shape[0] // 16, codes.shape[1]), np.uint32)
    for t in range(16):
        words |= codes[t::16].astype(np.uint32) << np.uint32(2 * t)
    return torch.from_numpy(words.view(np.int32))


def _same_walks(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))


def test_walk_many_staged_matches_plain(cuda):
    """K4 == the plain version: mostly-SUB random codes with stop cells at
    word-row and lane offsets, on rows of 700 lanes (TMA boxes), of 301
    lanes and on a view 4 bytes off alignment (4-byte cp.async copies),
    with buffers that end mid-path (max_steps 1, 15, 16, 17, 1,000), and
    walk_stage_cases' edge paths (word-row boundaries, a stop cell, lane
    offsets, 300-move gaps, li held at 0)."""
    rng = np.random.default_rng(31)
    for V, shift in ((700, 0), (301, 0), (700, 1)):
        codes = rng.choice(4, size=(101 * 16, V), p=[0.8, 0.09, 0.09, 0.02])
        flat = _pack16(codes).reshape(-1)
        dirs = flat[shift : shift + 100 * V].view(100, V)
        li = rng.integers(0, 280, 5)
        args = (li, rng.integers(0, 640 - li), [0, 40, 7, 55, 19], 40)
        loffs = [0, 20, 3, 17, 1]
        for max_steps in (4096, 1, 15, 16, 17, 1000):
            before = tw.COUNTS["many_kernel"]
            got = tw.walk_many(dirs.to(cuda), *args, max_steps, loffs)
            assert tw.COUNTS["many_kernel"] == before + 1
            _same_walks(got, tw.walk_many_plain(dirs, *args, max_steps, loffs))
    for name, dirs, *args in diag_edge_walks():
        got = tw.walk_many(dirs.to(cuda), *args[:5], args[5])
        _same_walks(got, tw.walk_many_plain(dirs, *args[:5], args[5]))


def test_walk_many_thousands_of_short_walks(cuda):
    """4,097 short walks (a warp each) in one K4 launch == the plain
    version."""
    rng = np.random.default_rng(32)
    W, KW, V = 4097, 8, 64
    codes = rng.choice(3, size=(W * KW * 16, V), p=[0.8, 0.1, 0.1])
    dirs = _pack16(codes)
    li, sj = rng.integers(0, 60, W), rng.integers(0, 60, W)
    before = tw.COUNTS["many_kernel"]
    got = tw.walk_many(dirs.to(cuda), li, sj, np.arange(W) * KW, KW, 256)
    _same_walks(got, tw.walk_many_plain(dirs, li, sj, np.arange(W) * KW, KW, 256))
    assert tw.COUNTS["many_kernel"] == before + 1


def _banded_batch(rng, ms, ns, Lm, Ln):
    """Mutated copies: pair p is s1 of m_p bp and a 5%-mutated s2 of n_p."""
    B = len(ms)
    s1 = np.full((B, Lm), 0xFE, np.uint8)
    s2 = np.full((B, Ln), PAD_S2, np.uint8)
    for b in range(B):
        base = BASES[rng.integers(0, 4, max(ms[b], ns[b]))]
        s1[b, : ms[b]] = base[: ms[b]]
        other = base[: ns[b]].copy()
        flip = rng.random(ns[b]) < 0.05
        other[flip] = BASES[rng.integers(0, 4, int(flip.sum()))]
        s2[b, : ns[b]] = other
    return torch.from_numpy(s1), torch.from_numpy(s2), np.array(ms), np.array(ns)


def _band_codes(dirs, ms, ns, V, M, N):
    """Codes at every true in-band cell of each pair, flattened."""
    words = dirs.cpu().numpy().astype(np.int64)
    out = []
    for p in range(len(ms)):
        i = np.arange(1, ms[p] + 1)
        off = gb.band_offset(i, M, N, V)
        for r in range(ms[p]):
            v = np.arange(max(1, off[r] + 1), min(ns[p], off[r] + V) + 1) - off[r] - 1
            out.append((words[p, r // 16, v] >> (2 * (r % 16))) & 3)
    return np.concatenate(out)


@pytest.mark.parametrize("st", [None, -1])
@pytest.mark.parametrize(
    "ms,ns,V",
    [([2500], [2400], 1024), ([1800], [1500], 2048), ([3000, 2990, 2950], [2980, 2900, 2940], 384),
     ([700, 650], [690, 640], 2048), ([8600], [8400], 8192)],
    ids=["K10-narrow", "K10-full", "K12-narrow", "K12-full", "K10-narrow-16-lanes"],
)
def test_banded_fill_kernel_matches_plain(cuda, st, ms, ns, V):
    """K10 (one pair, V a multiple of 1024) and K12 (a batch): scores and
    codes at every true in-band cell (at V = 8192, the width that had a
    16-lanes-a-thread form before the warp-strip sweep)."""
    rng = np.random.default_rng(11)
    s1, s2, ms, ns = _banded_batch(rng, ms, ns, max(ms), max(max(ns), V))
    sc = Scores(2, -3, -2, -4, st)
    want = gb.gotoh_banded_plain(s1, s2, ms, ns, sc, V)
    got = gb.fill_cuda(s1.to(cuda), s2.to(cuda), ms, ns, sc, V, {"kernel": 0})
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    M, N = int(max(ms)), int(max(ns))
    assert np.array_equal(_band_codes(got[1], ms, ns, V, M, N), _band_codes(want[1], ms, ns, V, M, N))
    if len(ms) == 1:
        score, dirs = gb.gotoh_banded(s1[0].to(cuda), s2[0].to(cuda), M, N, sc, V)
        assert score == int(want[0][0]) and torch.equal(dirs, got[1][0])
    else:
        groups = gbb.gotoh_banded_batch(s1.to(cuda), s2.to(cuda), ms, ns, sc, V)
        assert torch.equal(torch.cat([g.score for g in groups]).cpu(), want[0])


def test_banded_fill_wide_kernel_matches_plain(cuda):
    """A band wider than 32,768 lanes (the width that had a form with the
    row state in device memory) that slides, against the plain fill run
    on the card."""
    rng = np.random.default_rng(14)
    V = 33_792
    s1, s2, ms, ns = _banded_batch(rng, [V + 300], [V + 200], V + 300, V + 200)
    sc = Scores(2, -3, -2, -4, -1)
    want = gb.gotoh_banded_plain(s1.to(cuda), s2.to(cuda), ms, ns, sc, V)
    score, dirs = gb.gotoh_banded(s1[0].to(cuda), s2[0].to(cuda), int(ms[0]), int(ns[0]), sc, V)
    assert score == int(want[0][0])
    M, N = int(ms[0]), int(ns[0])
    assert np.array_equal(_band_codes(dirs[None], ms, ns, V, M, N),
                          _band_codes(want[1], ms, ns, V, M, N))


#: band edges of the warp-strip sweep (ms, ns, V): a band at column 0 all
#: along (n <= V), one that slides a column a row (m = n, 2.5 strips),
#: 32 lanes a thread in the old register form (V = 32,768, cut to n), a
#: K12 batch of mixed lengths whose strips end mid-lane.
BAND_EDGES = {
    "column0": ([1500], [900], 1024),
    "slides": ([1300], [1300], 256),
    "lanes32": ([33_100], [33_000], 32_768),
    "mixed": ([2000, 1990, 1700, 1111], [1900, 1950, 1650, 1100], 384),
}


@pytest.mark.parametrize("case", list(BAND_EDGES))
@pytest.mark.parametrize("max_blocks", [None, 2])
def test_banded_sweep_edges_match_plain(cuda, case, max_blocks):
    """The band sweep at its edges (strips of 128 rows, a code word over 4
    lanes), on the whole grid and on two blocks (tickets and ring slots
    cycle): scores and codes at every true in-band cell equal the plain
    fill's."""
    ms, ns, V = BAND_EDGES[case]
    rng = np.random.default_rng(15)
    s1, s2, ms, ns = _banded_batch(rng, ms, ns, max(ms), max(max(ns), V))
    sc = Scores(2, -3, -2, -4, -1)
    plain_dev = cuda if V > 4096 else torch.device("cpu")
    want = gb.gotoh_banded_plain(s1.to(plain_dev), s2.to(plain_dev), ms, ns, sc, V)
    got = gb.fill_cuda(s1.to(cuda), s2.to(cuda), ms, ns, sc, V, {"kernel": 0},
                       max_blocks=max_blocks)
    M, N = int(max(ms)), int(max(ns))
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert np.array_equal(_band_codes(got[1], ms, ns, V, M, N),
                          _band_codes(want[1], ms, ns, V, M, N))


def test_banded_tight_ring_waits_are_no_fault(cuda, monkeypatch):
    """A ring of two slots a pair on two blocks: a strip waits a whole
    strip's sweep (about V + 128 columns) for its slot, each wait under a
    1 ms bound, and the heartbeat keeps them from tripping; a 1 ns bound
    trips and raises."""
    rng = np.random.default_rng(16)
    M, N, V = 12_000, 11_900, 4096
    s1, s2, ms, ns = _banded_batch(rng, [M], [N], M, N)
    sc = Scores()
    want = gb.gotoh_banded_plain(s1.to(cuda), s2.to(cuda), ms, ns, sc, V)
    off, _, _ = gb.plan_streams(M, N, V)
    monkeypatch.setattr(gp, "PIPE_RING_BYTES", 2 * 8 * gb.band_slot_width(off, ms, ns, V))
    got = gb.fill_cuda(s1.to(cuda), s2.to(cuda), ms, ns, sc, V, {"kernel": 0},
                       max_blocks=2, spin_ns=1_000_000)
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert np.array_equal(_band_codes(got[1], ms, ns, V, M, N), _band_codes(want[1], ms, ns, V, M, N))
    with pytest.raises(RuntimeError, match="passed its bound"):
        gb.fill_cuda(s1.to(cuda), s2.to(cuda), ms, ns, sc, V, {"kernel": 0}, max_blocks=2,
                     spin_ns=1)


def test_banded_walk_kernel_matches_plain(cuda):
    """K11 over a K12 batch in one launch (shared geometry), with a cap
    that forces resumes, and the corrupt all-INS bitmap raising."""
    rng = np.random.default_rng(12)
    s1, s2, ms, ns = _banded_batch(rng, [2000, 1990, 1950, 2000], [1990, 1900, 1940, 1985],
                                   2048, 2048)
    sc = Scores()
    want = gbb.banded_align_batch(s1, s2, ms, ns, sc, 256)
    got = gbb.banded_align_batch(s1.to(cuda), s2.to(cuda), ms, ns, sc, 256)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert all(np.array_equal(g[1], w[1]) for g, w in zip(got, want))
    groups = gbb.gotoh_banded_batch(s1.to(cuda), s2.to(cuda), ms, ns, sc, 256)
    resumed = gb.walk_banded_batch(groups[0].dirs, ms, ns, 256, geom=(groups[0].M, groups[0].N),
                                   max_steps=700)
    assert all(np.array_equal(g, w[1]) for g, w in zip(resumed, want))
    dirs = torch.full((18, 256), 0x55555555, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="left the band"):
        gb.walk_banded(dirs.to(cuda), 280, 100, 256, geom=(300, 290))



@pytest.mark.parametrize("case", range(len(BAND_EDGE_SPECS)))
def test_banded_walk_edges_match_plain(cuda, case):
    """K11 == the plain walker on walk_stage_cases' edge paths (gaps wider than
    the lane window both ways, both band edges, starts on rows 16k, 16k+1
    and 16k+15), carried whole and resumed at max_steps 1, 15, 16, 17 and
    1,000."""
    name, dirs, m, n = band_edge_walk(case)
    want = gb.walk_banded_plain(dirs, m, n, 1024)
    for cap in (None, 1, 15, 16, 17, 1000):
        got = gb.walk_banded(dirs.to(cuda), m, n, 1024, max_steps=cap)
        assert np.array_equal(got, want), (name, cap)


def test_banded_walk_any_lanes_and_one_launch(cuda):
    """K11 on rows of 255 and 301 lanes and on a bitmap view 4 bytes off
    alignment (4-byte copies); a batch of walks carried whole in one
    launch."""
    rng = np.random.default_rng(33)
    for V in (255, 301):
        dirs = _pack16(rng.choice(3, size=(40 * 16, V), p=[0.9, 0.05, 0.05]))
        m = 40 * 16 - 3
        want = gb.walk_banded_plain(dirs, m, m - 5, V, (m, m - 3))
        assert np.array_equal(gb.walk_banded(dirs.to(cuda), m, m - 5, V, geom=(m, m - 3)), want)
    name, dirs, m, n = band_edge_walk(0)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32), dirs.reshape(-1)]).to(cuda)
    view = flat[1:].view(dirs.shape)
    assert np.array_equal(gb.walk_banded(view, m, n, 1024), gb.walk_banded_plain(dirs, m, n, 1024))
    s1, s2, ms, ns = _banded_batch(rng, [2000, 1990, 1950, 2000, 1999], [1990, 1900, 1940, 1985,
                                                                          1999], 2048, 2048)
    groups = gbb.gotoh_banded_batch(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), 256)
    d = torch.cat([g.dirs for g in groups])
    geom = (groups[0].M, groups[0].N)
    before = gb.COUNTS["walk_kernel"]
    got = gb.walk_banded_batch(d, ms, ns, 256, geom=geom)
    assert gb.COUNTS["walk_kernel"] == before + 1
    for p in range(len(ms)):
        assert np.array_equal(got[p], gb.walk_banded_plain(d[p].cpu(), int(ms[p]), int(ns[p]),
                                                           256, geom))


def test_align_banded_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(13)
    a = "".join(rng.choice(list("ACGT"), 5000))
    b = a[:1200] + a[1203:3000] + "ACG" + a[3000:4990]
    sc = Scores()
    want = align_banded(Sequence("a", a), Sequence("b", b), sc, band=1024, device="cpu")
    got = align_banded(Sequence("a", a), Sequence("b", b), sc, band=1024, device="cuda")
    assert (got.score, got.alignment) == (want.score, want.alignment)


PROT = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)


def _prot_batch(rng, ms, ns, Lm, Ln, letters=PROT):
    """Related protein pairs (a shifted, mutated copy), padded; a few
    lowercase bytes, which score as X (BLOSUM62) or the minimum."""
    B = len(ms)
    s1 = np.full((B, Lm), 0xFE, np.uint8)
    s2 = np.full((B, Ln), PAD_S2, np.uint8)
    for b in range(B):
        base = letters[rng.integers(0, len(letters), max(Lm, Ln) + 20)]
        s1[b, : ms[b]] = base[: ms[b]]
        other = base[7 : 7 + ns[b]].copy()
        flip = rng.random(ns[b]) < 0.2
        other[flip] = letters[rng.integers(0, len(letters), int(flip.sum()))]
        s2[b, : ns[b]] = other
    s1[0, : min(3, ms[0])] = np.frombuffer(b"acd", np.uint8)[: min(3, ms[0])]
    return torch.from_numpy(s1), torch.from_numpy(s2), np.array(ms), np.array(ns)


def _matrix(kind):
    rng = np.random.default_rng(40)
    if kind == "blosum62":
        return subst.blosum62()
    if kind == "asymmetric":
        return subst.SubstMatrix("ARNDCQEGHILKMFPSTWYV", rng.integers(-6, 9, (20, 20)))
    if kind == "near200":
        return subst.SubstMatrix("ARNDCQEGHILKMFPSTWYV", rng.integers(-200, 201, (20, 20)))
    return subst.dna_matrix(Scores(2, -3, -2, -4))  # no X


MATRIX_CASES = [
    ([300, 0, 17, 250], [280, 40, 0, 260], 384, 384),  # zero lengths
    ([383], [383], 384, 384),  # B = 1
    ([1000, 990], [1000, 1000], 1024, 1024),  # 1,000 aa: four strips of 256 rows
    ([1500, 700], [1400, 1500], 1536, 1536),  # six and three strips
]


def test_matrix_profile_kernel_matches_plain(cuda):
    rng = np.random.default_rng(41)
    for kind in ("blosum62", "asymmetric", "near200", "dna"):
        mx = _matrix(kind)
        letters = np.frombuffer(b"ACGT", np.uint8) if kind == "dna" else PROT
        _, s2, _, ns = _prot_batch(rng, [300, 0, 20], [380, 30, 0], 384, 384, letters)
        got = gm.matrix_profile(s2.to(cuda), ns, mx)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), gm.matrix_profile_plain(s2, ns, mx))
    big = subst.SubstMatrix(bytes(range(33, 33 + 150)).decode("latin-1"),
                            rng.integers(-9, 9, (150, 150)))  # 151 rows: > 48 KB of staging
    _, s2, _, ns = _prot_batch(rng, [100, 50], [300, 333], 384, 384)
    assert torch.equal(gm.matrix_profile(s2.to(cuda), ns, big).cpu(),
                       gm.matrix_profile_plain(s2, ns, big))


#: K15's edge shapes (B, Ln, n_p per pair or None for random): rows of
#: every alignment (Ln % 8 != 0), n_p inside a 16-byte chunk and at a
#: chunk's edge, n_p = 0, B = 1, rows shorter than a chunk, two column tiles
#: of 2,048 and a tail, and enough pairs that the grid loops.
PROFILE_SHAPES = [
    (5, 383, [383, 0, 200, 17, 1]),
    (1, 384, [384]),
    (3, 7, [7, 3, 0]),
    (6, 9, [9, 8, 1, 0, 2, 5]),
    (3, 16, [16, 15, 9]),
    (4, 2100, [2100, 2049, 5, 2048]),
    (2, 4101, [4101, 4096]),
    (3, 1, [1, 0, 1]),
    (4097, 100, None),
]


@pytest.mark.parametrize("shape", PROFILE_SHAPES, ids=[f"{b}x{ln}" for b, ln, _ in PROFILE_SHAPES])
def test_matrix_profile_kernel_edges_match_plain(cuda, shape):
    """K15 at its tails under BLOSUM62 and a matrix without X, with bytes
    outside the alphabet: == the plain version, entry for entry."""
    B, Ln, ns = shape
    rng = np.random.default_rng(Ln + B)
    ns = np.asarray(ns if ns is not None else rng.integers(0, Ln + 1, B), np.int64)
    s2 = rng.integers(0, 256, (B, Ln)).astype(np.uint8)
    s2[:, : Ln // 2] = PROT[rng.integers(0, 20, (B, Ln // 2))]
    for kind in ("blosum62", "dna"):
        mx = _matrix(kind)
        before = gm.COUNTS["profile_kernel"]
        got = gm.matrix_profile(torch.from_numpy(s2).to(cuda), ns, mx)
        assert gm.COUNTS["profile_kernel"] == before + 1
        assert torch.equal(got.cpu(), gm.matrix_profile_plain(torch.from_numpy(s2), ns, mx))


@pytest.mark.parametrize("with_x", [True, False])
def test_matrix_profile_kernel_widest_alphabet(cuda, with_x):
    """A = 256, the most rows a matrix can give (every byte value in the
    alphabet, or every one but X and the extra row; the launch admits
    257): the table fills most of shared memory and the kernel == the
    plain version."""
    rng = np.random.default_rng(256)
    letters = bytes(b for b in range(256) if with_x or b != ord("X")).decode("latin-1")
    mx = subst.SubstMatrix(letters, rng.integers(-50, 50, (len(letters), len(letters))))
    s2 = rng.integers(0, 256, (3, 3001)).astype(np.uint8)
    ns = np.array([3001, 1500, 7])
    got = gm.matrix_profile(torch.from_numpy(s2).to(cuda), ns, mx)
    assert got.shape[1] == 256
    assert torch.equal(got.cpu(), gm.matrix_profile_plain(torch.from_numpy(s2), ns, mx))


@pytest.mark.parametrize("budget_groups,profiles", [(None, 1), (2, 2)])
def test_grouped_profiles_read_lengths_uploaded_once(cuda, monkeypatch, budget_groups, profiles):
    """The grouped stream entry uploads the s2 lengths once; a profile
    launch covers the fill groups its budget holds, each reading its slice
    of the lengths, and each group's fill its slice of the profile: scores
    == the plain route's, one fill launch a group."""
    rng = np.random.default_rng(43)
    s1, s2, ms, ns = _prot_batch(rng, rng.integers(1, 120, 20), rng.integers(1, 120, 20), 128,
                                 127)
    mx = subst.blosum62()
    if budget_groups:
        monkeypatch.setattr(gms, "PROFILE_BUDGET_BYTES", 2 * 24 * 127 * 8 * budget_groups)
    want = gms.gotoh_scores_matrix_stream(s1, s2, ms, ns, mx, -1, -11)
    before = dict(gm.COUNTS)
    got = gms.gotoh_scores_matrix_stream_grouped(s1.to(cuda), s2.to(cuda), ms, ns, mx, -1, -11,
                                                 group_size=8)
    assert gm.COUNTS["profile_kernel"] - before["profile_kernel"] == profiles
    assert gm.COUNTS["stream_kernel"] - before["stream_kernel"] == 3
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("kind", ["blosum62", "asymmetric", "near200", "dna"])
def test_matrix_fill_kernel_matches_plain(cuda, kind, is_local):
    """Scores, start cells and codes at every true cell."""
    rng = np.random.default_rng(42)
    mx = _matrix(kind)
    letters = np.frombuffer(b"ACGT", np.uint8) if kind == "dna" else PROT
    for ms, ns, Lm, Ln in MATRIX_CASES:
        s1, s2, ms, ns = _prot_batch(rng, ms, ns, Lm, Ln, letters)
        code1 = gm.row_codes(s1, mx)
        prof = gm.matrix_profile_plain(s2, ns, mx)
        want = gm.matrix_fill_plain(code1, prof, ms, ns, -1, -11, is_local, emit_dirs=True)
        got = gm.matrix_fill(code1.to(cuda), prof.to(cuda), ms, ns, -1, -11, is_local,
                             emit_dirs=True)
        torch.cuda.synchronize()
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g.cpu(), w)
        gd, wd = got.dirs.cpu().numpy(), want.dirs.numpy()
        for p in range(len(ms)):
            assert np.array_equal(_codes_at(gd[p], ms[p], ns[p]), _codes_at(wd[p], ms[p], ns[p]))


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("st", [None, -1])
def test_matrix_dna_bridge_equals_k3(cuda, is_local, st):
    rng = np.random.default_rng(43)
    s1, s2, ms, ns = _stream_batch(rng, [700, 0, 650], [600, 500, 0], 768, 768)
    sc = Scores(2, -3, -2, -4, st)
    want = gs.gotoh_stream_fill(s1.to(cuda), s2.to(cuda), ms, ns, sc, is_local, emit_dirs=True)
    got = gm.gotoh_matrix_fill(s1.to(cuda), s2.to(cuda), ms, ns, subst.dna_matrix(sc), sc.g,
                               sc.h, is_local, emit_dirs=True)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    for p in range(len(ms)):
        assert np.array_equal(_codes_at(got.dirs[p].cpu().numpy(), ms[p], ns[p]),
                              _codes_at(want.dirs[p].cpu().numpy(), ms[p], ns[p]))


@pytest.mark.parametrize("is_local", [False, True])
def test_matrix_aligners_cuda_match_cpu(cuda, is_local):
    rng = np.random.default_rng(44)
    mx = subst.blosum62()
    base = "".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"), 420))
    pairs = [(Sequence(f"a{k}", base[k : 300 + 5 * k]), Sequence(f"b{k}", base[k + 9 : 330]))
             for k in range(18)]
    want = matrix_align_batch(pairs, mx, -1, -11, is_local, device="cpu")
    got = matrix_align_batch(pairs, mx, -1, -11, is_local, device="cuda")
    assert [(g.score, g.alignment) for g in got] == [(w.score, w.alignment) for w in want]
    one = PairwiseAligner(Scores(0, 0, -1, -11), is_local, device="cuda", matrix=mx)
    assert (one.align(*pairs[3]).alignment, one.score_only(*pairs[3])) == (
        want[3].alignment, want[3].score)


def _same_fill(got, want, ms, ns):
    """Scores, start cells, a clear error word and, where the plain fill
    has dirs, the codes at every true cell."""
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.cpu(), w.cpu())
    assert int(got.err) == 0
    if want.dirs is not None:
        gd, wd = got.dirs.cpu().numpy(), want.dirs.cpu().numpy()
        for p in range(len(ms)):
            assert np.array_equal(_codes_at(gd[p], ms[p], ns[p]), _codes_at(wd[p], ms[p], ns[p]))


#: K3's and the matrix fill's pipeline edges: empty sequences, one row
#: and one column, m + 1 not a multiple of any strip height, multi-strip
#: pairs at every height (rows past 32 x 16).
PIPE_MS, PIPE_NS = [700, 0, 1, 130, 545, 17, 1100], [650, 33, 1, 0, 700, 1, 1000]


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("rows", [32 * r for r in gp.LANE_ROWS])
@pytest.mark.parametrize("dirs", [False, True])
def test_stream_pipeline_every_strip_height(cuda, is_local, rows, dirs):
    """K3 on the warp-strip pipeline at every compiled strip height, on
    the whole grid and on 3 blocks (tickets and ring slots cycle),
    kimura, == the plain version (codes at every true cell)."""
    rng = np.random.default_rng(70 + rows)
    s1, s2, ms, ns = _stream_batch(rng, PIPE_MS, PIPE_NS, 1152, 1024)
    sc = Scores(2, -3, -2, -4, -1)
    want = gs.gotoh_stream_plain(s1, s2, ms, ns, sc, is_local, emit_dirs=dirs)
    for max_blocks in (None, 3):
        before = gs.COUNTS["kernel"]
        got = gs._stream_cuda(s1.to(cuda), s2.to(cuda), ms, ns, sc, is_local, dirs, rows,
                              max_blocks)
        _same_fill(got, want, ms, ns)
        assert gs.COUNTS["kernel"] == before + 1


@pytest.mark.parametrize("is_local", [False, True])
def test_stream_pipeline_one_pair_and_tight_ring(cuda, monkeypatch, is_local):
    """B = 1 of 29 strips, and a ring of five slots for the ragged batch
    on 3 blocks: three launches, two or more slots a multi-strip pair,
    scores and codes == the plain version."""
    rng = np.random.default_rng(73)
    s1, s2, ms, ns = _stream_batch(rng, [3700], [2100], 3712, 2176)
    want = gs.gotoh_stream_plain(s1, s2, ms, ns, Scores(), is_local, emit_dirs=True)
    _same_fill(gs._stream_cuda(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), is_local, True, 128),
               want, ms, ns)
    s1, s2, ms, ns = _stream_batch(rng, STRIP_MS, STRIP_NS, 768, 768)
    monkeypatch.setattr(gp, "PIPE_RING_BYTES", 5 * 8 * 769)
    want = gs.gotoh_stream_plain(s1, s2, ms, ns, Scores(), is_local, emit_dirs=True)
    before = gs.COUNTS["kernel"]
    got = gs._stream_cuda(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), is_local, True, 64, 3)
    _same_fill(got, want, ms, ns)
    assert gs.COUNTS["kernel"] == before + len(gp.pipeline_groups(ms, 768, 64)) == before + 3


@pytest.mark.parametrize("rows", [32, 256])
def test_stream_pipeline_local_ties_and_stops(cuda, rows):
    """Local ties across a lane's rows and across strips keep the
    row-major last best, and an all-mismatch batch's codes (STOP on row 0
    and column 0, the floor inside) equal the plain version's."""
    unit = np.frombuffer(b"ACGTTGCA", np.uint8)
    s1 = torch.from_numpy(np.stack([np.tile(unit, 80)[:600], np.tile(unit[::-1], 80)[:600]]))
    s2 = torch.from_numpy(np.stack([np.tile(unit, 20)[:150]] * 2))
    ties = (s1, s2, np.array([600, 599]), np.array([150, 149]))
    for a1, a2, m, n in (ties, _mismatch_batch([120, 600, 1, 333], [100, 150, 7, 1], 640)):
        want = gs.gotoh_stream_plain(a1, a2, m, n, Scores(), True, emit_dirs=True)
        got = gs._stream_cuda(a1.to(cuda), a2.to(cuda), m, n, Scores(), True, True, rows, 3)
        _same_fill(got, want, m, n)


def test_stream_pipeline_error_word_comes_back(cuda, monkeypatch):
    """A 1 ns wait bound trips: the launch returns, its error word is set
    in the result, and each reader raises."""
    from genomics_rs_tpu_torch.parallel.batch import _read

    rng = np.random.default_rng(74)
    s1, s2, ms, ns = _stream_batch(rng, [1279], [9000], 1280, 9000)
    monkeypatch.setattr(gp, "PIPE_RING_BYTES", 2 * 8 * 9001)
    c1, c2 = s1.to(cuda), s2.to(cuda)
    got = gs._stream_cuda(c1, c2, ms, ns, Scores(), False, True, 32, 2, spin_ns=1)
    assert int(got.err) != 0
    with pytest.raises(RuntimeError, match="passed its bound"):
        gs.StreamDirsResult(got)
    with pytest.raises(RuntimeError, match="passed its bound"):
        _read([(got.score, got.start_i, got.start_j, got.err)])
    ok = gs._stream_cuda(c1, c2, ms, ns, Scores(), False, True, 32, 2, spin_ns=1_000_000)
    _same_fill(ok, gs.gotoh_stream_plain(s1, s2, ms, ns, Scores(), False, emit_dirs=True), ms, ns)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("rows", [32 * r for r in gp.LANE_ROWS])
def test_matrix_pipeline_every_strip_height(cuda, is_local, rows):
    """The matrix fill at every compiled strip height, whole grid and 3
    blocks, scores and codes == the plain version: zero lengths, B = 1,
    multi-strip pairs, an asymmetric matrix; the route counts its
    launches."""
    rng = np.random.default_rng(80 + rows)
    for kind in ("blosum62", "asymmetric"):
        mx = _matrix(kind)
        s1, s2, ms, ns = _prot_batch(rng, [383, 0, 17, 700, 1], [383, 40, 0, 650, 1], 768, 768)
        code1, prof = gm.row_codes(s1, mx), gm.matrix_profile_plain(s2, ns, mx)
        for sel in (slice(None), slice(3, 4)):
            c, pf, m, n = code1[sel].contiguous(), prof[sel].contiguous(), ms[sel], ns[sel]
            for dirs in (False, True):
                want = gm.matrix_fill_plain(c, pf, m, n, -1, -11, is_local, dirs)
                for max_blocks in (None, 3):
                    before = gm.COUNTS["stream_kernel"]
                    got = gm._matrix_cuda(c.to(cuda), pf.to(cuda), m, n, -1, -11, is_local, dirs,
                                          "stream", rows, max_blocks)
                    _same_fill(got, want, m, n)
                    assert gm.COUNTS["stream_kernel"] == before + 1


#: a ragged batch for the strip kernels: empty sequences, one-base pairs,
#: lengths that are multiples of nothing, rows past one strip of 256.
STRIP_MS, STRIP_NS = [700, 0, 130, 1, 257, 700, 513], [650, 33, 0, 1, 700, 64, 511]


def _mismatch_batch(ms, ns, L):
    """All-mismatch pairs (A against T): every local cell is 0, so the
    keep-last best is (0, m, n)."""
    s1 = np.full((len(ms), L), 0xFE, np.uint8)
    s2 = np.full((len(ms), L), PAD_S2, np.uint8)
    for b, (m, n) in enumerate(zip(ms, ns)):
        s1[b, :m], s2[b, :n] = ord("A"), ord("T")
    return torch.from_numpy(s1), torch.from_numpy(s2), np.array(ms), np.array(ns)


def _same_scores(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("st", [None, -1])
def test_warp_strip_kernel_matches_plain(cuda, is_local, st):
    """The warp-strip kernel at its strip height; K7 and K8 each count
    their launches, and B = 1 on the stream8 route is K7's launch."""
    rng = np.random.default_rng(48)
    s1, s2, ms, ns = _stream_batch(rng, STRIP_MS, STRIP_NS, 768, 768)
    sc = Scores(2, -3, -2, -4, st)
    want = gp.gotoh_strips_plain(s1, s2, ms, ns, sc, is_local, 32 * gseg.ROWS_PER_LANE)
    c1, c2 = s1.to(cuda), s2.to(cuda)
    before = gseg.COUNTS["kernel"]
    _same_scores(gseg.warp_strip_cuda(c1, c2, ms, ns, sc, is_local), want)
    assert gseg.COUNTS["kernel"] == before + 1
    before = gseg.COUNTS["kernel"], gs8.COUNTS["kernel"]
    _same_scores(gseg.gotoh_scores_segmented(c1, c2, ms, ns, sc, is_local), want)
    _same_scores(gs8.gotoh_scores_stream8(c1, c2, ms, ns, sc, is_local), want)
    one = gs8.gotoh_scores_stream8(c1[:1], c2[:1], ms[:1], ns[:1], sc, is_local)
    torch.cuda.synchronize()
    _same_scores(one, [w[:1] for w in want])
    assert (gseg.COUNTS["kernel"] - before[0], gs8.COUNTS["kernel"] - before[1]) == (2, 1)


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("st", [None, -1])
@pytest.mark.parametrize("rows,max_blocks", [(256, None), (32, 3), (64, 1)])
def test_strip_pipeline_kernel_matches_plain(cuda, is_local, st, rows, max_blocks):
    """K9 at the default strip height, and at small heights with a capped
    grid, so strips outnumber the persistent blocks: tickets cycle and
    ring slots are reused (two slots a pair at one block)."""
    rng = np.random.default_rng(50 + rows)
    s1, s2, ms, ns = _stream_batch(rng, STRIP_MS, STRIP_NS, 768, 768)
    sc = Scores(2, -3, -2, -4, st)
    want = gp.gotoh_strips_plain(s1, s2, ms, ns, sc, is_local, rows)
    before = gp.COUNTS["kernel"]
    got = gp._pallas_cuda(s1.to(cuda), s2.to(cuda), ms, ns, sc, is_local, rows, max_blocks)
    torch.cuda.synchronize()
    _same_scores(got, want)
    assert gp.COUNTS["kernel"] == before + 1
    plan = gp.pipeline_plan(ms, ns, 768, rows, 1 << 20 if max_blocks is None else max_blocks)
    assert plan[2] == int(np.sum((ms + rows) // rows))


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("rows", [128, 256, 512])
def test_strip_pipeline_mid_lane_and_tiny_pairs(cuda, is_local, rows):
    """Strips that end mid-lane (m + 1 not a multiple of 32 x RT, a lane
    with some rows past m), one-row, one-column and empty pairs, at each
    timed strip height on a capped grid."""
    rng = np.random.default_rng(60 + rows)
    ms, ns = [rows + 5, 1, 0, 3 * rows - 40, 17, 2, rows], [rows - 3, 0, 9, 450, 1, 1, 0]
    s1, s2, ms, ns = _stream_batch(rng, ms, ns, 3 * rows, 512)
    sc = Scores(2, -3, -2, -4, -1)
    want = gp.gotoh_strips_plain(s1, s2, ms, ns, sc, is_local, 7)
    got = gp._pallas_cuda(s1.to(cuda), s2.to(cuda), ms, ns, sc, is_local, rows, 5)
    torch.cuda.synchronize()
    _same_scores(got, want)


@pytest.mark.parametrize("rows", [32, 256])
def test_strip_pipeline_local_ties_keep_last(cuda, rows):
    """Local ties across a lane's rows and across strips: repeats give
    equal bests on many rows and columns, and the kernel keeps the
    row-major last one, as the plain version does."""
    unit = np.frombuffer(b"ACGTTGCA", np.uint8)
    s1 = torch.from_numpy(np.tile(unit, 80)[None, :600].copy())
    s2 = torch.from_numpy(np.tile(unit, 20)[None, :150].copy())
    s1 = torch.cat([s1, torch.from_numpy(np.tile(unit[::-1], 80)[None, :600].copy())])
    s2 = torch.cat([s2, s2])
    ms, ns = np.array([600, 599]), np.array([150, 149])
    want = gp.gotoh_strips_plain(s1, s2, ms, ns, Scores(), True, 64)
    got = gp._pallas_cuda(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), True, rows, 3)
    torch.cuda.synchronize()
    _same_scores(got, want)


def test_strip_pipeline_tight_ring_waits_are_no_fault(cuda, monkeypatch):
    """Two ring slots for a pair of 40 strips on two blocks: slot waits of
    a whole sweep each pass under a 1 ms bound (the heartbeat), and a 1 ns
    bound trips and raises."""
    rng = np.random.default_rng(62)
    s1, s2, ms, ns = _stream_batch(rng, [1279], [9000], 1280, 9000)
    monkeypatch.setattr(gp, "PIPE_RING_BYTES", 2 * 8 * 9001)
    want = gp.gotoh_strips_plain(s1, s2, ms, ns, Scores(), False, 256)
    got = gp._pallas_cuda(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), False, 32, 2,
                          spin_ns=1_000_000)
    _same_scores(got, want)
    with pytest.raises(RuntimeError, match="passed its bound"):
        gp._pallas_cuda(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), False, 32, 2, spin_ns=1)


@pytest.mark.parametrize("is_local", [False, True])
def test_strip_pipeline_splits_a_tight_ring(cuda, monkeypatch, is_local):
    """A ring of five slots for seven pairs of up to 11 strips on a 3-block
    grid: the bucket runs as three launches, every pair of three or more
    strips on two or more slots, and equals the plain version."""
    rng = np.random.default_rng(58)
    s1, s2, ms, ns = _stream_batch(rng, STRIP_MS, STRIP_NS, 768, 768)
    monkeypatch.setattr(gp, "PIPE_RING_BYTES", 5 * 8 * 769)
    sc = Scores(2, -3, -2, -4, -1)
    want = gp.gotoh_strips_plain(s1, s2, ms, ns, sc, is_local, 64)
    before = gp.COUNTS["kernel"]
    got = gp._pallas_cuda(s1.to(cuda), s2.to(cuda), ms, ns, sc, is_local, 64, 3)
    torch.cuda.synchronize()
    _same_scores(got, want)
    groups = gp.pipeline_groups(ms, 768, 64)
    assert gp.COUNTS["kernel"] == before + len(groups) == before + 3


@pytest.mark.parametrize("case", ["mixed 1-8 kb global", "empty global", "empty local"])
def test_stream8_pipeline_matches_plain(cuda, case):
    """K8 on the warp-strip pipeline == its plain version (K3's, scores
    only; run on the card) on a mixed 1-8 kb global batch (the stream8
    tier's) and on a batch with empty sequences; each call one launch on
    K8's count, none on K3's."""
    rng = np.random.default_rng(70)
    if case.startswith("mixed"):
        s1, s2, ms, ns = _stream_batch(rng, list(rng.integers(1_000, 8_001, 12)),
                                       list(rng.integers(1_000, 8_001, 12)), 8064, 8064)
    else:
        s1, s2, ms, ns = _stream_batch(rng, [700, 0, 130, 0, 257], [650, 33, 0, 0, 700], 768,
                                       768)
    is_local = case.endswith("local")
    c1, c2 = s1.to(cuda), s2.to(cuda)
    want = gs.gotoh_stream_plain(c1, c2, ms, ns, Scores(), is_local)
    before = gs8.COUNTS["kernel"], gs.COUNTS["kernel"]
    got = gs8.gotoh_scores_stream8(c1, c2, ms, ns, Scores(), is_local)
    _same_scores(got, [w.cpu() for w in want[:3]])
    assert (gs8.COUNTS["kernel"] - before[0], gs.COUNTS["kernel"] - before[1]) == (1, 0)


@pytest.mark.parametrize("is_local", [False, True])
def test_stream8_splits_a_tight_ring(cuda, monkeypatch, is_local):
    """A ring of five slots for seven pairs of 1,000-1,024 rows: K8 runs the
    plan's launches (one a pipeline group, all counted on its route) and
    equals its plain version; the error words of all of them are read."""
    rng = np.random.default_rng(71)
    s1, s2, ms, ns = _stream_batch(rng, list(rng.integers(1000, 1025, 7)),
                                   list(rng.integers(700, 769, 7)), 1024, 768)
    monkeypatch.setattr(gp, "PIPE_RING_BYTES", 5 * 8 * 769)
    groups = gp.pipeline_groups(ms, 768, gs.stream_rows(ms, ns, 1024, False))
    assert len(groups) > 1
    want = gs.gotoh_stream_plain(s1, s2, ms, ns, Scores(), is_local)
    before = gs8.COUNTS["kernel"]
    fill = gs8.gotoh_stream8_fill(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), is_local)
    assert int(fill.err) == 0
    _same_scores(fill[:3], want[:3])
    assert gs8.COUNTS["kernel"] - before == len(groups)


@pytest.mark.parametrize("route", ["segmented", "stream8", "pallas", "stream"])
def test_strip_kernels_all_mismatch_local(cuda, route):
    """Every cell 0: each route gives (0, m, n), as the plain version does."""
    from genomics_rs_tpu_torch.parallel.batch import score_pairs

    s1, s2, ms, ns = _mismatch_batch([120, 600, 1, 333], [100, 590, 637, 1], 640)
    got = score_pairs(s1.numpy(), s2.numpy(), ms, ns, Scores(), True, engine=route)
    assert [list(x) for x in got] == [[0] * 4, list(ms), list(ns)]
    want = gp.gotoh_strips_plain(s1, s2, ms, ns, Scores(), True, 64)
    assert [list(x.numpy()) for x in want] == [list(x) for x in got]


@pytest.mark.parametrize("is_local", [False, True])
def test_score_pairs_engines_agree_on_cuda(cuda, is_local):
    """Every engine through ``score_pairs`` on the card equals K3, and the
    CPU route's plain version."""
    from genomics_rs_tpu_torch.parallel.batch import score_pairs

    rng = np.random.default_rng(8)
    s1, s2, ms, ns = _stream_batch(rng, [250, 3, 200, 256], [240, 256, 0, 97], 256, 256)
    a = (s1.numpy(), s2.numpy(), ms, ns, Scores(), is_local)
    want = score_pairs(*a, engine="stream")
    for e in ("auto", "segmented", "stream8", "pallas"):
        for dev in ("cuda", "cpu"):
            got = score_pairs(*a, engine=e, device=dev)
            assert all(np.array_equal(g, w) for g, w in zip(got, want)), (e, dev)


def _tile_inputs(rng, R, B, sc):
    """A tile's characters and boundary rows carried from a real fill:
    the top row and left column of a seeded table's block at (R, B)."""
    a = BASES[rng.integers(0, 4, 2 * R)]
    b = BASES[rng.integers(0, 4, 2 * B)]
    s1, s2 = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    full = rb.gotoh_rowblock_plain(s1[:R], s2, global_boundary_top(0, 2 * B, sc, device="cpu"),
                                   2 * R, 2 * B, 0, sc, False, emit_cols=True)
    top = full.bottom[:, B:].contiguous()  # row R, columns B..2B
    return s1[R:].contiguous(), s2[B:].contiguous(), top


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("st", [None, -1])
@pytest.mark.parametrize("R,max_blocks", [(300, None), (700, 2), (1000, 1)])
def test_tile_kernel_matches_tile_fill(cuda, is_local, st, R, max_blocks):
    """K5 at an interior tile (i0, j0 > 0, top and left streamed), one
    past n, and one holding (m, n), over 2–4 strips of 256 rows on a grid
    of all, two or one persistent blocks: bottom, right, best, (m, n) and
    the codes equal the plain versions."""
    from genomics_rs_tpu_torch.ops.gotoh_tile import tile_fill

    rng = np.random.default_rng(5)
    B = 400
    sc = Scores(2, -3, -2, -4, st)
    s1, s2, top = _tile_inputs(rng, R, B, sc)
    left = torch.from_numpy(rng.integers(-600, -500, (3, R)).astype(np.int32))
    i0, j0 = R, B
    for m, n in ((2 * R + 50, 2 * B + 70), (2 * R, B - 5), (2 * R - 17, 2 * B - 33)):
        before = dict(gp.TILE_COUNTS)
        on_card = (s1.to(cuda), s2.to(cuda), top.to(cuda), left.to(cuda), m, n, i0, j0, sc,
                   is_local)
        if max_blocks is None:  # the entry point
            got = gp.gotoh_tile_pallas(*on_card, emit_dirs=True, emit_bottom=True,
                                       emit_right=True)
        else:  # the same launch on a capped grid
            got = rb.launch(*on_card, True, True, False, True, True, gp.TILE_COUNTS,
                            max_blocks=max_blocks)
        want = tile_fill(s1, s2, top, left, sc, is_local, i0, j0, m, n)
        plain = gp.gotoh_tile_pallas(s1, s2, top, left, m, n, i0, j0, sc, is_local,
                                     emit_dirs=True)
        torch.cuda.synchronize()
        assert gp.TILE_COUNTS["kernel"] == before["kernel"] + 1
        assert int(got.err) == 0
        assert torch.equal(got.bottom.cpu(), want.bottom)
        assert torch.equal(got.right.cpu(), want.right)
        assert [int(x) for x in got.best] == [int(x) for x in want.best], (m, n)
        assert int(got.score_at_mn) == int(want.at_mn), (m, n)
        assert np.array_equal(_codes_at(got.dirs.cpu().numpy(), R, B),
                              _codes_at(plain.dirs.numpy(), R, B))


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("R", [64, 300, 4096])
def test_blocked_kernel_matches_plain(cuda, is_local, R):
    """K16 (the strip pipeline at a strip height from R) == the plain
    strips at R-row strips, on its own launch count."""
    rng = np.random.default_rng(12)
    s1, s2, ms, ns = _stream_batch(rng, [700, 3, 640, 1], [500, 512, 0, 97], 768, 512)
    before = dict(gp.BLOCKED_COUNTS)
    got = gp.gotoh_scores_blocked(s1.to(cuda), s2.to(cuda), ms, ns, Scores(), is_local, R=R)
    want = gp.gotoh_strips_plain(s1, s2, ms, ns, Scores(), is_local, R)
    assert gp.BLOCKED_COUNTS["kernel"] == before["kernel"] + 1
    assert [x.cpu().tolist() for x in got] == [x.tolist() for x in want]


@pytest.mark.parametrize("is_local", [False, True])
def test_two_shard_sharded_score_on_one_card(cuda, is_local):
    """Two shards of one card (two streams), C = 2: the score equals K1's
    whole-table fill and the CPU mesh's; four K5 launches."""
    from genomics_rs_tpu_torch.ops.gotoh_pallas import gotoh_fill_pallas
    from genomics_rs_tpu_torch.parallel import longseq
    from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh

    rng = np.random.default_rng(14)
    m, n = 700, 650
    s1 = np.full(768, 0xFE, np.uint8)
    s2 = np.full(768, PAD_S2, np.uint8)
    s1[:m], s2[:n] = BASES[rng.integers(0, 4, m)], BASES[rng.integers(0, 4, n)]
    before = gp.TILE_COUNTS["kernel"]
    got = longseq.sharded_gotoh_score(make_mesh(2, SEQ_AXIS, devices=[cuda, cuda]), s1, s2, m,
                                      n, Scores(), is_local)
    got = (int(got.score), got.best.tolist())
    assert gp.TILE_COUNTS["kernel"] == before + 4
    cpu = longseq.sharded_gotoh_score(make_mesh(2, SEQ_AXIS, devices=["cpu", "cpu"]), s1, s2,
                                      m, n, Scores(), is_local)
    assert got == (int(cpu.score), cpu.best.tolist())
    whole = gotoh_fill_pallas(torch.from_numpy(s1).to(cuda), torch.from_numpy(s2).to(cuda), m,
                              n, Scores(), is_local, emit_dirs=True, packed_dirs=True)
    if is_local:
        assert got[1] == [int(whole.score), int(whole.start_i), int(whole.start_j)]
    else:
        assert got[0] == int(whole.score)


# ---- the suffix structures: torch ops on the card ----


@pytest.mark.parametrize("text", ["", "A", "AAAAAAAA", "ACGT" * 50, "random", "contigs"])
def test_suffix_array_cuda_matches_sais(cuda, text):
    """The prefix-doubling suffix array on the card == SA-IS on the host
    (and the CPU run of the same torch ops), BWT included."""
    from genomics_rs_tpu_torch.ops.bwt_device import bwt_device, suffix_array
    from genomics_rs_tpu_torch.suffixtree.native import native_suffix_array

    rng = np.random.default_rng(15)
    if text == "random":
        text = BASES[rng.integers(0, 4, 70_000)].tobytes().decode()
    elif text == "contigs":
        text = "#".join(BASES[rng.integers(0, 4, n)].tobytes().decode() for n in (900, 1, 4_000))
    got = suffix_array(text, device=cuda)
    assert got.dtype == np.int32
    assert got.tolist() == native_suffix_array(text.encode() + b"$").tolist()
    assert got.tolist() == suffix_array(text, device="cpu").tolist()
    assert bwt_device(text, device=cuda) == bwt_device(text, device="cpu")


def test_search_batch_cuda_matches_host(cuda):
    """The lockstep backward search on the card == the host ``_range``
    loop: counts and (lo, hi) for substrings, absent bytes, '$', '#' and
    empty patterns; one device search, no host range; the Occ table stays
    on the card; the multi-contig ``locate_range`` equal too."""
    from genomics_rs_tpu_torch.suffixtree import fmindex as fm

    rng = np.random.default_rng(16)
    genome = BASES[rng.integers(0, 4, 200_000)].tobytes().decode()
    idx = fm.FMIndex.build(genome, device=cuda)
    pats = []
    for _ in range(5_000):
        L = int(rng.integers(20, 40))
        st = int(rng.integers(0, len(genome) - L))
        pats.append(genome[st : st + L])
    pats += ["", "ACGN", "$", "#", "A#C", "A", "ACGT" * 3]
    before = dict(fm.COUNTS)
    got = idx.search_batch(pats, device=True)
    assert fm.COUNTS["device"] == before["device"] + 1
    assert fm.COUNTS["host_range"] == before["host_range"]
    assert idx._dev[0].device.type == "cuda"
    want = idx.search_batch(pats, device=False)
    assert got[0].tolist() == want[0].tolist() and got[1] == want[1]
    assert (got[0][:5_000] >= 1).all()
    multi = fm.MultiFMIndex.build(
        [Sequence(f"c{k}", genome[k * 50_000 : (k + 1) * 50_000 - 7]) for k in range(4)],
        device=cuda)
    mc, mr = multi.search_batch(pats[:2_000], device=True)
    hc, hr = multi.search_batch(pats[:2_000], device=False)
    assert mc.tolist() == hc.tolist() and mr == hr
    assert [multi.locate_range(r) for r in mr] == [multi.locate_range(r) for r in hr]


def test_fmindex_device_build_matches_host_build(cuda):
    from genomics_rs_tpu_torch.suffixtree import fmindex as fm

    text = BASES[np.random.default_rng(17).integers(0, 4, 50_000)].tobytes().decode()
    a = fm.FMIndex.build(text, host=True, device=cuda)
    b = fm.FMIndex.build(text, host=False, device=cuda)
    assert a.sa.tolist() == b.sa.tolist() and a.bwt == b.bwt
    assert (a.occ == b.occ).all() and (a.cvec == b.cvec).all()


# ---- the scan engines and device seeding: torch ops on the card ----


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("st", [None, -1])
def test_scan_fill_cuda_matches_cpu(cuda, is_local, st):
    """The scan fill on the card gives the CPU run's dirs, scores and
    starts, one pair and a batch; the ``"diag"`` walk its moves; the batch
    engine and the matrix scan their scores."""
    from genomics_rs_tpu_torch.ops.gotoh_scan import gotoh_fill_scan, gotoh_fill_scan_batch
    from genomics_rs_tpu_torch.parallel.batch import batch_scores

    rng = np.random.default_rng(150 + is_local)
    sc = Scores(2, -3, -2, -4, st)
    B, Lm, Ln = 6, 256, 384
    s1 = BASES[rng.integers(0, 4, (B, Lm))]
    s2 = BASES[rng.integers(0, 4, (B, Ln))]
    ms = np.array([256, 200, 1, 0, 255, 31], np.int32)
    ns = np.array([384, 100, 7, 40, 0, 383], np.int32)
    for b in range(B):
        s1[b, ms[b]:], s2[b, ns[b]:] = 0xFE, PAD_S2
    args = (torch.from_numpy(s1), torch.from_numpy(s2), ms, ns, sc, is_local)
    got = gotoh_fill_scan_batch(args[0].to(cuda), args[1].to(cuda), *args[2:])
    want = gotoh_fill_scan_batch(*args)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    one = gotoh_fill_scan(args[0][1].to(cuda), args[1][1].to(cuda), 200, 100, sc, is_local)
    assert torch.equal(one.dirs.cpu(), want.dirs[1])
    walk = tb.walk_batch(got.dirs, got.start_i, got.start_j, sc, is_local, "diag", Lm + Ln + 1)
    walk_cpu = tb.walk_batch(want.dirs, want.start_i, want.start_j, sc, is_local, "diag",
                             Lm + Ln + 1)
    assert all(np.array_equal(a, b) for a, b in zip(walk, walk_cpu))
    bs = batch_scores(args[0].to(cuda), args[1].to(cuda), ms, ns, sc, is_local)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(bs[:3], want[1:]))
    if st is None:
        aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
        p1, p2 = aa[rng.integers(0, 20, (B, 96))], aa[rng.integers(0, 20, (B, 80))]
        mm, nn = np.minimum(ms, 96), np.minimum(ns, 80)
        mat = subst.blosum62()
        g = gm.gotoh_scores_matrix(torch.from_numpy(p1).to(cuda), torch.from_numpy(p2).to(cuda),
                                   mm, nn, mat, -1, -10, is_local, engine="scan")
        w = gm.gotoh_scores_matrix(torch.from_numpy(p1), torch.from_numpy(p2), mm, nn, mat, -1,
                                   -10, is_local, engine="scan")
        assert all(torch.equal(a.cpu(), b) for a, b in zip(g, w))


@pytest.mark.parametrize("is_local", [False, True])
def test_scan_paths_cuda_match_cpu(cuda, is_local):
    """The scan aligner, ``align_reads(engine="scan")`` over pipelined
    rounds and the sequence-parallel scan on two shards of one card give
    the CPU runs' results, and launch no kernel."""
    from genomics_rs_tpu_torch.models.reads import align_reads
    from genomics_rs_tpu_torch.parallel import longseq
    from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh

    rng = np.random.default_rng(160 + is_local)
    a = BASES[rng.integers(0, 4, 600)].tobytes().decode()
    b = a[5:300] + "ACGTAC" + a[320:590]
    sc = Scores()
    kernels = lambda: (rb.COUNTS["kernel"], tw.COUNTS["kernel"], tw.COUNTS["many_kernel"],  # noqa: E731
                       gp.TILE_COUNTS["kernel"], gsr.COUNTS["kernel"], tb.COUNTS["kernel"])
    before = kernels()
    al = PairwiseAligner(sc, is_local, device=cuda, engine="scan")
    al_cpu = PairwiseAligner(sc, is_local, device="cpu", engine="scan")
    x, y = Sequence("a", a), Sequence("b", b)
    assert _aln(al.align(x, y)) == _aln(al_cpu.align(x, y))
    reads = [Sequence(f"q{k}", a[k * 20 : k * 20 + 90]) for k in range(25)]
    refs = [Sequence(f"r{k}", a[k * 20 : k * 20 + 150]) for k in range(25)]
    kw = dict(is_local=is_local, with_cigars=True, engine="scan", batch=16)
    got = align_reads(reads, refs, sc, device=cuda, **kw)
    want = align_reads(reads, refs, sc, device="cpu", **kw)
    assert [_aln(r) for r in got[0]] == [_aln(r) for r in want[0]] and got[1] == want[1]
    s1 = Sequence("a", a).encoded(pad_to=768, pad_value=0xFE)
    s2 = Sequence("b", b).encoded(pad_to=768, pad_value=PAD_S2)
    g = longseq.sharded_gotoh_score(make_mesh(2, SEQ_AXIS, devices=[cuda, cuda]), s1, s2, len(a),
                                    len(b), sc, is_local, engine="scan")
    w = longseq.sharded_gotoh_score(make_mesh(2, SEQ_AXIS, devices=["cpu", "cpu"]), s1, s2,
                                    len(a), len(b), sc, is_local, engine="scan")
    assert (int(g.score), g.best.tolist()) == (int(w.score), w.best.tolist())
    assert kernels() == before


def _aln(r):
    return (r.score, [(c.value, i, j) for c, i, j in r.alignment], r.matches, r.mismatches,
            r.opening_gaps, r.gap_extensions)


def test_device_vote_cuda_matches_host(cuda):
    """The device vote on the card equals the host vote (ties included:
    the smallest bin wins, by a masked min, not ``argmax``), over two
    chunks with a padded last one."""
    from genomics_rs_tpu_torch.models import mapper

    rng = np.random.default_rng(170)
    g = BASES[rng.integers(0, 4, 20_000)].tobytes().decode()
    g = g[:8000] + g[1000:3000] + g[8000:]  # a 2 kb repeat: tied bins
    ix = mapper.KmerIndex(Sequence("g", g), 15)
    starts = rng.integers(0, len(g) - 130, 3000)
    reads = [g[s : s + 128] for s in starts]
    reads = [r if k % 5 else r[::-1] for k, r in enumerate(reads)]
    enc = np.stack([np.frombuffer(r.encode(), np.uint8) for r in reads])
    enc4 = mapper._BASE[enc]
    host = mapper._vote_windows(ix, enc4, 7, 64, 32)
    got = mapper._vote_windows_device(ix, enc4, 7, 64, 32, chunk=2048, device=cuda)
    for a_, b_ in zip(got, host):
        assert np.array_equal(a_, b_)
    assert (got[0] == got[4]).sum() > 10  # reads in the repeat tie
