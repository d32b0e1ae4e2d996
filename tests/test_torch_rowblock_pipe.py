"""The row-block fill's strip pipeline (K1 and its tile form K5) on the
host side, and the error word's path to the callers.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``).
Here: the host's plan of one block (strips, ring slots, persistent
blocks, ring bytes), the routing of CPU tensors to the plain versions,
the empty-block convention of the plain version against the JAX kernel,
and that a set error word raises where each caller reads its result.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu.config import Scores as JaxScores
from genomics_rs_tpu.ops.gotoh_rowblock import gotoh_rowblock_pallas
from genomics_rs_tpu.ops.gotoh_tile import global_boundary_top as jax_top
from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models.aligner import PairwiseAligner
from genomics_rs_tpu_torch.models.longalign import align_checkpointed, score_long
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_left, global_boundary_top
from genomics_rs_tpu_torch.parallel import longseq
from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain fill runs thousands of small torch ops; torch's thread
    pool only contends with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring_bytes(plan, B):
    return plan.slots * 8 * (B + 1)


def test_strip_rows_cover_short_blocks():
    assert rb.strip_rows(30_719) == rb.PIPE_ROWS == 256
    assert rb.strip_rows(100) == 128  # 101 rows: four warps
    assert rb.strip_rows(0) == 32
    assert rb.strip_rows(5_000, 512) == 512


def test_block_plan_one_strip():
    """R + 1 < T: one strip, no ring slot, one block."""
    plan = rb.block_plan(100, 5_000, rb.strip_rows(100), 528)
    assert plan == rb.BlockPlan(rows=128, strips=1, slots=0, blocks=1)
    assert plan.work_ints == rb.WORK_HEAD + 5


@pytest.mark.parametrize("k", [2, 3, 120])
def test_block_plan_whole_strips(k):
    """R + 1 = k T: k strips, a block each while the card holds them, and
    a slot for every strip but the last (all can be in flight)."""
    R = k * 256 - 1
    plan = rb.block_plan(R, 29_952, 256, 528)
    assert (plan.strips, plan.blocks, plan.slots) == (k, k, k - 1)
    assert -(-(R + 1) // plan.rows) == plan.strips


def test_block_plan_capped_grid_keeps_two_slots():
    """A grid of one or two blocks still gets two ring slots (a strip never
    writes the slot its successor is reading), at most blocks + 1."""
    assert rb.block_plan(2_047, 1_000, 256, 1) == rb.BlockPlan(256, 8, 2, 1)
    assert rb.block_plan(2_047, 1_000, 256, 2) == rb.BlockPlan(256, 8, 3, 2)
    assert rb.block_plan(2_047, 1_000, 256, 4) == rb.BlockPlan(256, 8, 5, 4)


@pytest.mark.parametrize("R,B", [(65_535, 1_078_175), (98_303, 1_078_175), (65_535, 29_952),
                                 (65_535, 20_000_000), (65_535, 100_000_000)])
def test_block_plan_long_blocks_fit_the_ring(R, B):
    """The checkpointed path's 65,535-row blocks and ``score_long``'s
    98,303-row blocks over column spans of 1 Mb up to 100 Mb: as many
    slots as ``RING_BYTES`` holds, and never more than it. Past 1 Mb the
    ring holds fewer slots than strips run at once, so strips wait about
    a sweep of B columns for a slot, a link of such waits for each slot
    they are behind; the kernel's heartbeat keeps those waits from
    counting as a hang (card: ``test_rowblock_long_slot_waits_are_no_fault``)."""
    plan = rb.block_plan(R, B, 256, 528)
    assert plan.strips == (R + 256) // 256
    assert plan.blocks == min(plan.strips, 528)
    assert 2 <= plan.slots <= plan.strips - 1
    assert _ring_bytes(plan, B) <= gp.RING_BYTES
    if B > 100_000:
        # The ring bounds the flight.
        assert plan.slots == gp.ring_budget(B, gp.RING_BYTES) < plan.strips - 1
    else:
        assert plan.slots == plan.strips - 1


def test_block_plan_refuses_a_ring_under_two_slots(monkeypatch):
    monkeypatch.setattr(gp, "RING_BYTES", 8 * 1_001)  # one slot of 1,000 columns
    with pytest.raises(ValueError, match="RING_BYTES"):
        rb.block_plan(1_000, 1_000, 256, 528)
    # Two strips need one slot, which fits.
    assert rb.block_plan(300, 1_000, 256, 528).slots == 1


def test_block_plan_rejects_bad_strip_heights():
    for rows in (0, 16, 100, 2048):
        with pytest.raises(ValueError, match="rows a strip"):
            rb.block_plan(1_000, 100, rows, 528)


def _pair(rng, m, n):
    return (Sequence("a", BASES[rng.integers(0, 4, m)].tobytes().decode()),
            Sequence("b", BASES[rng.integers(0, 4, n)].tobytes().decode()))


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors route to the plain versions: their counts move, the
    kernels' do not, and the error word is a clear 0-d tensor."""
    rng = np.random.default_rng(3)
    sc = Scores()
    s1 = torch.from_numpy(BASES[rng.integers(0, 4, 60)].copy())
    s2 = torch.from_numpy(BASES[rng.integers(0, 4, 50)].copy())
    k1, k5 = dict(rb.COUNTS), dict(gp.TILE_COUNTS)
    res = rb.gotoh_rowblock(s1, s2, global_boundary_top(0, 50, sc, device=CPU), 60, 50, 0, sc,
                            True, emit_dirs=True)
    assert (rb.COUNTS["plain"], rb.COUNTS["kernel"]) == (k1["plain"] + 1, k1["kernel"])
    assert res.err.shape == () and int(res.err) == 0
    tile = gp.gotoh_tile_pallas(s1, s2, global_boundary_top(0, 50, sc, device=CPU),
                                global_boundary_left(0, 60, sc, device=CPU), 60, 50, 0, 0, sc,
                                False, emit_dirs=False, emit_bottom=True, emit_right=True)
    assert (gp.TILE_COUNTS["plain"], gp.TILE_COUNTS["kernel"]) == (k5["plain"] + 1, k5["kernel"])
    assert int(tile.err) == 0
    PairwiseAligner(sc, device="cpu").align(*_pair(rng, 40, 30))
    assert rb.COUNTS["kernel"] == k1["kernel"] and gp.TILE_COUNTS["kernel"] == k5["kernel"]


@pytest.mark.parametrize("R,B,n", [(130, 128, 97), (200, 830, 800)])
def test_empty_block_best_matches_jax(R, B, n):
    """A local block wholly past m has no true cell: its best is the JAX
    kernel's lane-merge answer, (INT_MIN, i0 + V - 1, max(-1, Kp - V))."""
    rng = np.random.default_rng(R)
    s1 = BASES[rng.integers(0, 4, R)].copy()
    s2 = BASES[rng.integers(0, 4, B)].copy()
    js = JaxScores(2, -3, -2, -4)
    top = np.asarray(jax_top(0, B, js))
    m, i0 = 50, 300
    want = gotoh_rowblock_pallas(s1, s2, top, np.int32(m), np.int32(n), np.int32(i0), js, True,
                                 interpret=True)
    got = rb.gotoh_rowblock(torch.from_numpy(s1), torch.from_numpy(s2),
                            torch.from_numpy(top.copy()), m, n, i0, Scores(2, -3, -2, -4), True)
    assert [int(x) for x in got.best] == [int(x) for x in want.best]
    V, Kp = rb.lane_count(R), -(-(R + B + 1) // rb.CHUNK) * rb.CHUNK
    assert [int(x) for x in got.best] == [-(2**31), i0 + V - 1, max(-1, Kp - V)]


def test_raise_on_err():
    rb.raise_on_err(0)
    rb.raise_on_err(torch.zeros((), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="passed its bound"):
        rb.raise_on_err(torch.ones((), dtype=torch.int32))


@pytest.fixture
def failing_fills(monkeypatch):
    """Every K1 and K5 fill on the CPU route returns a set error word."""
    k1_plain, k5 = rb.gotoh_rowblock_plain, longseq.gotoh_tile_pallas

    def k1_failed(*a, **kw):
        return k1_plain(*a, **kw)._replace(err=torch.ones((), dtype=torch.int32))

    def k5_failed(*a, **kw):
        return k5(*a, **kw)._replace(err=torch.ones((), dtype=torch.int32))

    monkeypatch.setattr(rb, "gotoh_rowblock_plain", k1_failed)
    monkeypatch.setattr(longseq, "gotoh_tile_pallas", k5_failed)


def test_error_word_raises_in_align(failing_fills):
    """The monolithic fill's read (``_fill``), the checkpointed forward's
    (``_forward_blocks``, also under ``score_long``), the one-block fill's
    (``_walk_one_fill``) and the windowed refill's walk raise instead of
    returning a result."""
    a, b = _pair(np.random.default_rng(4), 90, 80)
    sc = Scores()
    with pytest.raises(RuntimeError, match="passed its bound"):
        PairwiseAligner(sc, device="cpu").align(a, b)
    for block_rows in (63, 1023):
        with pytest.raises(RuntimeError, match="passed its bound"):
            align_checkpointed(a, b, sc, block_rows=block_rows, device="cpu")
    with pytest.raises(RuntimeError, match="passed its bound"):
        score_long(a, b, sc, block_rows=63, device="cpu")


def test_error_word_raises_in_the_windowed_walk(monkeypatch):
    """Only the refills with dirs fail: the walk's read raises."""
    k1_plain = rb.gotoh_rowblock_plain

    def dirs_failed(*a, **kw):
        res = k1_plain(*a, **kw)
        return res._replace(err=torch.full((), int(kw.get("emit_dirs", False)), dtype=torch.int32))

    monkeypatch.setattr(rb, "gotoh_rowblock_plain", dirs_failed)
    a, b = _pair(np.random.default_rng(5), 90, 80)
    with pytest.raises(RuntimeError, match="passed its bound"):
        align_checkpointed(a, b, Scores(), block_rows=63, device="cpu")


@pytest.mark.parametrize("is_local", [False, True])
def test_error_word_raises_in_the_sharded_paths(failing_fills, is_local):
    """``sharded_gotoh_score``, ``sharded_fill_checkpoints``,
    ``batched_sharded_scores`` and ``align_sharded`` read the tiles' error
    words with their result and raise."""
    rng = np.random.default_rng(6)
    a, b = _pair(rng, 200, 190)
    mesh = make_mesh(2, SEQ_AXIS, devices=[CPU, CPU])
    s1 = a.encoded(pad_to=256, pad_value=PAD_S1)
    s2 = b.encoded(pad_to=256, pad_value=PAD_S2)
    sc = Scores()
    for fn in (longseq.sharded_gotoh_score, longseq.sharded_fill_checkpoints):
        with pytest.raises(RuntimeError, match="passed its bound"):
            fn(mesh, s1, s2, 200, 190, sc, is_local)
    with pytest.raises(RuntimeError, match="passed its bound"):
        longseq.align_sharded(mesh, a, b, sc, is_local=is_local)
    from genomics_rs_tpu_torch.parallel.mesh import make_mesh_2d

    mesh22 = make_mesh_2d(2, 2, devices=[CPU] * 4)
    with pytest.raises(RuntimeError, match="passed its bound"):
        longseq.batched_sharded_scores(mesh22, np.stack([s1, s1]), np.stack([s2, s2]),
                                       [200, 200], [190, 190], sc, is_local)
