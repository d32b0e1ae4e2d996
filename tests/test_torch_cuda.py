"""CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (run them on a GPU
machine with ``python -m pytest tests/test_torch_cuda.py``). The CPU
tests hold the plain versions equal to the JAX package; these hold the
kernels equal to the plain versions, bit for bit.
"""

import numpy as np
import pytest
import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.models.aligner import PairwiseAligner
from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
from genomics_rs_tpu_torch.ops import traceback_device as td
from genomics_rs_tpu_torch.ops import traceback_walker as tw
from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_top
from genomics_rs_tpu_torch.sequence import PAD_S2, Sequence

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


@pytest.mark.parametrize("is_local", [False, True])
@pytest.mark.parametrize("st", [None, -1])
@pytest.mark.parametrize("with_left", [False, True])
def test_rowblock_kernel_matches_plain(cuda, is_local, st, with_left):
    rng = np.random.default_rng(1)
    R, m, n, B, i0 = 300, 1000, 500, 512, 300
    sc = Scores(2, -3, -2, -4, st)
    s1 = torch.from_numpy(BASES[rng.integers(0, 4, R)].copy())
    s2 = torch.from_numpy(np.concatenate(
        [BASES[rng.integers(0, 4, n)], np.full(B - n, PAD_S2, np.uint8)]))
    top = global_boundary_top(7, B, sc)
    left = torch.from_numpy(rng.integers(-40, 5, (3, R)).astype(np.int32)) if with_left else None
    args = (m, n, i0, sc, is_local)
    emit = dict(emit_dirs=True, emit_bottom=True, emit_cols=True)
    want = rb.gotoh_rowblock(s1, s2, top, *args, left=left, **emit)
    got = rb.gotoh_rowblock(
        s1.to(cuda), s2.to(cuda), top.to(cuda), *args,
        left=None if left is None else left.to(cuda), **emit,
    )
    torch.cuda.synchronize()
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


@pytest.mark.parametrize("j0", [0, 1024])
def test_walk_kernel_matches_plain(cuda, j0):
    rng = np.random.default_rng(2)
    dirs = torch.from_numpy(rng.integers(-(2**31), 2**31, (64, 300), dtype=np.int64).astype(np.int32))
    for li, j in ((250, 700), (10, 900), (299, 5)):
        want = td.device_walk(dirs, li, j, 3, max_steps=40, j0=j0)
        got = tw.walk_full(dirs.to(cuda), li, j, 3, max_steps=40, j0=j0)
        assert np.array_equal(got[0], want[0])
        assert tuple(got[1:]) == tuple(want[1:])


@pytest.mark.parametrize("is_local", [False, True])
def test_align_cuda_matches_cpu(cuda, is_local):
    rng = np.random.default_rng(3)
    a = "".join(rng.choice(list("ACGT"), 700))
    b = a[:300] + "".join(rng.choice(list("ACGT"), 40)) + a[320:]
    sc = Scores()
    want = PairwiseAligner(sc, is_local, device="cpu").align(Sequence("a", a), Sequence("b", b))
    got = PairwiseAligner(sc, is_local, device="cuda").align(Sequence("a", a), Sequence("b", b))
    assert (got.score, got.alignment) == (want.score, want.alignment)
