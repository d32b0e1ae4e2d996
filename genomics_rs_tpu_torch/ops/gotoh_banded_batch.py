"""Batched banded Gotoh fill (kernel K12); counterpart of
``genomics_rs_tpu/ops/gotoh_banded_batch.py``.

All pairs of a batch ride one window, planned from the batch geometry
``(M, N) = (max m, max n)``: per row, ``off(i)`` and ``delta`` are shared,
while chars and probe cells are per pair. A pair's result equals the
full DP exactly when an optimal path of that pair stays inside the
shared window. The JAX kernel packs 8 pairs into one (8, W) pane per
launch; here one launch of ``csrc/gotoh_banded.cu`` (the K10 kernel at B
pairs, one thread block each) fills the whole batch, which gives the
same answers because the window was already shared by the whole batch.
Results still come as one :class:`BandedBatchResult` per group of 8.

A CUDA tensor launches the kernel, a CPU tensor runs the plain version
(``gotoh_banded.gotoh_banded_plain`` over the batch).
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops.gotoh_banded import (
    fill_cuda,
    gotoh_banded_plain,
    probe_lanes,
    walk_banded_batch,
)

#: pairs per result group (the JAX kernel's pane of 8 sublanes).
GROUP = 8

#: launches of the batched fill (K12) / calls of its plain version.
COUNTS = {"kernel": 0, "plain": 0}


class BandedBatchResult:
    """Scores and codes of one group of up to 8 pairs.

    ``score`` (G,) int32 and ``dirs`` (G, ceil(M/16), W) int32 are views
    of the batch's tensors; ``pair_dirs(r)`` is pair r's bitmap, walked
    by ``gotoh_banded.walk_banded(..., geom=(M, N))``.
    """

    def __init__(self, score, dirs, ms, ns, W: int, M: int, N: int):
        self.score = score
        self.dirs = dirs
        self.ms = np.asarray(ms)
        self.ns = np.asarray(ns)
        self.W = W
        self.M = M
        self.N = N

    def pair_dirs(self, r: int) -> torch.Tensor:
        return self.dirs[r]


def _fill(s1b, s2b, ms, ns, scores, W: int):
    """Checks, then one fill over the batch: ``(score (B,), dirs (B, KW,
    W), ms, ns, M, N)``."""
    if W < 128 or W % 128:
        raise ValueError(f"band width W={W} must be a multiple of 128")
    ms_np = np.asarray(ms, np.int64).reshape(-1)
    ns_np = np.asarray(ns, np.int64).reshape(-1)
    B = s1b.shape[0]
    if s1b.dim() != 2 or s2b.dim() != 2 or s2b.shape[0] != B or ms_np.shape != (B,) \
            or ns_np.shape != (B,):
        raise ValueError("s1b (B, Lm), s2b (B, Ln) and one (m, n) per pair")
    if B < 1 or np.any(ms_np < 1) or np.any(ns_np < 1):
        raise ValueError("banded batch needs nonempty pairs")
    M = int(ms_np.max())
    N = int(ns_np.max())
    if not 1 <= N <= M:
        raise ValueError(f"banded batch needs 1 <= N ({N}) <= M ({M}); swap pairs")
    v_mn = probe_lanes(ms_np, ns_np, M, N, W)
    if np.any((v_mn < 0) | (v_mn >= W)):
        bad = int(np.argmax((v_mn < 0) | (v_mn >= W)))
        raise ValueError(
            f"pair {bad} ({ms_np[bad]}x{ns_np[bad]}) ends outside the "
            f"shared band (M={M}, N={N}, W={W}): lengths too "
            "dissimilar for one banded batch — bucket by length or "
            "widen W"
        )
    if _build.uses_kernel(s1b):
        score, dirs = fill_cuda(s1b, s2b, ms_np, ns_np, scores, W, COUNTS)
    else:
        score, dirs = gotoh_banded_plain(s1b, s2b, ms_np, ns_np, scores, W, COUNTS)
    return score, dirs, ms_np, ns_np, M, N


def gotoh_banded_batch(s1b, s2b, ms, ns, scores, W: int) -> list[BandedBatchResult]:
    """Banded fills for a batch of similar pairs.

    ``s1b`` (B, Lm) and ``s2b`` (B, Ln) uint8 tensors with true lengths
    ``ms``/``ns``; all pairs share the window of ``(M, N) = (max ms, max
    ns)`` (requires ``N <= M`` and every pair's ``(m_p, n_p)`` inside it;
    raises otherwise). ``W`` is a multiple of 128. Returns one
    :class:`BandedBatchResult` per group of 8 pairs, in order.
    """
    score, dirs, ms_np, ns_np, M, N = _fill(s1b, s2b, ms, ns, scores, W)
    return [
        BandedBatchResult(score[g0 : g0 + GROUP], dirs[g0 : g0 + GROUP],
                          ms_np[g0 : g0 + GROUP], ns_np[g0 : g0 + GROUP], W, M, N)
        for g0 in range(0, len(ms_np), GROUP)
    ]


def banded_align_batch(s1b, s2b, ms, ns, scores, W: int) -> list[tuple[int, np.ndarray]]:
    """Batched banded fill plus every pair's walk; returns ``(score,
    moves)`` in batch order (moves in walk order, the ``classify_moves``
    input). On the card: one fill launch (K12) and one walker launch
    (K11) for all pairs, each walk carried whole."""
    score, dirs, ms_np, ns_np, M, N = _fill(s1b, s2b, ms, ns, scores, W)
    moves = walk_banded_batch(dirs, ms_np, ns_np, W, geom=(M, N))
    return list(zip(score.cpu().tolist(), moves))
