"""Checkpointed linear-space alignment with full traceback (counterpart
of ``genomics_rs_tpu/models/longalign.py``).

1. **Forward pass** — the table is filled as full-width row blocks of
   ``block_rows`` rows by the row-block fill (``ops/gotoh_rowblock``,
   one launch per block); each block's top row is checkpointed, and so
   is every column at stride V (the fill's lane count).
2. **Backward pass** — walking from the end cell, each crossed block is
   refilled over a narrow column window ending at the walk's entry
   column (left boundary = the nearest captured column at least V to
   the left, top boundary = the checkpointed row sliced to the window),
   its packed direction bitmap is chased on the device
   (``ops/traceback_device.device_walk``), and only the move codes
   reach the host. A walk that runs out of window exits left and
   resumes one stride wider.

Every refill injects exact boundary values, so the codes, path, ties
and stats equal a monolithic fill's.

**One fill** — a pair of one block (``NB == 1``) whose walk can open no
window right of column 0 (``n < 2V``) would refill the whole table from
the same boundary row: :func:`align_checkpointed` then runs that fill
alone, with dirs, and takes the end cell (``(m, n)`` or the local best)
and the error word from it; the forward pass is left out.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.gotoh_rowblock import gotoh_rowblock, lane_count, raise_on_err
from genomics_rs_tpu_torch.ops.gotoh_scan import INT_MIN
from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_top
from genomics_rs_tpu_torch.ops.traceback import AlignedSequences, classify_moves
from genomics_rs_tpu_torch.ops.traceback_device import device_walk
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, round_up
from genomics_rs_tpu_torch.utils.profiling import annotate

log = logging.getLogger(__name__)

#: calls of :func:`align_checkpointed` by route: one fill with dirs, or
#: the forward pass and the windowed refills.
ROUTE_COUNTS = {"one_fill": 0, "forward": 0}


def _forward_blocks(
    s1e: torch.Tensor,
    s2e: torch.Tensor,
    m: int,
    n: int,
    R: int,
    NB: int,
    scores: Scores,
    is_local: bool,
    keep_tops: bool,
    keep_cols: bool = False,
):
    """Forward pass over full-width row blocks: one fill per block, each
    block's bottom row the next one's top.

    Returns (tops [NB x (3, Ln+1)] | None, cols [NB x (NC, 3, V)] | None,
    best (v, i, j), at_mn), the last two merged on the host once, where
    the fills' error words are read too.
    """
    top = global_boundary_top(0, s2e.shape[0], scores, device=s2e.device)
    tops, cols, outs = [], [], []
    for b in range(NB):
        i0 = b * R
        res = gotoh_rowblock(
            s1e[i0 : i0 + R], s2e, top, m, n, i0, scores, is_local,
            emit_cols=keep_cols,
        )
        if keep_tops:
            tops.append(top)
        if keep_cols:
            cols.append(res.cols)
        outs.append(torch.stack([res.score_at_mn, *res.best, res.err]))
        top = res.bottom
    with annotate("genomics/longalign.wait"):
        r = torch.stack(outs).cpu().numpy().astype(np.int64)
    raise_on_err(r[:, 4].max())
    at_mn = int(r[:, 0].max())
    if is_local:
        # Merge with the reference tie-break (blocks ordered by i).
        v = r[:, 1].max()
        i_best = r[r[:, 1] == v, 2].max()
        j_best = r[(r[:, 1] == v) & (r[:, 2] == i_best), 3].max()
        best = (int(v), int(i_best), int(j_best))
    else:
        best = (INT_MIN, 0, 0)
    return (tops if keep_tops else None), (cols if keep_cols else None), best, at_mn


def _encode_blocks(seq1, seq2, R: int, device):
    m, n = len(seq1), len(seq2)
    Lm = max(round_up(m, R), R)
    Ln = max(round_up(n, 128), 128)
    with annotate("genomics/longalign.encode"):
        s1e = torch.from_numpy(seq1.encoded(pad_to=Lm, pad_value=PAD_S1).copy())
        s2e = torch.from_numpy(seq2.encoded(pad_to=Ln, pad_value=PAD_S2).copy())
        return s1e.to(device), s2e.to(device), Lm // R


def score_long(
    seq1: Sequence,
    seq2: Sequence,
    scores: Scores,
    is_local: bool = False,
    block_rows: int = 98303,
    device="cuda",
) -> tuple[int, int, int]:
    """(score, start_i, start_j) for arbitrarily long pairs: forward block
    fills only, one rolling boundary row, O(n) device memory."""
    device = resolve_device(device)
    m, n = len(seq1), len(seq2)
    R = min(block_rows, max(round_up(m + 1, 1024) - 1, 1023))
    s1e, s2e, NB = _encode_blocks(seq1, seq2, R, device)
    t0 = time.perf_counter()
    _, _, best, at_mn = _forward_blocks(
        s1e, s2e, m, n, R, NB, scores, is_local, keep_tops=False
    )
    elapsed = time.perf_counter() - t0
    log.info(
        "[ScoreLong] %dx%d in %d blocks: %.2fs", m, n, NB, elapsed
    )
    if is_local:
        return best
    return at_mn, m, n


def _walk_span_windowed(
    s1e, s2e, tops, cols, R: int, m: int, scores: Scores, is_local: bool,
    i: int, j: int,
):
    """Walk the traceback upward through windowed block refills.

    ``tops[b]`` is the checkpointed I/S/D of row ``b*R`` over columns
    0..Ln; ``cols[b][c]`` the captured I/S/D of column ``c*V``. Each
    crossed block is refilled over columns ``[jc, j]`` only, ``jc``
    being the nearest captured column at least V left of the entry
    column. Returns the move codes in walk order.
    """
    codes: list[np.ndarray] = []
    if i == 0 and j == 0:
        return codes
    Ln = s2e.shape[0]
    V = lane_count(R)
    blk = max(0, (i - 1) // R)
    max_steps = R + 2 * V + 1
    while True:
        i0 = blk * R
        jc = max(0, (j // V - 1) * V)
        Bt = min(Ln - jc, round_up(max(j - jc, 1), V))
        top_w = tops[blk][:, jc : jc + Bt + 1].contiguous()
        left = cols[blk][jc // V, :, 1 : R + 1].contiguous() if jc > 0 else None
        res = gotoh_rowblock(
            s1e[i0 : i0 + R], s2e[jc : jc + Bt], top_w, m, Bt, i0,
            scores, is_local,
            emit_dirs=True, emit_bottom=False, left=left,
        )
        blk_codes, i, j_local, done = device_walk(
            res.dirs, i - i0, j - jc, i0, max_steps=max_steps, j0=jc
        )
        raise_on_err(res.err)  # the walk's read has synchronised
        codes.append(blk_codes)
        j = j_local + jc
        if done:
            return codes
        if i < i0:
            if blk == 0:
                raise RuntimeError(
                    f"traceback left block 0 at ({i}, {j}) without "
                    "terminating"
                )
            blk -= 1
        elif j_local == 0:
            # Left exit: same block, one stride wider.
            if jc == 0:
                raise RuntimeError(
                    f"traceback hit the left edge at ({i}, {j}) "
                    "without terminating"
                )
        else:
            raise RuntimeError(f"traceback stalled at ({i}, {j}) in block {blk}")


def _walk_one_fill(s1e, s2e, m: int, n: int, R: int, scores: Scores, is_local: bool):
    """One block, every walk window at column 0: a single fill with dirs
    over the whole table, walked from ``(m, n)`` or the local best.
    Returns (score, start_i, start_j, move codes in walk order as a
    list of arrays, like :func:`_walk_span_windowed`)."""
    top = global_boundary_top(0, s2e.shape[0], scores, device=s2e.device)
    res = gotoh_rowblock(
        s1e, s2e, top, m, n, 0, scores, is_local,
        emit_dirs=True, emit_bottom=False,
    )
    with annotate("genomics/longalign.wait"):
        r = torch.stack([res.score_at_mn, *res.best, res.err]).cpu().tolist()
    raise_on_err(r[4])
    score, i, j = r[1:4] if is_local else (r[0], m, n)
    if i == 0 and j == 0:
        return score, i, j, []
    codes, i_f, j_f, done = device_walk(
        res.dirs, i, j, 0, max_steps=R + 2 * lane_count(R) + 1
    )
    if not done:
        raise RuntimeError(f"traceback stopped at ({i_f}, {j_f}) without terminating")
    return score, i, j, [codes]


def align_checkpointed(
    seq1: Sequence,
    seq2: Sequence,
    scores: Scores,
    is_local: bool = False,
    block_rows: int = 65535,
    device="cuda",
) -> AlignedSequences:
    """Full global/local alignment with O((m/R + R) * V) device memory
    (module docstring). Size ``block_rows`` so R+1 is a multiple of
    1024: a block's lane count is R+1 rounded up to 1024."""
    device = resolve_device(device)
    m, n = len(seq1), len(seq2)
    R = block_rows
    s1e, s2e, NB = _encode_blocks(seq1, seq2, R, device)

    if NB == 1 and n < 2 * lane_count(R):
        ROUTE_COUNTS["one_fill"] += 1
        score, start_i, start_j, codes = _walk_one_fill(
            s1e, s2e, m, n, R, scores, is_local
        )
    else:
        ROUTE_COUNTS["forward"] += 1
        tops, cols, best, at_mn = _forward_blocks(
            s1e, s2e, m, n, R, NB, scores, is_local,
            keep_tops=True, keep_cols=True,
        )
        if is_local:
            score, start_i, start_j = best
        else:
            score, start_i, start_j = at_mn, m, n
        codes = _walk_span_windowed(
            s1e, s2e, tops, cols, R, m, scores, is_local, start_i, start_j
        )
    log.info("[LongAlign] %dx%d in %d blocks of %d rows", m, n, NB, R)
    all_codes = np.concatenate(codes) if codes else np.zeros(0, np.uint8)
    return classify_moves(all_codes, start_i, start_j, score, seq1, seq2)
