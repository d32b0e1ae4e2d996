"""Traceback walk over a block's packed direction bitmap (counterpart of
``genomics_rs_tpu/ops/traceback_device.py``).

Movement follows the reference retrace: per-axis saturation at 0, stop
when (0, 0) is reached after a move (full-width bitmaps), local
termination on a stop code. Only the O(m+n) move list leaves the
device.

* :func:`walk_block` — the walker's plain version (a host loop over the
  bitmap's words), with ``walk_block``'s contract.
* :func:`resume_walk` — drives a bounded walker to the end of the path
  or the edge of the block.
* :func:`device_walk` — the front door: a CUDA bitmap goes to the
  kernel (``ops/traceback_walker.walk_full``) at every size, a CPU
  bitmap to :func:`walk_block`.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_STOP
from genomics_rs_tpu_torch.utils.profiling import annotate

#: calls of the plain walker.
COUNTS = {"plain": 0}


def walk_block(
    dirs: torch.Tensor,
    start_li: int,
    start_j: int,
    i0: int,
    max_steps: int,
    j0: int = 0,
):
    """Chase codes from block-local ``(start_li, start_j)`` until the
    path terminates or leaves the block.

    ``dirs``: packed int32 ``(KW, V)`` words; the code at block cell
    ``(li, j)`` is ``(dirs[(li+j)//16, li] >> 2*((li+j)%16)) & 3``.
    ``i0``: global row of lane 0. ``j0``: global column of the bitmap's
    column 0 (a windowed refill); when a move lands on local column 0
    with ``j0 > 0`` the walk exits left (done False, ``j_final == 0``).

    Returns ``(moves uint8[max_steps], count, i_final, j_final, done)``;
    ``i_final == i0 - 1`` after an upward exit. Raises ``IndexError``
    if the walk reaches a cell outside the bitmap.
    """
    COUNTS["plain"] += 1
    words = dirs.detach().to("cpu").numpy()
    KW, V = words.shape
    li, j, i0, j0 = int(start_li), int(start_j), int(i0), int(j0)
    moves = np.zeros(max_steps, np.uint8)
    pos, done, exited = 0, False, 0
    while not done and exited == 0 and pos < max_steps:
        k = li + j
        if not (0 <= li < V and k >= 0 and (k >> 4) < KW):
            raise IndexError(f"walk left the bitmap at (li={li}, j={j})")
        code = (int(words[k >> 4, li]) >> (2 * (k & 15))) & 3
        ig_new = max(i0 + li - (0 if code == DIR_INS else 1), 0)
        j_new = max(j - (0 if code == DIR_DEL else 1), 0)
        if code != DIR_STOP:
            moves[pos] = code
            pos += 1
        if code == DIR_STOP or (ig_new == 0 and j_new == 0 and j0 == 0):
            done = True
        elif ig_new < i0:
            exited = 1
        elif j_new == 0 and j0 > 0:
            exited = 2
        # The position moves on every step, stop codes included.
        li, j = max(ig_new - i0, 0), j_new
    i_final = i0 - 1 if exited == 1 else i0 + li
    return torch.from_numpy(moves), pos, i_final, j, done


def resume_walk(step_fn, start_li, start_j, i0: int, windowed=False):
    """Drive a single-buffer block walker to completion.

    ``step_fn(li, j) -> (codes uint8[count], i_final, j_final, done)``
    performs one bounded walk from block-local row ``li``; this loop
    resumes it until the path terminates, exits the block upward
    (``i_final < i0``) or, for a windowed bitmap, exits left onto local
    column 0. A resume that did not move the position is a corrupt
    table and raises.
    """
    li, j = int(start_li), int(start_j)
    i0 = int(i0)
    chunks = []
    while True:
        codes, i_f, j_f, done = step_fn(li, j)
        chunks.append(np.asarray(codes, np.uint8))
        prev = (i0 + li, j)
        i_g, j_g, done = int(i_f), int(j_f), bool(done)
        if done or i_g < i0 or (windowed and j_g == 0):
            return np.concatenate(chunks), i_g, j_g, done
        if (i_g, j_g) == prev:
            raise RuntimeError(
                f"traceback made no progress at ({i_g}, {j_g})"
            )
        li, j = i_g - i0, j_g


def device_walk(
    dirs: torch.Tensor,
    start_li,
    start_j,
    i0,
    max_steps: int,
    j0=0,
):
    """Chase a packed-dirs block from ``(start_li, start_j)``; returns
    ``(codes uint8[count], i_final, j_final, done)``.

    A CUDA bitmap is walked by the kernel, a CPU bitmap by
    :func:`walk_block`; both resume past a full move buffer.
    ``j0 > 0``: the bitmap is a column window starting at global column
    ``j0`` (see :func:`walk_block`).
    """
    if _build.uses_kernel(dirs):
        from genomics_rs_tpu_torch.ops.traceback_walker import walk_full

        return walk_full(dirs, start_li, start_j, i0, max_steps=max_steps, j0=j0)

    def step(li, j):
        moves, count, i_f, j_f, done = walk_block(
            dirs, li, j, i0, max_steps=max_steps, j0=j0
        )
        return moves.numpy()[:count], i_f, j_f, done

    with annotate("genomics/traceback_device.walk"):
        return resume_walk(step, start_li, start_j, i0, windowed=int(j0) > 0)
