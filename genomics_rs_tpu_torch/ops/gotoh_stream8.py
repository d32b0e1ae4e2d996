"""The 8-stream batch tier (kernel K8; counterpart of
``genomics_rs_tpu/ops/gotoh_stream8.py``'s ``gotoh_scores_stream8``).

The JAX kernel stacks eight multi-segment wavefronts on the sublane rows
of one register pane, an answer to a TPU core's single wide vector. On
Hopper the warp-strip kernel of ``ops/gotoh_segmented`` already gives
every pair its own warp, so this tier launches that kernel under its own
launch count. A single pair takes K7's route (and count), as the JAX
wrapper falls back to the segmented kernel at B = 1; the JAX wrapper's
other fallbacks (empty sequences, probe collisions, int32 drift) answer
TPU layout limits the port does not have.
"""

from __future__ import annotations

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops.gotoh_pallas import gotoh_strips_plain
from genomics_rs_tpu_torch.ops.gotoh_segmented import (
    ROWS_PER_LANE,
    gotoh_scores_segmented,
    warp_strip_cuda,
)

#: launches of the CUDA kernel on this route / calls of the plain version.
COUNTS = {"kernel": 0, "plain": 0}


def gotoh_scores_stream8(s1eb, s2eb, ms, ns, scores, is_local: bool = False):
    """``(score, start_i, start_j)``, int32 tensors of shape (B,) on the
    batch's device; B = 1 runs ``gotoh_scores_segmented``."""
    if s1eb.shape[0] < 2:
        return gotoh_scores_segmented(s1eb, s2eb, ms, ns, scores, is_local)
    if _build.uses_kernel(s1eb):
        return warp_strip_cuda(s1eb, s2eb, ms, ns, scores, is_local, COUNTS)
    COUNTS["plain"] += 1
    return gotoh_strips_plain(s1eb, s2eb, ms, ns, scores, is_local, 32 * ROWS_PER_LANE)
