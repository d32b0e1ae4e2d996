"""The 8-stream batch tier (kernel K8; counterpart of
``genomics_rs_tpu/ops/gotoh_stream8.py``'s ``gotoh_scores_stream8``).

The JAX kernel stacks eight multi-segment wavefronts on the sublane rows
of one register pane, an answer to a TPU core's single wide vector. On
Hopper this route runs the warp-strip pipeline of K3
(``csrc/gotoh_stream.cu`` on ``csrc/gotoh_warp_pipe.cuh``, entered through
``ops/gotoh_stream.run_stream``) at scores only, with the strip height of
``gotoh_stream.stream_rows``: every strip of a pair is one warp's work, and
a pair's strips spread over every SM through the pipeline's ring and
tickets, under this route's own launch count (one launch for each of
``gotoh_pallas.pipeline_groups``' pair ranges). A single pair takes K7's
route (and count), as the JAX wrapper falls back to the segmented kernel
at B = 1; the JAX wrapper's other fallbacks (empty sequences, probe
collisions, int32 drift) answer TPU layout limits the port does not have.

The launch does not synchronise: :func:`gotoh_stream8_fill` returns the
pipeline's error word unread (``parallel/batch`` reads it with the
scores), and :func:`gotoh_scores_stream8` reads it before it returns.
"""

from __future__ import annotations

import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops import gotoh_stream as gs
from genomics_rs_tpu_torch.ops.gotoh_pallas import raise_on_err
from genomics_rs_tpu_torch.ops.gotoh_segmented import gotoh_scores_segmented

#: launches of the CUDA kernel on this route / calls of the plain version.
COUNTS = {"kernel": 0, "plain": 0}


def gotoh_stream8_fill(s1eb, s2eb, ms, ns, scores, is_local: bool = False) -> gs.StreamFill:
    """Scores of every pair as a ``gotoh_stream.StreamFill`` (no codes),
    its error word unread. The device of ``s1eb`` picks the route: CUDA
    launches the pipeline, CPU runs ``gotoh_stream_plain`` at scores only;
    B = 1 runs ``gotoh_scores_segmented`` (its error word is zero)."""
    if s1eb.shape[0] < 2:
        score, si, sj = gotoh_scores_segmented(s1eb, s2eb, ms, ns, scores, is_local)
        return gs.StreamFill(score, si, sj, None,
                             torch.zeros((), dtype=torch.int32, device=s1eb.device))
    if _build.uses_kernel(s1eb):
        return gs._stream_cuda(s1eb, s2eb, ms, ns, scores, is_local, counts=COUNTS,
                               what="gotoh_stream8")
    return gs.gotoh_stream_plain(s1eb, s2eb, ms, ns, scores, is_local, counts=COUNTS)


def gotoh_scores_stream8(s1eb, s2eb, ms, ns, scores, is_local: bool = False):
    """``(score, start_i, start_j)``, int32 tensors of shape (B,) on the
    batch's device, after reading the fill's error word (on the card, one
    synchronisation)."""
    out = gotoh_stream8_fill(s1eb, s2eb, ms, ns, scores, is_local)
    raise_on_err(out.err, "gotoh_stream8")
    return out.score, out.start_i, out.start_j
