"""Mid-length batch scores, one warp per pair (kernel K7; counterpart of
``genomics_rs_tpu/ops/gotoh_segmented.py``).

:func:`gotoh_scores_segmented` keeps its JAX namesake's contract: for a
padded batch ``s1eb`` (B, Lm), ``s2eb`` (B, Ln) of uint8 byte codes with
true lengths ``ms``/``ns`` (empty sequences allowed), each pair's global
score at ``(m, n)`` or its local keep-last row-major argmax ``(v, i, j)``,
as ``(score, start_i, start_j)`` int32 tensors of shape (B,).

On a CUDA tensor it launches the warp-strip kernel of
``csrc/gotoh_segmented.cu``: one warp sweeps its pair in skewed strips of
``32 * ROWS_PER_LANE`` rows, lane ``l`` holding ``ROWS_PER_LANE`` rows in
registers, with no block barrier. The same kernel serves the stream8
route's single pairs (``ops/gotoh_stream8``; K8 itself runs on K3's
pipeline) under K7's count. On a CPU
tensor it runs ``gotoh_strips_plain`` at the kernel's strip height. The
JAX wrapper's padded-lane drift guard has no counterpart: only true cells
are computed.
"""

from __future__ import annotations

import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops.gotoh_pallas import gotoh_strips_plain
from genomics_rs_tpu_torch.ops.gotoh_stream import _lengths
from genomics_rs_tpu_torch.ops.subst import encode_chars, kimura_active

#: rows a lane holds (R, the kernel's compile-time constant; PERF.md §6
#: says why 8).
ROWS_PER_LANE = 8

#: launches of the CUDA kernel on this route / calls of the plain version.
COUNTS = {"kernel": 0, "plain": 0}


def gotoh_scores_segmented(s1eb, s2eb, ms, ns, scores, is_local: bool = False):
    """``(score, start_i, start_j)``, int32 tensors of shape (B,) on the
    batch's device. The device of ``s1eb`` picks the route."""
    if _build.uses_kernel(s1eb):
        return warp_strip_cuda(s1eb, s2eb, ms, ns, scores, is_local)
    COUNTS["plain"] += 1
    return gotoh_strips_plain(s1eb, s2eb, ms, ns, scores, is_local, 32 * ROWS_PER_LANE)


def warp_strip_cuda(s1eb, s2eb, ms, ns, scores, is_local):
    """Launch the warp-strip kernel and add one to ``COUNTS["kernel"]``."""
    dev = s1eb.device
    if dev.type != "cuda":
        raise ValueError(f"the warp-strip kernel takes CUDA tensors, not {dev}")
    B, Lm = s1eb.shape
    Ln = s2eb.shape[1]
    _build.require(s1eb, "s1eb", torch.uint8, dev, (B, Lm))
    _build.require(s2eb, "s2eb", torch.uint8, dev, (B, Ln))
    ms_h, ns_h = _lengths(ms, ns, B, Lm, Ln)
    i32 = dict(dtype=torch.int32, device=dev)
    if B == 0:
        return tuple(torch.empty((0,), **i32) for _ in range(3))
    lib = _build.library()
    kim = kimura_active(scores)
    s1c = encode_chars(s1eb, scores).contiguous()
    s2c = encode_chars(s2eb, scores).contiguous()
    ms_d = torch.as_tensor(ms_h, dtype=torch.int32).to(dev)
    ns_d = torch.as_tensor(ns_h, dtype=torch.int32).to(dev)
    res = torch.empty((B, 3), **i32)
    scratch = torch.empty((B, 4 * (Ln + 1)), **i32)
    with torch.cuda.device(dev):
        err = lib.gotoh_segmented_launch(
            _build.ptr(s1c), _build.ptr(s2c), _build.ptr(ms_d), _build.ptr(ns_d),
            _build.ptr(res), _build.ptr(scratch), B, Lm, Ln,
            scores.s_match, scores.s_mismatch, scores.s_transition if kim else 0, int(kim),
            scores.g, scores.h, int(is_local), _build.stream_handle(dev),
        )
    _build.check(err, "gotoh_segmented")
    COUNTS["kernel"] += 1
    return res[:, 0], res[:, 1], res[:, 2]
