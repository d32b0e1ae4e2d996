"""The protein stream entries (counterpart of
``genomics_rs_tpu/ops/gotoh_matrix_stream.py``).

The JAX module packs many pairs into one TPU lane vector along both
axes (K14, ``_mstream_fill``) and builds that stream's substitution
input with an assembler kernel (K15, ``_mstream_build_fast``). The port
fills each pair's row strips on their own warps (K3's warp-strip
pipeline), so these entries are the matrix fill of ``ops/gotoh_matrix``
(profile kernel, then fill kernel) under the ``"stream"`` route, with
the JAX contracts:

* :func:`gotoh_scores_matrix_stream` and its grouped form, ``(score,
  start_i, start_j)``;
* :func:`gotoh_matrix_stream_fill_dirs`, scores plus direction codes.
  JAX's dirs are one global word array addressed per pair by word and
  lane offsets; the port keeps K3's per-pair ``(B, KW, V)`` bitmaps, so
  ``koff(p) = p * KW``, ``loff(p) = 0`` and ``segment_dirs(p) =
  dirs[p]``.

Each returns ``None`` where the JAX entry does for input or matrix
reasons: no pairs, a zero length, or a matrix entry past the int8
stream (``|v| > 127``). JAX's TPU-geometry refusals (lane budget, drift
bound) have no counterpart: the kernel computes only true cells.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops.gotoh_matrix import (
    _ext_matrix,
    checked_scores,
    gotoh_matrix_fill,
    matrix_fill,
    matrix_profile,
    row_codes,
)
from genomics_rs_tpu_torch.ops.gotoh_pallas import raise_on_err
from genomics_rs_tpu_torch.ops.gotoh_stream import StreamDirsResult

#: most bytes of query profile one launch of the grouped entry builds: the
#: profile of as many whole fill groups as fit (one group at least).
PROFILE_BUDGET_BYTES = 256 << 20


def _host(x) -> np.ndarray:
    """Lengths as a flat int32 numpy array."""
    return np.asarray(x.cpu() if torch.is_tensor(x) else x, np.int32).reshape(-1)


def _applicable(ms, ns, matrix) -> bool:
    ms, ns = _host(ms), _host(ns)
    if ms.size < 1 or (ms < 1).any() or (ns < 1).any():
        return False
    return int(np.abs(_ext_matrix(matrix)).max()) <= 127


def gotoh_scores_matrix_stream(s1eb: torch.Tensor, s2eb: torch.Tensor, ms, ns, matrix,
                               g: int, h: int, is_local: bool = False):
    """``(score, start_i, start_j)`` int32 tensors of shape (B,) of one
    matrix fill, or ``None`` (see the module doc). The device of
    ``s1eb`` picks the kernels or their plain versions."""
    if not _applicable(ms, ns, matrix):
        return None
    return checked_scores(gotoh_matrix_fill(s1eb, s2eb, ms, ns, matrix, g, h, is_local,
                                            route="stream"))


def gotoh_scores_matrix_stream_grouped(s1eb: torch.Tensor, s2eb: torch.Tensor, ms, ns, matrix,
                                       g: int, h: int, is_local: bool = False,
                                       group_size: int = 1024):
    """The scores of a large batch, one fill per sub-batch of
    ``group_size`` pairs, the profile of as many sub-batches as
    ``PROFILE_BUDGET_BYTES`` holds built at once (bounding its memory);
    same results as :func:`gotoh_scores_matrix_stream`, or ``None``. The
    s2 lengths go to the batch's device once, sliced per profile."""
    if not _applicable(ms, ns, matrix):
        return None
    ms, ns = _host(ms), _host(ns)
    B, Ln = s2eb.shape
    per_group = 2 * _ext_matrix(matrix).shape[0] * Ln * group_size
    span = max(1, PROFILE_BUDGET_BYTES // per_group) * group_size
    ns_dev = (torch.from_numpy(ns).to(s2eb.device, non_blocking=True)
              if s2eb.device.type == "cuda" else None)
    fills = []
    for s0 in range(0, B, span):
        sp = slice(s0, s0 + span)
        prof = matrix_profile(s2eb[sp], ns[sp], matrix, None if ns_dev is None else ns_dev[sp])
        code1 = row_codes(s1eb[sp], matrix)
        for g0 in range(0, prof.shape[0], group_size):
            gl, sl = slice(g0, g0 + group_size), slice(s0 + g0, s0 + g0 + group_size)
            fills.append(matrix_fill(code1[gl], prof[gl], ms[sl], ns[sl], g, h, is_local,
                                     route="stream"))
    raise_on_err(torch.stack([f.err for f in fills]).max(), "gotoh_matrix")
    return tuple(torch.cat(parts) for parts in zip(*(f[:3] for f in fills)))


class MatrixStreamDirsResult(StreamDirsResult):
    """Scores, start cells (numpy; ``(m, n)`` in global mode) and the
    per-pair packed bitmaps ``dirs`` (B, KW, V) of a matrix fill, with
    the JAX result's per-pair addressing."""

    def __init__(self, fill, ms, ns):
        super().__init__(fill)
        self.ms = np.asarray(ms)
        self.ns = np.asarray(ns)

    def koff(self, p: int) -> int:
        return p * self.KW

    def loff(self, p: int) -> int:
        return 0


def gotoh_matrix_stream_fill_dirs(s1eb: torch.Tensor, s2eb: torch.Tensor, ms, ns, matrix,
                                  g: int, h: int,
                                  is_local: bool = False) -> MatrixStreamDirsResult | None:
    """The matrix fill with packed direction codes, the alignment
    counterpart of :func:`gotoh_scores_matrix_stream`; ``None`` where it
    is."""
    if not _applicable(ms, ns, matrix):
        return None
    ms, ns = _host(ms), _host(ns)
    fill = gotoh_matrix_fill(s1eb, s2eb, ms, ns, matrix, g, h, is_local, emit_dirs=True,
                             route="stream")
    return MatrixStreamDirsResult(fill, ms, ns)
