"""Row-major numpy Gotoh fill (small-input utility).

Materialises the full I/S/D score matrices like the reference's
``alignment_table`` (``src/alignment/algo.rs:151-282``)
— used only for the small-input score-table visualisations and as an
independent cross-check in tests. The device path never builds these.
Uses int64 with the reference's offset "-infinity"
(``i64::MIN + |g+h|``, ``algo.rs:166``) so printed tables match.
"""

from __future__ import annotations

import numpy as np

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops.subst import kimura_active, sub_score_np

I64_MIN = np.iinfo(np.int64).min


def gotoh_tables_numpy(
    a: str, b: str, scores: Scores, is_local: bool, matrix=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (I, S, D) int64 matrices of shape (len(a)+1, len(b)+1).

    ``matrix`` (a ``SubstMatrix``) overrides the per-pair substitution
    scores entirely; otherwise ``scores.s_transition`` selects the
    two-score or kimura form (ops/subst.py).
    """
    sm, sx, g, h = scores.s_match, scores.s_mismatch, scores.g, scores.h
    st = scores.s_transition if kimura_active(scores) else None
    lut = matrix.byte_lut() if matrix is not None else None
    ab = np.frombuffer(a.encode("ascii"), dtype=np.uint8)
    bb = np.frombuffer(b.encode("ascii"), dtype=np.uint8)
    neg = I64_MIN + abs(g + h)
    m, n = len(a), len(b)
    I = np.full((m + 1, n + 1), neg, dtype=np.int64)
    S = np.full((m + 1, n + 1), neg, dtype=np.int64)
    D = np.full((m + 1, n + 1), neg, dtype=np.int64)
    I[0, 0] = S[0, 0] = D[0, 0] = 0
    for i in range(1, m + 1):
        D[i, 0] = h + i * g
    for j in range(1, n + 1):
        I[0, j] = h + j * g
    floor = [0] if is_local else []
    for i in range(1, m + 1):
        ai = ab[i - 1]
        if lut is not None:
            subs = lut[ai, bb]
        else:
            subs = sub_score_np(ai, bb, sm, sx, st)
        for j in range(1, n + 1):
            I[i, j] = max(I[i, j - 1] + g, S[i, j - 1] + h + g, D[i, j - 1] + h + g, *floor)
            D[i, j] = max(I[i - 1, j] + h + g, S[i - 1, j] + h + g, D[i - 1, j] + g, *floor)
            S[i, j] = subs[j - 1] + max(I[i - 1, j - 1], S[i - 1, j - 1], D[i - 1, j - 1], *floor)
    return I, S, D
