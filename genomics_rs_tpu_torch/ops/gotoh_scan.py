"""Gotoh constants and the fill result type (the constants of
``genomics_rs_tpu/ops/gotoh_scan.py``; its ``lax.scan`` oracle fill is
not ported).

Direction codes encode the reference's retrace priority S > I > D:

    0 = substitute (diagonal), 1 = insert (left), 2 = delete (up),
    3 = stop (local zero cell)
"""

from __future__ import annotations

from typing import NamedTuple

#: "-infinity" for int32 score lanes. Codes are chosen by equality, so
#: this exact value matters at boundary cells.
NEG_INF = -(1 << 30)

#: "No value yet" in argmax trackers (below NEG_INF).
INT_MIN = -(1 << 31)

DIR_SUB = 0
DIR_INS = 1
DIR_DEL = 2
DIR_STOP = 3


class FillResult(NamedTuple):
    """Output of a whole-table fill: packed dirs, the score at the
    retrace start cell, and that cell (m, n for global; the keep-last
    row-major argmax for local)."""

    dirs: object
    score: int
    start_i: int
    start_j: int
