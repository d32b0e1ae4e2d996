"""Pairwise-alignment row helpers (counterpart of ``_alignment_ops`` and
``_gapped_pair`` in ``genomics_rs_tpu/models/msa.py``; the center-star
MSA itself is not ported yet). ``align-matrix --alignments-out`` renders
each pair's gapped rows with them."""

from __future__ import annotations

from genomics_rs_tpu_torch.ops.traceback import AlignedSequences, AlignmentChoice

_GAP = "-"


def _alignment_ops(aln: AlignedSequences) -> str:
    """Forward per-column ops of a pairwise alignment: 'M' consumes a
    char of both sequences, 'I' only of s2 (gap in s1), 'D' only of s1
    (gap in s2), the display convention."""
    C = AlignmentChoice
    ops = []
    for choice, _, _ in reversed(aln.alignment):
        if choice in (C.INSERT, C.OPEN_INSERT):
            ops.append("I")
        elif choice in (C.DELETE, C.OPEN_DELETE):
            ops.append("D")
        else:
            ops.append("M")
    return "".join(ops)


def _gapped_pair(center: str, other: str, ops: str) -> tuple[str, str]:
    """Expand an op string into the two gapped row strings."""
    ci = oi = 0
    crow: list[str] = []
    orow: list[str] = []
    for op in ops:
        if op == "I":
            crow.append(_GAP)
        else:
            crow.append(center[ci])
            ci += 1
        if op == "D":
            orow.append(_GAP)
        else:
            orow.append(other[oi])
            oi += 1
    if ci != len(center) or oi != len(other):
        raise AssertionError(
            "pairwise alignment did not consume both sequences "
            f"({ci}/{len(center)}, {oi}/{len(other)})"
        )
    return "".join(crow), "".join(orow)
