"""Alignment rendering (counterpart of
``genomics_rs_tpu/display/alignment.py``; reference parity with
``display.rs``).

* ``format_aligned_sequences`` — 3-row chunked rendering (s1 / glyph
  row / s2) in 200-column chunks, then the stats block.
* ``format_alignment_table`` — colored path-over-matrix view for small
  inputs.
* ``format_scores_table`` — per-matrix I/S/D score dumps with ``-inf``.
"""

from __future__ import annotations

from genomics_rs_tpu_torch.display._fmt import rust_f64

import numpy as np

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.ops.traceback import AlignedSequences, AlignmentChoice as C

DISP_MAX_WIDTH = 200

_ANSI = {
    "green": "\x1b[32m",
    "red": "\x1b[31m",
    "blue": "\x1b[34m",
    "cyan": "\x1b[36m",
    "bold_blue": "\x1b[1;34m",
    "bold_cyan": "\x1b[1;36m",
    "reset": "\x1b[0m",
}


def format_aligned_sequences(a: AlignedSequences) -> str:
    out: list[str] = []
    s1, s2 = a.s1.sequence, a.s2.sequence

    s1_out: list[str] = []
    align_out: list[str] = []
    s2_out: list[str] = []
    s1_idx = s2_idx = 0
    horizontal_len = 0
    align_idx = 0

    for choice, _, _ in reversed(a.alignment):
        if horizontal_len > DISP_MAX_WIDTH:
            out.append(f"\n\n{align_idx - DISP_MAX_WIDTH}-{align_idx}:\n")
            out.append("".join(s1_out) + "\n" + "".join(align_out) + "\n" + "".join(s2_out))
            s1_out, align_out, s2_out = [], [], []
            horizontal_len = 0

        if choice in (C.INSERT, C.OPEN_INSERT):
            s1_out.append("-")
        elif s1_idx < len(s1):
            s1_out.append(s1[s1_idx])
            s1_idx += 1

        align_out.append(
            {
                C.MATCH: "|",
                C.MISMATCH: "x",
                C.INSERT: " ",
                C.DELETE: " ",
                C.OPEN_INSERT: "%",
                C.OPEN_DELETE: "%",
            }[choice]
        )

        if choice in (C.DELETE, C.OPEN_DELETE):
            s2_out.append("-")
        elif s2_idx < len(s2):
            s2_out.append(s2[s2_idx])
            s2_idx += 1

        horizontal_len += 1
        align_idx += 1

    out.append(f"\n\n{align_idx - len(s1_out)}-{align_idx}:\n")
    out.append("".join(s1_out) + "\n" + "".join(align_out) + "\n" + "".join(s2_out))

    def pct(x: int) -> float:
        return x / align_idx * 100.0 if align_idx else float("nan")

    out.append(f"\n\nAlignment Score: {a.score}")
    out.append(f"Matches: {a.matches}/{align_idx} ({pct(a.matches):.2f}%)")
    out.append(f"Mismatches: {a.mismatches}/{align_idx} ({pct(a.mismatches):.2f}%)")
    out.append(
        f"Gap Extensions: {a.gap_extensions}/{align_idx} ({pct(a.gap_extensions):.2f}%)"
    )
    out.append(f"Opening Gaps: {a.opening_gaps}/{align_idx} ({pct(a.opening_gaps):.2f}%)")
    out.append(f"Percent Identity {rust_f64(pct(a.matches))}%")
    return "\n".join(out)


def format_alignment_table(a: AlignedSequences, color: bool = True) -> str | None:
    """Path-over-matrix view; None if too large (display.rs:139-144)."""
    s1, s2 = a.s1.sequence, a.s2.sequence
    if not (len(s1) < DISP_MAX_WIDTH and len(s2) < DISP_MAX_WIDTH * 10):
        return None

    def paint(ch: str, col: str) -> str:
        return f"{_ANSI[col]}{ch}{_ANSI['reset']}" if color else ch

    # Earlier entries win, like the reference's linear .find().
    by_cell: dict[tuple[int, int], C] = {}
    for choice, x, y in a.alignment:
        by_cell.setdefault((x, y), choice)

    lines = ["\nSequence Table (S1 columns, S2 rows):\n", " " + s2]
    glyph = {
        C.MATCH: paint("M", "green"),
        C.MISMATCH: paint("X", "red"),
        C.INSERT: paint("I", "blue"),
        C.DELETE: paint("D", "cyan"),
        C.OPEN_INSERT: paint("I", "bold_blue"),
        C.OPEN_DELETE: paint("D", "bold_cyan"),
    }
    for i in range(len(s1)):
        row = [s1[i]]
        for j in range(len(s2)):
            choice = by_cell.get((i + 1, j + 1))
            row.append(glyph[choice] if choice is not None else ".")
        lines.append("".join(row))
    return "\n".join(lines)


def format_scores_table(table: np.ndarray) -> str:
    """One I/S/D matrix as a tab-separated dump with -inf rendering."""
    rows, cols = table.shape
    lines = [". \t" + "\t".join(str(j) for j in range(cols)) + "\t"]
    for i in range(rows):
        vals = []
        for j in range(cols):
            v = int(table[i, j])
            vals.append("-inf" if v <= -9223372036854775700 else str(v))
        lines.append(f"{i}\t" + "\t".join(vals) + "\t")
    return "\n".join(lines)


def print_alignment_tables(
    a: AlignedSequences, scores: Scores, is_local: bool, matrix=None
) -> None:
    """Full small-input diagnostics: path matrix + I/S/D score tables
    (under ``matrix``, a ``SubstMatrix``, when given)."""
    from genomics_rs_tpu_torch.ops.gotoh_numpy import gotoh_tables_numpy

    vis = format_alignment_table(a)
    if vis is None:
        return
    print(vis)
    I, S, D = gotoh_tables_numpy(a.s1.sequence, a.s2.sequence, scores, is_local, matrix=matrix)
    print("Delete Scores")
    print(format_scores_table(D))
    print("Insert Scores")
    print(format_scores_table(I))
    print("Sub Scores")
    print(format_scores_table(S))
