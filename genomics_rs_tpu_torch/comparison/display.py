"""Terminal similarity heatmap (counterpart of
``genomics_rs_tpu/comparison/display.py``; parity with the reference's
``src/comparison/display.rs:7-28``).

Percent similarity = score / max(len_i, len_j); rendered as truecolor
``■`` glyphs on a 26-entry viridis ramp indexed by pct/4. Our ramp is
sampled uniformly from the standard viridis colormap (the reference
embeds a GenAI-produced LUT with idiosyncratic entries at the top end —
visual output only, untested there, so we use the canonical ramp).
"""

from __future__ import annotations

import numpy as np

# 26 uniform samples of matplotlib's viridis (public colormap data).
VIRIDIS_COLORS: list[tuple[int, int, int]] = [
    (68, 1, 84),
    (71, 17, 100),
    (72, 31, 112),
    (71, 45, 123),
    (67, 58, 129),
    (62, 71, 134),
    (56, 84, 140),
    (50, 95, 142),
    (45, 106, 143),
    (41, 117, 143),
    (37, 128, 142),
    (33, 138, 141),
    (30, 148, 139),
    (28, 159, 136),
    (31, 169, 131),
    (41, 179, 124),
    (57, 188, 113),
    (78, 197, 100),
    (102, 205, 85),
    (128, 212, 67),
    (156, 218, 48),
    (185, 222, 40),
    (212, 225, 42),
    (238, 228, 59),
    (253, 231, 37),
    (253, 253, 253),
]


def _pct(score: int, total: int) -> float:
    if total == 0:
        return 0.0
    return score / total * 100.0


def format_similarity_matrix(matrix: np.ndarray, color: bool = True) -> str:
    """Rows/cols indexed by sequence number; one glyph per pair."""
    num = matrix.shape[0]
    lines = ["  " + " ".join(str(i) for i in range(num)) + " "]
    for j in range(num):
        cells = []
        for i in range(num):
            score, l1, l2, _ = (int(x) for x in matrix[j, i])
            pct = _pct(score, max(l1, l2))
            idx = min(int(pct) // 4, len(VIRIDIS_COLORS) - 1)
            r, g, b = VIRIDIS_COLORS[idx]
            if color:
                cells.append(f"\x1b[38;2;{r};{g};{b}m■\x1b[0m")
            else:
                cells.append(f"{int(pct):3d}")
        lines.append(f"{j} " + " ".join(cells) + " ")
    return "\n".join(lines)


def print_similarity_matrix(matrix: np.ndarray) -> None:
    print(format_similarity_matrix(matrix))
