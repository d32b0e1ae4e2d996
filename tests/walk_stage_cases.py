"""Seeded bitmaps whose staged walks (K2, K4 and K11,
``csrc/traceback_walk.cu``) take the kernels' edge paths: gaps wider than
K11's lane window, the band's edges, starts on word-row boundaries, stop
cells, lane offsets and K2's block exits. The CPU tests
(``test_torch_walk_stage.py``), the card tests (``test_torch_cuda.py``) and
``chip_smoke.py`` walk them.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops.gotoh_banded import plan_streams
from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_STOP, DIR_SUB
from genomics_rs_tpu_torch.ops.walk_stage import BAND_ABOVE, BAND_LANES


def _pack_rows(codes: np.ndarray) -> np.ndarray:
    """(16 K, V) codes -> (K, V) int32 words, row t of a word at bits 2t."""
    K = codes.shape[0] // 16
    words = np.zeros((K, codes.shape[1]), np.uint32)
    for t in range(16):
        words |= codes[t::16].astype(np.uint32) << np.uint32(2 * t)
    return words.view(np.int32)


def band_path_bitmap(moves, m: int, n: int, V: int, geom: tuple[int, int] | None = None,
                     seed: int = 0) -> torch.Tensor:
    """A banded code bitmap (ceil(m/16), V) whose walk from ``(m, n)``
    spells ``moves`` (walk order, ending at the origin): the path's
    interior cells hold its codes, every other cell a random SUB, INS or
    DEL code. Raises ``ValueError`` for a path that leaves the band
    planned from ``geom`` (default ``(m, n)``) or misses the origin. Edge
    cases of K11 (wide gaps, band edges, word-row boundaries) are built
    with it."""
    gM, gN = geom or (m, n)
    offs, _, _ = plan_streams(gM, gN, V)
    KW = -(-m // 16)
    codes = np.random.default_rng(seed).integers(0, 3, (KW * 16, V))
    i, j = int(m), int(n)
    for c in moves:
        if i > 0 and j > 0:
            v = j - int(offs[i - 1]) - 1
            if not 0 <= v < V:
                raise ValueError(f"the path leaves the band at ({i}, {j}): lane {v}")
            codes[i - 1, v] = c
        elif c != (DIR_INS if i == 0 else DIR_DEL):
            raise ValueError(f"code {c} on the boundary at ({i}, {j})")
        i -= c != DIR_INS
        j -= c != DIR_DEL
    if (i, j) != (0, 0):
        raise ValueError(f"the path ends at ({i}, {j}), not the origin")
    return torch.from_numpy(_pack_rows(codes))


def diag_path_bitmap(moves, li: int, j: int, KW: int, V: int, seed: int = 0) -> torch.Tensor:
    """A diag16 code bitmap (KW, V) whose walk from ``(li, j)`` spells
    ``moves`` (walk order; a STOP code ends it), every other cell a
    random code. Built for K4's edge cases."""
    codes = np.random.default_rng(seed).integers(0, 4, (KW * 16, V))
    for c in moves:
        codes[li + j, li] = c
        if c == DIR_STOP:
            break
        li, j = max(li - (c != DIR_INS), 0), max(j - (c != DIR_DEL), 0)
    return torch.from_numpy(_pack_rows(codes))


def _band_program(m, n, V, geom, parts, ride=None):
    """Moves from ``(m, n)``: ``parts`` [(code, count), ...], then, with
    ``ride``, along the band's lane where the walk stands (SUB where the
    band slides, DEL where it does not), else down the diagonal, then the
    boundary's DEL or INS codes to the origin."""
    _, deltas, _ = plan_streams(*(geom or (m, n)), V)
    moves, i, j = [], m, n
    for c, count in parts:
        moves += [c] * count
        i -= count * (c != DIR_INS)
        j -= count * (c != DIR_DEL)
    while i > 0 and j > 0:
        c = DIR_DEL if ride and not deltas[i - 1] else DIR_SUB
        moves.append(c)
        i -= 1
        j -= c == DIR_SUB
    return moves + [DIR_DEL] * i + [DIR_INS] * j


#: K11's edge cases: (name, m, n, [(code, count), ...], ride the band's lane)
BAND_EDGE_SPECS = (
    ("insertion gap wider than the window", 3000, 2990,
     [(DIR_SUB, 600), (DIR_INS, BAND_LANES + 150), (DIR_SUB, 300)], False),
    ("deletion gap wider than the window", 3000, 2600,
     [(DIR_SUB, 500), (DIR_DEL, 2 * BAND_ABOVE + 200), (DIR_SUB, 300)], False),
    ("along the band's top edge", 2500, 2400, [], True),
    ("along the band's bottom edge", 2500, 2400, [(DIR_INS, 1023)], True),
    ("start on row 16k", 2048, 2040, [(DIR_SUB, 100), (DIR_INS, 3), (DIR_SUB, 90)], False),
    ("start on row 16k+1", 2049, 2040, [(DIR_DEL, 2), (DIR_SUB, 70)], False),
    ("start on row 16k+15", 2063, 2040, [(DIR_SUB, 15), (DIR_DEL, 17), (DIR_SUB, 33)], False),
)


def band_edge_walk(k: int, V: int = 1024):
    """K11's edge case ``k`` of :data:`BAND_EDGE_SPECS` as ``(name, dirs
    (KW, V), m, n)``, its window planned from its own ``(m, n)``: gaps
    wider than the lane window both ways, paths along both band edges,
    starts on word-row boundaries (rows 16k, 16k+1, 16k+15)."""
    name, m, n, parts, ride = BAND_EDGE_SPECS[k]
    moves = _band_program(m, n, V, None, parts, ride)
    return name, band_path_bitmap(moves, m, n, V, seed=k), m, n


def diag_edge_walks():
    """K4's edge cases as ``(name, dirs (KWT, V), walk_many's start_li,
    start_j, koffs, KW, max_steps, loffs)``, bitmaps (80, 640) for JAX's
    walker (V % 128 == 0): starts on word-row boundaries
    (k = 16q, 16q+1, 16q+15), a stop cell mid-path, lane offsets, runs of
    300 insertions and of 300 deletions, and a walk held at li = 0 by
    saturation."""
    KW, V = 80, 640
    rng = np.random.default_rng(7)

    def walk(li, j, parts, tail=DIR_SUB):
        moves = [c for c, count in parts for _ in range(count)]
        return moves + [tail] * (li + j)

    specs = [  # (name, li, j, loff, moves)
        ("start on k = 16q", 300, 500, 0, walk(300, 500, [(DIR_SUB, 40), (DIR_INS, 7)])),
        ("start on k = 16q+1", 301, 500, 0, walk(301, 500, [(DIR_DEL, 5), (DIR_SUB, 9)])),
        ("start on k = 16q+15", 315, 500, 3, walk(315, 500, [(DIR_SUB, 16), (DIR_DEL, 1)])),
        ("a stop cell mid-path", 400, 600, 0, [DIR_SUB] * 250 + [DIR_INS] * 20 + [DIR_STOP]),
        ("lane offset", 350, 700, 130, walk(350, 700, [(DIR_SUB, 200), (DIR_INS, 40)])),
        ("300 insertions", 200, 900, 0, walk(200, 900, [(DIR_SUB, 50), (DIR_INS, 300)])),
        ("300 deletions", 450, 500, 0, walk(450, 500, [(DIR_SUB, 20), (DIR_DEL, 300)])),
        ("held at li = 0", 100, 1000, 0, walk(100, 1000, [(DIR_SUB, 100)])),
    ]
    out = []
    for q, (name, li, j, loff, moves) in enumerate(specs):
        own = diag_path_bitmap(moves, li, j, KW, V - loff, seed=q)
        dirs = torch.from_numpy(rng.integers(0, 2**32, (KW, V), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32))
        dirs[:, loff:] = own
        out.append((name, dirs, [li], [j], [0], KW, 4096, [loff]))
    return out


def _exit_moves(rng, li: int, j: int, i0: int, j0: int) -> list:
    """A mostly-SUB random path from (li, j) up to the move that ends it:
    an exit of the block (i0 > 0, j0 > 0) or the origin."""
    moves = []
    while True:
        c = int(rng.choice(3, p=[0.8, 0.1, 0.1]))
        moves.append(c)
        ig, jn = max(i0 + li - (c != DIR_INS), 0), max(j - (c != DIR_DEL), 0)
        if (ig == 0 and jn == 0 and j0 == 0) or ig < i0 or (jn == 0 and j0 > 0):
            return moves
        li, j = max(ig - i0, 0), jn


def exit_walks():
    """K2's edge cases as ``(name, dirs (48, 256), start_li, start_j, i0,
    j0)`` (a shape JAX's ``walk_pallas`` takes): up exits (i0 > 0) in the
    middle of a SUB run, off lane 0 after an INS run held there and after a
    DEL run, left exits (j0 > 0) in a SUB run and in an INS run, a start on
    a window's column 0, both exits on one move (the up exit wins), stop
    cells (mid-path, on the first move), ``done`` at i0 = 1 and random
    mostly-SUB paths to an exit."""
    KW, V = 48, 256
    S, I, D, X = DIR_SUB, DIR_INS, DIR_DEL, DIR_STOP
    rng = np.random.default_rng(13)
    specs = [  # (name, li, j, i0, j0, moves)
        ("up exit in a SUB run", 5, 42, 40, 0, [S] * 6),
        ("up exit off lane 0 after an INS run", 0, 300, 40, 0, [I] * 37 + [S]),
        ("up exit after a DEL run", 20, 100, 40, 0, [S] * 3 + [D] * 18),
        ("left exit in a SUB run", 197, 10, 0, 512, [S] * 10),
        ("left exit in an INS run", 100, 9, 30, 512, [I] * 9),
        ("start on a window's column 0", 50, 0, 0, 512, [D]),
        ("both exits on one move", 0, 1, 40, 512, [S]),
        ("a stop cell mid-path", 150, 400, 64, 0, [S] * 40 + [I] * 5 + [X]),
        ("a stop on the first move", 10, 10, 0, 0, [X]),
        ("done at i0 = 1", 3, 4, 1, 0, [S] * 4),
        ("a random path to an up exit", 250, 500, 3, 0, _exit_moves(rng, 250, 500, 3, 0)),
        ("a random path to a left exit", 240, 200, 9, 1024, _exit_moves(rng, 240, 200, 9, 1024)),
        ("a random path to the origin", 200, 300, 0, 0, _exit_moves(rng, 200, 300, 0, 0)),
    ]
    return [(name, diag_path_bitmap(moves, li, j, KW, V, seed=q), li, j, i0, j0)
            for q, (name, li, j, i0, j0, moves) in enumerate(specs)]
