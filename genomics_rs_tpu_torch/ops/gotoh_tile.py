"""Boundary-injected Gotoh tile fill (counterpart of
``genomics_rs_tpu/ops/gotoh_tile.py``: ``TileResult``, ``tile_fill``,
``global_boundary_top`` and ``global_boundary_left``).

:func:`tile_fill` fills the interior of one (R+1) x (B+1) tile of the
table from its top row and left column, as an anti-diagonal loop over
R+1 lanes (lane ``iv`` holds tile row ``iv``; at step ``k`` it is at
tile column ``k - iv``), the JAX ``lax.scan`` step by step. It is the
plain version of the tile kernel K5
(``ops/gotoh_pallas.gotoh_tile_pallas``) and the unit of the
sequence-parallel pipeline (``parallel/longseq``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from genomics_rs_tpu_torch.ops.gotoh_scan import INT_MIN, NEG_INF
from genomics_rs_tpu_torch.ops.subst import encode_chars, kimura_active, sentinel, sub_score


class TileResult(NamedTuple):
    """bottom/right carry I/S/D stacked on axis 0 (order I, S, D).

    bottom: int32 (3, B+1): row R of the tile, columns 0..B.
    right:  int32 (3, R): column B of the tile, rows 1..R.
    best:   (value, i_global, j_global) 0-d int32 tensors: the keep-last
            argmax over the tile's true cells (boundaries included;
            larger value, then larger i, then larger j). A tile with no
            true cell gives (INT_MIN, i0 + R, j0 + B).
    at_mn:  0-d int32: the cell max at global (m, n) if it lies in this
            tile, else INT_MIN.
    """

    bottom: torch.Tensor
    right: torch.Tensor
    best: tuple
    at_mn: torch.Tensor


def tile_fill(s1t, s2t, top, left, scores, is_local: bool, i0, j0, m, n) -> TileResult:
    """Fill tile rows [i0+1, i0+R] x columns [j0+1, j0+B] of the table.

    ``s1t`` uint8 (R,) bases of rows i0+1..i0+R; ``s2t`` uint8 (B,) of
    columns j0+1..j0+B; ``top`` int32 (3, B+1) I/S/D at row i0, columns
    j0..j0+B (element 0 is the corner); ``left`` int32 (3, R) at column
    j0, rows i0+1..i0+R. A cell is true when ``i <= m`` and
    ``j0 + j <= n``. Runs on the tensors' device.
    """
    dev = s1t.device
    R, B = s1t.shape[0], s2t.shape[0]
    i0, j0, m, n = int(i0), int(j0), int(m), int(n)
    i32 = dict(dtype=torch.int32, device=dev)
    g, h = scores.g, scores.h
    hg = h + g
    st = scores.s_transition if kimura_active(scores) else None
    zero = 0 if is_local else NEG_INF

    iv = torch.arange(R + 1, **i32)
    ig = i0 + iv
    s1m = torch.cat([torch.full((1,), sentinel(0xFD, scores), **i32),
                     encode_chars(s1t, scores).to(torch.int32)])
    s2i = encode_chars(s2t, scores).to(torch.int32)
    top = top.to(device=dev, dtype=torch.int32)
    left = left.to(device=dev, dtype=torch.int32)
    negc = torch.full((3, 1), NEG_INF, **i32)
    X1 = torch.full((3, R + 1), NEG_INF, **i32)  # I/S/D of diagonal k-1
    X2 = X1.clone()  # ... and of diagonal k-2
    bv = torch.full((R + 1,), INT_MIN, **i32)
    bk = torch.zeros((R + 1,), **i32)
    at_mn = torch.tensor(INT_MIN, **i32)
    bottom = torch.empty((3, B + 1), **i32)
    right = torch.empty((3, R), **i32)
    mi, nj = m - i0, n - j0  # tile-local (m, n)
    row_ok = iv <= mi

    for k in range(R + B + 1):
        Xu = torch.cat([negc, X1[:, :-1]], 1)  # cell (i-1, j): diagonal k-1
        Xd = torch.cat([negc, X2[:, :-1]], 1)  # cell (i-1, j-1): diagonal k-2
        I = torch.clamp_min(torch.maximum(X1[0] + g, torch.maximum(X1[1], X1[2]) + hg), zero)
        D = torch.clamp_min(torch.maximum(torch.maximum(Xu[0], Xu[1]) + hg, Xu[2] + g), zero)
        s2j = s2i[(k - 1 - iv).clamp_(0, B - 1)] if B else torch.zeros_like(iv)
        S = sub_score(s1m, s2j, scores.s_match, scores.s_mismatch, st) + torch.clamp_min(
            Xd.amax(0), zero)
        X = torch.stack([I, S, D])
        # Lane 0 is the tile's top row (column k); lane k its left column.
        X[:, 0] = top[:, min(k, B)]
        if 1 <= k <= R:
            X[:, k] = left[:, k - 1]
        lo, hi = max(0, k - B), min(R, k)  # the lanes at tile columns 0..B
        X[:, :lo] = NEG_INF
        X[:, hi + 1 :] = NEG_INF

        cm = X.amax(0)
        if is_local:
            cm = torch.clamp_min(cm, 0)
        # Per-lane keep-last argmax over the true cells (global coords).
        true = row_ok & (iv >= lo) & (iv <= hi) & (iv >= k - nj)
        val = torch.where(true, cm, INT_MIN)
        upd = val >= bv
        bv = torch.where(upd, val, bv)
        bk = torch.where(upd, j0 + k - iv, bk)
        if k == mi + nj and 0 <= mi <= R and 0 <= nj <= B:
            at_mn = cm[mi]
        if k >= R:
            bottom[:, k - R] = X[:, R]
        if B + 1 <= k:
            right[:, k - B - 1] = X[:, k - B]
        X1, X2 = X, X1

    # Tile-level reduce with the reference tie-break: larger value, then
    # larger global i, then larger global j (every lane updated at step 0,
    # so a lane's i is its own row's).
    vmax = bv.max()
    i_best = torch.where(bv == vmax, ig, -1).max()
    j_best = torch.where((bv == vmax) & (ig == i_best), bk, -1).max()
    return TileResult(bottom=bottom, right=right, best=(vmax, i_best, j_best), at_mn=at_mn)


def global_boundary_top(j0: int, B: int, scores, device) -> torch.Tensor:
    """Row-0 I/S/D for columns j0..j0+B as (3, B+1) int32 on ``device``:
    the origin is 0, and row 0 has I = h + j*g, S = D = -inf."""
    js = int(j0) + torch.arange(B + 1, dtype=torch.int32, device=device)
    at0 = js == 0
    I = torch.where(at0, 0, scores.h + js * scores.g).to(torch.int32)
    S = torch.where(at0, 0, NEG_INF).to(torch.int32)
    return torch.stack([I, S, S.clone()])


def global_boundary_left(i0: int, R: int, scores, device) -> torch.Tensor:
    """Col-0 I/S/D for rows i0+1..i0+R as (3, R) int32 on ``device``."""
    i_ = int(i0) + 1 + torch.arange(R, dtype=torch.int32, device=device)
    neg = torch.full((R,), NEG_INF, dtype=torch.int32, device=device)
    D = (scores.h + i_ * scores.g).to(torch.int32)
    return torch.stack([neg, neg.clone(), D])
