"""The anti-diagonal Gotoh fill as a loop of torch ops (counterpart of
``genomics_rs_tpu/ops/gotoh_scan.py``: its constants, ``FillResult`` and
the ``lax.scan`` oracle ``gotoh_fill_scan``).

The three-matrix affine-gap DP (I/S/D = insert/substitute/delete) with
the reference's quirks: local mode's zero lane inside every predecessor
max, I<->D cross-transitions at gap-open cost, boundary rows at offset
"-inf" (``NEG_INF``), and the local start at the *last* argmax in
row-major order over the whole (m+1) x (n+1) table. One step fills one
anti-diagonal ``k``: lane ``i`` holds cell ``(i, k - i)``. The table is
padded (Lm, Ln); cells past the true lengths hold bounded garbage that
no true cell reads, and the score and argmax are masked to the true
region.

Direction codes encode the reference's retrace priority S > I > D:

    0 = substitute (diagonal), 1 = insert (left), 2 = delete (up),
    3 = stop (local zero cell)

:func:`gotoh_fill_scan_batch` runs B pairs in lockstep over a (B, Mp)
carry (what JAX gets by ``vmap``); :func:`gotoh_fill_scan` is its one-pair
form. Both run on the inputs' device, in int32 throughout, as a Python
loop of K = Lm + Ln + 1 steps with no synchronisation inside: the dirs
are preallocated and each step writes its codes in place. This is the
correctness oracle behind ``--engine scan``, not a fast path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genomics_rs_tpu_torch.ops.subst import encode_chars, kimura_active, sentinel

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
    """Output of a whole-table fill: the dirs, the score at the retrace
    start cell, and that cell (m, n for global; the keep-last row-major
    argmax for local). The row-block fill gives packed dirs and ints;
    the scan gives uint8 (K, Mp) dirs, diag-major (``dirs[i + j, i]`` is
    the code of cell (i, j)), and 0-d int32 tensors, or with a batch
    dimension in front from :func:`gotoh_fill_scan_batch`."""

    dirs: object
    score: object
    start_i: object
    start_j: object


def _lengths(x, B: int, dev) -> torch.Tensor:
    """True lengths as an int32 (B, 1) tensor on ``dev``."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x, dtype=np.int32).reshape(-1))
    return x.to(device=dev, dtype=torch.int32).reshape(B, 1)


def gotoh_fill_scan_batch(s1eb: torch.Tensor, s2eb: torch.Tensor, ms, ns, scores,
                          is_local: bool, emit_dirs: bool = True,
                          subst_lut=None) -> FillResult:
    """Fill B padded tables by anti-diagonals, on the device of ``s1eb``.

    ``s1eb``/``s2eb``: uint8 (B, Lm) / (B, Ln) byte batches (pad values of
    the two sides must differ, as ``PAD_S1``/``PAD_S2`` do); ``ms``/``ns``:
    true lengths (B,). ``subst_lut``: optional (256, 256) int32 byte-pair
    score table (``SubstMatrix.byte_lut()``), which replaces the
    match/mismatch/transition scores and excludes ``s_transition``.
    Returns a :class:`FillResult` of (B, K, Mp) uint8 dirs (``None``
    without ``emit_dirs``) and (B,) int32 score, start_i, start_j.
    """
    if subst_lut is not None and kimura_active(scores):
        raise ValueError(
            "subst_lut and scores.s_transition are mutually exclusive "
            "(a full matrix already fixes every pair's score)"
        )
    dev = s1eb.device
    B, Lm = s1eb.shape
    Ln = s2eb.shape[1]
    if Lm < 1 or Ln < 1:
        raise ValueError(f"padded lengths must be >= 1, not ({Lm}, {Ln})")
    Mp = Lm + 1
    K = Lm + Ln + 1
    i32 = dict(dtype=torch.int32, device=dev)
    g, h = int(scores.g), int(scores.h)
    hg = h + g
    zl = 0 if is_local else NEG_INF
    m_col = _lengths(ms, B, dev)
    n_col = _lengths(ns, B, dev)
    iv = torch.arange(Mp, **i32)

    # s1m[:, i] = s1[i-1] (the base consumed entering row i); lane 0 unused.
    s1m = torch.cat([torch.full((B, 1), sentinel(0xFD, scores), **i32),
                     encode_chars(s1eb, scores)], 1)
    s2i = encode_chars(s2eb, scores)
    if subst_lut is not None:
        lut = torch.as_tensor(np.asarray(subst_lut, np.int32)).to(dev).reshape(-1)
        row = s1m.long() * 256
    st = int(scores.s_transition) if kimura_active(scores) else None
    sm, sx = int(scores.s_match), int(scores.s_mismatch)

    neg = torch.full((B, Mp), NEG_INF, **i32)
    neg1 = neg[:, :1]
    I1, S1, D1 = neg, neg, neg
    # shift(max(I, S, D)) of the last two diagonals: S reads the diagonal
    # k - 2 predecessor (i - 1, j - 1).
    up1, up2 = neg, neg
    s2j = s2i[:, :1].expand(B, Mp)  # clip(k - 1 - i) = 0 before the first step
    dirs = torch.empty((B, K, Mp), dtype=torch.uint8, device=dev) if emit_dirs else None
    if is_local:
        vk = torch.empty((K, B), **i32)  # per diagonal: the max over true cells
        ik = torch.empty((K, B), **i32)  # and the largest row holding it
    else:
        at = torch.empty((K, B), **i32)  # per diagonal: the cell max in row m
        m_idx = m_col.long()

    for k in range(K):
        # Lane i's s2 character is s2[k - 1 - i] (clipped): lane 0 takes
        # the new one, the rest shift down from the last diagonal.
        s2j = torch.cat([s2i[:, min(max(k - 1, 0), Ln - 1)][:, None], s2j[:, :-1]], 1)
        if subst_lut is not None:
            sub = lut[row + s2j]
        elif st is None:
            sub = torch.where(s1m == s2j, sm, sx).to(torch.int32)
        else:
            sub = torch.where(s1m == s2j, sm,
                              torch.where((s1m ^ s2j) == 2, st, sx)).to(torch.int32)

        # I(i, j) from (i, j-1) = this lane of diagonal k - 1; D(i, j)
        # from (i-1, j) = the lane above; S from (i-1, j-1) on k - 2.
        In = torch.maximum(I1 + g, torch.maximum(S1, D1) + hg).clamp_min(zl)
        Dn = torch.maximum(torch.cat([neg1, torch.maximum(I1, S1)[:, :-1]], 1) + hg,
                           torch.cat([neg1, D1[:, :-1]], 1) + g).clamp_min(zl)
        Sn = sub + up2.clamp_min(zl)

        # Boundaries: the origin, row 0 (I = h + j*g), column 0 (D = h +
        # i*g) and the lanes off the table (j < 0 or j > Ln).
        if k == 0:
            In[:, 0], Sn[:, 0], Dn[:, 0] = 0, 0, 0
            In[:, 1:], Sn[:, 1:], Dn[:, 1:] = NEG_INF, NEG_INF, NEG_INF
        else:
            In[:, 0] = h + k * g if k <= Ln else NEG_INF
            Sn[:, 0], Dn[:, 0] = NEG_INF, NEG_INF
            if k <= Lm:
                In[:, k], Sn[:, k], Dn[:, k] = NEG_INF, NEG_INF, h + k * g
            lo = max(0, k - Ln)
            if lo > 0:
                In[:, :lo], Sn[:, :lo], Dn[:, :lo] = NEG_INF, NEG_INF, NEG_INF
            if k + 1 < Mp:
                In[:, k + 1 :], Sn[:, k + 1 :], Dn[:, k + 1 :] = NEG_INF, NEG_INF, NEG_INF

        cm = torch.maximum(torch.maximum(In, Sn), Dn)
        up = torch.cat([neg1, cm[:, :-1]], 1)
        if is_local:
            cm = cm.clamp_min(0)
        if emit_dirs:
            dirs[:, k] = torch.where(
                cm == Sn, DIR_SUB,
                torch.where(cm == In, DIR_INS, torch.where(cm == Dn, DIR_DEL, DIR_STOP)))
        if is_local:
            # The true cells of diagonal k: i <= m, j = k - i in 0..n.
            true = (iv <= m_col) & (iv <= k) & (iv >= k - n_col)
            val = torch.where(true, cm, INT_MIN)
            vmax = val.amax(1)
            vk[k] = vmax
            ik[k] = torch.where(val == vmax[:, None], iv, -1).amax(1)
        else:
            at[k] = cm.gather(1, m_idx)[:, 0]
        I1, S1, D1 = In, Sn, Dn
        up2, up1 = up1, up

    if is_local:
        # Keep-last row-major argmax: the largest value, then the largest
        # row, then the largest column (a later diagonal at that row).
        bv = vk.amax(0)
        on = vk == bv[None]
        bi = torch.where(on, ik, -1).amax(0)
        kk = torch.arange(K, **i32)[:, None]
        bj = torch.where(on & (ik == bi[None]), kk - ik, -1).amax(0)
        return FillResult(dirs, bv, bi, bj)
    score = at.gather(0, (m_col + n_col).long().reshape(1, B))[0]
    return FillResult(dirs, score, m_col[:, 0].clone(), n_col[:, 0].clone())


def gotoh_fill_scan(s1e: torch.Tensor, s2e: torch.Tensor, m, n, scores, is_local: bool,
                    emit_dirs: bool = True, subst_lut=None) -> FillResult:
    """Fill one (m+1) x (n+1) table: :func:`gotoh_fill_scan_batch` at B = 1.
    ``s1e``/``s2e`` are uint8 (Lm,) / (Ln,) on the fill's device. Returns
    (K, Mp) uint8 dirs (a (0, 0) placeholder without ``emit_dirs``) and
    0-d int32 score, start_i, start_j."""
    res = gotoh_fill_scan_batch(s1e[None], s2e[None], [int(m)], [int(n)], scores, is_local,
                                emit_dirs, subst_lut)
    dirs = (res.dirs[0] if emit_dirs
            else torch.zeros((0, 0), dtype=torch.uint8, device=s1e.device))
    return FillResult(dirs, res.score[0], res.start_i[0], res.start_j[0])
