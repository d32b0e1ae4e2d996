"""Short-read batched Gotoh fill (kernel K6; counterpart of
``genomics_rs_tpu/ops/gotoh_shortread.py``).

:func:`gotoh_scores_shortread` keeps the contract of its JAX namesake:
for a padded batch ``s1b`` (B, L1), ``s2b`` (B, L2) of uint8 byte codes
(pad bytes of the two sides differ) with true lengths ``ms``/``ns`` >= 1,
each pair's global score at ``(m, n)`` or its local best, and with
``emit_dirs`` the per-pair direction words in the ``rows16`` layout:
``codes[b, i-1, (j-1)//16]`` holds the 2-bit codes (S > I > D > STOP) of
the interior cells ``(i, 16w+1 .. 16w+16)``, bits ``2*((j-1)%16)``. Local
ties go to the larger value, then the larger i, then the larger j; a best
<= 0 is the empty alignment, score 0 at ``(m, n)``.

On a CUDA tensor it launches ``csrc/gotoh_shortread.cu``: a sub-warp
wavefront, a group of :func:`group_size` lanes a pair, lane ``l`` holding
:func:`lane_rows` consecutive rows in registers and the lanes one column
apart, so no scan runs on any row; on a CPU tensor it runs
:func:`gotoh_shortread_plain`, the TPU kernel's row loop
(``_rowscan_body``) with its doubling (max,+) scan written as torch ops
over the batch.

Bounds of the contract (both routes): ``L2 <= SHORTREAD_MAX_LEN`` and a
multiple of 16, ``L1`` a multiple of 32 when codes are emitted (the JAX
kernel's row chunk), and every length >= 1 (the JAX kernel leaves empty
sequences to its caller). Codes hold every true cell (rows ``1..m``,
columns ``1..n``) of each pair; the kernel writes the words of rows
``1..m`` up to column ``n``'s (bits past ``n`` zero) and leaves the rest
zero, the plain version fills every column of the rows up to the batch's
longest ``m``.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops.gotoh_rowblock import _wrap_int32
from genomics_rs_tpu_torch.ops.gotoh_scan import (
    DIR_DEL,
    DIR_INS,
    DIR_STOP,
    DIR_SUB,
    INT_MIN,
    NEG_INF,
)
from genomics_rs_tpu_torch.ops.subst import encode_chars, kimura_active, sub_score

#: Longest padded sequence of the tier (the JAX kernel's bound), and the
#: short-read tier bound of the JAX router and of ``parallel/batch``.
SHORTREAD_MAX_LEN = 256
#: lanes a pair takes in the kernel (G), a power of two.
GROUP_SIZES = (8, 16, 32)
#: rows a lane holds (RT), one compiled kernel each (the switch of
#: ``gotoh_shortread_launch``); G x RT must reach the batch's longest ``m``.
LANE_ROWS = (4, 5, 8, 10, 16, 20, 32)
#: G by the batch's longest ``m``: ``(most rows, G)``, the first that holds
#: it. From the sweep of every G at the paths' shapes (``chip_smoke.py``
#: phase 14, ``tools/time_fills.py --only K6``; PERF.md): G = 8 (RT = 16
#: or 20) led or tied at 128 and 152 rows; at 256 rows G = 8 needs 32 rows
#: a lane, whose local kernel with codes spills, and G = 32 was fastest.
GROUP_BY_ROWS = ((160, 8), (256, 32))

#: launches of the CUDA kernel / calls of the plain version.
COUNTS = {"kernel": 0, "plain": 0}


def _check(s1b, s2b, ms, ns, emit_dirs: bool):
    if s1b.dim() != 2 or s2b.dim() != 2 or s1b.shape[0] != s2b.shape[0]:
        raise ValueError("s1b and s2b must be (B, L1) and (B, L2)")
    B, L1 = s1b.shape
    L2 = s2b.shape[1]
    if L2 % 16 or not 16 <= L2 <= SHORTREAD_MAX_LEN:
        raise ValueError(f"L2 = {L2}: K6 takes a multiple of 16 up to {SHORTREAD_MAX_LEN}")
    if emit_dirs and L1 % 32:
        raise ValueError(f"L1 = {L1} is not a multiple of the 32-row code chunk")
    ms = np.asarray(ms.cpu() if torch.is_tensor(ms) else ms, np.int64).reshape(-1)
    ns = np.asarray(ns.cpu() if torch.is_tensor(ns) else ns, np.int64).reshape(-1)
    if ms.shape != (B,) or ns.shape != (B,):
        raise ValueError(f"ms/ns must have shape ({B},)")
    if B and (ms.min() < 1 or ms.max() > L1 or ns.min() < 1 or ns.max() > L2):
        raise ValueError(f"lengths outside 1..({L1}, {L2})")
    return B, L1, L2, ms, ns


def group_size(rows: int) -> int:
    """Lanes a pair takes (G) for a batch whose longest first sequence
    has ``rows`` rows (:data:`GROUP_BY_ROWS`)."""
    return next((G for most, G in GROUP_BY_ROWS if rows <= most), GROUP_BY_ROWS[-1][1])


def lane_rows(rows: int, G: int) -> int:
    """Rows a lane holds (RT) at ``G`` lanes a pair: the least compiled
    RT (:data:`LANE_ROWS`) with ``G * RT >= rows``. Raises if none."""
    if G not in GROUP_SIZES:
        raise ValueError(f"K6: {G} lanes a pair is not one of {GROUP_SIZES}")
    rt = next((r for r in LANE_ROWS if G * r >= rows), None)
    if rt is None:
        raise ValueError(f"K6: {rows} rows pass {G} lanes of {LANE_ROWS[-1]} rows")
    return rt


def gotoh_scores_shortread(s1b, s2b, ms, ns, scores, is_local: bool,
                           emit_dirs: bool = False):
    """``(score, start_i, start_j)`` int32 tensors of shape (B,) on the
    fill's device, plus ``codes`` (B, L1, L2 // 16) int32 with
    ``emit_dirs``. The device of ``s1b`` picks the route."""
    fn = _shortread_cuda if _build.uses_kernel(s1b) else gotoh_shortread_plain
    return fn(s1b, s2b, ms, ns, scores, is_local, emit_dirs)


def _shortread_cuda(s1b, s2b, ms, ns, scores, is_local, emit_dirs=False, group=None):
    """Launch K6 at ``group`` lanes a pair (default :func:`group_size` of
    the batch's longest ``m``) and :func:`lane_rows` rows a lane."""
    dev = s1b.device
    if dev.type != "cuda":
        raise ValueError(f"the K6 kernel takes CUDA tensors, not {dev}")
    B, L1, L2, ms_h, ns_h = _check(s1b, s2b, ms, ns, emit_dirs)
    _build.require(s1b, "s1b", torch.uint8, dev, (B, L1))
    _build.require(s2b, "s2b", torch.uint8, dev, (B, L2))
    i32 = dict(dtype=torch.int32, device=dev)
    res = torch.empty((B, 3), **i32)
    codes = torch.zeros((B, L1, L2 // 16), **i32) if emit_dirs else None
    if B:
        rows = int(ms_h.max())
        G = group_size(rows) if group is None else int(group)
        RT = lane_rows(rows, G)
        lib = _build.library()
        s1c = encode_chars(s1b, scores).contiguous()
        s2c = encode_chars(s2b, scores).contiguous()
        ms_d = torch.as_tensor(ms_h, dtype=torch.int32).to(dev)
        ns_d = torch.as_tensor(ns_h, dtype=torch.int32).to(dev)
        kim = kimura_active(scores)
        with torch.cuda.device(dev):
            err = lib.gotoh_shortread_launch(
                _build.ptr(s1c), _build.ptr(s2c), _build.ptr(ms_d), _build.ptr(ns_d),
                _build.ptr(codes), _build.ptr(res),
                B, L1, L2, G, RT, scores.s_match, scores.s_mismatch,
                scores.s_transition if kim else 0, int(kim),
                scores.g, scores.h, int(is_local), _build.stream_handle(dev),
            )
        _build.check(err, "gotoh_shortread")
        COUNTS["kernel"] += 1
    out = (res[:, 0], res[:, 1], res[:, 2])
    return out + (codes,) if emit_dirs else out


def gotoh_shortread_plain(s1b, s2b, ms, ns, scores, is_local=False, emit_dirs=False):
    """The plain PyTorch version: ``_rowscan_body`` over the whole batch,
    state (B, L2), one step per row up to the batch's longest ``m``,
    the horizontal chain by the doubling (max,+) scan. Runs on the
    tensors' device."""
    COUNTS["plain"] += 1
    dev = s1b.device
    B, L1, L2, ms_h, ns_h = _check(s1b, s2b, ms, ns, emit_dirs)
    i32 = dict(dtype=torch.int32, device=dev)
    g, h = scores.g, scores.h
    hg = h + g
    st = scores.s_transition if kimura_active(scores) else None
    zero = 0 if is_local else NEG_INF
    W = L2 // 16

    s1c = encode_chars(s1b, scores)
    s2c = encode_chars(s2b, scores)
    m_col = torch.as_tensor(ms_h, dtype=torch.int32).to(dev)[:, None]
    n_col = torch.as_tensor(ns_h, dtype=torch.int32).to(dev)[:, None]
    jrow = torch.arange(1, L2 + 1, **i32)[None, :]
    rI = (h + jrow * g).expand(B, L2).clone()
    rS = torch.full((B, L2), NEG_INF, **i32)
    rD = rS.clone()
    fin = torch.full((B, L2), INT_MIN, **i32)
    bv = torch.full((B, L2), INT_MIN, **i32)
    bi = torch.zeros((B, L2), **i32)
    codes = torch.zeros((B, L1, W), **i32) if emit_dirs else None
    shifts = (2 * torch.arange(16, dtype=torch.int64, device=dev))[None, None, :]

    def shift_row(x, fill: int):
        """y[j] = x[j-1] along the columns; y[first] = fill."""
        return torch.cat([torch.full((B, 1), fill, **i32), x[:, :-1]], 1)

    for i in range(1, int(ms_h.max(initial=0)) + 1):
        Mp = torch.maximum(torch.maximum(rI, rS), rD)
        Mp_sh = shift_row(Mp, 0 if i == 1 else h + (i - 1) * g)
        Dn = torch.clamp_min(torch.maximum(torch.maximum(rI, rS) + hg, rD + g), zero)
        Sn = sub_score(s1c[:, i - 1 : i], s2c, scores.s_match, scores.s_mismatch, st) + (
            torch.clamp_min(Mp_sh, zero))
        N = torch.clamp_min(torch.maximum(Sn, Dn) + hg, zero)
        x = shift_row(N, max(h + i * g + hg, zero))
        d = 1
        while d < L2:
            r = torch.cat([torch.full((B, d), NEG_INF, **i32), x[:, :-d]], 1)
            x = torch.maximum(x, r + d * g)
            d *= 2
        In = x
        cm = torch.maximum(torch.maximum(In, Sn), Dn)
        if is_local:
            cm = torch.clamp_min(cm, 0)
            val = torch.where((i <= m_col) & (jrow <= n_col), cm, INT_MIN)
            upd = val >= bv
            bv = torch.where(upd, val, bv)
            bi = torch.where(upd, i, bi)
        fin = torch.where((i == m_col) & (jrow == n_col), cm, fin)
        if emit_dirs:
            code = torch.where(
                cm == Sn, DIR_SUB,
                torch.where(cm == In, DIR_INS, torch.where(cm == Dn, DIR_DEL, DIR_STOP)),
            ).to(torch.int64)
            codes[:, i - 1] = _wrap_int32((code.view(B, W, 16) << shifts).sum(2))
        rI, rS, rD = In, Sn, Dn

    ms_t, ns_t = m_col[:, 0].clone(), n_col[:, 0].clone()
    if is_local:
        vmax = bv.max(1).values
        tied = bv == vmax[:, None]
        i_best = torch.where(tied, bi, -1).max(1).values
        j_best = torch.where(tied & (bi == i_best[:, None]), jrow, -1).max(1).values
        empty = vmax <= 0
        out = (torch.clamp_min(vmax, 0).to(torch.int32),
               torch.where(empty, ms_t, i_best.to(torch.int32)),
               torch.where(empty, ns_t, j_best.to(torch.int32)))
    else:
        out = (fin.max(1).values, ms_t, ns_t)
    return out + (codes,) if emit_dirs else out
