"""Batched Gotoh fill, one pair per thread block (kernel K3; counterpart
of ``genomics_rs_tpu/ops/gotoh_stream.py``).

:func:`gotoh_scores_stream` and :func:`gotoh_stream_fill_dirs` keep the
contracts of their JAX namesakes: for a padded batch ``s1eb`` (B, Lm),
``s2eb`` (B, Ln) of uint8 byte codes with true lengths ``ms``/``ns``,
each pair's global score at ``(m, n)`` or its local keep-last row-major
argmax ``(v, i, j)``, and optionally each pair's packed direction codes.
On a CUDA tensor they launch ``csrc/gotoh_stream.cu``; on a CPU tensor
they run :func:`gotoh_stream_plain`.

The JAX kernel streams every pair through one V-lane wavefront and
keeps one global (Kp/16, V) word array; the port fills each pair in its
own thread block and its own bitmap. So the layouts differ and the
contracts do not:

* ``dirs`` int32 ``(B, KW, V)``, ``KW = (Lm + Ln)/16 + 1``,
  ``V = lane_count(Lm)``: the code at cell ``(i, j)`` of pair ``p`` is
  ``(dirs[p, (i+j)//16, i] >> 2*((i+j)%16)) & 3`` (S > I > D > STOP),
  K1's layout, so K2 and K4 walk it as they walk K1's. Words outside a
  pair's true cells are zero from the kernel and unspecified from the
  plain version.
* The kernel computes only true cells, so it needs none of the JAX
  wrapper's fallbacks (B < 2, zero lengths, probe collisions, drift).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops.gotoh_rowblock import PACK, _wrap_int32, lane_count
from genomics_rs_tpu_torch.ops.gotoh_scan import (
    DIR_DEL,
    DIR_INS,
    DIR_STOP,
    DIR_SUB,
    INT_MIN,
    NEG_INF,
)
from genomics_rs_tpu_torch.ops.subst import (
    encode_chars,
    kimura_active,
    sentinel,
    sub_score,
)
from genomics_rs_tpu_torch.sequence import round_up

#: launches of the CUDA kernel / calls of the plain version.
COUNTS = {"kernel": 0, "plain": 0}


class StreamFill(NamedTuple):
    """Per-pair results, int32 tensors of shape (B,) on the fill's device:
    the global score at (m, n) with ``start = (m, n)``, or the local
    best with its start cell; ``dirs`` (B, KW, V) or None."""

    score: torch.Tensor
    start_i: torch.Tensor
    start_j: torch.Tensor
    dirs: torch.Tensor | None


def dirs_shape(Lm: int, Ln: int) -> tuple[int, int]:
    """(KW, V) of one pair's bitmap in a (Lm, Ln) bucket."""
    return (Lm + Ln) // PACK + 1, lane_count(Lm)


def _lengths(ms, ns, B: int, Lm: int, Ln: int):
    ms = np.asarray(ms.cpu() if torch.is_tensor(ms) else ms, np.int64).reshape(-1)
    ns = np.asarray(ns.cpu() if torch.is_tensor(ns) else ns, np.int64).reshape(-1)
    if ms.shape != (B,) or ns.shape != (B,):
        raise ValueError(f"ms/ns must have shape ({B},)")
    if ms.min(initial=0) < 0 or ms.max(initial=0) > Lm or ns.min(initial=0) < 0 or ns.max(initial=0) > Ln:
        raise ValueError(f"lengths outside 0..({Lm}, {Ln})")
    return ms, ns


def gotoh_stream_fill(
    s1eb: torch.Tensor,
    s2eb: torch.Tensor,
    ms,
    ns,
    scores,
    is_local: bool = False,
    emit_dirs: bool = False,
) -> StreamFill:
    """Fill every pair of the batch. The device of ``s1eb`` picks the
    route: CUDA launches the kernel, CPU runs the plain version."""
    fn = _stream_cuda if _build.uses_kernel(s1eb) else gotoh_stream_plain
    return fn(s1eb, s2eb, ms, ns, scores, is_local, emit_dirs)


def gotoh_scores_stream(s1eb, s2eb, ms, ns, scores, is_local: bool = False):
    """``(score, start_i, start_j)``, int32 tensors of shape (B,)."""
    out = gotoh_stream_fill(s1eb, s2eb, ms, ns, scores, is_local)
    return out.score, out.start_i, out.start_j


class StreamDirsResult:
    """Scores, start cells (numpy, pair-local coordinates: ``(m, n)`` in
    global mode, the keep-last argmax in local mode) and the per-pair
    packed bitmaps ``dirs`` (B, KW, V) of a batched fill. Walk pair
    ``t`` with ``device_walk(res.segment_dirs(t), start_i[t],
    start_j[t], 0, max_steps)``, or every pair at once with
    ``walk_many`` over ``res.dirs.view(B * KW, V)`` at word-row offsets
    ``t * KW``."""

    def __init__(self, fill: StreamFill):
        self.dirs = fill.dirs
        self.score = fill.score.cpu().numpy()
        self.start_i = fill.start_i.cpu().numpy()
        self.start_j = fill.start_j.cpu().numpy()
        self.KW = fill.dirs.shape[1]

    def segment_dirs(self, t: int) -> torch.Tensor:
        """Pair ``t``'s (KW, V) bitmap (a view)."""
        return self.dirs[t]


def gotoh_stream_fill_dirs(
    s1eb, s2eb, ms, ns, scores, is_local: bool = False
) -> StreamDirsResult:
    """The batched fill with packed direction codes (the alignment
    counterpart of :func:`gotoh_scores_stream`)."""
    return StreamDirsResult(
        gotoh_stream_fill(s1eb, s2eb, ms, ns, scores, is_local, emit_dirs=True)
    )


def _stream_cuda(s1eb, s2eb, ms, ns, scores, is_local, emit_dirs=False) -> StreamFill:
    dev = s1eb.device
    if dev.type != "cuda":
        raise ValueError(f"the K3 kernel takes CUDA tensors, not {dev}")
    B, Lm = s1eb.shape
    Ln = s2eb.shape[1]
    _build.require(s1eb, "s1eb", torch.uint8, dev, (B, Lm))
    _build.require(s2eb, "s2eb", torch.uint8, dev, (B, Ln))
    ms_h, ns_h = _lengths(ms, ns, B, Lm, Ln)
    lib = _build.library()
    KW, V = dirs_shape(Lm, Ln)
    i32 = dict(dtype=torch.int32, device=dev)
    s1c = encode_chars(s1eb, scores).contiguous()
    s2c = encode_chars(s2eb, scores).contiguous()
    ms_d = torch.as_tensor(ms_h, dtype=torch.int32).to(dev)
    ns_d = torch.as_tensor(ns_h, dtype=torch.int32).to(dev)
    dirs = torch.zeros((B, KW, V), **i32) if emit_dirs else None
    res = torch.empty((B, 3), **i32)
    scratch = torch.empty((B, 4 * (Ln + 1)), **i32)
    threads = min(1024, round_up(Lm + 1, 32))
    kim = kimura_active(scores)
    with torch.cuda.device(dev):
        err = lib.gotoh_stream_launch(
            _build.ptr(s1c), _build.ptr(s2c), _build.ptr(ms_d), _build.ptr(ns_d),
            _build.ptr(dirs), _build.ptr(res), _build.ptr(scratch),
            B, Lm, Ln, V, KW,
            scores.s_match, scores.s_mismatch,
            scores.s_transition if kim else 0, int(kim),
            scores.g, scores.h, int(is_local), threads,
            _build.stream_handle(dev),
        )
    _build.check(err, "gotoh_stream")
    COUNTS["kernel"] += 1
    return StreamFill(res[:, 0], res[:, 1], res[:, 2], dirs)


def gotoh_stream_plain(
    s1eb, s2eb, ms, ns, scores, is_local=False, emit_dirs=False
) -> StreamFill:
    """The plain PyTorch version: K1's anti-diagonal step
    (``gotoh_rowblock_plain``) vectorised over the batch, state (B, V)
    with lane ``iv`` = row ``iv``, run to the batch's last true
    diagonal (:func:`wavefront_plain`), with the two-score or kimura
    substitution. Runs on the tensors' device."""
    COUNTS["plain"] += 1
    dev = s1eb.device
    B, Lm = s1eb.shape
    Ln = s2eb.shape[1]
    ms_h, ns_h = _lengths(ms, ns, B, Lm, Ln)
    V = lane_count(Lm)
    i32 = dict(dtype=torch.int32, device=dev)
    st = scores.s_transition if kimura_active(scores) else None
    s1m = torch.full((B, V), sentinel(0xFD, scores), **i32)
    s1m[:, 1 : Lm + 1] = encode_chars(s1eb, scores)
    s2c = encode_chars(s2eb, scores)
    s2pad = torch.full((B, 1), sentinel(0xFF, scores), **i32)
    s2j = torch.full((B, V), 0xFF, **i32)

    def sub_at(k: int) -> torch.Tensor:
        # The s2 character of lane iv's column j = k - iv shifts in at lane 0.
        nonlocal s2j
        inj = s2c[:, max(k - 1, 0) : max(k - 1, 0) + 1] if k - 1 < Ln else s2pad
        s2j = torch.cat([inj, s2j[:, :-1]], 1)
        return sub_score(s1m, s2j, scores.s_match, scores.s_mismatch, st)

    return wavefront_plain(sub_at, B, Lm, Ln, ms_h, ns_h, scores.g, scores.h,
                           is_local, emit_dirs, dev)


def wavefront_plain(sub_at, B: int, Lm: int, Ln: int, ms_h, ns_h, g: int, h: int,
                    is_local: bool, emit_dirs: bool, dev, i0: int = 0, V: int | None = None,
                    top=None, emit_bottom: bool = False):
    """The batched fill's plain body, shared by K3's and the matrix
    fill's plain versions: ``sub_at(k)`` gives the (B, V) int32
    substitution scores of anti-diagonal ``k`` (lane ``iv`` holds cell
    ``(i0 + iv, k - iv)``; any bounded value off the true cells). Lanes
    ahead of the wavefront and cells past a pair's (m, n) carry bounded
    garbage that no true cell reads, and the local argmax masks them
    out.

    A row strip (``gotoh_strips_plain``) runs the same step over ``V``
    lanes from row ``i0``: with ``top`` = (A, M) int32 (B, Ln + 1) of
    row ``i0`` (the strip above's bottom), lane 0 replays that row and
    lanes 1.. are the strip's rows; without it, lane 0 is row 0, the
    global top boundary. Results (the local best in global rows, the
    global score) cover the strip's own rows only; ``emit_bottom``
    returns ``(fill, (A, M))`` with lane ``V - 1``'s row."""
    if emit_dirs and top is not None:
        raise ValueError("dirs are emitted for whole tables only (no carried top row)")
    KW, V0 = dirs_shape(Lm, Ln)
    V = V0 if V is None else V
    lo = 0 if top is None else 1  # the first lane that is the strip's own row
    i32 = dict(dtype=torch.int32, device=dev)
    hg = g + h
    iv = torch.arange(V, **i32)[None, :]
    ms_loc = np.asarray(ms_h, np.int64) - i0
    m_col = torch.as_tensor(ms_loc, dtype=torch.int32).to(dev)[:, None]
    n_col = torch.as_tensor(ns_h, dtype=torch.int32).to(dev)[:, None]
    neg1 = torch.full((B, 1), NEG_INF, **i32)
    I = torch.full((B, V), NEG_INF, **i32)
    P, A, M, SM = I.clone(), I.clone(), I.clone(), I.clone()
    K = int((np.clip(ms_loc, 0, V - 1) + ns_h).max()) + 1 if B else 0
    if emit_bottom and B:
        K = max(K, V + int(np.max(ns_h)))
    probes: dict[int, list[int]] = {}
    for p in range(B):
        if lo <= ms_loc[p] < V:
            probes.setdefault(int(ms_loc[p] + ns_h[p]), []).append(p)
    fin = torch.full((B,), INT_MIN, **i32)
    bv = torch.full((B, V), INT_MIN, **i32)
    bk = torch.zeros((B, V), **i32)
    acc = torch.zeros((B, V), dtype=torch.int64, device=dev)
    dirs = torch.zeros((B, KW, V), **i32) if emit_dirs else None
    bottom = (torch.full((B, Ln + 1), NEG_INF, **i32),
              torch.full((B, Ln + 1), NEG_INF, **i32)) if emit_bottom else None

    for k in range(K):
        Dn = torch.cat([neg1, A[:, :-1]], 1)
        SMn = torch.cat([neg1, M[:, :-1]], 1)
        In = torch.maximum(I + g, P + hg)
        if is_local:
            In = torch.clamp_min(In, 0)
        # S adds the substitution to M of the up-left cell (shifted one
        # step ago); D takes the row above's open/extend value A.
        Sn = sub_at(k) + SM
        if k < V:  # column 0 of lane k
            In[:, k] = NEG_INF
            Sn[:, k] = NEG_INF
            Dn[:, k] = h + (i0 + k) * g
        Qn = torch.maximum(In, Sn)
        if top is None:
            # Row 0 is the global top boundary (corner 0).
            tI, tS = (0, 0) if k == 0 else (h + k * g, NEG_INF)
            Qn[:, 0] = max(tI, tS)
            Dn[:, 0] = tS
        Mn = torch.maximum(Qn, Dn)
        if is_local:
            Mn = torch.clamp_min(Mn, 0)

        if emit_dirs:
            Id = In.clone()
            Sd = Sn.clone()
            Id[:, 0], Sd[:, 0] = tI, tS
            code = torch.where(
                Mn == Sd,
                DIR_SUB,
                torch.where(Mn == Id, DIR_INS, torch.where(Mn == Dn, DIR_DEL, DIR_STOP)),
            ).to(torch.int64)
            sp = k % PACK
            acc = (code << (2 * sp)) if sp == 0 else acc | (code << (2 * sp))
            if sp == PACK - 1 or k == K - 1:
                dirs[:, k // PACK] = _wrap_int32(acc)

        if is_local:
            j = k - iv
            val = torch.where((iv >= lo) & (iv <= m_col) & (j >= 0) & (j <= n_col), Mn, INT_MIN)
            upd = val >= bv
            bv = torch.where(upd, val, bv)
            bk = torch.where(upd, j, bk)
        elif k in probes:
            idx = torch.tensor(probes[k], device=dev)
            fin[idx] = Mn[idx, m_col[idx, 0].long()]

        An = torch.maximum(Qn + hg, Dn + g)
        if is_local:
            An = torch.clamp_min(An, 0)
        if top is not None:  # lane 0 replays the carried row
            An[:, 0], Mn[:, 0] = (top[0][:, k], top[1][:, k]) if k <= Ln else (NEG_INF,) * 2
        if emit_bottom and 0 <= k - (V - 1) <= Ln:
            bottom[0][:, k - (V - 1)] = An[:, V - 1]
            bottom[1][:, k - (V - 1)] = Mn[:, V - 1]
        I, P, A, M, SM = In, torch.maximum(Sn, Dn), An, Mn, SMn

    if not is_local:
        fill = StreamFill(fin, m_col[:, 0] + i0, n_col[:, 0].clone(), dirs)
    else:
        vmax = bv.max(1).values
        tied = bv == vmax[:, None]
        i_best = torch.where(tied, iv, -1).max(1).values
        j_best = torch.where(tied & (iv == i_best[:, None]), bk, -1).max(1).values
        fill = StreamFill(vmax, (i_best + i0).to(torch.int32), j_best.to(torch.int32), dirs)
    return (fill, bottom) if emit_bottom else fill
