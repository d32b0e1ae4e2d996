"""Batched Gotoh fill on the warp-strip pipeline (kernel K3; counterpart
of ``genomics_rs_tpu/ops/gotoh_stream.py``).

:func:`gotoh_scores_stream` and :func:`gotoh_stream_fill_dirs` keep the
contracts of their JAX namesakes: for a padded batch ``s1eb`` (B, Lm),
``s2eb`` (B, Ln) of uint8 byte codes with true lengths ``ms``/``ns``,
each pair's global score at ``(m, n)`` or its local keep-last row-major
argmax ``(v, i, j)``, and optionally each pair's packed direction codes.
On a CUDA tensor they launch ``csrc/gotoh_stream.cu``: every row strip of
:func:`stream_rows` rows is one warp's work in K9's warp-strip pipeline
(``csrc/gotoh_warp_pipe.cuh``), a pair's strips on many SMs, planned and
launched by ``gotoh_pallas.launch_groups``; on a CPU tensor they run
:func:`gotoh_stream_plain`.

The JAX kernel streams every pair through one V-lane wavefront and
keeps one global (Kp/16, V) word array; the port fills each pair's
strips on their own warps and keeps one bitmap a pair. So the layouts
differ and the contracts do not:

* ``dirs`` int32 ``(B, KW, V)``, ``KW = (Lm + Ln)/16 + 1``,
  ``V = lane_count(Lm)``: the code at cell ``(i, j)`` of pair ``p`` is
  ``(dirs[p, (i+j)//16, i] >> 2*((i+j)%16)) & 3`` (S > I > D > STOP),
  K1's layout, so K2 and K4 walk it as they walk K1's. Words outside a
  pair's true cells are zero from the kernel and unspecified from the
  plain version.
* The kernel computes only true cells, so it needs none of the JAX
  wrapper's fallbacks (B < 2, zero lengths, probe collisions, drift).
* The launch does not synchronise: :class:`StreamFill` carries the
  pipeline's error word, and the readers of the scores raise on it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp  # imports this module too
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
from genomics_rs_tpu_torch.utils.profiling import annotate

#: launches of the CUDA kernel / calls of the plain version.
COUNTS = {"kernel": 0, "plain": 0}
#: the strip height (32 x RT rows) of K3 and the matrix fill, but for
#: short buckets and scores-only buckets that fill twice as many rows
#: (:func:`stream_rows`); ``tools/time_fills.py --only sweep`` times every
#: height on the card (PERF.md).
STREAM_ROWS = 256


class StreamFill(NamedTuple):
    """Per-pair results, int32 tensors of shape (B,) on the fill's device:
    the global score at (m, n) with ``start = (m, n)``, or the local
    best with its start cell; ``dirs`` (B, KW, V) or None; ``err`` the
    kernel's error word (0-d int32, zero from the plain version), not
    read by the fill: whoever reads the scores calls
    ``gotoh_pallas.raise_on_err(err)`` (:class:`StreamDirsResult` and
    :func:`gotoh_scores_stream` do)."""

    score: torch.Tensor
    start_i: torch.Tensor
    start_j: torch.Tensor
    dirs: torch.Tensor | None
    err: torch.Tensor


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
    """``(score, start_i, start_j)``, int32 tensors of shape (B,), after
    reading the fill's error word (on the card, one synchronisation)."""
    out = gotoh_stream_fill(s1eb, s2eb, ms, ns, scores, is_local)
    gp.raise_on_err(out.err, "gotoh_stream")
    return out.score, out.start_i, out.start_j


class StreamDirsResult:
    """Scores, start cells (numpy, pair-local coordinates: ``(m, n)`` in
    global mode, the keep-last argmax in local mode) and the per-pair
    packed bitmaps ``dirs`` (B, KW, V) of a batched fill. Walk pair
    ``t`` with ``device_walk(res.segment_dirs(t), start_i[t],
    start_j[t], 0, max_steps)``, or every pair at once with
    ``walk_many`` over ``res.dirs.view(B * KW, V)`` at word-row offsets
    ``t * KW``. Raises if the fill's error word is set."""

    def __init__(self, fill: StreamFill):
        self.dirs = fill.dirs
        self.score = fill.score.cpu().numpy()
        self.start_i = fill.start_i.cpu().numpy()
        self.start_j = fill.start_j.cpu().numpy()
        gp.raise_on_err(fill.err, "batched fill")
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


def stream_rows(ms_h, ns_h, Lm: int, emit_dirs: bool) -> int:
    """The strip height (32 x RT rows) of K3 and the matrix fill for a
    bucket of padded ``Lm`` rows and true lengths ``ms_h``/``ns_h``:
    :data:`STREAM_ROWS`, or the least compiled height that holds the
    bucket's ``Lm + 1`` rows if that is lower; a scores-only bucket
    takes twice :data:`STREAM_ROWS` where the step model says its strips
    cost less there. The model, from the strip-height sweep on the card
    (PERF.md): a strip sweeps ``n + 32`` steps and a step costs ``4 + RT``
    (the shuffles and the hand-off, then RT cells), so a pair of ``s``
    strips costs ``s (n + 32) (4 + RT)``. With codes every bucket the
    sweep took was fastest at :data:`STREAM_ROWS`."""
    rows = gp.pipe_rows(Lm, STREAM_ROWS)
    if emit_dirs or rows < STREAM_ROWS or len(ms_h) == 0:
        return rows
    cols = np.asarray(ns_h, np.float64) + 32

    def cost(h: int) -> float:
        return float(np.sum(gp.strip_counts(ms_h, h) * cols)) * (4 + h // 32)

    return 2 * rows if cost(2 * rows) < cost(rows) else rows


def _stream_cuda(s1eb, s2eb, ms, ns, scores, is_local, emit_dirs=False, rows_per_strip=None,
                 max_blocks=None, spin_ns=None, counts=COUNTS, what="gotoh_stream") -> StreamFill:
    """Launch K3 on the warp-strip pipeline at strips of ``rows_per_strip``
    rows (a compiled height; default :func:`stream_rows`'s), one launch for
    each of ``gotoh_pallas.pipeline_groups``' pair ranges, each adding
    one to ``counts["kernel"]`` (default K3's :data:`COUNTS`; K8's route
    passes its own, and its name as ``what``); ``max_blocks`` caps the
    persistent grid (the card tests cycle tickets and ring slots with it),
    ``spin_ns`` bounds a wait that sees nothing of the launch move. Does
    not synchronise: the error word comes back in the result."""
    dev = s1eb.device
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel takes CUDA tensors, not {dev}")
    B, Lm = s1eb.shape
    Ln = s2eb.shape[1]
    with torch.cuda.device(dev):
        with annotate("genomics/gotoh_stream.plan"):
            _build.require(s1eb, "s1eb", torch.uint8, dev, (B, Lm))
            _build.require(s2eb, "s2eb", torch.uint8, dev, (B, Ln))
            ms_h, ns_h = _lengths(ms, ns, B, Lm, Ln)
            rows = (stream_rows(ms_h, ns_h, Lm, emit_dirs) if rows_per_strip is None
                    else int(rows_per_strip))
            gp.check_rows(rows, what)
            lib = _build.library()
            per_sm = gp.blocks_per_sm(lib.gotoh_stream_blocks_per_sm, rows // 32, int(is_local),
                                      int(emit_dirs))
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return run_stream(lib, s1eb, s2eb, ms_h, ns_h, scores, is_local, emit_dirs, rows,
                          gp.resident_blocks(per_sm, sms, max_blocks),
                          gp.SPIN_NS if spin_ns is None else spin_ns,
                          _build.stream_handle(dev), counts, what)


def run_stream(lib, s1eb, s2eb, ms_h, ns_h, scores, is_local, emit_dirs, rows, resident,
               spin_ns, stream, counts=COUNTS, what="gotoh_stream") -> StreamFill:
    """Plan and launch K3 over the batch's tensors (``gotoh_pallas.
    launch_groups``), adding one to ``counts["kernel"]`` a launch; returns
    the fill with its error word unread."""
    dev = s1eb.device
    B, Lm = s1eb.shape
    Ln = s2eb.shape[1]
    KW, V = dirs_shape(Lm, Ln)
    i32 = dict(dtype=torch.int32, device=dev)
    dirs = torch.zeros((B, KW, V), **i32) if emit_dirs else None
    res = torch.empty((B, 3), **i32)
    if B == 0:
        return StreamFill(res[:, 0], res[:, 1], res[:, 2], dirs, torch.zeros((), **i32))
    kim = kimura_active(scores)
    s1c = encode_chars(s1eb, scores).contiguous()
    s2c = encode_chars(s2eb, scores).contiguous()

    def launch(lo, hi, plan, work, ring, nlevels, total, blocks):
        return lib.gotoh_stream_launch(
            _build.ptr(s1c[lo:hi]), _build.ptr(s2c[lo:hi]), _build.ptr(plan),
            _build.ptr(work), _build.ptr(ring), _build.ptr(None if dirs is None else dirs[lo:hi]),
            _build.ptr(res[lo:hi]), hi - lo, Lm, Ln, V, KW, nlevels, total,
            scores.s_match, scores.s_mismatch, scores.s_transition if kim else 0, int(kim),
            scores.g, scores.h, int(is_local), rows // 32, blocks, int(spin_ns), stream,
        )

    err = gp.launch_groups(launch, ms_h, ns_h, Ln, rows, resident, dev, counts, what)
    return StreamFill(res[:, 0], res[:, 1], res[:, 2], dirs, err)


def gotoh_stream_plain(
    s1eb, s2eb, ms, ns, scores, is_local=False, emit_dirs=False, counts=COUNTS
) -> StreamFill:
    """The plain PyTorch version: K1's anti-diagonal step
    (``gotoh_rowblock_plain``) vectorised over the batch, state (B, V)
    with lane ``iv`` = row ``iv``, run to the batch's last true
    diagonal (:func:`wavefront_plain`), with the two-score or kimura
    substitution. Runs on the tensors' device; adds one to
    ``counts["plain"]`` (default K3's :data:`COUNTS`)."""
    counts["plain"] += 1
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

    no_err = torch.zeros((), **i32)
    if not is_local:
        fill = StreamFill(fin, m_col[:, 0] + i0, n_col[:, 0].clone(), dirs, no_err)
    else:
        vmax = bv.max(1).values
        tied = bv == vmax[:, None]
        i_best = torch.where(tied, iv, -1).max(1).values
        j_best = torch.where(tied & (iv == i_best[:, None]), bk, -1).max(1).values
        fill = StreamFill(vmax, (i_best + i0).to(torch.int32), j_best.to(torch.int32), dirs,
                          no_err)
    return (fill, bottom) if emit_bottom else fill
