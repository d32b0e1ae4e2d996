"""Full-width row-block Gotoh fill (kernel K1; counterpart of
``genomics_rs_tpu/ops/gotoh_rowblock.py``).

:func:`gotoh_rowblock` fills rows ``i0+1 .. i0+R`` of the alignment
table over columns ``0 .. B`` from the row-``i0`` boundary ``top``, with
the contract of ``gotoh_rowblock_pallas``: the score at ``(m, n)`` when
row ``m`` falls in the block, the local keep-last row-major argmax, and
optionally the packed direction codes, the bottom row and the stride-V
column checkpoints. On a CUDA tensor it launches the hand-written
kernel in ``csrc/gotoh_rowblock.cu``, a strip pipeline over many SMs
(:func:`block_plan` sizes it on the host); on a CPU tensor it runs
:func:`gotoh_rowblock_plain`.

The result carries the launch's error word (``TileFillResult.err``, a
0-d int32 tensor; always 0 on the CPU route). It is set when a pipeline
wait saw nothing of the launch move for :data:`SPIN_NS` (a hang, not a
long wait behind running strips), and then no other output holds: a caller reads it
with its own first read of the result and calls :func:`raise_on_err`, so
no launch synchronises the host.

Layouts kept from the JAX package so the two can be compared and mixed:

* ``V = max(round_up(R+1, 1024), 1024)`` lanes (rows ``0..R`` of the
  block), ``K = R + B + 1`` diagonals, ``Kp = round_up(K, 256)``;
* ``dirs`` int32 ``(Kp/16, V)``: the code at block cell ``(li, j)`` is
  ``(dirs[(li+j)//16, li] >> 2*((li+j)%16)) & 3`` (S > I > D > STOP);
* ``cols`` int32 ``(NC, 3, V)``, ``NC = ceil(Kp/V)``: ``cols[c, :, v]``
  holds I/S/D at ``(i0+v, c*V)``; lane 0 and columns past ``n`` are
  never consumed;
* ``bottom`` int32 ``(3, B+1)``: I/S/D of row ``i0+R``.

With ``left`` (3, R), the column-0 boundary of rows ``i0+1..i0+R`` is
streamed in instead of computed; ``s2e``/``n``/``top`` are then
window-local while ``m``/``i0`` stay global.

Codes and scores must hold bit-exactly: the local zero floor sits
inside every predecessor max, I<->D cross-transitions cost a gap open,
"-inf" is ``-2**30`` in int32, and codes are chosen by equality.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from genomics_rs_tpu_torch.ops import _build
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
from genomics_rs_tpu_torch.utils.profiling import annotate

#: diagonal padding quantum (``Kp``), kept from the JAX kernel so packed
#: bitmaps have the same shape in both packages.
CHUNK = 256
#: codes per packed int32 word.
PACK = 16

#: launches of the CUDA kernel / calls of the plain version.
COUNTS = {"kernel": 0, "plain": 0}
#: rows of a pipeline strip (threads of a block); ``chip_smoke.py`` phase 5
#: times the fill at 128, 256 and 512.
PIPE_ROWS = 256
#: ints of the kernel's workspace before its per-strip arrays: res[4],
#: ticket, error word, finished strips, heartbeat (``WORK_HEAD`` in the
#: source).
WORK_HEAD = 8
#: ns a pipeline wait may see nothing of the launch move before it sets
#: the error word (``SPIN_NS`` in the source).
SPIN_NS = 10_000_000_000
#: the error word's index in the workspace.
ERR_INDEX = 5


class TileFillResult(NamedTuple):
    """``score_at_mn`` and ``best`` are 0-d int32 tensors on the fill's
    device (``best`` = (v, i, j) in global coordinates; (INT_MIN, 0, 0)
    in global mode); the optional outputs are ``None`` when not asked
    for."""

    dirs: torch.Tensor | None
    score_at_mn: torch.Tensor
    best: tuple
    bottom: torch.Tensor | None
    cols: torch.Tensor | None
    #: I/S/D of the block's last column (rows 1..R), the tile kernel's
    #: ``emit_right`` (K5; ``ops/gotoh_pallas.gotoh_tile_pallas``).
    right: torch.Tensor | None = None
    #: the launch's error word (0-d int32; nonzero: a pipeline wait saw
    #: nothing move for its bound and no output holds). See
    #: :func:`raise_on_err`.
    err: torch.Tensor | None = None


class BlockPlan(NamedTuple):
    """The host's plan of one pipelined block fill (the kernel's
    arguments; nothing is copied to the device for it)."""

    rows: int  # T: rows of a strip, threads of a block
    strips: int  # ceil((R + 1) / T)
    slots: int  # ring slots of 2 x (B + 1) int32
    blocks: int  # persistent blocks of the grid

    @property
    def work_ints(self) -> int:
        return WORK_HEAD + 5 * self.strips


def strip_rows(R: int, rows: int = PIPE_ROWS) -> int:
    """The strip height for a block of ``R`` rows: ``rows``, or fewer
    for a shorter block (a multiple of 32, at least one warp)."""
    return min(int(rows), round_up(R + 1, 32))


def block_plan(R: int, B: int, rows: int, resident: int) -> BlockPlan:
    """Plan one block's pipeline: strips of ``rows`` rows (a multiple of
    32), as many persistent blocks as strips up to ``resident``, and
    ``min(strips - 1, k)`` ring slots with ``k`` from 2 (a strip never
    writes the slot its successor still reads) up to ``blocks + 1`` (no
    more strips run at once), as many as ``gotoh_pallas.RING_BYTES``
    holds at ``B + 1`` columns (``ring_budget``). Raises ``ValueError``
    when two slots do not fit."""
    from genomics_rs_tpu_torch.ops import gotoh_pallas as gp

    if rows < 32 or rows % 32 or rows > 1024:
        raise ValueError(f"gotoh_rowblock: {rows} rows a strip (a multiple of 32 up to 1024)")
    strips = (R + rows) // rows
    blocks = max(1, min(strips, int(resident)))
    need = min(strips - 1, 2)
    budget = gp.ring_budget(B, gp.RING_BYTES)
    if budget < need:
        raise ValueError(f"gotoh_rowblock: {need} ring slots of {B + 1} columns pass RING_BYTES")
    return BlockPlan(rows, strips, min(strips - 1, max(2, min(blocks + 1, budget))), blocks)


def raise_on_err(err) -> None:
    """Raise if a pipeline's error word (read on the host) is set."""
    with annotate("genomics/gotoh_rowblock.wait"):
        err = int(err)
    if err != 0:
        raise RuntimeError("gotoh_rowblock: a strip pipeline wait passed its bound")


def lane_count(R: int) -> int:
    """Lanes ``V`` of a block of ``R`` rows (also the column-checkpoint
    stride)."""
    return max(round_up(R + 1, 1024), 1024)


def _shapes(R: int, B: int):
    V = lane_count(R)
    K = R + B + 1
    Kp = round_up(K, CHUNK)
    NC = -(-Kp // V)
    return V, K, Kp, NC


def gotoh_rowblock(
    s1_block: torch.Tensor,
    s2e: torch.Tensor,
    top: torch.Tensor,
    m: int,
    n: int,
    i0: int,
    scores,
    is_local: bool,
    emit_dirs: bool = False,
    emit_bottom: bool = True,
    emit_cols: bool = False,
    left: torch.Tensor | None = None,
) -> TileFillResult:
    """Fill one row block (see the module docstring for the contract).

    ``s1_block`` (R,) and ``s2e`` (B,) are uint8 byte codes, ``top``
    int32 (3, B+1), ``left`` int32 (3, R) or None. The device of
    ``s1_block`` picks the route: CUDA launches the kernel, CPU runs
    the plain version.
    """
    if _build.uses_kernel(s1_block):
        return launch(s1_block, s2e, top, left, m, n, i0, 0, scores, is_local,
                      emit_dirs, emit_bottom, emit_cols, False, False, COUNTS)
    return gotoh_rowblock_plain(
        s1_block, s2e, top, m, n, i0, scores, is_local,
        emit_dirs=emit_dirs, emit_bottom=emit_bottom,
        emit_cols=emit_cols, left=left,
    )


#: persistent blocks an SM holds, by (device, rows, local, tile).
_PER_SM: dict = {}


def _resident(lib, dev: torch.device, rows: int, is_local: bool, tile: bool) -> int:
    """Blocks of ``rows`` threads the card holds at once for the kernel's
    instantiation (cached: an occupancy query, no synchronisation)."""
    key = (dev.index, rows, bool(is_local), bool(tile))
    if key not in _PER_SM:
        with torch.cuda.device(dev):
            per_sm = lib.gotoh_rowblock_blocks_per_sm(rows, int(is_local), int(tile))
        if per_sm < 1:
            raise RuntimeError(f"gotoh_rowblock: no block of {rows} threads fits an SM ({per_sm})")
        _PER_SM[key] = per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    return _PER_SM[key]


def _workspace(plan: BlockPlan, dev: torch.device) -> torch.Tensor:
    """The kernel's zeroed workspace: res[4], ticket, error word, finished,
    heartbeat, then progress, released and the strips' bests."""
    return torch.zeros(plan.work_ints, dtype=torch.int32, device=dev)


def launch(s1_block, s2e, top, left, m, n, i0, j0, scores, is_local, emit_dirs,
           emit_bottom, emit_cols, emit_right, tile, counts, rows=PIPE_ROWS,
           max_blocks=None, spin_ns=SPIN_NS) -> TileFillResult:
    """Launch ``csrc/gotoh_rowblock.cu`` on the tensors' CUDA device and
    add one to ``counts["kernel"]`` (K1's count, or K5's for
    ``ops/gotoh_pallas.gotoh_tile_pallas``). ``j0`` is the block's global
    column offset; ``tile`` tracks the argmax in global mode too;
    ``emit_right`` returns column B's I/S/D as ``right`` (3, R). Strips
    hold :func:`strip_rows` ``(R, rows)`` rows; ``max_blocks`` caps the
    persistent grid below what the card holds (the card tests cycle
    tickets and ring slots with it); ``spin_ns`` bounds a pipeline wait
    that sees nothing move. Nothing here waits for the device: the error
    word comes back in the result."""
    lib = _build.library()
    dev = s1_block.device
    if dev.type != "cuda":
        raise ValueError(f"the row-block kernel takes CUDA tensors, not {dev}")
    R, B = s1_block.shape[0], s2e.shape[0]
    V, K, Kp, NC = _shapes(R, B)
    _build.require(s1_block, "s1_block", torch.uint8, dev, (R,))
    _build.require(s2e, "s2e", torch.uint8, dev, (B,))
    _build.require(top, "top", torch.int32, dev, (3, B + 1))
    if left is not None:
        _build.require(left, "left", torch.int32, dev, (3, R))
    with annotate("genomics/gotoh_rowblock.plan"):
        T = strip_rows(R, rows)
        resident = _resident(lib, dev, T, is_local, tile)
        if max_blocks is not None:
            resident = min(resident, int(max_blocks))
        plan = block_plan(R, B, T, resident)
        i32 = dict(dtype=torch.int32, device=dev)
        s1c = encode_chars(s1_block, scores).contiguous()
        s2c = encode_chars(s2e, scores).contiguous()
        dirs = torch.empty((Kp // PACK, V), **i32) if emit_dirs else None
        bottom = torch.empty((3, B + 1), **i32) if emit_bottom else None
        cols = torch.empty((NC, 3, V), **i32) if emit_cols else None
        right = torch.empty((3, R), **i32) if emit_right else None
        work = _workspace(plan, dev)
        ring = torch.empty(max(plan.slots, 1) * 2 * (B + 1), **i32)
        kim = kimura_active(scores)
    with torch.cuda.device(dev), annotate("genomics/gotoh_rowblock.launch"):
        err = lib.gotoh_rowblock_launch(
            _build.ptr(s1c), _build.ptr(s2c), _build.ptr(top),
            _build.ptr(left), _build.ptr(dirs), _build.ptr(bottom),
            _build.ptr(cols), _build.ptr(right), _build.ptr(work), _build.ptr(ring),
            R, B, V, int(m), int(n), int(i0), int(j0), int(tile),
            scores.s_match, scores.s_mismatch,
            scores.s_transition if kim else 0, int(kim),
            scores.g, scores.h, int(is_local), T, plan.blocks, plan.strips, plan.slots,
            int(spin_ns), _build.stream_handle(dev),
        )
    _build.check(err, "gotoh_rowblock")
    counts["kernel"] += 1
    return TileFillResult(
        dirs=dirs,
        score_at_mn=work[0],
        best=(work[1], work[2], work[3]),
        bottom=bottom,
        cols=cols,
        right=right,
        err=work[ERR_INDEX],
    )


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32 code bits -> the int32 with the same bits."""
    return (((x + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def gotoh_rowblock_plain(
    s1_block, s2e, top, m, n, i0, scores, is_local,
    emit_dirs=False, emit_bottom=True, emit_cols=False, left=None,
) -> TileFillResult:
    """The plain PyTorch version of the fill: an anti-diagonal loop over
    ``V`` lanes (lane ``iv`` = block row ``iv``; at diagonal ``k`` it
    holds cell ``(iv, k - iv)``), the same step as the TPU kernel's.
    Lanes ahead of the wavefront and columns past ``B`` carry bounded
    garbage that no true cell reads."""
    COUNTS["plain"] += 1
    dev = s1_block.device
    R, B = s1_block.shape[0], s2e.shape[0]
    V, K, Kp, NC = _shapes(R, B)
    m, n, i0 = int(m), int(n), int(i0)
    i32 = dict(dtype=torch.int32, device=dev)
    g, h = scores.g, scores.h
    hg = g + h
    st = scores.s_transition if kimura_active(scores) else None

    s1m = torch.full((V,), sentinel(0xFD, scores), **i32)
    s1m[1 : R + 1] = encode_chars(s1_block, scores)
    s2c = encode_chars(s2e, scores).tolist()
    s2pad = sentinel(0xFF, scores)
    topI, topS, topD = top.to(torch.int32).tolist()
    if left is not None:
        leftI, leftS, leftD = left.to(torch.int32).tolist()

    iv = torch.arange(V, **i32)
    neg1 = torch.full((1,), NEG_INF, **i32)
    I = torch.full((V,), NEG_INF, **i32)
    P, A, M, SM = I.clone(), I.clone(), I.clone(), I.clone()
    s2j = torch.full((V,), 0xFF, **i32)
    mi0 = m - i0
    le_r = iv <= R
    lem = (iv <= mi0) & le_r
    probe_in = 0 <= mi0 <= R
    fin = INT_MIN
    bv = torch.full((V,), INT_MIN, **i32)
    bk = torch.zeros(V, **i32)
    acc = torch.zeros(V, dtype=torch.int64, device=dev)
    dirs = torch.zeros((Kp // PACK, V), **i32) if emit_dirs else None
    bottom = torch.empty((3, B + 1), **i32) if emit_bottom else None
    cols = torch.full((NC, 3, V), NEG_INF, **i32) if emit_cols else None
    cap = torch.full((3, V), NEG_INF, **i32) if emit_cols else None

    for k in range(K):
        inj = s2c[max(k - 1, 0)] if k - 1 < B else s2pad
        s2j = torch.cat([s2j.new_full((1,), inj), s2j[:-1]])
        # Pre-shift carries: D' = shift(A) of the row above; S' adds the
        # substitution to M of the up-left cell (M shifted one step ago).
        Dn = torch.cat([neg1, A[:-1]])
        SMn = torch.cat([neg1, M[:-1]])
        In = torch.maximum(I + g, P + hg)
        if is_local:
            In = torch.clamp_min(In, 0)
        Sn = sub_score(s1m, s2j, scores.s_match, scores.s_mismatch, st) + SM
        if k < V:  # column 0 of lane k
            if left is not None:
                if 1 <= k <= R:
                    In[k], Sn[k], Dn[k] = leftI[k - 1], leftS[k - 1], leftD[k - 1]
                else:
                    In[k] = Sn[k] = Dn[k] = NEG_INF
            else:
                In[k] = NEG_INF
                Sn[k] = NEG_INF
                Dn[k] = h + (i0 + k) * g
        Qn = torch.maximum(In, Sn)
        # Row 0 is the top boundary.
        tI, tS, tD = (
            (topI[k], topS[k], topD[k]) if k <= B else (NEG_INF,) * 3
        )
        Qn[0] = max(tI, tS)
        Dn[0] = tD
        Mn = torch.maximum(Qn, Dn)
        if is_local:
            Mn = torch.clamp_min(Mn, 0)

        if emit_cols:
            v = k % V
            cap[0, v], cap[1, v], cap[2, v] = In[v], Sn[v], Dn[v]
            if v == V - 1 or k == K - 1:
                cols[k // V] = cap

        if emit_dirs:
            Id = In.clone()
            Sd = Sn.clone()
            Id[0], Sd[0] = tI, tS
            code = torch.where(
                Mn == Sd,
                DIR_SUB,
                torch.where(
                    Mn == Id, DIR_INS, torch.where(Mn == Dn, DIR_DEL, DIR_STOP)
                ),
            ).to(torch.int64)
            sp = k % PACK
            acc = (code << (2 * sp)) if sp == 0 else acc | (code << (2 * sp))
            if sp == PACK - 1 or k == K - 1:
                dirs[k // PACK] = _wrap_int32(acc)

        if is_local:
            val = torch.where(
                lem & (iv <= k) & (iv >= k - n), Mn, INT_MIN
            ).to(torch.int32)
            upd = val >= bv
            bv = torch.where(upd, val, bv)
            bk = torch.where(upd, k - iv, bk)

        if probe_in and k == mi0 + n:
            fin = int(Mn[mi0])

        if emit_bottom and R <= k <= R + B:
            bottom[0, k - R], bottom[1, k - R], bottom[2, k - R] = (
                In[R], Sn[R], Dn[R]
            )

        An = torch.maximum(Qn + hg, Dn + g)
        if is_local:
            An = torch.clamp_min(An, 0)
        I, P, A, M, SM = In, torch.maximum(Sn, Dn), An, Mn, SMn

    t32 = lambda x: torch.tensor(x, **i32)  # noqa: E731
    if not is_local:
        best = (t32(INT_MIN), t32(0), t32(0))
    elif mi0 < 0:
        # No true cell: the TPU kernel's lane merge over its Kp padded
        # diagonals leaves lane V-1 at column Kp - V.
        best = (t32(INT_MIN), t32(i0 + V - 1), t32(max(-1, Kp - V)))
    else:
        vmax = bv.max()
        ig = i0 + iv
        i_best = torch.where(bv == vmax, ig, -1).max()
        j_best = torch.where((bv == vmax) & (ig == i_best), bk, -1).max()
        best = (vmax, i_best.to(torch.int32), j_best.to(torch.int32))
    return TileFillResult(
        dirs=dirs,
        score_at_mn=t32(fin),
        best=best,
        bottom=bottom,
        cols=cols,
        err=t32(0),
    )
