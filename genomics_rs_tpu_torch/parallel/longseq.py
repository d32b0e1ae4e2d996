"""Sequence-parallel (wavefront-sharded) Gotoh fill over a mesh axis
(counterpart of ``genomics_rs_tpu/parallel/longseq.py``).

The rows of one pair's table are cut into P shards of R rows, and its
columns into C blocks of B; shard p fills tile (p, c) at wave t = p + c,
from the bottom row of tile (p - 1, c) and the right column of tile
(p, c - 1). After P + C - 1 waves every tile is filled; the score at
(m, n) and the local argmax (reference last-row-major tie-break) are
merged across the shards.

JAX runs this as one ``shard_map`` program with a ``ppermute`` of the
bottom rows and ``pmax`` merges. Here one process drives the mesh's
devices from a host loop over the waves:

* each shard issues its tiles on a CUDA stream of its own, so the tiles
  of one wave run at once, also when the mesh repeats one card;
* a tile's bottom row goes to shard p + 1 after an event on shard p's
  stream: a peer copy when the two shards sit on different cards, the
  same memory when they share one;
* the merges run on shard 0's device with JAX's tie-break;
* a tile is K5 (``ops/gotoh_pallas.gotoh_tile_pallas``) on a CUDA shard
  and its plain version ``tile_fill`` on a CPU shard. ``engine="scan"``
  runs ``ops/gotoh_tile.tile_fill`` on every shard, as JAX's scan engine
  does: torch ops on the shard's device, never the kernel. The loop
  issues only active tiles; JAX's masked form computes the others and
  drops them.

:func:`align_sharded` adds the full traceback: the forward keeps every
tile's entry top row and left column (:func:`sharded_fill_checkpoints`),
and the walk refills narrow column windows shard by shard with the
row-block fill (K1) and chases them on the device, as
``models/longalign`` does on one device. Path and stats equal the
single-device aligner's.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.gotoh_pallas import gotoh_tile_pallas
from genomics_rs_tpu_torch.ops.gotoh_rowblock import gotoh_rowblock, lane_count, raise_on_err
from genomics_rs_tpu_torch.ops.gotoh_scan import INT_MIN
from genomics_rs_tpu_torch.ops.gotoh_tile import (
    global_boundary_left,
    global_boundary_top,
    tile_fill,
)
from genomics_rs_tpu_torch.ops.traceback import classify_moves
from genomics_rs_tpu_torch.ops.traceback_device import device_walk
from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, axis_devices
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, round_up


class LongSeqResult(NamedTuple):
    score: torch.Tensor  # 0-d int32: global-mode score, the cell max at (m, n)
    best: torch.Tensor  # int32 (3,): local argmax (value, i, j)


class ShardedFill(NamedTuple):
    """Checkpointing sharded forward result (see :func:`align_sharded`).

    tops: (P*C, 3, B+1): tile (p, c)'s entry TOP row (row p*R, columns
      c*B..(c+1)*B) at index p*C + c.
    lefts: (P*C, 3, R): tile (p, c)'s entry LEFT column (column c*B, rows
      p*R+1..(p+1)*R).
    """

    score: torch.Tensor
    best: torch.Tensor
    tops: torch.Tensor
    lefts: torch.Tensor


def _merge_best(a, b):
    """Merge two (v, i, j) candidates with the reference tie-break (larger
    value, then larger i, then larger j)."""
    av, ai, aj = a
    bv, bi, bj = b
    b_wins = (bv > av) | ((bv == av) & ((bi > ai) | ((bi == ai) & (bj > aj))))
    return (torch.where(b_wins, bv, av), torch.where(b_wins, bi, ai),
            torch.where(b_wins, bj, aj))


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _used_on(t: torch.Tensor, stream) -> torch.Tensor:
    """Tell the caching allocator that ``stream`` reads ``t`` too."""
    if stream is not None:
        t.record_stream(stream)
    return t


def _hand_off(bottom, src_stream, dst_dev, dst_stream, xfer):
    """Tile (p, c)'s bottom row, issued on ``src_stream``, as shard p+1's
    top: ordered before ``dst_stream``'s next tile by an event (CPU
    shards: the row itself)."""
    if src_stream is None:
        return bottom
    if bottom.device == dst_dev:
        dst_stream.wait_stream(src_stream)
        return _used_on(bottom, dst_stream)
    # A peer copy on the source's stream; the destination's current stream
    # is an idle transfer stream, so the copy's two-way barrier holds the
    # source back behind nothing.
    with torch.cuda.stream(src_stream), torch.cuda.stream(xfer):
        out = bottom.to(dst_dev, non_blocking=True)
    dst_stream.wait_stream(xfer)
    return _used_on(out, dst_stream)


def _check_engine(engine: str) -> None:
    if engine not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown engine {engine!r}")


def _as_u8(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))


def _seq_core(devs, s1e, s2e, m: int, n: int, scores, is_local: bool, n_blocks: int,
              engine: str = "auto", emit_ckpt: bool = False):
    """The pipeline of one pair over the shard devices ``devs`` (a list of
    ``torch.device``; repeats allowed): returns ``(LongSeqResult, err)``,
    or ``(ShardedFill, err)`` with ``emit_ckpt``, on ``devs[0]``, ``err``
    the largest of the tiles' error words (0-d int32). Issues work and
    returns without waiting for it: the caller reads ``err``
    (``raise_on_err``) with the result."""
    _check_engine(engine)
    devs = [resolve_device(d) for d in devs]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh of CPU and CUDA devices: {devs}")
    P, C = len(devs), int(n_blocks)
    s1e, s2e = _as_u8(s1e), _as_u8(s2e)
    Lm, N = s1e.shape[0], s2e.shape[0]
    if Lm % P:
        raise ValueError(f"s1 length {Lm} must divide into {P} shards")
    if N % C:
        raise ValueError(f"s2 length {N} must divide into n_blocks = {C}")
    R, B = Lm // P, N // C
    m, n = int(m), int(n)
    cuda = devs[0].type == "cuda"
    streams = [torch.cuda.Stream(device=d) if cuda else None for d in devs]
    # An idle stream on each card that receives a peer copy.
    xfer = [torch.cuda.Stream(device=d) if cuda and p and devs[p - 1] != d else None
            for p, d in enumerate(devs)]

    # Inputs go up on each device's current stream; the shard streams
    # wait for them.
    s2_on = {d: s2e.to(d) for d in devs}
    s1_sh = [s1e[p * R : (p + 1) * R].to(d) for p, d in enumerate(devs)]
    s2_sh, left, best, at_mn, errs = [], [], [], [], []
    for p, (d, s) in enumerate(zip(devs, streams)):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(d))
        _used_on(s1_sh[p], s)
        s2_sh.append(_used_on(s2_on[d], s))
        with _on(s):
            left.append(global_boundary_left(p * R, R, scores, device=d))
            z = torch.zeros((), dtype=torch.int32, device=d)
            best.append((z + INT_MIN, z, z))
            at_mn.append(z + INT_MIN)
            errs.append(z)
    tops = [[] for _ in range(P)]
    lefts = [[] for _ in range(P)]
    incoming = [None] * P

    for t in range(P + C - 1):
        # Shards in reverse, so a hand-off to shard p+1 lands after its
        # tile of this wave (which reads the previous wave's row).
        for p in reversed(range(P)):
            c = t - p
            if not 0 <= c < C:
                continue
            j0 = c * B
            with _on(streams[p]):
                top = (global_boundary_top(j0, B, scores, device=devs[p]) if p == 0
                       else incoming[p])
                if emit_ckpt:
                    tops[p].append(top)
                    lefts[p].append(left[p])
                if engine == "scan":
                    res = tile_fill(s1_sh[p], s2_sh[p][j0 : j0 + B], top, left[p], scores,
                                    is_local, p * R, j0, m, n)
                    tile_mn = res.at_mn
                else:
                    res = gotoh_tile_pallas(
                        s1_sh[p], s2_sh[p][j0 : j0 + B], top, left[p], m, n, p * R, j0,
                        scores, is_local, emit_dirs=False, emit_bottom=True, emit_right=True)
                    tile_mn = res.score_at_mn
                    errs[p] = torch.maximum(errs[p], res.err)
                left[p] = res.right
                best[p] = _merge_best(best[p], res.best)
                at_mn[p] = torch.maximum(at_mn[p], tile_mn)
            if p + 1 < P:
                incoming[p + 1] = _hand_off(res.bottom, streams[p], devs[p + 1],
                                            streams[p + 1], xfer[p + 1])

    # Join every shard's stream into its device's current stream, then the
    # pmax merges on shard 0's device.
    dev0 = devs[0]
    outs = []
    for p, (d, s) in enumerate(zip(devs, streams)):
        row = [*best[p], at_mn[p], errs[p]]
        if emit_ckpt:
            with _on(s):
                row += [torch.stack(tops[p]), torch.stack(lefts[p])]
        cur = torch.cuda.current_stream(d) if s is not None else None
        if cur is not None:
            cur.wait_stream(s)
        outs.append([_used_on(x, cur).to(dev0) for x in row])
    v = torch.stack([o[0] for o in outs])
    i = torch.stack([o[1] for o in outs])
    j = torch.stack([o[2] for o in outs])
    score = torch.stack([o[3] for o in outs]).max()
    err = torch.stack([o[4] for o in outs]).max()
    bv = v.max()
    bi = torch.where(v == bv, i, -1).max()
    bj = torch.where((v == bv) & (i == bi), j, -1).max()
    best_t = torch.stack([bv, bi, bj])
    if emit_ckpt:
        return ShardedFill(score=score, best=best_t, tops=torch.cat([o[5] for o in outs]),
                           lefts=torch.cat([o[6] for o in outs])), err
    return LongSeqResult(score=score, best=best_t), err


def sharded_gotoh_score(mesh, s1e, s2e, m, n, scores, is_local: bool = False,
                        axis_name: str = SEQ_AXIS, n_blocks: int | None = None,
                        engine: str = "auto") -> LongSeqResult:
    """Score one (long) pair with its rows sharded over ``axis_name``.

    ``s1e`` length must be divisible by the axis size, ``s2e`` length by
    ``n_blocks`` (default: the axis size). Pad with ``PAD_S1``/``PAD_S2``
    and pass the true lengths in ``m``/``n``. ``engine``: ``"auto"`` or
    ``"pallas"`` (K5 on CUDA shards, ``tile_fill`` on CPU shards), or
    ``"scan"`` (``tile_fill`` on every shard).
    Returns 0-d ``score`` and (3,) ``best`` int32 tensors on the axis's
    first device, once the tiles' error words are read (one
    synchronisation, after every tile is issued).
    """
    devs = axis_devices(mesh, axis_name)
    out, err = _seq_core(devs, s1e, s2e, m, n, scores, is_local, n_blocks or len(devs), engine)
    raise_on_err(err)
    return out


def sharded_fill_checkpoints(mesh, s1e, s2e, m, n, scores, is_local: bool = False,
                             axis_name: str = SEQ_AXIS, n_blocks: int | None = None,
                             engine: str = "auto") -> ShardedFill:
    """The checkpointing sharded forward under :func:`align_sharded`:
    :func:`sharded_gotoh_score`'s contract plus every tile's entry
    boundaries (``ShardedFill.tops``/``lefts``)."""
    devs = axis_devices(mesh, axis_name)
    fill, err = _seq_core(devs, s1e, s2e, m, n, scores, is_local, n_blocks or len(devs),
                          engine, emit_ckpt=True)
    raise_on_err(err)
    return fill


def batched_sharded_scores(mesh, s1b, s2b, ms, ns, scores, is_local: bool = False,
                           data_axis: str = "data", seq_axis: str = SEQ_AXIS,
                           n_blocks: int | None = None, engine: str = "auto") -> LongSeqResult:
    """2-D (data x seq) sharding: pairs over ``data``, each pair's DP rows
    over ``seq``. ``s1b`` (Batch, Lm) with Batch divisible by the data
    axis and Lm by the seq axis; ``s2b`` (Batch, Ln); ``ms``/``ns``
    (Batch,). Returns (Batch,) scores and (Batch, 3) bests on the mesh's
    first device."""
    arr = np.moveaxis(mesh.devices, (mesh.axis_names.index(data_axis),
                                     mesh.axis_names.index(seq_axis)), (0, 1))
    arr = arr.reshape(arr.shape[0], arr.shape[1], -1)[:, :, 0]
    n_data = arr.shape[0]
    C = n_blocks or arr.shape[1]
    batch = len(ms)
    if batch % n_data:
        raise ValueError(f"batch {batch} must divide into {n_data} data shards")
    per = batch // n_data
    dev0 = arr[0, 0]
    outs, errs = [], []
    for b in range(batch):
        out, err = _seq_core(list(arr[b // per]), s1b[b], s2b[b], int(ms[b]), int(ns[b]),
                             scores, is_local, C, engine)
        outs.append(out)
        errs.append(err.to(dev0))
    raise_on_err(torch.stack(errs).max())  # every pair issued: one synchronisation
    return LongSeqResult(score=torch.stack([o.score.to(dev0) for o in outs]),
                         best=torch.stack([o.best.to(dev0) for o in outs]))


def _refill_and_walk_shard(s1_rows, s2_win, top_w, left_col, m: int, i0: int, jc: int, Bt: int,
                           i: int, j: int, scores, is_local: bool, sub_rows: int):
    """Refill one row-shard's traceback window and walk it.

    When the shard is taller than ``sub_rows``, a window-local
    sub-forward (no dirs) first rebuilds the sub-block top rows from the
    shard's captured boundaries; the walk then proceeds bottom-up through
    per-sub-block dirs refills. Returns ``(codes_list, i, j, done)`` with
    (i, j) global.
    """
    R = s1_rows.shape[0]
    codes: list = []

    def left_of(r0, rk):
        return left_col[:, r0 : r0 + rk].contiguous() if jc > 0 else None

    errs = []  # the fills' error words, read after each walk
    if R <= sub_rows:
        subs, sub_tops = [(0, R)], [top_w]
    else:
        subs = [(k * sub_rows, min(sub_rows, R - k * sub_rows)) for k in range(-(-R // sub_rows))]
        sub_tops = [top_w]
        for r0, rk in subs[:-1]:
            res = gotoh_rowblock(s1_rows[r0 : r0 + rk], s2_win, sub_tops[-1], m, Bt, i0 + r0,
                                 scores, is_local, emit_dirs=False, emit_bottom=True,
                                 left=left_of(r0, rk))
            sub_tops.append(res.bottom)
            errs.append(res.err)

    # Walk the sub-blocks bottom-up from (i, j).
    kb = next(k for k, (r0, rk) in enumerate(subs) if i0 + r0 < max(i, 1) <= i0 + r0 + rk)
    while True:
        r0, rk = subs[kb]
        res = gotoh_rowblock(s1_rows[r0 : r0 + rk], s2_win, sub_tops[kb], m, Bt, i0 + r0,
                             scores, is_local, emit_dirs=True, emit_bottom=False,
                             left=left_of(r0, rk))
        blk_codes, i, j_f, done = device_walk(res.dirs, i - (i0 + r0), j - jc, i0 + r0,
                                              max_steps=rk + 2 * lane_count(rk) + 1, j0=jc)
        raise_on_err(torch.stack([*errs, res.err]).max())  # the walk's read has synchronised
        codes.append(np.asarray(blk_codes))
        i, j = int(i), int(j_f) + jc
        if done:
            return codes, i, j, True
        if i < i0 + r0:
            if kb == 0:
                return codes, i, j, False  # exits the shard upward
            kb -= 1
        elif int(j_f) == 0 and jc > 0:
            return codes, i, j, False  # left exit: the caller widens
        else:
            raise RuntimeError(f"sharded traceback stalled at ({i}, {j})")


def align_sharded(mesh, seq1, seq2, scores, is_local: bool = False, axis_name: str = SEQ_AXIS,
                  n_blocks: int | None = None, engine: str = "auto", sub_rows: int = 65535):
    """Full alignment (path and stats) of one long pair with its DP rows
    sharded over ``axis_name``: the sharded checkpointing forward, then a
    walk shard by shard through windowed dirs refills seeded by the
    captured tile boundaries (module docstring). Equal to
    ``PairwiseAligner.align``. ``sub_rows`` bounds one refill's rows;
    taller shards rebuild sub-block tops inside the window first."""
    devs = axis_devices(mesh, axis_name)
    P = len(devs)
    C = n_blocks or P
    m, n = len(seq1), len(seq2)
    R = max(round_up(m, 128 * P), 128 * P) // P
    Lm = R * P
    Ln = max(round_up(n, 128 * C), 128 * C)
    B = Ln // C
    s1e = torch.from_numpy(seq1.encoded(pad_to=Lm, pad_value=PAD_S1).copy())
    s2e = torch.from_numpy(seq2.encoded(pad_to=Ln, pad_value=PAD_S2).copy())

    fill, err = _seq_core(devs, s1e, s2e, m, n, scores, is_local, C, engine, emit_ckpt=True)
    v, bi, bj, at_mn, err = torch.stack([*fill.best, fill.score, err]).tolist()
    raise_on_err(err)
    score, start_i, start_j = (v, bi, bj) if is_local else (at_mn, m, n)

    s1_sh = {}
    top_cache: dict[int, torch.Tensor] = {}

    def shard_top_full(p: int) -> torch.Tensor:
        # Tile tops overlap by one column (tile c's column B is tile c+1's
        # column 0): the first B of each, then the last tile's final column.
        parts = [fill.tops[p * C + c][:, :B] for c in range(C)]
        parts.append(fill.tops[p * C + C - 1][:, B:])
        return torch.cat(parts, 1).to(devs[p])  # (3, Ln+1)

    codes_all: list[np.ndarray] = []
    i, j = start_i, start_j
    done = i == 0 and j == 0
    shard = max(0, (i - 1) // R) if not done else 0
    while not done:
        d = devs[shard]
        i0 = shard * R
        jc = max(0, (j // B - 1) * B)
        Bt = min(Ln - jc, round_up(max(j - jc, 1), B))
        if shard not in top_cache:
            top_cache[shard] = shard_top_full(shard)
            s1_sh[shard] = s1e[i0 : i0 + R].to(d)
        top_w = top_cache[shard][:, jc : jc + Bt + 1].contiguous()
        left_col = fill.lefts[shard * C + jc // B].to(d)
        codes, i, j, term = _refill_and_walk_shard(
            s1_sh[shard], s2e[jc : jc + Bt].to(d), top_w, left_col, m, i0, jc, Bt, i, j,
            scores, is_local, sub_rows)
        codes_all.extend(codes)
        if term:
            break
        if i < i0:
            if shard == 0:
                raise RuntimeError(f"sharded traceback left shard 0 at ({i}, {j})")
            shard -= 1
        elif j <= jc and jc == 0:
            raise RuntimeError(f"sharded traceback hit the left edge at ({i}, {j})")
        # else a left exit: the loop refills one stride wider

    all_codes = np.concatenate(codes_all) if codes_all else np.zeros(0, np.uint8)
    return classify_moves(all_codes, start_i, start_j, score, seq1, seq2)
