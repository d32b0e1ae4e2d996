"""Traceback walkers (kernels K2 and K4; counterparts of
``genomics_rs_tpu/ops/traceback_pallas.py``'s ``walk_pallas``,
``walk_full`` and ``walk_many``).

:func:`walk_kernel` has ``walk_pallas``'s contract: it chases a packed
direction bitmap from a start cell and returns the moves PACKED 16 to
an int32 word (:func:`unpack_moves` decodes them on the host). It
launches K2 (``walk_kernel`` in ``csrc/traceback_walk.cu``: K4's staged
chase on one warp with the block exits added, ``ops/walk_stage``) and
takes CUDA bitmaps only; :func:`walk_full` loops it until the path ends
or leaves the block. A CPU bitmap goes through
``traceback_device.device_walk`` to the plain walker ``walk_block``.

:func:`walk_many` has ``walk_many``'s contract: W full-bitmap walks in
one launch over one packed array, each at its own word-row and lane
offset. A CUDA bitmap launches K4 (``walk_many_kernel`` in the same
source: a staged chase, a warp a walk reading a ring of bitmap boxes in
shared memory), a CPU bitmap runs :func:`walk_many_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops.traceback_device import resume_walk, walk_block
from genomics_rs_tpu_torch.utils.profiling import annotate

#: moves per packed output word.
MPW = 16
#: largest move buffer one call takes.
MAX_STEPS_CAP = 65536

#: launches of K2 ("kernel") and K4 ("many_kernel"), calls of K4's plain
#: version ("many_plain").
COUNTS = {"kernel": 0, "many_kernel": 0, "many_plain": 0}


def unpack_moves(words: np.ndarray, count: int) -> np.ndarray:
    """Decode ``count`` 2-bit move codes from packed words (host)."""
    words = np.asarray(words).astype(np.uint32)
    t = np.arange(MPW, dtype=np.uint32)
    codes = (words[:, None] >> (2 * t)[None, :]) & 3
    return codes.reshape(-1).astype(np.uint8)[:count]


#: int32 slots ahead of K2's moves in its one output buffer: the meta
#: (pos, li, j, done, exited, oob) and two pad slots (the moves start 32
#: bytes in).
META_SLOTS = 8


def walk_kernel(
    dirs: torch.Tensor,
    start_li: int,
    start_j: int,
    i0: int,
    max_steps: int,
    j0: int = 0,
):
    """``walk_block`` semantics with packed move output, on a CUDA
    bitmap (any other device raises).

    Returns ``(words int32[ceil(count/16)], count, i_final, j_final,
    done)`` on the host (numpy words, Python scalars): the kernel writes
    its meta and moves into one buffer, read back in one copy. Not done
    with ``i_final == i0 - 1`` is an upward exit, not done with
    ``j_final == 0`` and ``j0 > 0`` a left exit, and otherwise a full
    buffer (resume from the final cell).
    """
    if max_steps > MAX_STEPS_CAP:
        raise ValueError(
            f"max_steps {max_steps} > {MAX_STEPS_CAP}; loop walk_full"
        )
    if not _build.uses_kernel(dirs):
        raise ValueError(
            f"walk_kernel takes a CUDA bitmap, not {dirs.device}; "
            "device_walk routes CPU bitmaps to walk_block"
        )
    dev = dirs.device
    KW, V = dirs.shape
    _build.require(dirs, "dirs", torch.int32, dev)
    out = torch.empty(META_SLOTS + -(-max_steps // MPW), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.traceback_walk_launch(
            _build.ptr(dirs), _build.ptr(out), KW, V, int(start_li), int(start_j), int(i0),
            int(j0), int(max_steps), _build.stream_handle(dev),
        )
    _build.check(err, "traceback_walk")
    COUNTS["kernel"] += 1
    host = out.cpu().numpy()
    pos, li, j, done, exited, oob = (int(x) for x in host[:6])
    if oob:
        raise IndexError(f"walk left the bitmap at (li={li}, j={j})")
    i_final = int(i0) - 1 if exited == 1 else int(i0) + li
    words = host[META_SLOTS : META_SLOTS + -(-pos // MPW)]
    return words, pos, i_final, j, bool(done)


def walk_full(
    dirs: torch.Tensor,
    start_li: int,
    start_j: int,
    i0: int,
    max_steps: int,
    j0: int = 0,
):
    """Loop :func:`walk_kernel` until the path terminates or exits the
    block, concatenating the decoded codes on the host.

    Returns ``(codes uint8[count], i_final, j_final, done)``, as one
    ``walk_block`` call that never fills its buffer would.
    """
    cap = min(max_steps, MAX_STEPS_CAP)

    def step(li, j):
        words, count, i_f, j_f, done = walk_kernel(
            dirs, li, j, i0, max_steps=cap, j0=j0
        )
        return unpack_moves(words, count), i_f, j_f, done

    with annotate("genomics/traceback_walker.walk"):
        return resume_walk(step, start_li, start_j, int(i0), windowed=int(j0) > 0)


def pack_moves(codes: np.ndarray, nw: int) -> np.ndarray:
    """2-bit move codes -> ``nw`` int32 words, 16 to a word (host)."""
    padded = np.zeros(nw * MPW, np.uint32)
    padded[: len(codes)] = codes
    shifts = 2 * np.arange(MPW, dtype=np.uint32)
    words = np.bitwise_or.reduce(padded.reshape(nw, MPW) << shifts, axis=1)
    return words.astype(np.uint32).view(np.int32)


def _walk_args(dirs, start_li, start_j, koffs, max_steps, loffs):
    if max_steps > MAX_STEPS_CAP:
        raise ValueError(f"max_steps {max_steps} > {MAX_STEPS_CAP}; use walk_full")
    if dirs.dim() != 2:
        raise ValueError(f"dirs must be (KW_total, V), not {tuple(dirs.shape)}")
    cols = [np.asarray(x, np.int64).reshape(-1) for x in (start_li, start_j, koffs)]
    W = cols[0].shape[0]
    cols.append(np.zeros(W, np.int64) if loffs is None else np.asarray(loffs, np.int64).reshape(-1))
    if any(c.shape != (W,) for c in cols):
        raise ValueError("start_li, start_j, koffs and loffs must have one entry per walk")
    if W and (cols[2].min() < 0 or cols[3].min() < 0):
        raise ValueError("koffs and loffs must be >= 0")
    return W, cols


def walk_many(dirs: torch.Tensor, start_li, start_j, koffs, KW: int,
              max_steps: int, loffs=None):
    """Chase W independent full-bitmap walks (i0 = j0 = 0) in one call.

    Walk ``w`` reads the word rows ``[koffs[w], koffs[w] + KW)`` of
    ``dirs`` (KW_total, V) and its lanes from ``loffs[w]`` (default 0)
    on, from the walk-local cell ``(start_li[w], start_j[w])``. Returns
    numpy ``(words (W, NW) int32, counts, i_f, j_f, done)``; decode walk
    ``w`` with ``unpack_moves(words[w], counts[w])``. ``max_steps`` must
    cover the longest path, so a False ``done`` is a corrupt bitmap, not
    a resume request. A walk that leaves its bitmap raises
    ``IndexError``. A CUDA bitmap launches K4, a CPU bitmap runs
    :func:`walk_many_plain`.
    """
    fn = _walk_many_cuda if _build.uses_kernel(dirs) else walk_many_plain
    return fn(dirs, start_li, start_j, koffs, KW, max_steps, loffs)


def _walk_many_cuda(dirs, start_li, start_j, koffs, KW, max_steps, loffs=None):
    dev = dirs.device
    if dev.type != "cuda":
        raise ValueError(f"the K4 kernel takes a CUDA bitmap, not {dev}")
    W, cols = _walk_args(dirs, start_li, start_j, koffs, max_steps, loffs)
    _build.require(dirs, "dirs", torch.int32, dev)
    KWT, V = dirs.shape
    nw = -(-max_steps // MPW)
    lib = _build.library()
    starts = torch.from_numpy(np.stack(cols, 1).astype(np.int32)).to(dev)
    words = torch.zeros((W, nw), dtype=torch.int32, device=dev)
    meta = torch.empty((W, 5), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.walk_many_launch(
            _build.ptr(dirs), _build.ptr(starts), _build.ptr(words), _build.ptr(meta),
            W, int(KW), KWT, V, nw, int(max_steps), _build.stream_handle(dev),
        )
    _build.check(err, "walk_many")
    COUNTS["many_kernel"] += 1
    meta = meta.cpu().numpy()
    bad = np.nonzero(meta[:, 4])[0]
    if bad.size:
        w = int(bad[0])
        raise IndexError(f"walk {w} left its bitmap at (li={meta[w, 1]}, j={meta[w, 2]})")
    return words.cpu().numpy(), meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3] != 0


def walk_many_plain(dirs, start_li, start_j, koffs, KW, max_steps, loffs=None):
    """The plain version of :func:`walk_many`: ``walk_block`` over each
    walk's view of the bitmap, on the host (a CUDA bitmap raises)."""
    if dirs.device.type != "cpu":
        raise ValueError(f"walk_many_plain walks a CPU bitmap, not {dirs.device}")
    W, (li, j, ko, lo) = _walk_args(dirs, start_li, start_j, koffs, max_steps, loffs)
    COUNTS["many_plain"] += 1
    nw = -(-max_steps // MPW)
    words = np.zeros((W, nw), np.int32)
    out = np.zeros((4, W), np.int64)
    for w in range(W):
        view = dirs[ko[w] : ko[w] + int(KW), lo[w] :]
        moves, count, i_f, j_f, done = walk_block(view, li[w], j[w], 0, max_steps=max_steps)
        words[w] = pack_moves(moves.numpy()[:count], nw)
        out[:, w] = count, i_f, j_f, done
    return words, out[0], out[1], out[2], out[3] != 0
