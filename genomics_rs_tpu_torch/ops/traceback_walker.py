"""Traceback walker (kernel K2; counterpart of
``genomics_rs_tpu/ops/traceback_pallas.py``'s ``walk_pallas`` and
``walk_full``).

:func:`walk_kernel` has ``walk_pallas``'s contract: it chases a packed
direction bitmap from a start cell and returns the moves PACKED 16 to
an int32 word (:func:`unpack_moves` decodes them on the host). It
launches ``csrc/traceback_walk.cu`` and takes CUDA bitmaps only;
:func:`walk_full` loops it until the path ends or leaves the block.
A CPU bitmap goes through ``traceback_device.device_walk`` to the
plain walker ``walk_block``.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops.traceback_device import resume_walk

#: moves per packed output word.
MPW = 16
#: largest move buffer one call takes.
MAX_STEPS_CAP = 65536

#: launches of the CUDA kernel.
COUNTS = {"kernel": 0}


def unpack_moves(words: np.ndarray, count: int) -> np.ndarray:
    """Decode ``count`` 2-bit move codes from packed words (host)."""
    words = np.asarray(words).astype(np.uint32)
    t = np.arange(MPW, dtype=np.uint32)
    codes = (words[:, None] >> (2 * t)[None, :]) & 3
    return codes.reshape(-1).astype(np.uint8)[:count]


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

    Returns ``(words int32[ceil(max_steps/16)], count, i_final,
    j_final, done)``; ``words`` stays on the bitmap's device, the rest
    are Python scalars. Not done with ``i_final == i0 - 1`` is an
    upward exit, not done with ``j_final == 0`` and ``j0 > 0`` a left
    exit, and otherwise a full buffer (resume from the final cell).
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
    nw = -(-max_steps // MPW)
    lib = _build.library()
    dev = dirs.device
    KW, V = dirs.shape
    _build.require(dirs, "dirs", torch.int32, dev)
    words = torch.empty(nw, dtype=torch.int32, device=dev)
    meta = torch.empty(6, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.traceback_walk_launch(
            _build.ptr(dirs), _build.ptr(words), _build.ptr(meta),
            KW, V, int(start_li), int(start_j), int(i0), int(j0),
            int(max_steps), _build.stream_handle(dev),
        )
    _build.check(err, "traceback_walk")
    COUNTS["kernel"] += 1
    pos, li, j, done, exited, oob = meta.tolist()
    if oob:
        raise IndexError(f"walk left the bitmap at (li={li}, j={j})")
    i_final = int(i0) - 1 if exited == 1 else int(i0) + li
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
        used = words[: -(-count // MPW)].cpu().numpy()
        return unpack_moves(used, count), i_f, j_f, done

    return resume_walk(step, start_li, start_j, int(i0), windowed=int(j0) > 0)
