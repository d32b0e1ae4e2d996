"""Batched pair scoring (counterpart of ``genomics_rs_tpu/parallel/batch.py``:
``score_pairs``, ``_kernel_scores``, ``pad_batch`` and the router's tier
bounds).

The JAX router picks one of five TPU kernels by padded length
(shortread up to ``SHORTREAD_MAX_LEN``, segmented or stream8 up to
``SEGMENTED_MAX_LEN``, the stream kernel beyond). Only the stream
kernel (K3) is ported so far, and it fills one pair per thread block at
any length, so here ``"auto"`` and ``"stream"`` send every bucket to it:
the kernel on a CUDA device, its plain version on the CPU. The other
engines, and ``"scan"``, raise until their kernels land (ROADMAP Queue
B K6–K9). The mesh paths (``batch_scores_sharded``,
``device_loop_scores``) wait for ROADMAP Queue A item 14.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.gotoh_stream import gotoh_scores_stream

#: The JAX router's tier bounds (padded lengths), kept for the tiers
#: K6–K9 will serve: the short-read tier up to this length...
SHORTREAD_MAX_LEN = 256
#: ...the row-segmented tier up to this one...
SEGMENTED_MAX_LEN = 8192
#: ...with the 8-stream tier above this one in global mode.
STREAM8_MIN_LEN = 1024

NOT_PORTED = "not yet ported (ROADMAP Queue B K6–K9)"
_UNPORTED = ("shortread", "segmented", "stream8", "pallas", "scan")


def _kernel_scores(engine: str, s1b, s2b, ms, ns, scores, is_local: bool):
    """Dispatch one named engine on tensors already on their device;
    returns (score, start_i, start_j) int32 tensors of shape (B,)."""
    if engine == "stream":
        return gotoh_scores_stream(s1b, s2b, ms, ns, scores, is_local)
    if engine in _UNPORTED:
        raise NotImplementedError(f"engine {engine!r} is {NOT_PORTED}")
    raise ValueError(f"unknown engine {engine!r}")


def score_pairs(s1b, s2b, ms, ns, scores, is_local: bool = False,
                engine: str = "auto", device="cuda"):
    """Score a batch of encoded pairs (uint8 (B, Lm) and (B, Ln), true
    lengths ``ms``/``ns``) on ``device``. ``"auto"`` and ``"stream"``
    run K3 (its plain version on the CPU). Returns numpy
    ``(score, start_i, start_j)`` int32 arrays of shape (B,)."""
    dev = resolve_device(device)
    if engine == "auto":
        engine = "stream"
    s1 = torch.as_tensor(np.ascontiguousarray(s1b), dtype=torch.uint8).to(dev)
    s2 = torch.as_tensor(np.ascontiguousarray(s2b), dtype=torch.uint8).to(dev)
    out = _kernel_scores(engine, s1, s2, ms, ns, scores, is_local)
    return tuple(x.cpu().numpy() for x in out)


def pad_batch(arrs, batch: int, multiple: int, pad_values=None):
    """Pad the leading batch dim of every array in ``arrs`` up to a
    multiple. ``pad_values[i]`` fills array i's padding rows; ``None``
    replicates row 0. Returns (padded arrays, padded batch size)."""
    pb = -(-batch // multiple) * multiple
    if pb == batch:
        return arrs, batch
    if pad_values is None:
        pad_values = [None] * len(arrs)
    out = []
    for a, pv in zip(arrs, pad_values):
        if pv is None:
            pad = np.broadcast_to(a[:1], (pb - batch,) + a.shape[1:])
        else:
            pad = np.full((pb - batch,) + a.shape[1:], pv, dtype=a.dtype)
        out.append(np.concatenate([a, pad], axis=0))
    return out, pb
