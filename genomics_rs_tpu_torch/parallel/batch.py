"""Batched pair scoring (counterpart of ``genomics_rs_tpu/parallel/batch.py``:
``score_pairs``, ``_kernel_scores``, ``pad_batch`` and the router's tier
bounds).

Five engines, each a kernel on a CUDA device and its plain version on the
CPU: ``"shortread"`` (K6, one warp a pair, up to 256 bytes),
``"segmented"`` and ``"stream8"`` (K7 and K8: the warp-strip kernel, one
warp a pair at any length, each route with its own launch count),
``"stream"`` (K3, one thread block a pair) and ``"pallas"`` (K9, one
pair's row strips pipelined over many blocks). ``"auto"`` tiers a bucket
by padded length as the JAX router does on its device
(:func:`route_engine`). ``"scan"`` is not ported (ROADMAP Queue A item
3). The mesh paths (``batch_scores_sharded``, ``device_loop_scores``) wait
for ROADMAP Queue A item 14.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.gotoh_pallas import gotoh_scores_pallas_batch
from genomics_rs_tpu_torch.ops.gotoh_segmented import gotoh_scores_segmented
from genomics_rs_tpu_torch.ops.gotoh_shortread import SHORTREAD_MAX_LEN, gotoh_scores_shortread
from genomics_rs_tpu_torch.ops.gotoh_stream import gotoh_scores_stream
from genomics_rs_tpu_torch.ops.gotoh_stream8 import gotoh_scores_stream8

#: The JAX router's tier bounds (padded lengths): past the short-read
#: tier (K6, up to ``SHORTREAD_MAX_LEN``), the segmented tier up to this
#: one...
SEGMENTED_MAX_LEN = 8192
#: ...with the 8-stream tier above this one in global mode at B >= 2.
STREAM8_MIN_LEN = 1024

NOT_PORTED = "not yet ported (ROADMAP Queue A item 3)"

_ENGINES = {
    "shortread": gotoh_scores_shortread,
    "segmented": gotoh_scores_segmented,
    "stream8": gotoh_scores_stream8,
    "stream": gotoh_scores_stream,
    "pallas": gotoh_scores_pallas_batch,
}


def shortread_fits(L1: int, L2: int, ms, ns) -> bool:
    """True when K6 takes a (L1, L2) bucket: both padded lengths within
    ``SHORTREAD_MAX_LEN``, ``L2`` a multiple of 16, and no empty
    sequence."""
    return (max(L1, L2) <= SHORTREAD_MAX_LEN and L2 % 16 == 0
            and int(np.min(ms, initial=1)) >= 1 and int(np.min(ns, initial=1)) >= 1)


def route_engine(B: int, Lm: int, Ln: int, is_local: bool, ms, ns) -> str:
    """The engine ``"auto"`` runs for a bucket of B pairs padded to (Lm, Ln):
    the JAX router's tiers (short-read up to 256, segmented up to 8,192
    with stream8 for global buckets past 1,024 at B >= 2, then stream at
    B >= 2 and pallas for a single pair). A short bucket that K6 does not
    take (an empty sequence, ``Ln % 16 != 0``) goes to the segmented
    kernel, where JAX's short-read wrapper pads it."""
    if max(Lm, Ln) <= SHORTREAD_MAX_LEN:
        return "shortread" if shortread_fits(Lm, Ln, ms, ns) else "segmented"
    if Lm <= SEGMENTED_MAX_LEN:
        return "stream8" if not is_local and Lm > STREAM8_MIN_LEN and B >= 2 else "segmented"
    return "stream" if B >= 2 else "pallas"


def _kernel_scores(engine: str, s1b, s2b, ms, ns, scores, is_local: bool):
    """Dispatch one named engine on tensors already on their device;
    returns (score, start_i, start_j) int32 tensors of shape (B,)."""
    if engine == "scan":
        raise NotImplementedError(f"engine 'scan' is {NOT_PORTED}")
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return _ENGINES[engine](s1b, s2b, ms, ns, scores, is_local)


def score_pairs(s1b, s2b, ms, ns, scores, is_local: bool = False,
                engine: str = "auto", device="cuda"):
    """Score a batch of encoded pairs (uint8 (B, Lm) and (B, Ln), true
    lengths ``ms``/``ns``) on ``device``: ``engine`` is ``"auto"``
    (:func:`route_engine`) or one of ``"shortread"``, ``"segmented"``,
    ``"stream8"``, ``"stream"``, ``"pallas"``. Returns numpy ``(score,
    start_i, start_j)`` int32 arrays of shape (B,)."""
    dev = resolve_device(device)
    if engine == "auto":
        engine = route_engine(s1b.shape[0], s1b.shape[1], s2b.shape[1], is_local, ms, ns)
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
