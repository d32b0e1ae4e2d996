"""Batched pair scoring (counterpart of ``genomics_rs_tpu/parallel/batch.py``:
``score_pairs``, ``_kernel_scores``, ``pad_batch`` and the router's tier
bounds).

The JAX router picks one of five TPU kernels by padded length
(shortread up to ``SHORTREAD_MAX_LEN``, segmented or stream8 up to
``SEGMENTED_MAX_LEN``, the stream kernel beyond). Two are ported: the
short-read kernel K6 (``"shortread"``) and the stream kernel K3
(``"stream"``), which fills one pair per thread block at any length.
``"auto"`` sends a bucket with ``max(L1, L2) <= SHORTREAD_MAX_LEN`` and
no empty sequence to K6 and every other bucket to K3: the kernels on a
CUDA device, their plain versions on the CPU. The other engines, and
``"scan"``, raise until their kernels land (ROADMAP Queue B K7–K9). The
mesh paths (``batch_scores_sharded``, ``device_loop_scores``) wait for
ROADMAP Queue A item 14.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.gotoh_shortread import SHORTREAD_MAX_LEN, gotoh_scores_shortread
from genomics_rs_tpu_torch.ops.gotoh_stream import gotoh_scores_stream

#: The JAX router's tier bounds (padded lengths): the short-read tier
#: (K6) up to ``SHORTREAD_MAX_LEN``, kept for the tiers K7–K9 will
#: serve: the row-segmented tier up to this one...
SEGMENTED_MAX_LEN = 8192
#: ...with the 8-stream tier above this one in global mode.
STREAM8_MIN_LEN = 1024

NOT_PORTED = "not yet ported (ROADMAP Queue B K7–K9)"
_UNPORTED = ("segmented", "stream8", "pallas", "scan")


def shortread_fits(L1: int, L2: int, ms, ns) -> bool:
    """True when K6 takes a (L1, L2) bucket: both padded lengths within
    ``SHORTREAD_MAX_LEN`` and no empty sequence."""
    return (max(L1, L2) <= SHORTREAD_MAX_LEN and L2 % 16 == 0
            and int(np.min(ms, initial=1)) >= 1 and int(np.min(ns, initial=1)) >= 1)


def _kernel_scores(engine: str, s1b, s2b, ms, ns, scores, is_local: bool):
    """Dispatch one named engine on tensors already on their device;
    returns (score, start_i, start_j) int32 tensors of shape (B,)."""
    if engine == "stream":
        return gotoh_scores_stream(s1b, s2b, ms, ns, scores, is_local)
    if engine == "shortread":
        return gotoh_scores_shortread(s1b, s2b, ms, ns, scores, is_local)
    if engine in _UNPORTED:
        raise NotImplementedError(f"engine {engine!r} is {NOT_PORTED}")
    raise ValueError(f"unknown engine {engine!r}")


def score_pairs(s1b, s2b, ms, ns, scores, is_local: bool = False,
                engine: str = "auto", device="cuda"):
    """Score a batch of encoded pairs (uint8 (B, Lm) and (B, Ln), true
    lengths ``ms``/``ns``) on ``device``. ``"auto"`` runs K6 or K3 (their
    plain versions on the CPU), ``"shortread"`` K6, ``"stream"`` K3.
    Returns numpy ``(score, start_i, start_j)`` int32 arrays of shape
    (B,)."""
    dev = resolve_device(device)
    if engine == "auto":
        fits = shortread_fits(s1b.shape[1], s2b.shape[1], ms, ns)
        engine = "shortread" if fits else "stream"
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
