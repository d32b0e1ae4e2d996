"""Suffix array and Burrows-Wheeler Transform as torch ops on a device
(counterpart of ``genomics_rs_tpu/ops/bwt_device.py``, whose rounds are
``lax.sort`` calls).

A prefix-doubling suffix array: ceil(log2(cap)) rounds, each one
``torch.sort`` of the composite key (rank, rank of the suffix k places
on), then dense ranks from a cumulative sum of the sorted keys' changes,
scattered back. Then

    BWT[k] = s'[SA[k] - 1]   (wrapping: SA[k] == 0 -> terminator)

which equals the suffix tree's DFS BWT (``compute_stats``): suffixes
compare in ASCII byte order, as the tree's sorted-alphabet child slots
do, and the terminator '$' (0x24) sorts below A/C/G/T.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device

TERMINATOR = 0x24  # '$'


def _suffix_array_padded(s: torch.Tensor, rounds: int) -> torch.Tensor:
    """SA (int64) of the whole uint8 tensor ``s``; its ranks are the JAX
    version's, round for round.

    ``torch.sort`` is not stable, which is harmless: equal keys get equal
    dense ranks whatever their order, and after the last round every rank
    is distinct (the prefixes compared are at least ``len(s)`` long), so
    the final scatter is a permutation."""
    cap = s.shape[0]
    rank = s.to(torch.int64)
    # rank2 + 1 lies in [0, max(cap, 256)]: the key is exact in int64.
    base = max(cap, 256) + 1
    changed = torch.empty(cap, dtype=torch.bool, device=s.device)
    changed[0] = False
    for i in range(rounds):
        k = 1 << i
        rank2 = torch.full_like(rank, -1)
        if k < cap:
            rank2[: cap - k] = rank[k:]
        skey, order = torch.sort(rank * base + (rank2 + 1))
        changed[1:] = skey[1:] != skey[:-1]
        rank = torch.empty_like(rank).scatter_(0, order, torch.cumsum(changed, 0))
    return torch.empty_like(rank).scatter_(
        0, rank, torch.arange(cap, dtype=torch.int64, device=s.device))


def suffix_array(text: str | bytes, device="cuda") -> np.ndarray:
    """Suffix array (int32) of ``text + '$'`` (terminator included),
    computed on ``device``.

    The input is padded to the next power of two with 0xFF, as the JAX
    version pads it: every real suffix is decided at or before the unique
    '$' (so pad bytes are never consulted between real suffixes), and
    pad-region suffixes start with 0xFF > any real byte, so they sort
    strictly last and the first len + 1 entries are the unpadded SA."""
    dev = resolve_device(device)
    if isinstance(text, str):
        text = text.encode("latin-1")
    s = np.frombuffer(text + b"$", dtype=np.uint8)
    n = len(s)
    cap = 1 << max(1, math.ceil(math.log2(n)))
    padded = np.concatenate([s, np.full(cap - n, 0xFF, dtype=np.uint8)])
    rounds = max(1, math.ceil(math.log2(cap)))
    sa = _suffix_array_padded(torch.from_numpy(padded).to(dev), rounds)
    return sa[:n].to(torch.int32).cpu().numpy()


def bwt_device(text: str | bytes, device="cuda") -> str:
    """BWT of ``text`` (with '$' terminator), identical to the
    suffix-tree DFS BWT of ``compute_stats`` for string 0."""
    if isinstance(text, str):
        text = text.encode("latin-1")
    s = np.frombuffer(text + b"$", dtype=np.uint8)
    sa = suffix_array(text, device)
    return s[(sa - 1) % len(s)].tobytes().decode("latin-1")
