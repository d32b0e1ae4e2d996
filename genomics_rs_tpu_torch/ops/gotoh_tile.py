"""Global boundary rows and columns (counterpart of
``global_boundary_top``/``global_boundary_left`` in
``genomics_rs_tpu/ops/gotoh_tile.py``)."""

from __future__ import annotations

import torch

from genomics_rs_tpu_torch.ops.gotoh_scan import NEG_INF


def global_boundary_top(j0: int, B: int, scores, device="cpu") -> torch.Tensor:
    """Row-0 I/S/D for columns j0..j0+B as (3, B+1) int32: the origin is
    0, and row 0 has I = h + j*g, S = D = -inf."""
    js = int(j0) + torch.arange(B + 1, dtype=torch.int32, device=device)
    at0 = js == 0
    I = torch.where(at0, 0, scores.h + js * scores.g).to(torch.int32)
    S = torch.where(at0, 0, NEG_INF).to(torch.int32)
    return torch.stack([I, S, S.clone()])


def global_boundary_left(i0: int, R: int, scores, device="cpu") -> torch.Tensor:
    """Col-0 I/S/D for rows i0+1..i0+R as (3, R) int32."""
    i_ = int(i0) + 1 + torch.arange(R, dtype=torch.int32, device=device)
    neg = torch.full((R,), NEG_INF, dtype=torch.int32, device=device)
    D = (scores.h + i_ * scores.g).to(torch.int32)
    return torch.stack([neg, neg.clone(), D])
