"""Banded global alignment: full traceback inside a diagonal band
(counterpart of ``genomics_rs_tpu/models/banded.py``).

For similar pairs (resequenced samples, same-species chromosomes) the
optimal path hugs the length-proportional diagonal, and a width-V band
captures it at O(m*V) cost instead of O(m*n).

Semantics: standard banded Gotoh. Cells outside the band are -inf, so
the result equals the full DP exactly when an optimal path stays inside
the band, and is a lower bound otherwise. With ``band >= len(seq2)`` the
band covers the whole matrix and the output equals the full aligner's.
"""

from __future__ import annotations

import logging

import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.gotoh_banded import gotoh_banded, walk_banded
from genomics_rs_tpu_torch.ops.traceback import AlignedSequences, classify_moves
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, round_up
from genomics_rs_tpu_torch.utils.profiling import annotate

log = logging.getLogger(__name__)


def align_banded(seq1: Sequence, seq2: Sequence, scores: Scores, band: int = 2048,
                 device="cuda") -> AlignedSequences:
    """Global alignment restricted to a width-``band`` diagonal band.

    Requires ``len(seq2) <= len(seq1)`` (the band tracks the
    length-proportional diagonal, which must slide at most one column
    per row: pass the longer sequence first). ``band`` is rounded up to
    a multiple of 1024 lanes, as in the JAX package: another width gives
    another result wherever an optimal path leaves the narrower band.
    ``device="cuda"`` runs the fill and walk kernels (K10, K11),
    ``"cpu"`` their plain versions.
    """
    m, n = len(seq1), len(seq2)
    if not 1 <= n <= m:
        raise ValueError(
            f"align_banded needs 1 <= len(seq2) ({n}) <= len(seq1) "
            f"({m}); pass the longer sequence first"
        )
    dev = resolve_device(device)
    V = max(round_up(band, 1024), 1024)
    with annotate("genomics/banded.encode"):
        s1e = torch.from_numpy(seq1.encoded(pad_to=max(round_up(m, 128), 128),
                                            pad_value=PAD_S1).copy()).to(dev)
        s2e = torch.from_numpy(seq2.encoded(pad_to=max(round_up(n, 128), V),
                                            pad_value=PAD_S2).copy()).to(dev)

    score, dirs = gotoh_banded(s1e, s2e, m, n, scores, V)
    codes = walk_banded(dirs, m, n, V)
    log.info("[Banded] %dx%d band=%d (%.3g band cells)", m, n, V, (m + 1.0) * V)
    return classify_moves(codes, m, n, score, seq1, seq2)
