"""DP cells of a request, counted from its inputs whatever computes them:
``m * n`` interior cells a full pair, the in-band cells a banded pair
(row ``i`` keeps columns ``off(i)+1 .. min(off(i)+V, n)``, ``off`` the
banded model's window start, copied in ``reference.band_offset``). A
refill of the same cells is not counted again."""

from __future__ import annotations

import numpy as np

from portbench.reference import band_offset


def full(ms, ns) -> float:
    """Interior cells of pairs with lengths ``ms`` x ``ns``."""
    return float(np.sum(np.asarray(ms, np.float64) * np.asarray(ns, np.float64)))


def banded(m: int, n: int, V: int) -> float:
    """In-band cells of rows 1..m of an m x n table at band ``V``."""
    off = band_offset(np.arange(1, m + 1), m, n, V)
    return float(np.sum(np.minimum(off + V, n) - off))


def band_width(band: int) -> int:
    """The band the banded model runs for a requested ``band``: rounded
    up to a multiple of 1,024 lanes, at least 1,024."""
    return max(-(-int(band) // 1024) * 1024, 1024)
