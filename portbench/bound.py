"""The bound model, a frozen copy of ``chip_smoke.py``'s: the least time
the card could take for a kernel's work, from the inputs alone.

Integer operations over the card's int32 rate (SMs x 64 lanes x the
largest SM clock, read on the card at run time) against bytes over the
H100 SXM's 3.35 TB/s (NVIDIA's data sheet); the larger bounds the kernel.
Operations a DP cell, counted from the recurrence: 12 global, 19 local,
+9 with direction codes; under a substitution matrix's profile 10 / 17,
+9; 21 a band cell. Bytes: every input once, 2 bits of codes a cell,
the results out; a query profile ``1 + 2A`` bytes a column of the query
(its byte in, ``A`` int16 values out), one profile a query, whatever a
program builds.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = {"global": 12, "local": 19, "dirs": 9}
OPS_PER_MATRIX_CELL = {"global": 10, "local": 17, "dirs": 9}
OPS_PER_BAND_CELL = 21
#: the largest SM clock of an H100 SXM (MHz), used when ``nvidia-smi``
#: gives none.
H100_MAX_SM_MHZ = 1980.0


def int32_rate(sms: int, max_sm_mhz: float) -> float:
    """Peak int32 operations a second: SMs x 64 lanes x the clock."""
    return float(sms) * 64.0 * float(max_sm_mhz) * 1e6


def smi(query: str) -> str | None:
    """One ``nvidia-smi --query-gpu`` field of card 0, or ``None``."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def card_rate(sms: int) -> tuple[float, float]:
    """(int32 ops/s, the SM clock used) of this card."""
    mhz = smi("clocks.max.sm")
    try:
        clock = float(mhz)
    except (TypeError, ValueError):
        clock = H100_MAX_SM_MHZ
    return int32_rate(sms, clock), clock


def bound_s(ops: float, nbytes: float, rate: float) -> tuple[float, str]:
    """(least seconds, what bounds it)."""
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fill(cells: float, chars: float, pairs: int, kind: str, dirs: bool = False,
         matrix: bool = False, profile_bytes: float = 0.0) -> tuple[float, float]:
    """(ops, bytes) of a Gotoh fill: ``cells`` interior cells over
    ``chars`` input characters (one byte each; four under a matrix's row
    codes) and ``pairs`` pairs (12 bytes of results each); ``kind`` is
    ``"global"`` or ``"local"``."""
    per = OPS_PER_MATRIX_CELL if matrix else OPS_PER_CELL
    ops = cells * (per[kind] + (per["dirs"] if dirs else 0))
    nbytes = chars * (4.0 if matrix else 1.0) + profile_bytes + 12.0 * pairs
    return ops, nbytes + (cells / 4.0 if dirs else 0.0)


def band(cells: float, chars: float) -> tuple[float, float]:
    """(ops, bytes) of a banded fill with codes."""
    return cells * OPS_PER_BAND_CELL, chars + cells / 4.0 + 4.0


def profile(cols: float, alphabet: int) -> tuple[float, float]:
    """(ops, bytes) of query profiles over ``cols`` columns in all."""
    return 0.0, cols * (1.0 + 2.0 * alphabet)


def share_pct(ops: float, nbytes: float, seconds: float, rate: float) -> tuple[float, str] | None:
    """Roofline share of work of ``ops`` operations and ``nbytes`` bytes
    that took ``seconds`` of the kernel's device time, and what bounds
    it; ``None`` when the kernel did not run."""
    if seconds <= 0 or (ops <= 0 and nbytes <= 0):
        return None
    least, by = bound_s(ops, nbytes, rate)
    return 100.0 * least / seconds, by
