"""Scoring configuration (counterpart of ``genomics_rs_tpu/config.py``).

TOML-compatible with the reference config format: a ``[scores]`` table
with integer ``s_match``, ``s_mismatch``, ``g`` (gap extension) and
``h`` (gap open), plus the optional ``s_transition`` extension.
"""

from __future__ import annotations

import dataclasses
import sys
import tomllib


@dataclasses.dataclass(frozen=True)
class Scores:
    """Affine-gap scoring parameters.

    A gap of length L costs ``h + L*g``. ``s_transition``, when set,
    scores DNA transitions (A<->G, C<->T, same case) apart from other
    mismatches (Kimura two-class scoring); ``None`` is the reference's
    two-score model.
    """

    s_match: int = 1
    s_mismatch: int = -2
    g: int = -1  # gap extension
    h: int = -5  # gap open
    s_transition: int | None = None

    def as_tuple(self) -> tuple:
        """Length 4 when classic, 5 with a transition score."""
        base = (self.s_match, self.s_mismatch, self.g, self.h)
        if self.s_transition is None:
            return base
        return base + (self.s_transition,)

    @classmethod
    def from_tuple(cls, t) -> "Scores":
        """Inverse of :meth:`as_tuple` (also of the JAX ``Scores``'s)."""
        return cls(*(int(v) for v in t))


@dataclasses.dataclass(frozen=True)
class Config:
    scores: Scores = dataclasses.field(default_factory=Scores)


def get_config(filepath: str = "config.toml") -> Config:
    """Load a TOML config file; exits with status 1 on a read or parse
    error, like the reference CLI."""
    try:
        with open(filepath, "rb") as f:
            raw = tomllib.load(f)
    except OSError:
        print(f"Could not read config file: {filepath}", file=sys.stderr)
        raise SystemExit(1)
    except tomllib.TOMLDecodeError:
        print(f"Could not parse config file: {filepath}", file=sys.stderr)
        raise SystemExit(1)

    try:
        s = raw["scores"]
        scores = Scores(
            s_match=int(s["s_match"]),
            s_mismatch=int(s["s_mismatch"]),
            g=int(s["g"]),
            h=int(s["h"]),
            s_transition=(
                int(s["s_transition"]) if "s_transition" in s else None
            ),
        )
    except (KeyError, TypeError, ValueError):
        print(f"Could not parse config file: {filepath}", file=sys.stderr)
        raise SystemExit(1)

    return Config(scores=scores)
