"""What every driver shares: inputs taken in turn, the sample of inputs
whose answers are kept for the check, and the comparison of kept
answers with the reference's.

A driver (``drivers/<name>.py``) defines ``Driver(ctx)`` with
``setup()``, ``warm()``, ``request(k)`` (the k-th request of the window;
it returns the answer on the host), ``cells(k)``, ``work(k)`` (kernel id
-> (ops, bytes) of the bound model), ``keep(k, answer)`` (a compact copy
for the check), ``release()`` (frees the program's state),
``reference(inputs, control)`` (the plain reference's answers by input,
or with ``control`` the control's); :class:`Cycle` gives the rest.
"""

from __future__ import annotations

import numpy as np

from portbench.gen import rng

#: the sample of inputs is drawn among the first inputs of the order, so
#: that a window reaches each of them.
SAMPLE_AMONG = 8


class Cycle:
    """Inputs ``0..n-1`` taken in turn, in a seeded order."""

    def __init__(self, ctx, n: int):
        self.ctx = ctx
        self.n = n
        self.order = rng(ctx.seed, 3).permutation(n)

    def input_of(self, k: int) -> int:
        return int(self.order[k % self.n])

    def sample_inputs(self, r: np.random.Generator, count: int) -> list[int]:
        """``count`` inputs: the first of the (seeded) order, so that any
        window compares one, and the rest drawn by the seed among the next
        of the order."""
        rest = self.order[1 : min(self.n, SAMPLE_AMONG)]
        k = min(max(count - 1, 0), rest.size)
        return [int(self.order[0])] + [int(x) for x in r.choice(rest, size=k, replace=False)]

    def same(self, got, want) -> bool:
        return np.array_equal(got, want)

    def check(self, kept: dict) -> list[tuple[str, float, float]]:
        """The kept answers against the plain reference's."""
        return compare(kept, self.reference(sorted(kept)), self.same)


def compare(kept: dict, want: dict, same) -> list[tuple[str, float, float]]:
    """The numbers compared: answers kept from the window that differ
    from the reference's (``same(got, want)`` is False), and whether any
    answer was compared at all."""
    n = sum(len(v) for v in kept.values())
    wrong = sum(0 if same(got, want[x]) else 1 for x, v in kept.items() for got in v)
    return [("wrong_answers", wrong, 0), ("no_answer_compared", int(n == 0), 0)]


def same_alignment(got: dict, want: dict) -> bool:
    """Score, start, every move (choice and cell) and the four counts."""
    keys = ("score", "start", "matches", "mismatches", "gap_extensions", "opening_gaps")
    return (all(got[k] == want[k] for k in keys)
            and all(np.array_equal(got[k], want[k]) for k in ("choice", "i", "j")))


def alignment_record(al, ids: dict) -> dict:
    """A program's ``AlignedSequences`` as plain numbers: choice codes
    (by ``ids``: id of each choice member -> reference code), cells,
    score, start and counts."""
    moves = al.alignment
    if moves:
        ch, ii, jj = zip(*moves)
    else:
        ch, ii, jj = (), (), ()
    return {"choice": np.fromiter(map(ids.__getitem__, map(id, ch)), np.uint8, len(ch)),
            "i": np.asarray(ii, np.int64), "j": np.asarray(jj, np.int64),
            "score": int(al.score), "start": (int(ii[0]), int(jj[0])) if moves else None,
            "matches": int(al.matches), "mismatches": int(al.mismatches),
            "gap_extensions": int(al.gap_extensions), "opening_gaps": int(al.opening_gaps)}


def choice_ids() -> dict:
    """id of each of the program's ``AlignmentChoice`` members -> the
    reference's choice code (by the member's name)."""
    from genomics_rs_tpu_torch.ops.traceback import AlignmentChoice

    from portbench.reference import CHOICE_NAMES

    return {id(c): CHOICE_NAMES.index(c.value) for c in AlignmentChoice}
