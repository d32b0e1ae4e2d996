"""Host-side traceback over 2-bit direction codes.

Reproduces the reference retrace (``src/alignment/algo.rs:287-441``)
bit-for-bit:

* arm priority S > I > D is already baked into the direction codes;
* match/mismatch classification at cell (i, j) uses ``is_match(i, j)``
  with the reference's off-by-one indexing and None==None semantics
  (``algo.rs:354``, ``sequence.rs:102-115``, SURVEY §2.4-5);
* open vs extension gap classification follows ``last_choice`` exactly
  (``algo.rs:372-399``): ``last_choice`` starts as Match, and is set to
  the *non-open* variant after an open;
* movement uses the checked_sub semantics (``algo.rs:412-421``):
  saturate at 0 per axis, break when both hit None or when (0, 0) is
  reached after a move;
* local mode terminates on a max==0 cell only when none of S/I/D equals
  the max (``algo.rs:401-405``) — encoded as DIR_STOP.

The traceback is O(m+n) and pointer-chasing, so it runs on host over a
numpy view of the direction array. A copy of
``genomics_rs_tpu/ops/traceback.py`` without the batch classifier.
"""

from __future__ import annotations

import dataclasses
import enum
import logging

import numpy as np

from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_STOP, DIR_SUB
from genomics_rs_tpu_torch.sequence import Sequence

log = logging.getLogger(__name__)


class AlignmentChoice(enum.Enum):
    """Mirror of the reference enum (``algo.rs:124-133``)."""

    MATCH = "Match"
    MISMATCH = "Mismatch"
    INSERT = "Insert"
    DELETE = "Delete"
    OPEN_INSERT = "OpenInsert"
    OPEN_DELETE = "OpenDelete"


#: choice object by numeric code (classify_moves' vectorized path).
_CHOICE_ARR = np.array(
    [
        AlignmentChoice.MATCH,
        AlignmentChoice.MISMATCH,
        AlignmentChoice.INSERT,
        AlignmentChoice.OPEN_INSERT,
        AlignmentChoice.DELETE,
        AlignmentChoice.OPEN_DELETE,
    ],
    dtype=object,
)


@dataclasses.dataclass
class AlignedSequences:
    """Mirror of ``AlignedSequences`` (``algo.rs:135-146``).

    ``alignment`` is in traceback order (end of the alignment first),
    entries are ``(choice, i, j)`` with the 1-indexed table coordinates
    of the cell at which the move was taken.
    """

    s1: Sequence
    s2: Sequence
    alignment: list[tuple[AlignmentChoice, int, int]]
    score: int
    matches: int
    mismatches: int
    gap_extensions: int
    opening_gaps: int


def _is_match_ref(s1: bytes, s2: bytes, i: int, j: int) -> bool:
    """Reference ``is_match``: None == None past both ends is a match."""
    c1 = s1[i] if i < len(s1) else None
    c2 = s2[j] if j < len(s2) else None
    return c1 == c2


def classify_moves(
    codes,
    start_i: int,
    start_j: int,
    score: int,
    seq1: Sequence,
    seq2: Sequence,
) -> AlignedSequences:
    """Build AlignedSequences from a pre-walked move-code sequence.

    ``codes`` are DIR_* codes along the path starting at
    (start_i, start_j) (end of the alignment first), already
    terminated — no stop codes inside. Movement and classification
    replicate ``traceback_host`` exactly (same reference semantics);
    used by the checkpointed long-pair traceback whose walking happens
    on device (``ops/traceback_device.py``).
    """
    s1 = seq1.sequence.encode("ascii")
    s2 = seq2.sequence.encode("ascii")
    i, j = int(start_i), int(start_j)
    out = AlignedSequences(
        s1=seq1,
        s2=seq2,
        alignment=[],
        score=int(score),
        matches=0,
        mismatches=0,
        gap_extensions=0,
        opening_gaps=0,
    )
    # Per-step retrace traces mirror the reference's RUST_LOG=debug
    # output (``algo.rs:360-399``: "Match found at (i, j)" etc.); the
    # reference also prints the cell max, which the 2-bit direction
    # codes no longer carry — documented deviation.
    dbg = log.isEnabledFor(logging.DEBUG)
    if not dbg:
        # Whole-path numpy classification: a chromosome-scale path is
        # millions of moves — the per-move Python loop below (kept for
        # the debug-trace parity path) costs seconds. Same semantics.
        codes_a = np.asarray(codes, dtype=np.uint8)
        T = codes_a.shape[0]
        is_sub = codes_a == DIR_SUB
        is_ins = codes_a == DIR_INS
        is_del = codes_a == DIR_DEL
        if T and not bool((is_sub | is_ins | is_del).all()):
            bad = codes_a[~(is_sub | is_ins | is_del)][0]
            raise ValueError(f"Unexpected move code {int(bad)}")
        di = np.where(is_ins, 0, 1)
        dj = np.where(is_del, 0, 1)
        # Position each move is taken AT (pre-move). Saturation never
        # disagrees with the cumsum in a valid table (a clamped axis
        # only receives codes that no longer move it); clip anyway so
        # corrupt inputs can't index negatively.
        i_at = np.maximum(i - np.cumsum(di) + di, 0)
        j_at = np.maximum(j - np.cumsum(dj) + dj, 0)
        # Reference is_match quirk: bytes AT (i, j) (algo.rs:354) with
        # None == None past both ends (sentinel 0x100).
        s1a = np.frombuffer(s1, np.uint8).astype(np.int32)
        s2a = np.frombuffer(s2, np.uint8).astype(np.int32)
        c1 = np.where(
            i_at < len(s1a),
            s1a[np.minimum(i_at, max(len(s1a) - 1, 0))]
            if len(s1a)
            else 0x100,
            0x100,
        )
        c2 = np.where(
            j_at < len(s2a),
            s2a[np.minimum(j_at, max(len(s2a) - 1, 0))]
            if len(s2a)
            else 0x100,
            0x100,
        )
        match = is_sub & (c1 == c2)
        mismatch = is_sub & ~match
        prev = np.empty_like(codes_a)
        prev[0:1] = 255
        prev[1:] = codes_a[:-1]
        ins_open = is_ins & (prev != DIR_INS)
        del_open = is_del & (prev != DIR_DEL)
        out.matches = int(match.sum())
        out.mismatches = int(mismatch.sum())
        out.opening_gaps = int(ins_open.sum() + del_open.sum())
        out.gap_extensions = int(
            (is_ins & ~ins_open).sum() + (is_del & ~del_open).sum()
        )
        choice_code = np.zeros(T, np.uint8)
        choice_code[mismatch] = 1
        choice_code[is_ins & ~ins_open] = 2
        choice_code[ins_open] = 3
        choice_code[is_del & ~del_open] = 4
        choice_code[del_open] = 5
        ch_objs = _CHOICE_ARR[choice_code]
        out.alignment = list(
            zip(ch_objs.tolist(), i_at.tolist(), j_at.tolist())
        )
        return out
    last_choice = AlignmentChoice.MATCH
    for code in codes:
        code = int(code)
        if code == DIR_SUB:
            if _is_match_ref(s1, s2, i, j):
                last_choice = AlignmentChoice.MATCH
                out.matches += 1
                out.alignment.append((AlignmentChoice.MATCH, i, j))
                if dbg:
                    log.debug("Match found at (%d, %d)", i, j)
            else:
                last_choice = AlignmentChoice.MISMATCH
                out.mismatches += 1
                out.alignment.append((AlignmentChoice.MISMATCH, i, j))
                if dbg:
                    log.debug("Mismatch found at (%d, %d)", i, j)
            i = max(i - 1, 0)
            j = max(j - 1, 0)
        elif code == DIR_INS:
            if last_choice == AlignmentChoice.INSERT:
                out.gap_extensions += 1
                choice = AlignmentChoice.INSERT
            else:
                out.opening_gaps += 1
                choice = AlignmentChoice.OPEN_INSERT
            out.alignment.append((choice, i, j))
            last_choice = AlignmentChoice.INSERT
            if dbg:
                log.debug("Insert found at (%d, %d)", i, j)
            j = max(j - 1, 0)
        elif code == DIR_DEL:
            if last_choice == AlignmentChoice.DELETE:
                out.gap_extensions += 1
                choice = AlignmentChoice.DELETE
            else:
                out.opening_gaps += 1
                choice = AlignmentChoice.OPEN_DELETE
            out.alignment.append((choice, i, j))
            last_choice = AlignmentChoice.DELETE
            if dbg:
                log.debug("Delete found at (%d, %d)", i, j)
            i = max(i - 1, 0)
        else:
            raise ValueError(f"Unexpected move code {code}")
    return out


def traceback_host(
    dirs: np.ndarray,
    start_i: int,
    start_j: int,
    score: int,
    seq1: Sequence,
    seq2: Sequence,
    is_local: bool,
) -> AlignedSequences:
    """Walk ``dirs`` from the start cell, then classify the moves.

    Movement rules mirror the reference retrace (``algo.rs:339-421``):
    per-axis checked_sub saturation, break when both axes underflow or
    when (0, 0) is reached after a move, local termination on a stop
    code. Classification (stats, open vs extend, is_match quirks) is
    shared with the checkpointed path via :func:`classify_moves`.
    """
    i, j = int(start_i), int(start_j)
    codes: list[int] = []
    while True:
        code = int(dirs[i + j, i])
        if code == DIR_STOP:
            if is_local:
                break
            raise RuntimeError(
                f"Unexpected stop code during global retrace at ({i}, {j})"
            )
        codes.append(code)
        if code == DIR_SUB:
            ni = i - 1 if i > 0 else None
            nj = j - 1 if j > 0 else None
        elif code == DIR_INS:
            ni = i
            nj = j - 1 if j > 0 else None
        else:
            ni = i - 1 if i > 0 else None
            nj = j
        if ni is None and nj is None:
            break
        i = ni if ni is not None else 0
        j = nj if nj is not None else 0
        if i == 0 and j == 0:
            break

    return classify_moves(codes, start_i, start_j, score, seq1, seq2)
