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
``genomics_rs_tpu/ops/traceback.py``: :func:`classify_moves` classifies
one walked path, :func:`classify_moves_batch` a batch of them in one
2-D pass (and one path, for ``classify_moves``, outside DEBUG logging).
"""

from __future__ import annotations

import dataclasses
import enum
import logging

import numpy as np

from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_STOP, DIR_SUB
from genomics_rs_tpu_torch.sequence import Sequence
from genomics_rs_tpu_torch.utils.profiling import annotate

log = logging.getLogger(__name__)


class AlignmentChoice(enum.Enum):
    """Mirror of the reference enum (``algo.rs:124-133``)."""

    MATCH = "Match"
    MISMATCH = "Mismatch"
    INSERT = "Insert"
    DELETE = "Delete"
    OPEN_INSERT = "OpenInsert"
    OPEN_DELETE = "OpenDelete"


#: choice object by numeric code (the numpy classifiers' paths).
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
    if not log.isEnabledFor(logging.DEBUG):
        # Whole-path numpy classification (a chromosome-scale path is
        # millions of moves; the per-move loop below, kept for the debug
        # trace and the empty path, costs seconds there): the batch
        # classifier on a batch of one, so both share one numpy body.
        codes_a = np.asarray(codes, dtype=np.uint8)
        if codes_a.size:
            return classify_moves_batch(codes_a[None], [codes_a.size], [start_i], [start_j],
                                        [score], [(seq1, seq2)])[0]
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


def classify_moves_batch(
    moves: np.ndarray,
    counts: np.ndarray,
    start_is: np.ndarray,
    start_js: np.ndarray,
    scores: np.ndarray,
    pairs: list[tuple[Sequence, Sequence]],
) -> list[AlignedSequences]:
    """:func:`classify_moves` over a whole batch in ONE 2-D numpy pass.

    ``moves`` is (B, T) uint8, row ``b`` holding pair ``b``'s codes in
    traceback order up to ``counts[b]``; what lies past ``counts[b]``
    (the walks' ``NO_MOVE`` padding) is never read. The result is
    bit-identical to :func:`classify_moves`' per-move loop, the
    reference's off-by-one ``is_match`` included, with one set of numpy
    calls for the batch in place of one a pair (``classify_moves`` runs
    this body on a batch of one). Under DEBUG logging (the per-move
    trace) and for ``T == 0`` it classifies pair by pair.
    """
    with annotate("genomics/traceback.classify"):
        B, T = moves.shape
        counts = np.asarray(counts, np.int64)
        if log.isEnabledFor(logging.DEBUG) or T == 0:
            return [classify_moves(moves[b, : int(counts[b])], int(start_is[b]),
                                   int(start_js[b]), int(scores[b]), a, s)
                    for b, (a, s) in enumerate(pairs)]
        if not B:
            return []
        # Only the live prefix: a walk buffer is padded far past its paths.
        T = min(T, max(int(counts.max()), 1))
        mask = np.arange(T)[None, :] < counts[:, None]
        codes = np.where(mask, moves[:, :T], 255).astype(np.uint8, copy=False)
        is_sub = codes == DIR_SUB
        is_ins = codes == DIR_INS
        is_del = codes == DIR_DEL
        valid = is_sub | is_ins | is_del
        if (valid != mask).any():
            raise ValueError(f"Unexpected move code {int(codes[mask & ~valid][0])}")
        # Position each move is taken AT (pre-move). Saturation never
        # disagrees with the cumsum in a valid table (a clamped axis only
        # receives codes that no longer move it); clip at 0 anyway so corrupt
        # inputs can't index negatively. Padding moves neither axis.
        di = mask & ~is_ins
        dj = mask & ~is_del
        i_at = np.maximum(np.asarray(start_is, np.int64)[:, None] - np.cumsum(di, axis=1) + di, 0)
        j_at = np.maximum(np.asarray(start_js, np.int64)[:, None] - np.cumsum(dj, axis=1) + dj, 0)
        # Both sequences' bytes at (i, j), 0x100 past either end (the
        # reference's None == None): each row ends in the sentinel, and an
        # index past a sequence's end is clipped onto it.
        l1 = np.array([len(a.sequence) for a, _ in pairs], np.int64)
        l2 = np.array([len(b.sequence) for _, b in pairs], np.int64)
        s1mat = np.full((B, int(l1.max()) + 1), 0x100, np.int16)
        s2mat = np.full((B, int(l2.max()) + 1), 0x100, np.int16)
        for b, (a, s) in enumerate(pairs):
            s1mat[b, : l1[b]] = np.frombuffer(a.sequence.encode("ascii"), np.uint8)
            s2mat[b, : l2[b]] = np.frombuffer(s.sequence.encode("ascii"), np.uint8)
        rows = np.arange(B)[:, None]
        c1 = s1mat[rows, np.minimum(i_at, l1[:, None])]
        c2 = s2mat[rows, np.minimum(j_at, l2[:, None])]
        match = is_sub & (c1 == c2)
        mismatch = is_sub & ~match
        prev = np.empty_like(codes)
        prev[:, 0] = 255
        prev[:, 1:] = codes[:, :-1]
        ins_open = is_ins & (prev != DIR_INS)
        del_open = is_del & (prev != DIR_DEL)
        ins_ext = is_ins & ~ins_open
        del_ext = is_del & ~del_open
        choice_code = np.zeros((B, T), np.uint8)
        choice_code[mismatch] = 1
        choice_code[ins_ext] = 2
        choice_code[ins_open] = 3
        choice_code[del_ext] = 4
        choice_code[del_open] = 5
        n_match = np.count_nonzero(match, axis=1)
        n_mis = np.count_nonzero(mismatch, axis=1)
        n_open = np.count_nonzero(ins_open | del_open, axis=1)
        n_ext = np.count_nonzero(ins_ext | del_ext, axis=1)
        out: list[AlignedSequences] = []
        for b, (a, s) in enumerate(pairs):
            c = int(counts[b])
            # Choice objects over the real path only, never the padding.
            out.append(AlignedSequences(
                s1=a,
                s2=s,
                alignment=list(zip(_CHOICE_ARR[choice_code[b, :c]].tolist(),
                                   i_at[b, :c].tolist(), j_at[b, :c].tolist())),
                score=int(scores[b]),
                matches=int(n_match[b]),
                mismatches=int(n_mis[b]),
                gap_extensions=int(n_ext[b]),
                opening_gaps=int(n_open[b]),
            ))
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
