"""Center-star multiple sequence alignment (counterpart of
``genomics_rs_tpu/models/msa.py``).

1. **Center selection**: the all-pairs global score matrix
   (``parallel/allpairs``: the router's tier for each DNA bucket, the
   matrix fill under ``matrix=``); the center is the sequence with the largest summed score
   against the rest (ties: the smallest index).
2. **Star alignments**: every other sequence aligned globally to the
   center. DNA: one batched dirs fill and one batched walk per group
   (``models/aligner.stream_walk_group``: K3 + K4), or the per-pair
   aligner when one pair's bitmap passes ``STAR_PAIR_DIRS_BUDGET``.
   Protein: ``models/aligner.matrix_align_batch``.
3. **Merge**: "once a gap, always a gap". Between two center chars (a
   slot) the merged alignment carries the longest gap run any pairwise
   alignment put there, each row's inserted chars first and padding
   after (:func:`_build_rows`); the same columns as the sequential
   two-pointer merge (:func:`_merge_center`, kept as the test oracle).

``align-matrix --alignments-out`` renders each pair's gapped rows with
:func:`_alignment_ops` and :func:`_gapped_pair`.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.traceback import AlignedSequences, AlignmentChoice
from genomics_rs_tpu_torch.sequence import Sequence, SequenceContainer, round_up
from genomics_rs_tpu_torch.utils.profiling import PhaseTimer

log = logging.getLogger(__name__)

_GAP = "-"


@dataclasses.dataclass
class MSAResult:
    """A finished multiple alignment: ``rows[k]`` is the gapped row of
    ``names[k]``; all rows share one length, and removing the gaps gives
    back the input sequences."""

    names: list[str]
    rows: list[str]
    center_index: int
    #: [j][i] = global score for i <= j (lower triangle, like
    #: AllPairsResult.matrix).
    score_matrix: np.ndarray

    @property
    def width(self) -> int:
        return len(self.rows[0]) if self.rows else 0

    def conservation(self) -> str:
        """'*' where a column is gap-free and fully identical."""
        out = []
        for col in zip(*self.rows):
            first = col[0]
            out.append("*" if first != _GAP and all(ch == first for ch in col) else " ")
        return "".join(out)


def _alignment_ops(aln: AlignedSequences) -> str:
    """Forward per-column ops of a pairwise alignment: 'M' consumes a
    char of both sequences, 'I' only of s2 (gap in s1), 'D' only of s1
    (gap in s2), the display convention."""
    C = AlignmentChoice
    ops = []
    for choice, _, _ in reversed(aln.alignment):
        if choice in (C.INSERT, C.OPEN_INSERT):
            ops.append("I")
        elif choice in (C.DELETE, C.OPEN_DELETE):
            ops.append("D")
        else:
            ops.append("M")
    return "".join(ops)


def _gapped_pair(center: str, other: str, ops: str) -> tuple[str, str]:
    """Expand an op string into the two gapped row strings."""
    ci = oi = 0
    crow: list[str] = []
    orow: list[str] = []
    for op in ops:
        if op == "I":
            crow.append(_GAP)
        else:
            crow.append(center[ci])
            ci += 1
        if op == "D":
            orow.append(_GAP)
        else:
            orow.append(other[oi])
            oi += 1
    if ci != len(center) or oi != len(other):
        raise AssertionError(
            "pairwise alignment did not consume both sequences "
            f"({ci}/{len(center)}, {oi}/{len(other)})"
        )
    return "".join(crow), "".join(orow)


def _merge_center(master: str, rows: list[str], new_center: str,
                  new_row: str) -> tuple[str, list[str], str]:
    """Merge a gapped center into the master (once a gap, always a gap).

    ``master`` and ``new_center`` are two gapped spellings of the same
    center; the merged center takes a gap wherever either has one.
    Returns the merged center, the re-padded existing rows and the padded
    new row.
    """
    a = b = 0
    merged: list[str] = []
    take_a: list[int] = []  # source column of each merged column (-1: gap)
    take_b: list[int] = []
    la, lb = len(master), len(new_center)
    while a < la or b < lb:
        ca = master[a] if a < la else None
        cb = new_center[b] if b < lb else None
        if ca is not None and cb is not None and (ca == cb or (ca != _GAP and cb != _GAP)):
            # The same center char, or two aligned gap columns.
            merged.append(ca)
            take_a.append(a)
            take_b.append(b)
            a += 1
            b += 1
        elif ca == _GAP or cb is None:
            # The master has an extra gap column: pad the new row.
            merged.append(_GAP)
            take_a.append(a)
            take_b.append(-1)
            a += 1
        else:
            # The new alignment opened a gap the master lacks: pad the
            # master and every existing row.
            merged.append(_GAP)
            take_a.append(-1)
            take_b.append(b)
            b += 1
    out_rows = ["".join(r[i] if i >= 0 else _GAP for i in take_a) for r in rows]
    padded_new = "".join(new_row[i] if i >= 0 else _GAP for i in take_b)
    return "".join(merged), out_rows, padded_new


#: forward-op byte by walk move code (DIR_SUB/INS/DEL = 0/1/2).
_OP_BY_CODE = np.frombuffer(b"MID?", dtype=np.uint8)

#: largest per-pair packed bitmap the batched star stage builds; past
#: it, pairs go to the per-pair aligner (its checkpointed route).
STAR_PAIR_DIRS_BUDGET = 1 << 30


def _star_ops_batched(cseq: Sequence, others: list[Sequence], scores: Scores,
                      device) -> list[str]:
    """Per-pair forward op strings (M/I/D) of the center-vs-other global
    alignments: per group of ``models/aligner._stream_group_pairs``
    pairs, one batched dirs fill (K3) and one batched walk (K4)."""
    from genomics_rs_tpu_torch.models.aligner import (
        PAD_MULTIPLE,
        _stream_group_pairs,
        stream_walk_group,
    )
    from genomics_rs_tpu_torch.ops.traceback_batch import NO_MOVE
    from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2

    m = len(cseq)
    Lm = max(round_up(m, PAD_MULTIPLE), PAD_MULTIPLE)
    Ln = max(round_up(max(len(o) for o in others), PAD_MULTIPLE), PAD_MULTIPLE)
    s1e = cseq.encoded(pad_to=Lm, pad_value=PAD_S1)
    max_steps = round_up(Lm + Ln + 1, 8192)
    group = max(1, _stream_group_pairs(Lm, Ln, max_steps))
    ops: list[str] = []
    for g0 in range(0, len(others), group):
        chunk = others[g0 : g0 + group]
        s1b = np.stack([s1e] * len(chunk))
        s2b = np.stack([o.encoded(pad_to=Ln, pad_value=PAD_S2) for o in chunk])
        msg = np.full(len(chunk), m, np.int32)
        nsg = np.array([len(o) for o in chunk], np.int32)
        moves, counts, i_f, j_f, done, _, _, _ = stream_walk_group(
            s1b, s2b, msg, nsg, scores, False, max_steps, device)
        ok = done & (i_f == 0) & (j_f == 0)
        if not ok.all():
            bad = int(np.flatnonzero(~ok)[0])
            raise RuntimeError(
                f"batched star walk left the table at ({int(i_f[bad])}, {int(j_f[bad])})")
        for t in range(len(chunk)):
            mv = moves[t, : counts[t]][::-1]  # forward order
            if (mv == NO_MOVE).any():
                raise RuntimeError("batched star walk emitted a gap")
            ops.append(_OP_BY_CODE[mv].tobytes().decode())
    return ops


def _build_rows(center: str, others: list[str], ops_list: list[str]) -> tuple[str, list[str]]:
    """Merged MSA rows from per-pair op strings (slot-count merge).

    Slot p is the gap run between center chars p-1 and p (slot 0 before
    the first, slot C after the last). The merged width gives every slot
    the longest run over all pairs; each row places its own inserted
    chars at the head of the slot and pads the rest: the columns of the
    sequential merge (:func:`_merge_center`), in O(width) numpy a row.
    """
    C = len(center)
    K1 = len(others)
    gaps = np.zeros((K1, C + 1), np.int64)
    parsed = []
    for k, ops in enumerate(ops_list):
        opsb = np.frombuffer(ops.encode("latin-1"), np.uint8)
        isI = opsb == ord("I")
        ccex = np.concatenate([[0], np.cumsum(~isI)[:-1]])
        slots = ccex[isI]
        gaps[k] = np.bincount(slots, minlength=C + 1)
        parsed.append((opsb, isI, ccex, slots))
    M = gaps.max(axis=0) if K1 else np.zeros(C + 1, np.int64)
    W = C + int(M.sum())
    preM = np.concatenate([[0], np.cumsum(M)])
    base = np.arange(C + 1) + preM[:-1]  # slot p's first column
    pos_center = base[:C] + M[:C]  # center char p's column
    center_b = np.frombuffer(center.encode("latin-1"), np.uint8)
    master = np.full(W, ord(_GAP), np.uint8)
    master[pos_center] = center_b
    rows: list[str] = []
    for (opsb, isI, ccex, slots), other in zip(parsed, others):
        if (~isI).sum() != C:
            raise AssertionError(
                f"pairwise alignment did not consume the center ({int((~isI).sum())}/{C})")
        other_b = np.frombuffer(other.encode("latin-1"), np.uint8)
        noD = opsb != ord("D")
        if noD.sum() != len(other):
            raise AssertionError(
                "pairwise alignment did not consume the row sequence "
                f"({int(noD.sum())}/{len(other)})"
            )
        oiex = np.concatenate([[0], np.cumsum(noD)[:-1]])
        out = np.full(W, ord(_GAP), np.uint8)
        cops = opsb[~isI]  # the op consuming each center char
        m_mask = cops == ord("M")
        out[pos_center[m_mask]] = other_b[oiex[~isI][m_mask]]
        # I-run chars go at the head of their slot, in run order.
        rank = np.arange(len(slots)) - np.searchsorted(slots, slots)
        out[base[slots] + rank] = other_b[oiex[isI]]
        rows.append(out.tobytes().decode("latin-1"))
    return master.tobytes().decode("latin-1"), rows


def center_star_msa(container: SequenceContainer, scores: Scores, engine: str = "auto",
                    matrix=None, device="cuda") -> MSAResult:
    """Multiple alignment of every sequence in ``container`` on
    ``device`` (``"cuda"`` runs the kernels, ``"cpu"`` their plain
    versions).

    ``engine``: ``"auto"`` and ``"pallas"`` take the batched route, the
    DNA score pass on that engine (``"pallas"``: K9 on every bucket);
    ``"scan"`` scores with the scan fill and aligns each sequence to the
    center with the scan aligner, as the JAX package does (under a
    matrix, as JAX, the score pass and star stage stay on the matrix
    fill). ``matrix`` (a ``SubstMatrix``) switches
    to full-matrix scoring, protein MSA: ``allpairs_matrix_scores`` and
    ``matrix_align_batch``; gap costs still come from
    ``scores.g``/``scores.h``.
    """
    from genomics_rs_tpu_torch.models.aligner import PairwiseAligner, matrix_align_batch
    from genomics_rs_tpu_torch.parallel.allpairs import allpairs_matrix_scores, allpairs_scores

    if engine not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device)
    seqs = container.sequences
    if not seqs:
        raise ValueError("msa needs at least one sequence")
    names = [s.name for s in seqs]
    if len(seqs) == 1:
        return MSAResult(names, [seqs[0].sequence], 0, np.zeros((1, 1), np.int64))

    with PhaseTimer("msa", device=dev).span("compute the pairwise score matrix"):
        if matrix is not None:
            ap = allpairs_matrix_scores(container, matrix, g=scores.g, h=scores.h,
                                        is_local=False, device=dev)
        else:
            ap = allpairs_scores(container, scores, is_local=False, engine=engine, device=dev)
    # Symmetrize the lower triangle; the diagonal (self scores) stays out
    # of the center sum.
    mat = ap.matrix
    full = mat + mat.T
    np.fill_diagonal(full, 0)
    sums = full.sum(axis=1)
    center = int(np.argmax(sums))
    log.info("MSA center: %s (summed score %d)", names[center], sums[center])

    cseq = seqs[center]
    order = [k for k in range(len(seqs)) if k != center]
    others = [seqs[k] for k in order]
    Lm_est = max(round_up(len(cseq), 128), 128)
    Ln_est = max(round_up(max((len(o) for o in others), default=1), 128), 128)
    est_dirs = (Lm_est + Ln_est + 1) * round_up(Lm_est + 1, 1024) // 4
    with PhaseTimer("msa", device=dev).span("align the corpus to the center"):
        if matrix is not None:
            alns = matrix_align_batch([(cseq, o) for o in others], matrix, g=scores.g,
                                      h=scores.h, is_local=False, device=dev)
            ops_list = [_alignment_ops(al) for al in alns]
        elif engine != "scan" and est_dirs <= STAR_PAIR_DIRS_BUDGET:
            ops_list = _star_ops_batched(cseq, others, scores, dev)
        else:
            aligner = PairwiseAligner(scores, is_local=False, device=dev, engine=engine)
            ops_list = [_alignment_ops(aligner.align(cseq, o)) for o in others]
        master, rows = _build_rows(cseq.sequence, [o.sequence for o in others], ops_list)

    # Rows back in corpus order, center included.
    all_rows = [""] * len(seqs)
    all_rows[center] = master
    for pos, k in enumerate(order):
        all_rows[k] = rows[pos]
    return MSAResult(names, all_rows, center, mat)


def write_msa_fasta(result: MSAResult, path: str) -> None:
    """Aligned-FASTA output (60-column wrapped)."""
    with open(path, "w") as f:
        for name, row in zip(result.names, result.rows):
            f.write(f">{name}\n")
            for i in range(0, len(row), 60):
                f.write(row[i : i + 60] + "\n")


def format_msa_clustal(result: MSAResult, width: int = 60) -> str:
    """CLUSTAL-style block rendering with a conservation line."""
    cons = result.conservation()
    namew = max((len(n) for n in result.names), default=0)
    namew = min(max(namew, 10), 30)
    lines = ["genomics_rs_tpu multiple sequence alignment", ""]
    for start in range(0, result.width, width):
        for name, row in zip(result.names, result.rows):
            lines.append(f"{name[:namew]:<{namew}}  {row[start:start + width]}")
        lines.append(f"{'':<{namew}}  {cons[start:start + width]}")
        lines.append("")
    return "\n".join(lines)
