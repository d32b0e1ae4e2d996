"""Pairwise aligner: the user-facing alignment API (counterpart of
``genomics_rs_tpu/models/aligner.py``'s ``PairwiseAligner``,
``align_pair`` and ``align_batch``).

``align`` fills the whole table with the row-block fill as ONE block,
keeping the 2-bit direction codes packed (``ops/gotoh_rowblock``),
chases them on the device (``ops/traceback_device.device_walk``), and
classifies the moves on the host. A pair whose packed bitmap would
exceed ``DIRS_BYTE_BUDGET`` goes to the checkpointed path
(``models/longalign``), which gives the same result in linear space.

``align_batch`` gives the same alignments for many pairs at once: one
batched fill with dirs per group of pairs (``ops/gotoh_stream``, K3 on
the warp-strip pipeline) and one batched walk (K4, through
``ops/traceback_batch.walk_batch``), in :func:`stream_walk_group`,
which ``models/reads.align_reads`` shares for reads too wide for K6.

Under a substitution matrix (``matrix=``, protein) both fill with the
matrix fill (``ops/gotoh_matrix``: query profile, then K3's pipeline):
``PairwiseAligner`` one pair with dirs, walked by K2, with no
checkpointed route (as in the JAX package); :func:`matrix_align_batch`
one fill with dirs per group and one K4 walk, then host classification:
one 2-D ``classify_moves_batch`` pass a group.

``engine="scan"`` (the JAX package's ``lax.scan`` oracle) fills with
``ops/gotoh_scan.gotoh_fill_scan`` instead, uint8 dirs a cell (under a
matrix from its byte-pair table), and walks them on the host
(``ops/traceback.traceback_host``), with no checkpointed route, as JAX's
scan engine does; ``align_batch(engine="scan")`` runs it pair by pair.
``"auto"`` and ``"pallas"`` are the kernel routes above; neither reaches
the scan, and the scan reaches no kernel.

Sequences are padded to multiples of ``PAD_MULTIPLE``, as in the JAX
package, so both packages fill tables of the same shape.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.gotoh_matrix import gotoh_matrix_fill
from genomics_rs_tpu_torch.ops.gotoh_matrix_stream import gotoh_matrix_stream_fill_dirs
from genomics_rs_tpu_torch.ops.gotoh_pallas import raise_on_err as raise_pipe_err
from genomics_rs_tpu_torch.ops.gotoh_rowblock import gotoh_rowblock, raise_on_err
from genomics_rs_tpu_torch.ops.gotoh_scan import FillResult, gotoh_fill_scan
from genomics_rs_tpu_torch.ops.gotoh_stream import dirs_shape, gotoh_stream_fill_dirs
from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_top
from genomics_rs_tpu_torch.ops.subst import warn_unknown_bytes
from genomics_rs_tpu_torch.ops.traceback import (
    AlignedSequences,
    classify_moves,
    classify_moves_batch,
    traceback_host,
)
from genomics_rs_tpu_torch.ops.traceback_batch import NO_MOVE, walk_batch
from genomics_rs_tpu_torch.ops.traceback_device import device_walk
from genomics_rs_tpu_torch.ops.traceback_walker import MAX_STEPS_CAP, MPW
from genomics_rs_tpu_torch.sequence import (
    PAD_S1,
    PAD_S2,
    Sequence,
    SequenceContainer,
    round_up,
)
from genomics_rs_tpu_torch.utils.profiling import PhaseTimer, spinner

log = logging.getLogger(__name__)

PAD_MULTIPLE = 128

#: ``PairwiseAligner``/``align_batch`` engines.
ENGINES = ("auto", "pallas", "scan")


def _encode(seq: Sequence, pad_to: int, pad_value: int, device) -> torch.Tensor:
    arr = seq.encoded(pad_to=pad_to, pad_value=pad_value).copy()
    return torch.from_numpy(arr).to(device)


def _fill(s1e, s2e, m: int, n: int, scores: Scores, is_local: bool,
          emit_dirs: bool = True, matrix=None, engine: str = "auto") -> FillResult:
    """The whole (m+1) x (n+1) table: one row block, or under ``matrix``
    one matrix fill at B = 1; ``engine="scan"`` the scan fill (numpy
    uint8 dirs). Scores and starts come back as ints."""
    if engine == "scan":
        lut = None if matrix is None else np.ascontiguousarray(matrix.byte_lut(), np.int32)
        f = gotoh_fill_scan(s1e, s2e, m, n, scores, is_local, emit_dirs=emit_dirs,
                            subst_lut=lut)
        score, si, sj = torch.stack([f.score, f.start_i, f.start_j]).tolist()
        return FillResult(dirs=f.dirs.cpu().numpy() if emit_dirs else None, score=score,
                          start_i=si, start_j=sj)
    if matrix is not None:
        f = gotoh_matrix_fill(s1e[None], s2e[None], [m], [n], matrix, scores.g, scores.h,
                              is_local, emit_dirs, route="stream")
        score, si, sj, err = torch.stack(
            [f.score[0], f.start_i[0], f.start_j[0], f.err]).tolist()
        raise_pipe_err(err, "gotoh_matrix")
        return FillResult(dirs=None if f.dirs is None else f.dirs[0], score=score,
                          start_i=si, start_j=sj)
    res = gotoh_rowblock(
        s1e, s2e,
        global_boundary_top(0, s2e.shape[0], scores, device=s2e.device),
        m, n, 0, scores, is_local,
        emit_dirs=emit_dirs, emit_bottom=False,
    )
    at_mn, v, bi, bj, err = torch.stack([res.score_at_mn, *res.best, res.err]).tolist()
    raise_on_err(err)
    score, si, sj = (v, bi, bj) if is_local else (at_mn, m, n)
    return FillResult(dirs=res.dirs, score=score, start_i=si, start_j=sj)


class PairwiseAligner:
    """Global (Needleman-Wunsch) / local (Smith-Waterman) affine-gap
    aligner.

    Args:
      scores: scoring parameters (``s_transition`` turns on kimura
        transition scoring).
      is_local: local vs global alignment.
      device: ``"cuda"`` runs the CUDA kernels (an error when CUDA is
        absent), ``"cpu"`` their plain PyTorch versions.
      matrix: optional full substitution matrix (``ops/subst.SubstMatrix``,
        e.g. ``get_matrix("BLOSUM62")``) for protein alignment; gap costs
        still come from ``scores.g``/``scores.h``. Mutually exclusive with
        ``s_transition``.
      engine: ``"auto"`` or ``"pallas"`` (the kernels, the same route) or
        ``"scan"`` (the scan fill and the host walk, on ``device``).
    """

    #: Largest monolithic PACKED direction bitmap (bytes) before routing
    #: to the checkpointed linear-space path.
    DIRS_BYTE_BUDGET = 256 << 20
    #: Above this many rows, scores come from rolling row blocks.
    SCORE_ROWS_LIMIT = 131072

    def __init__(self, scores: Scores, is_local: bool = False, device="cuda", matrix=None,
                 engine: str = "auto"):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        self.scores = scores
        self.is_local = is_local
        self.device = resolve_device(device)
        self.matrix = matrix
        self.engine = engine
        if matrix is not None and scores.s_transition is not None:
            raise ValueError("matrix and scores.s_transition are mutually exclusive")

    def align(self, seq1: Sequence, seq2: Sequence) -> AlignedSequences:
        m, n = len(seq1), len(seq2)
        Lm = max(round_up(m, PAD_MULTIPLE), PAD_MULTIPLE)
        Ln = max(round_up(n, PAD_MULTIPLE), PAD_MULTIPLE)

        # The monolithic packed bitmap is (Lm+Ln+1) x roundup(Lm+1, 1024)
        # / 4 bytes; past the budget the checkpointed path bounds it.
        est_dirs = (Lm + Ln + 1) * (round_up(Lm + 1, 1024)) // 4
        scan = self.engine == "scan"
        if self.matrix is None and not scan and est_dirs > self.DIRS_BYTE_BUDGET:
            from genomics_rs_tpu_torch.models.longalign import align_checkpointed

            block_rows = min(65535, max(round_up(m + 1, 1024) - 1, 1023))
            log.info(
                "align: %dx%d exceeds dirs budget -> windowed "
                "checkpointed path (block_rows=%d)",
                m, n, block_rows,
            )
            return align_checkpointed(
                seq1, seq2, self.scores, is_local=self.is_local,
                block_rows=block_rows, device=self.device,
            )

        s1e = _encode(seq1, Lm, PAD_S1, self.device)
        s2e = _encode(seq2, Ln, PAD_S2, self.device)
        if self.matrix is not None:
            warn_unknown_bytes(
                self.matrix, np.concatenate([seq1.encoded()[:m], seq2.encoded()[:n]]),
                where="align",
            )
        timer = PhaseTimer("align", device=self.device)
        with spinner(
            "Computing sequence table...", "Sequence table computed"
        ), timer.span("fill table", cells=(m + 1.0) * (n + 1.0)):
            res = _fill(s1e, s2e, m, n, self.scores, self.is_local, matrix=self.matrix,
                        engine=self.engine)
        with spinner(
            "Retracing optimal alignment...", "Retrace complete"
        ), timer.span("retrace"):
            if scan:
                return traceback_host(res.dirs, res.start_i, res.start_j, res.score,
                                      seq1, seq2, self.is_local)
            max_steps = round_up(Lm + Ln + 1, 8192)
            codes, i_f, j_f, done = device_walk(
                res.dirs, res.start_i, res.start_j, 0, max_steps=max_steps
            )
            if not done:
                raise RuntimeError(
                    f"monolithic retrace left the table at ({i_f}, {j_f})"
                )
            if not self.is_local and (i_f, j_f) != (0, 0):
                raise RuntimeError(
                    f"global retrace hit a stop code at ({i_f}, {j_f})"
                )
            return classify_moves(
                codes, res.start_i, res.start_j, res.score, seq1, seq2
            )

    def score_only(self, seq1: Sequence, seq2: Sequence) -> int:
        """Alignment score without traceback (no direction bitmap)."""
        m, n = len(seq1), len(seq2)
        if self.matrix is None and self.engine != "scan" and m > self.SCORE_ROWS_LIMIT:
            from genomics_rs_tpu_torch.models.longalign import score_long

            return int(
                score_long(
                    seq1, seq2, self.scores, is_local=self.is_local,
                    device=self.device,
                )[0]
            )
        Lm = max(round_up(m, PAD_MULTIPLE), PAD_MULTIPLE)
        Ln = max(round_up(n, PAD_MULTIPLE), PAD_MULTIPLE)
        res = _fill(
            _encode(seq1, Lm, PAD_S1, self.device),
            _encode(seq2, Ln, PAD_S2, self.device),
            m, n, self.scores, self.is_local, emit_dirs=False, matrix=self.matrix,
            engine=self.engine,
        )
        return int(res.score)


def align_batch(pairs: list[tuple[Sequence, Sequence]], scores: Scores,
                is_local: bool = False, device="cuda",
                engine: str = "auto") -> list[AlignedSequences]:
    """Full alignments (path + stats) for a batch of pairs, equal to
    :meth:`PairwiseAligner.align` pair by pair.

    Pairs are padded to the batch maximum (pre-bucket very mixed
    batches with ``parallel/allpairs.bucketize_pairs``) and cut into
    groups of :func:`_stream_group_pairs`; each group is one batched
    fill with dirs (K3) and one batched walk (K4), then host
    classification in one ``classify_moves_batch`` pass (the JAX package
    classifies this path pair by pair, with the same results). When even
    two pairs bust the group budget, every
    pair goes to the per-pair aligner (its checkpointed route bounds
    the memory). ``engine="scan"`` aligns pair by pair with the scan
    aligner, as the JAX package does.
    """
    aligner = PairwiseAligner(scores, is_local=is_local, device=device, engine=engine)
    if engine == "scan":
        return [aligner.align(a, b) for a, b in pairs]
    if not pairs:
        return []
    Lm = max(round_up(max(len(a) for a, _ in pairs), PAD_MULTIPLE), PAD_MULTIPLE)
    Ln = max(round_up(max(len(b) for _, b in pairs), PAD_MULTIPLE), PAD_MULTIPLE)
    max_steps = round_up(Lm + Ln + 1, 8192)
    group = _stream_group_pairs(Lm, Ln, max_steps)
    if group < 2:
        return [aligner.align(a, b) for a, b in pairs]
    out: list[AlignedSequences] = []
    for g0 in range(0, len(pairs), group):
        chunk = pairs[g0 : g0 + group]
        s1b = np.stack([a.encoded(pad_to=Lm, pad_value=PAD_S1) for a, _ in chunk])
        s2b = np.stack([b.encoded(pad_to=Ln, pad_value=PAD_S2) for _, b in chunk])
        ms = np.array([len(a) for a, _ in chunk], np.int32)
        ns = np.array([len(b) for _, b in chunk], np.int32)
        walked = stream_walk_group(s1b, s2b, ms, ns, scores, is_local, max_steps,
                                   aligner.device)
        out += _classify_group(chunk, walked, is_local, "batched")
    return out


def _classify_group(chunk, walked, is_local: bool, what: str) -> list[AlignedSequences]:
    """The alignments of a walked group (``walked`` as
    :func:`stream_walk_group` returns it), after checking that every
    walk ended (at (0, 0) for a global fill): one ``classify_moves_batch``
    pass over the group."""
    moves, counts, i_f, j_f, done, scv, sci, scj = walked
    ok = done if is_local else done & (i_f == 0) & (j_f == 0)
    if not ok.all():
        t = int(np.flatnonzero(~ok)[0])
        raise RuntimeError(f"{what} retrace left the table at ({i_f[t]}, {j_f[t]})")
    return classify_moves_batch(moves, counts, sci, scj, scv, chunk)


#: device bytes of K3 bitmaps and walk buffers one group (of
#: ``align_batch``, or a round of ``models/reads.align_reads``) may hold.
GROUP_BYTE_BUDGET = 4 << 30


def _stream_group_pairs(Lm: int, Ln: int, max_steps: int) -> int:
    """Pairs per batched-dirs group, so that one group's bitmaps and
    walk buffers stay within ``GROUP_BYTE_BUDGET``: KW * V * 4 bytes of
    dirs per pair (``ops/gotoh_stream.dirs_shape``) plus ceil(max_steps
    / 16) words of moves per walk. Below 2, callers use the per-pair
    aligner."""
    KW, V = dirs_shape(Lm, Ln)
    per_pair = KW * V * 4 + -(-max_steps // MPW) * 4
    return int(GROUP_BYTE_BUDGET // per_pair)


def stream_walk_group(s1b: np.ndarray, s2b: np.ndarray, ms: np.ndarray,
                      ns: np.ndarray, scores: Scores, is_local: bool,
                      max_steps: int, device):
    """One batched dirs fill (K3) plus every pair's walk for a padded
    group. Returns numpy ``(moves, counts, i_f, j_f, done, score,
    start_i, start_j)``: the first five as ``ops/traceback_batch.
    walk_batch`` gives them, ``moves[t, :counts[t]]`` the traceback-order
    codes of pair ``t``. The walks are one ``walk_batch`` call on the
    ``"diag16"`` layout (K4) when ``max_steps`` fits its buffer, else one
    ``device_walk`` per pair. The caller checks ``done`` and, for a
    global fill, that every walk ended at (0, 0)."""
    stream = gotoh_stream_fill_dirs(
        torch.from_numpy(np.ascontiguousarray(s1b)).to(device),
        torch.from_numpy(np.ascontiguousarray(s2b)).to(device),
        ms, ns, scores, is_local=is_local,
    )
    return walk_dirs(stream, scores, is_local, max_steps)


def walk_dirs(stream, scores: Scores, is_local: bool, max_steps: int):
    """Every pair's walk over a batched fill's per-pair bitmaps
    (``StreamDirsResult``), returned as :func:`stream_walk_group` does."""
    sci, scj, scv = (np.asarray(x, np.int64)
                     for x in (stream.start_i, stream.start_j, stream.score))
    if max_steps <= MAX_STEPS_CAP:
        walked = walk_batch(stream.dirs, sci, scj, scores, is_local, "diag16", max_steps)
    else:
        B = len(sci)
        moves = np.full((B, max_steps), NO_MOVE, np.uint8)
        ends = np.zeros((4, B), np.int64)
        for t in range(B):
            codes, i_f, j_f, done = device_walk(
                stream.segment_dirs(t), int(sci[t]), int(scj[t]), 0, max_steps=max_steps)
            moves[t, : len(codes)] = codes
            ends[:, t] = len(codes), i_f, j_f, done
        walked = (moves, ends[0], ends[1], ends[2], ends[3] != 0)
    return walked + (scv, sci, scj)


def matrix_align_batch(pairs: list[tuple[Sequence, Sequence]], matrix, g: int, h: int,
                       is_local: bool = False, device="cuda") -> list[AlignedSequences]:
    """Full alignments (path + stats) for a batch of pairs under a full
    substitution matrix, the protein counterpart of :func:`align_batch`,
    equal to ``PairwiseAligner(matrix=matrix).align`` pair by pair.

    Groups of :func:`_stream_group_pairs` pairs, each one matrix fill
    with dirs (``ops/gotoh_matrix_stream.gotoh_matrix_stream_fill_dirs``)
    and one K4 walk (``walk_batch(..., "diag16")``), then host
    classification, one ``classify_moves_batch`` pass a group. As in the
    JAX package, a path longer than the walk buffer (``Lm + Ln + 1 >
    MAX_STEPS_CAP``) or a group the stream entry refuses (a zero length,
    ``|v| > 127``) goes to the per-pair aligner.
    """
    aligner = PairwiseAligner(Scores(0, 0, g, h), is_local=is_local, device=device,
                              matrix=matrix)
    if not pairs:
        return []
    Lm = max(round_up(max(len(a) for a, _ in pairs), PAD_MULTIPLE), PAD_MULTIPLE)
    Ln = max(round_up(max(len(b) for _, b in pairs), PAD_MULTIPLE), PAD_MULTIPLE)
    if Lm + Ln + 1 > MAX_STEPS_CAP:
        return [aligner.align(a, b) for a, b in pairs]
    max_steps = min(round_up(Lm + Ln + 1, 1024), MAX_STEPS_CAP)
    group = max(_stream_group_pairs(Lm, Ln, max_steps), 1)
    out: list[AlignedSequences] = []
    for g0 in range(0, len(pairs), group):
        chunk = pairs[g0 : g0 + group]
        s1b = np.stack([a.encoded(pad_to=Lm, pad_value=PAD_S1) for a, _ in chunk])
        s2b = np.stack([b.encoded(pad_to=Ln, pad_value=PAD_S2) for _, b in chunk])
        ms = np.array([len(a) for a, _ in chunk], np.int32)
        ns = np.array([len(b) for _, b in chunk], np.int32)
        res = gotoh_matrix_stream_fill_dirs(
            torch.from_numpy(s1b).to(aligner.device), torch.from_numpy(s2b).to(aligner.device),
            ms, ns, matrix, g, h, is_local=is_local,
        )
        if res is None:
            out += [aligner.align(a, b) for a, b in chunk]
            continue
        walked = walk_dirs(res, aligner.scores, is_local, max_steps)
        out += _classify_group(chunk, walked, is_local, "matrix batched")
    return out


def align_pair(
    container: SequenceContainer,
    scores: Scores,
    is_local: bool = False,
    device="cuda",
    matrix=None,
    engine: str = "auto",
) -> AlignedSequences:
    """Align the first two sequences of a container (the reference's
    Align mode: it warns and uses only the first two)."""
    if len(container.sequences) > 2:
        log.warning("More than two sequences found. Only the first two will be used.")
    aligner = PairwiseAligner(scores, is_local=is_local, device=device, matrix=matrix,
                              engine=engine)
    return aligner.align(container.sequences[0], container.sequences[1])
