"""All-pairs DP alignment-score matrix (counterpart of
``genomics_rs_tpu/parallel/allpairs.py``: ``AllPairsResult``,
``bucketize_pairs``, the single-device ``allpairs_scores`` and
``write_scores_tsv``).

Every pair (i <= j) of a container is globally or locally scored and
the matrix is kept as a lower triangle, like the reference's similarity
matrix. Pairs are grouped by power-of-two length class, each group
padded to its own longest lengths (round 128) and scored in one
``score_pairs`` call on the given engine: under ``"auto"`` the router's
tier for the bucket's shape (K6, K7/K8, K3 or K9), one launch a bucket on
a CUDA device.
``allpairs_matrix_scores`` (protein) scores each bucket under a
substitution matrix with one profile and one matrix fill
(``ops/gotoh_matrix``; buckets over 1,024 pairs in groups of 1,024).
``allpairs_scores_resumable`` waits for ROADMAP Queue A item 14.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.parallel.batch import score_pairs
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, SequenceContainer, round_up

log = logging.getLogger(__name__)


@dataclasses.dataclass
class AllPairsResult:
    names: list[str]
    lengths: list[int]
    #: [j][i] = score for i <= j; zeros above the diagonal.
    matrix: np.ndarray
    elapsed_s: float
    cells: float
    cells_per_s: float
    #: cells of the padded bucket shapes, (Lm+1)(Ln+1) per pair.
    padded_cells: float = 0.0


def _bucket_key(L: int) -> int:
    """Power-of-two length class (128 floor) for pair grouping."""
    b = 128
    while b < L:
        b *= 2
    return b


def bucketize_pairs(pairs: list[tuple[int, int]], lens) -> dict[tuple[int, int], list[int]]:
    """Group pair indices by (pow2 class of len_i, pow2 class of len_j)
    so each group is padded only to its own longest lengths."""
    groups: dict[tuple[int, int], list[int]] = {}
    for k, (i, j) in enumerate(pairs):
        key = (_bucket_key(int(lens[i])), _bucket_key(int(lens[j])))
        groups.setdefault(key, []).append(k)
    return groups


def _score_pairs_bucketed(container, pairs, lens, scores, is_local: bool,
                          engine: str, device) -> tuple[np.ndarray, float]:
    """Score ``pairs`` in length buckets on one device; returns
    (scores[k], padded cells)."""
    seqs = container.sequences
    out = np.zeros(len(pairs), dtype=np.int64)
    padded_cells = 0.0
    enc_cache: dict[tuple[int, int, int], np.ndarray] = {}

    def enc(idx: int, L: int, pad_value: int) -> np.ndarray:
        key = (idx, L, pad_value)
        if key not in enc_cache:
            enc_cache[key] = seqs[idx].encoded(pad_to=L, pad_value=pad_value)
        return enc_cache[key]

    groups = bucketize_pairs(pairs, lens)
    for key in sorted(groups):
        idxs = groups[key]
        Lm = max(round_up(max(int(lens[pairs[k][0]]) for k in idxs), 128), 128)
        Ln = max(round_up(max(int(lens[pairs[k][1]]) for k in idxs), 128), 128)
        s1b = np.stack([enc(pairs[k][0], Lm, PAD_S1) for k in idxs])
        s2b = np.stack([enc(pairs[k][1], Ln, PAD_S2) for k in idxs])
        ms = np.array([lens[pairs[k][0]] for k in idxs], dtype=np.int32)
        ns = np.array([lens[pairs[k][1]] for k in idxs], dtype=np.int32)
        sc, _, _ = score_pairs(s1b, s2b, ms, ns, scores, is_local, engine=engine,
                               device=device)
        for pos, k in enumerate(idxs):
            out[k] = int(sc[pos])
        padded_cells += float(len(idxs)) * (Lm + 1.0) * (Ln + 1.0)
        log.debug("[AllPairs] bucket %s: %d pairs at (%d, %d)", key, len(idxs), Lm, Ln)
    return out, padded_cells


def allpairs_scores(container: SequenceContainer, scores, is_local: bool = False,
                    engine: str = "auto", device="cuda") -> AllPairsResult:
    """Score matrix over all pairs (i <= j), lower-triangle layout, on
    ``device`` (``"cuda"`` runs the kernels, ``"cpu"`` their plain
    versions); ``engine`` is any of ``score_pairs``'."""
    dev = resolve_device(device)
    names = [s.name for s in container.sequences]
    num = len(names)
    lens = np.array([len(s) for s in container.sequences], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    total_cells = float(sum((lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs))
    matrix = np.zeros((num, num), dtype=np.int64)

    t0 = time.perf_counter()
    sc, padded_cells = _score_pairs_bucketed(
        container, pairs, lens, scores, is_local, engine, dev
    )
    for k, (i, j) in enumerate(pairs):
        matrix[j, i] = int(sc[k])
    elapsed = time.perf_counter() - t0

    log.info(
        "[AllPairs] %d pairs, %.3g cells (%.3g padded) in %.2fs (%.3g cells/s, "
        "engine=%s, device=%s)",
        len(pairs), total_cells, padded_cells, elapsed, total_cells / elapsed,
        engine, dev,
    )
    return AllPairsResult(
        names=names,
        lengths=[int(x) for x in lens],
        matrix=matrix,
        elapsed_s=elapsed,
        cells=total_cells,
        cells_per_s=total_cells / elapsed,
        padded_cells=padded_cells,
    )


def allpairs_matrix_scores(container: SequenceContainer, matrix, g: int, h: int,
                           is_local: bool = False, device="cuda") -> AllPairsResult:
    """All-pairs scores under a full substitution matrix (protein), in
    :func:`allpairs_scores`'s layout and buckets. A bucket of more than
    1,024 pairs goes to the grouped stream entry, as the JAX package
    routes it on its device; any other to ``gotoh_scores_matrix``."""
    from genomics_rs_tpu_torch.ops.gotoh_matrix import gotoh_scores_matrix
    from genomics_rs_tpu_torch.ops.gotoh_matrix_stream import gotoh_scores_matrix_stream_grouped

    dev = resolve_device(device)
    seqs = container.sequences
    names = [s.name for s in seqs]
    num = len(names)
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    total_cells = float(sum((lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs))
    out = np.zeros((num, num), dtype=np.int64)

    t0 = time.perf_counter()
    groups = bucketize_pairs(pairs, lens)
    padded_cells = 0.0
    for key in sorted(groups):
        sub = [pairs[k] for k in groups[key]]
        Lm = max(round_up(max(int(lens[i]) for i, _ in sub), 128), 128)
        Ln = max(round_up(max(int(lens[j]) for _, j in sub), 128), 128)
        s1b = np.stack([seqs[i].encoded(pad_to=Lm, pad_value=PAD_S1) for i, _ in sub])
        s2b = np.stack([seqs[j].encoded(pad_to=Ln, pad_value=PAD_S2) for _, j in sub])
        ms = np.array([lens[i] for i, _ in sub], dtype=np.int32)
        ns = np.array([lens[j] for _, j in sub], dtype=np.int32)
        padded_cells += float(len(sub)) * (Lm + 1.0) * (Ln + 1.0)
        out3 = None
        if len(sub) > 1024:
            out3 = gotoh_scores_matrix_stream_grouped(
                torch.from_numpy(s1b).to(dev), torch.from_numpy(s2b).to(dev), ms, ns,
                matrix, g, h, is_local)
        if out3 is None:
            out3 = gotoh_scores_matrix(s1b, s2b, ms, ns, matrix, g, h, is_local, device=dev)
        for (i, j), v in zip(sub, out3[0].cpu().numpy()):
            out[j, i] = int(v)
    elapsed = time.perf_counter() - t0

    log.info("[AllPairs/matrix] %d pairs, %.3g cells in %.2fs (%.3g cells/s)",
             len(pairs), total_cells, elapsed, total_cells / elapsed)
    return AllPairsResult(
        names=names,
        lengths=[int(x) for x in lens],
        matrix=out,
        elapsed_s=elapsed,
        cells=total_cells,
        cells_per_s=total_cells / elapsed,
        padded_cells=padded_cells,
    )


def write_scores_tsv(result: AllPairsResult, path: str) -> str:
    """Same TSV shape as the reference similarity matrix: index header
    row, then one row per sequence."""
    num = len(result.names)
    lines = ["\t" + "\t".join(str(i) for i in range(num)) + "\t"]
    for j in range(num):
        cells = "\t".join(str(int(result.matrix[j, i])) for i in range(num))
        lines.append(f"{j}\t{cells}\t")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text
