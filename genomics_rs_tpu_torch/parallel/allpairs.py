"""All-pairs DP alignment-score matrix (counterpart of
``genomics_rs_tpu/parallel/allpairs.py``: ``AllPairsResult``,
``bucketize_pairs``, ``allpairs_scores`` (one device, or a mesh),
``allpairs_scores_resumable`` and ``write_scores_tsv``).

Every pair (i <= j) of a container is globally or locally scored and
the matrix is kept as a lower triangle, like the reference's similarity
matrix. Pairs are grouped by power-of-two length class, each group
padded to its own longest lengths (round 128) and scored in one
``score_pairs`` call on the given engine: under ``"auto"`` the router's
tier for the bucket's shape (K6, K7/K8, K3 or K9), one launch a bucket on
a CUDA device; under ``"scan"`` the scan fill (``batch_scores``) on the
bucket's device or on each device of the mesh. With a ``mesh=`` of more than one device each bucket is
spread over the mesh as the JAX package does: ``batch_scores_sharded``
on the engine ``mesh_bucket_engine`` picks, or, for long-pair buckets,
equal K3 slices by ``device_loop_scores``.
``allpairs_matrix_scores`` (protein) scores each bucket under a
substitution matrix with one profile and one matrix fill
(``ops/gotoh_matrix``; buckets over 1,024 pairs in groups of 1,024).
``allpairs_scores_resumable`` scores chunks of pairs in order, appending
each to a JSONL checkpoint, and loads the finished chunks on a restart.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.parallel.batch import (
    batch_scores_sharded,
    device_loop_scores,
    mesh_bucket_engine,
    pad_batch,
    score_pairs,
)
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, SequenceContainer, round_up
from genomics_rs_tpu_torch.utils.profiling import annotate

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
                          engine: str, device, mesh=None) -> tuple[np.ndarray, float]:
    """Score ``pairs`` in length buckets, on ``device`` or over ``mesh``
    (more than one device: the module docstring's mesh path); returns
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

    with annotate("genomics/allpairs.encode"):
        groups = bucketize_pairs(pairs, lens)
    for key in sorted(groups):
        with annotate("genomics/allpairs.encode"):
            idxs = groups[key]
            Lm = max(round_up(max(int(lens[pairs[k][0]]) for k in idxs), 128), 128)
            Ln = max(round_up(max(int(lens[pairs[k][1]]) for k in idxs), 128), 128)
            s1b = np.stack([enc(pairs[k][0], Lm, PAD_S1) for k in idxs])
            s2b = np.stack([enc(pairs[k][1], Ln, PAD_S2) for k in idxs])
            ms = np.array([lens[pairs[k][0]] for k in idxs], dtype=np.int32)
            ns = np.array([lens[pairs[k][1]] for k in idxs], dtype=np.int32)
        if mesh is not None and mesh.size > 1:
            eng = mesh_bucket_engine(engine, Lm, Ln, is_local)
            if eng == "pallas":
                # Long-pair bucket: equal K3 slices, one per device.
                sc, _, _ = device_loop_scores(mesh.devices.flat, s1b, s2b, ms, ns, scores,
                                              is_local, engine="stream")
            else:
                (s1p, s2p, mp, np_), _ = pad_batch((s1b, s2b, ms, ns), len(idxs), mesh.size,
                                                   pad_values=[None, None, 0, 0])
                sc = batch_scores_sharded(mesh, s1p, s2p, mp, np_, scores, is_local,
                                          engine=eng).score
        else:
            sc, _, _ = score_pairs(s1b, s2b, ms, ns, scores, is_local, engine=engine,
                                   device=device)
        with annotate("genomics/allpairs.readback"):
            for pos, k in enumerate(idxs):
                out[k] = int(sc[pos])
        padded_cells += float(len(idxs)) * (Lm + 1.0) * (Ln + 1.0)
        log.debug("[AllPairs] bucket %s: %d pairs at (%d, %d)", key, len(idxs), Lm, Ln)
    return out, padded_cells


def allpairs_scores(container: SequenceContainer, scores, is_local: bool = False,
                    engine: str = "auto", device="cuda", mesh=None) -> AllPairsResult:
    """Score matrix over all pairs (i <= j), lower-triangle layout, on
    ``device`` (``"cuda"`` runs the kernels, ``"cpu"`` their plain
    versions) or, given a ``mesh`` (``parallel/mesh``) of more than one
    device, spread over its devices; ``engine`` is any of
    ``score_pairs``'. Multi-process runs go through
    ``parallel/distributed.allpairs_multihost``."""
    dev = resolve_device(device if mesh is None else mesh.devices.flat[0])
    names = [s.name for s in container.sequences]
    num = len(names)
    lens = np.array([len(s) for s in container.sequences], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    total_cells = float(sum((lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs))
    matrix = np.zeros((num, num), dtype=np.int64)

    t0 = time.perf_counter()
    sc, padded_cells = _score_pairs_bucketed(
        container, pairs, lens, scores, is_local, engine, dev, mesh
    )
    for k, (i, j) in enumerate(pairs):
        matrix[j, i] = int(sc[k])
    elapsed = time.perf_counter() - t0

    log.info(
        "[AllPairs] %d pairs, %.3g cells (%.3g padded) in %.2fs (%.3g cells/s, "
        "engine=%s, device=%s)",
        len(pairs), total_cells, padded_cells, elapsed, total_cells / elapsed,
        engine, mesh or dev,
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


def allpairs_scores_resumable(container: SequenceContainer, scores, checkpoint_path: str,
                              is_local: bool = False, engine: str = "auto",
                              chunk_pairs: int = 64, device="cuda",
                              mesh=None) -> AllPairsResult:
    """All-pairs scoring with crash-resumable per-chunk checkpoints.

    Pair chunks are scored in order and appended to ``checkpoint_path``
    (a JSONL: a ``{"meta": ...}`` line, then ``{"k0": chunk start,
    "scores": [...]}`` lines, the JAX package's format); on a restart the
    finished chunks are loaded instead of scored. The meta (names,
    lengths, a digest of the sequences, the scores, mode and chunk size)
    must match, else the file starts fresh; a torn last line is dropped.
    The matrix equals :func:`allpairs_scores`'.
    """
    dev = resolve_device(device if mesh is None else mesh.devices.flat[0])
    names = [s.name for s in container.sequences]
    num = len(names)
    lens = np.array([len(s) for s in container.sequences], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    matrix = np.zeros((num, num), dtype=np.int64)

    # Names and a content digest invalidate the checkpoint on any corpus
    # change, a length-preserving edit included.
    digest = hashlib.sha256()
    for s in container.sequences:
        digest.update(s.name.encode())
        digest.update(b"\0")
        digest.update(s.sequence.encode())
        digest.update(b"\1")
    meta = {
        "chunk_pairs": chunk_pairs,
        "n_pairs": len(pairs),
        "is_local": is_local,
        "scores": list(scores.as_tuple()),
        "lengths": [int(x) for x in lens],
        "names": names,
        "digest": digest.hexdigest(),
    }
    done: dict[int, list[int]] = {}
    if os.path.exists(checkpoint_path):
        try:
            with open(checkpoint_path) as f:
                lines = f.read().splitlines()
            if lines and json.loads(lines[0]).get("meta") == meta:
                for line in lines[1:]:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break  # a torn tail from a crash mid-write
                    if len(rec["scores"]) == len(pairs[rec["k0"] : rec["k0"] + chunk_pairs]):
                        done[rec["k0"]] = rec["scores"]
            else:
                log.warning("[AllPairs/resume] checkpoint %s was written with different "
                            "inputs/params; starting fresh", checkpoint_path)
                os.remove(checkpoint_path)
        except (OSError, json.JSONDecodeError, KeyError) as e:
            log.warning("[AllPairs/resume] unreadable checkpoint (%s); starting fresh", e)
            os.remove(checkpoint_path)
        if done:
            log.info("[AllPairs/resume] %d/%d chunks already done", len(done),
                     -(-len(pairs) // chunk_pairs))
    # Rewrite the file from the validated records, so a torn line cannot
    # corrupt the appends that follow.
    with open(checkpoint_path, "w") as f:
        f.write(json.dumps({"meta": meta}) + "\n")
        for k0 in sorted(done):
            f.write(json.dumps({"k0": k0, "scores": done[k0]}) + "\n")

    t0 = time.perf_counter()
    with open(checkpoint_path, "a") as ckpt:
        for k0 in range(0, len(pairs), chunk_pairs):
            chunk = pairs[k0 : k0 + chunk_pairs]
            if k0 in done:
                sc = done[k0]
            else:
                out, _ = _score_pairs_bucketed(container, chunk, lens, scores, is_local,
                                               engine, dev, mesh)
                sc = [int(x) for x in out]
                ckpt.write(json.dumps({"k0": k0, "scores": sc}) + "\n")
                ckpt.flush()
            for (i, j), v in zip(chunk, sc):
                matrix[j, i] = v
    elapsed = time.perf_counter() - t0

    total_cells = float(sum((lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs))
    return AllPairsResult(
        names=names,
        lengths=[int(x) for x in lens],
        matrix=matrix,
        elapsed_s=elapsed,
        cells=total_cells,
        cells_per_s=total_cells / max(elapsed, 1e-9),
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
