"""Multi-process execution: process-group init, pair dealing and
host-sharded all-pairs (counterpart of
``genomics_rs_tpu/parallel/distributed.py``).

* :func:`init_distributed` starts ``torch.distributed`` from torchrun's
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``): NCCL when CUDA is there, gloo on the CPU. Alone it
  does nothing.
* :func:`allpairs_multihost`: the pair list is dealt across the ranks
  (:func:`balanced_deal`), each rank scores its share on its own device
  and ``all_gather`` merges the (pair index, score) vectors, so every
  rank holds the whole matrix.
* :func:`allpairs_hybrid`, in one process: pairs too large for one
  share are split over a sub-mesh of devices and filled by the
  sequence-parallel pipeline (``parallel/longseq.sharded_gotoh_score``);
  the rest go through the bucketed batch engines.
"""

from __future__ import annotations

import heapq
import logging
import math
import os
import time

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh, local_devices
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, SequenceContainer, round_up

log = logging.getLogger(__name__)


def init_distributed(init_method: str | None = None) -> tuple[int, int]:
    """Start ``torch.distributed`` if the environment asks for it; returns
    (rank, world size). Call it before any other use of the group.

    torchrun sets ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``;
    ``init_method`` (e.g. ``file:///shared/rendezvous``) replaces the
    ``tcp://MASTER_ADDR:MASTER_PORT`` address. Without either it is a
    no-op and returns (0, 1). A failed start raises when the world has
    more than one rank (each rank would otherwise score every pair), and
    only warns for a world of one, as the JAX package does."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if init_method is None and "MASTER_ADDR" not in env:
        return 0, 1
    world = int(env["WORLD_SIZE"])
    rank = int(env["RANK"])
    if init_method is None:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        if backend == "nccl":
            torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    except Exception as e:  # noqa: BLE001 - the start's errors vary by backend
        if world > 1:
            raise RuntimeError(
                f"torch.distributed failed to start a {world}-rank {backend} group "
                f"({init_method}): {e}") from e
        log.warning("torch.distributed failed to start: %s", e)
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def balanced_deal(costs, n_shares: int) -> list[list[int]]:
    """Deal item indices into ``n_shares`` balanced shares (LPT): items by
    descending cost, each to the least-loaded share so far (within 4/3
    of optimal). Ties break on share index, so every rank deals alike."""
    order = sorted(range(len(costs)), key=lambda k: -costs[k])
    heap = [(0.0, h) for h in range(n_shares)]
    heapq.heapify(heap)
    shares: list[list[int]] = [[] for _ in range(n_shares)]
    for k in order:
        load, h = heapq.heappop(heap)
        shares[h].append(k)
        heapq.heappush(heap, (load + float(costs[k]), h))
    return shares


#: the JAX package's older name of :func:`balanced_deal`.
snake_deal = balanced_deal


#: column blocks per seq shard in the hybrid split's pipeline model: a
#: k-shard pipeline of C blocks keeps a shard busy C of C + k - 1 waves.
PIPELINE_BLOCKS = 8


class WorkUnit:
    """One share entry of :func:`hybrid_deal`: ``nparts == 1`` scores pair
    ``index`` alone; ``nparts > 1`` is one of the shares of ``group`` that
    fill pair ``index`` together, its rows sharded over the group."""

    __slots__ = ("index", "nparts", "group")

    def __init__(self, index: int, nparts: int, group: tuple):
        self.index = index
        self.nparts = nparts
        self.group = group

    def __repr__(self):
        return f"WorkUnit({self.index}, {self.nparts}, {self.group})"

    def __eq__(self, other):
        return (isinstance(other, WorkUnit)
                and (self.index, self.nparts, self.group)
                == (other.index, other.nparts, other.group))


def split_cost(cost: float, nparts: int) -> float:
    """Cost model of a share of an ``nparts``-way sequence-parallel fill:
    ``cost / nparts`` of cells plus the pipeline's fill and drain at
    ``C = PIPELINE_BLOCKS * nparts`` column blocks."""
    if nparts <= 1:
        return float(cost)
    C = PIPELINE_BLOCKS * nparts
    return float(cost) / nparts * (C + nparts - 1) / C


def hybrid_deal(costs, n_shares: int) -> list[list[WorkUnit]]:
    """LPT dealing that splits oversized items: an item costing more than
    the fair share (``total / n_shares``) goes to the k least-loaded
    shares as one group, each charged :func:`split_cost`; the rest follow
    plain LPT. k = ceil(cost / fair) + 0..3, keeping the smallest
    bottleneck. Deterministic (ties break on share index)."""
    total = float(sum(costs))
    fair = total / max(n_shares, 1)
    order = sorted(range(len(costs)), key=lambda k: -costs[k])

    def deal(extra: int):
        heap = [(0.0, h) for h in range(n_shares)]
        heapq.heapify(heap)
        shares: list[list[WorkUnit]] = [[] for _ in range(n_shares)]
        loads = [0.0] * n_shares
        for k in order:
            c = float(costs[k])
            if c > fair and n_shares > 1:
                parts = min(n_shares, math.ceil(c / fair) + extra)
                popped = [heapq.heappop(heap) for _ in range(parts)]
                group = tuple(sorted(h for _, h in popped))
                sub = split_cost(c, parts)
                for load, h in popped:
                    shares[h].append(WorkUnit(k, parts, group))
                    heapq.heappush(heap, (load + sub, h))
                    loads[h] = load + sub
            else:
                load, h = heapq.heappop(heap)
                shares[h].append(WorkUnit(k, 1, (h,)))
                heapq.heappush(heap, (load + c, h))
                loads[h] = load + c
        return max(loads), shares

    best = None
    for extra in range(4):
        bottleneck, shares = deal(extra)
        if best is None or bottleneck < best[0]:
            best = (bottleneck, shares)
    return best[1]


def allpairs_hybrid(container: SequenceContainer, scores, n_shares: int | None = None,
                    is_local: bool = False, engine: str = "auto", devices=None):
    """All-pairs scores under :func:`hybrid_deal`, in one process.

    ``devices`` (default: the local CUDA devices; a list may repeat one)
    stand for the shares' hosts. Pairs dealt whole are scored in length
    buckets on ``devices[0]`` (``engine`` as ``allpairs_scores``); each
    split pair's rows are sharded over its group's devices
    (``devices[h % len(devices)]``) at ``PIPELINE_BLOCKS`` column blocks a
    shard and filled by ``sharded_gotoh_score``. The matrix equals
    ``allpairs_scores``'."""
    from genomics_rs_tpu_torch.parallel.allpairs import AllPairsResult, _score_pairs_bucketed
    from genomics_rs_tpu_torch.parallel.longseq import sharded_gotoh_score

    devs = local_devices(devices)
    H = n_shares or len(devs)
    seqs = container.sequences
    names = [s.name for s in seqs]
    num = len(names)
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    costs = [(lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs]
    shares = hybrid_deal(costs, H)

    split_jobs: dict[int, tuple] = {}
    plain: list[int] = []
    for units in shares:
        for u in units:
            if u.nparts > 1:
                split_jobs[u.index] = u.group
            else:
                plain.append(u.index)

    t0 = time.perf_counter()
    matrix = np.zeros((num, num), dtype=np.int64)
    padded = 0.0
    if plain:
        sc, padded = _score_pairs_bucketed(container, [pairs[k] for k in plain], lens, scores,
                                           is_local, engine, devs[0])
        for k, v in zip(plain, sc):
            i, j = pairs[k]
            matrix[j, i] = int(v)

    for k, group in split_jobs.items():
        i, j = pairs[k]
        parts = len(group)
        sub_mesh = Mesh([devs[h % len(devs)] for h in group], (SEQ_AXIS,))
        m, n = int(lens[i]), int(lens[j])
        C = PIPELINE_BLOCKS * parts
        Lm = max(round_up(m, 128 * parts), 128 * parts)
        Ln = max(round_up(n, 128 * C), 128 * C)
        res = sharded_gotoh_score(
            sub_mesh, seqs[i].encoded(pad_to=Lm, pad_value=PAD_S1),
            seqs[j].encoded(pad_to=Ln, pad_value=PAD_S2), m, n, scores,
            is_local=is_local, n_blocks=C)
        matrix[j, i] = int(res.best[0] if is_local else res.score)
        padded += (Lm + 1.0) * (Ln + 1.0)
        log.info("[AllPairs/hybrid] pair (%d, %d) = %.3g cells split over %d shards "
                 "(group %s)", i, j, costs[k], parts, group)

    elapsed = time.perf_counter() - t0
    cells = float(sum(costs))
    return AllPairsResult(names=names, lengths=[int(x) for x in lens], matrix=matrix,
                          elapsed_s=elapsed, cells=cells, cells_per_s=cells / elapsed,
                          padded_cells=padded)


def allpairs_multihost(container: SequenceContainer, scores, is_local: bool = False,
                       engine: str = "auto", device="cuda"):
    """All-pairs scores with the pairs dealt across the ranks of the
    ``torch.distributed`` group (:func:`init_distributed`).

    Pairs are dealt by cost (:func:`balanced_deal`), each rank scores its
    share on ``device`` in length buckets, and ``all_gather`` of the
    padded (pair index, score) vectors assembles the whole lower-triangle
    matrix on every rank. With no group, or a group of one, it is
    ``allpairs_scores``."""
    import torch.distributed as dist

    from genomics_rs_tpu_torch.parallel.allpairs import (
        AllPairsResult,
        _score_pairs_bucketed,
        allpairs_scores,
    )

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return allpairs_scores(container, scores, is_local, engine, device=device)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = resolve_device(device)
    # The collective's tensors live where the backend wants them.
    coll = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))

    names = [s.name for s in container.sequences]
    num = len(names)
    lens = np.array([len(s) for s in container.sequences], dtype=np.int32)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]
    share_idx = balanced_deal([(lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs], world)
    mine_idx = share_idx[rank]
    mine = [pairs[k] for k in mine_idx]

    t0 = time.perf_counter()
    cap = max(len(s) for s in share_idx)
    local = torch.full((2, cap), -1, dtype=torch.int64)  # (pair index, score)
    if mine:
        sc, _ = _score_pairs_bucketed(container, mine, lens, scores, is_local, engine, dev)
        local[0, : len(mine)] = torch.as_tensor(mine_idx, dtype=torch.int64)
        local[1, : len(mine)] = torch.as_tensor(sc, dtype=torch.int64)
    gathered = [torch.empty((2, cap), dtype=torch.int64, device=coll) for _ in range(world)]
    dist.all_gather(gathered, local.to(coll))
    matrix = np.zeros((num, num), dtype=np.int64)
    for g in gathered:
        for k, v in g.cpu().numpy().T:
            if k >= 0:
                i, j = pairs[int(k)]
                matrix[j, i] = int(v)
    elapsed = time.perf_counter() - t0

    cells = float(sum((lens[i] + 1.0) * (lens[j] + 1.0) for i, j in pairs))
    log.info("[AllPairs/multihost] %d pairs over %d ranks in %.2fs (%.3g cells/s)",
             len(pairs), world, elapsed, cells / elapsed)
    return AllPairsResult(names=names, lengths=[int(x) for x in lens], matrix=matrix,
                          elapsed_s=elapsed, cells=cells, cells_per_s=cells / elapsed)
