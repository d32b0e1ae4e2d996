"""Time the fills that share the cell recurrence of
``genomics_rs_tpu_torch/csrc/gotoh_stream_body.cuh`` on one CUDA card.

Inputs are made from a seed: K1 at the main path's three fills (the
29,903 bp pair's forward fill with column checkpoints and its refill
with dirs, one block of 30,719 rows; a 10 kb local fill with dirs), K5
at the P = 4 tile of that pair, K9 on the whole pair (at strips of 128,
256 and 512 rows too, and on a grid of one block: the sweep's step) and
on a 300 kb prefix and the whole of ``chip_smoke.py``'s 1,078,175 bp
planted pair (that also at a 2 GiB ring), K16 on 4 planted copies of a
155 kb genome (strips of 128, 256 and 512 rows) and on their first 300
rows (phase 31's slice: at 128, 256 and 512 rows a strip, and on one
block at 256 and 512), K3 on 132 pairs of
8,192 bp, the warp strips (K7) on 528 pairs of 2,048 bp, K8 on each bucket
of ``chip_smoke.py`` phase 24's corpus that ``auto`` sends to it (and K7,
K8 and K3 on its largest), K6 on bench.py's 16,384 x 152 bp reads, at
the map shape and on 4,096 pairs of 256 bp (at each group size where the
build takes one), the walks (K2 on the 10 kb local fill's path through
``walk_full`` and its launch alone; K4 alone on the dirs group of 9's
walks; K11 alone on the 29,903 bp band walk), the query profile K15 at
1,024 x 384 and 32,768 x 383 aa through its wrapper and its launch alone
(each build's own launcher), the matrix fill
(K14) on 8,192 BLOSUM62 pairs of 383 aa, the banded fill K10 on the
29,903 bp pair at band 2048 (also on one block, where the build takes
it) and on the 1 Mb pair, and
K12 on 16 mutated copies of the 29,903 bp one; global and local where
the path has both; and the host walls of ``align_banded`` on the 1 Mb
pair and of ``sharded_gotoh_score`` on the 29,903 bp pair at P = 1 and
4 shards of the card. Prints the card's name
and power limit, then one JSON object: per fill the median CUDA-event ms
of ``--reps`` runs and a checksum of its outputs (per wall every run,
after a first; for a banded fill the codes of the true in-band cells
only, the contract), so that two builds of the kernels (two checkouts,
run one after the other on one card, in one run) can be compared for
time and held equal for results. ``--only`` keeps the fills whose name
holds one of its words.

    python3 tools/time_fills.py [--reps 5] [--only K9 K10]
    python3 tools/time_fills.py --only K2 K4 K11 K15
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    reps = args.reps

    def wanted(name: str) -> bool:
        return args.only is None or any(w in name for w in args.only)

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_fills: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])

    from genomics_rs_tpu_torch.config import Scores
    from genomics_rs_tpu_torch.ops import _build
    from genomics_rs_tpu_torch.ops import gotoh_banded as gb
    from genomics_rs_tpu_torch.ops import gotoh_banded_batch as gbb
    from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
    from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
    from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
    from genomics_rs_tpu_torch.ops import gotoh_segmented as gseg
    from genomics_rs_tpu_torch.ops import gotoh_stream as gs
    from genomics_rs_tpu_torch.ops import traceback_walker as tw
    from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_left, global_boundary_top
    from genomics_rs_tpu_torch.ops.subst import blosum62
    from genomics_rs_tpu_torch.sequence import PAD_S2, round_up

    _build.library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    sc = Scores()

    def related(n_a: int, n_b: int):
        a = acgt[rng.integers(0, 4, n_a)]
        b = a[:n_b].copy()
        snp = rng.random(n_b) < 0.01
        b[snp] = acgt[rng.integers(0, 4, int(snp.sum()))]
        return a, b

    def padded(x: np.ndarray, L: int, pad: int) -> torch.Tensor:
        out = np.full(L, pad, np.uint8)
        out[: len(x)] = x
        return torch.from_numpy(out).to(dev)

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    def checksum(*xs) -> int:
        return int(sum(int(x.long().sum()) for x in xs if x is not None))

    def k1_checksum(res, R, n, B) -> int:
        """Every output K1 defines: dirs at every block cell, the column
        checkpoints of rows 1..R at columns <= n, bottom, probe, best."""
        parts = [res.bottom, res.score_at_mn, *res.best]
        if res.cols is not None:
            V = rb.lane_count(R)
            parts += [res.cols[c, :, 1: R + 1] for c in range(res.cols.shape[0]) if c * V <= n]
        if res.dirs is not None:
            j = torch.arange(B + 1, device=dev)[None, :]
            for r0 in range(0, R + 1, 512):
                li = torch.arange(r0, min(R + 1, r0 + 512), device=dev)[:, None]
                k = li + j
                parts.append((res.dirs[k // 16, li].long() >> (2 * (k % 16))) & 3)
        return checksum(*parts)

    out = {}

    def k1(name, a, b, R, L, is_local, dirs, cols):
        if not wanted(name):
            return
        s1, s2 = padded(a, R, 0xFE), padded(b, L, PAD_S2)
        top = global_boundary_top(0, L, sc, device=dev)
        run = lambda: rb.launch(s1, s2, top, None, len(a), len(b), 0, 0, sc, is_local,  # noqa: E731
                                dirs, not dirs, cols, False, False, {"kernel": 0})
        res = run()
        rb.raise_on_err(res.err)
        out[name] = {"ms": cuda_ms(run), "sum": k1_checksum(res, R, len(b), L)}

    a30, b30 = related(29_903, 29_892)
    R30, L30 = round_up(len(a30) + 1, 1024) - 1, round_up(len(b30), 128)
    k1("K1 29.9 kb forward+cols", a30, b30, R30, L30, False, False, True)
    k1("K1 29.9 kb refill+dirs", a30, b30, R30, L30, False, True, False)
    a10, b10 = related(10_000, 9_990)
    k1("K1 10 kb local+dirs", a10, b10, round_up(10_000, 128), round_up(9_990, 128), True,
       True, False)

    # K2 on the 10 kb local fill's walk (the main path's single walk,
    # chip_smoke.py phase 5): through walk_full and its launch alone (the
    # launcher of whichever build runs: one output buffer, or words and
    # meta apart).
    lib = _build.library()
    stream = _build.stream_handle(dev)
    if wanted("K2 10 kb walk"):
        s1, s2 = padded(a10, round_up(10_000, 128), 0xFE), padded(b10, round_up(9_990, 128), PAD_S2)
        res = rb.gotoh_rowblock(s1, s2, global_boundary_top(0, s2.shape[0], sc, device=dev),
                                len(a10), len(b10), 0, sc, True, emit_dirs=True, emit_bottom=False)
        si, sj, cap = int(res.best[1]), int(res.best[2]), 24_576
        run = lambda: tw.walk_full(res.dirs, si, sj, 0, max_steps=cap)  # noqa: E731
        codes = run()[0]
        walk_sum = int(codes.astype(np.int64).sum()) + len(codes)
        out["K2 10 kb walk through walk_full"] = {"ms": cuda_ms(run), "sum": walk_sum,
                                                  "moves": len(codes)}
        KW, V = res.dirs.shape
        nw = -(-cap // 16)
        if hasattr(tw, "META_SLOTS"):
            buf = torch.empty(tw.META_SLOTS + nw, dtype=torch.int32, device=dev)
            ptrs = (_build.ptr(res.dirs), _build.ptr(buf))
        else:
            words = torch.empty(nw, dtype=torch.int32, device=dev)
            meta = torch.empty(6, dtype=torch.int32, device=dev)
            ptrs = (_build.ptr(res.dirs), _build.ptr(words), _build.ptr(meta))
        run = lambda: _build.check(lib.traceback_walk_launch(  # noqa: E731
            *ptrs, KW, V, si, sj, 0, 0, cap, stream), "traceback_walk")
        out["K2 10 kb walk alone"] = {"ms": cuda_ms(run), "sum": walk_sum}

    # K5: the interior tile (row and column shard 1) of the P = 4 pipeline.
    T4 = round_up(-(-len(a30) // 4), 128)
    s1 = padded(a30[T4: 2 * T4], T4, 0xFE)
    s2 = padded(b30[T4: 2 * T4], T4, PAD_S2)
    top = global_boundary_top(T4, T4, sc, device=dev)
    left = global_boundary_left(T4, T4, sc, device=dev)
    for is_local in (False, True):
        if not wanted(f"K5 P=4 tile local={is_local}"):
            continue
        run = lambda: gp.gotoh_tile_pallas(s1, s2, top, left, len(a30), len(b30), T4, T4,  # noqa: E731
                                           sc, is_local, emit_dirs=False, emit_bottom=True,
                                           emit_right=True)
        res = run()
        rb.raise_on_err(res.err)
        out[f"K5 P=4 tile local={is_local}"] = {
            "ms": cuda_ms(run), "sum": checksum(res.bottom, res.right, *res.best)}

    def batch(B: int, L: int):
        s1 = torch.from_numpy(acgt[rng.integers(0, 4, (B, L))]).to(dev)
        s2 = torch.from_numpy(acgt[rng.integers(0, 4, (B, L))]).to(dev)
        return s1, s2, np.full(B, L), np.full(B, L)

    pair = (padded(a30, round_up(len(a30), 128), 0xFE)[None],
            padded(b30, L30, PAD_S2)[None], np.array([len(a30)]), np.array([len(b30)]))
    # The 1,078,175 bp planted pair of chip_smoke.py (phases 17 and 25), cut
    # to its first 300 kb; K16's batch of phase 30.
    import chip_smoke

    mrng = np.random.default_rng(12_2048)
    genome = acgt[mrng.integers(0, 4, chip_smoke.GENOME_BP)].tobytes().decode()
    while True:
        planted, _ = chip_smoke.planted_copy(mrng, genome, sc)
        if len(planted) <= len(genome):
            break
    pre = 300_000
    g3 = np.frombuffer(genome[:pre].encode(), np.uint8)
    p3 = np.frombuffer(planted[:pre].encode(), np.uint8)
    prefix = (padded(g3, pre, 0xFE)[None], padded(p3, pre, PAD_S2)[None], np.array([pre]),
              np.array([pre]))
    brng = np.random.default_rng(3030)
    bgen = acgt[brng.integers(0, 4, chip_smoke.BLOCKED_LEN)].tobytes().decode()
    bcopies = [chip_smoke.planted_copy(brng, bgen, sc)[0] for _ in range(chip_smoke.BLOCKED_B)]
    Lk1, Lk2 = round_up(len(bgen), 128), round_up(max(len(c) for c in bcopies), 128)
    blocked = (torch.stack([padded(np.frombuffer(bgen.encode(), np.uint8), Lk1, 0xFE)] * 4),
               torch.stack([padded(np.frombuffer(c.encode(), np.uint8), Lk2, PAD_S2)
                            for c in bcopies]),
               np.full(4, len(bgen)), np.array([len(c) for c in bcopies]))
    cases = [("K9 29.9 kb pair", gp.gotoh_scores_pallas_batch, pair, (False, True)),
             ("K9 300 kb prefix", gp.gotoh_scores_pallas_batch, prefix, (False,)),
             ("K16 4 x 155 kb R=4096", gp.gotoh_scores_blocked, blocked, (False,))]
    for r in (128, 256, 512):
        cases.append((f"K9 29.9 kb pair rows={r}", lambda *a, r=r: gp._pallas_cuda(
            *a, rows_per_strip=r), pair, (False, True)))
        cases.append((f"K16 4 x 155 kb R={r}", lambda *a, r=r: gp.gotoh_scores_blocked(
            *a, R=r), blocked, (False,)))
    # One warp at a time (a grid of one block): the step time of the sweep.
    cases.append(("K9 29.9 kb pair rows=256 blocks=1", lambda *a: gp._pallas_cuda(
        *a, rows_per_strip=256, max_blocks=1), pair, (False,)))
    # Phase 31's slice: the K16 batch's first 300 rows, at each strip height
    # (1, 2 or 3 strips a pair) and one warp at a time.
    SLICE_ROWS = 300
    Lc = round_up(SLICE_ROWS, 128)
    k16_cut = (blocked[0][:, :Lc].contiguous(), blocked[1], np.minimum(blocked[2], SLICE_ROWS),
               blocked[3])
    for r in (128, 256, 512):
        cases.append((f"K16 300 rows x 155 kb R={r}", lambda *a, r=r: gp.gotoh_scores_blocked(
            *a, R=r), k16_cut, (False,)))
    for r in (256, 512):
        cases.append((f"K16 300 rows x 155 kb R={r} blocks=1", lambda *a, r=r: gp._pallas_cuda(
            *a, rows_per_strip=gp.blocked_rows(r), max_blocks=1), k16_cut, (False,)))
    # The whole 1,078,175 bp planted pair (phase 25's), at the card's ring
    # budget and at 2 GiB (the attribute a build's K9 plans its ring by).
    g1 = np.frombuffer(genome.encode(), np.uint8)
    p1 = np.frombuffer(planted.encode(), np.uint8)
    whole = (padded(g1, round_up(len(g1), 128), 0xFE)[None],
             padded(p1, round_up(len(p1), 128), PAD_S2)[None], np.array([len(g1)]),
             np.array([len(p1)]))
    ring_attr = "PIPE_RING_BYTES" if hasattr(gp, "PIPE_RING_BYTES") else "RING_BYTES"

    def ring_2g(*a):
        old = getattr(gp, ring_attr)
        setattr(gp, ring_attr, 2 << 30)
        try:
            return gp.gotoh_scores_pallas_batch(*a)
        finally:
            setattr(gp, ring_attr, old)

    cases += [("K9 1 Mb pair", gp.gotoh_scores_pallas_batch, whole, (False,)),
              ("K9 1 Mb pair ring=2GiB", ring_2g, whole, (False,))]
    cases += [("K3 132 x 8192", gs.gotoh_scores_stream, batch(132, 8192), (False, True)),
              ("K7 528 x 2048", gseg.gotoh_scores_segmented, batch(528, 2048), (False, True))]
    # chip_smoke.py phase 24's corpus as the CLI loads it (files g00..g127
    # in name order) and its buckets in the order the path scores them: K8
    # (global) on every bucket auto sends it, and K7 (local), K8 and K3
    # (global) on the largest.
    from genomics_rs_tpu_torch.ops import gotoh_stream8 as gs8
    from genomics_rs_tpu_torch.parallel.allpairs import bucketize_pairs
    from genomics_rs_tpu_torch.parallel.batch import route_engine
    from genomics_rs_tpu_torch.sequence import PAD_S1

    crng = np.random.default_rng(2424)
    clens = crng.integers(chip_smoke.MID_MIN, chip_smoke.MID_MAX + 1, chip_smoke.MID_N)
    mid = [chip_smoke.random_dna(crng, int(L)) for L in clens]
    mid = [np.frombuffer(mid[k].encode(), np.uint8)
           for k in sorted(range(len(mid)), key=lambda k: f"g{k:02d}")]
    mpairs = [(i, j) for j in range(len(mid)) for i in range(len(mid)) if i <= j]
    mgroups = bucketize_pairs(mpairs, [len(x) for x in mid])
    def stacked(seqs, L: int, pad: int) -> torch.Tensor:
        out = np.full((len(seqs), L), pad, np.uint8)
        for t, x in enumerate(seqs):
            out[t, : len(x)] = x
        return torch.from_numpy(out).to(dev)

    k8_buckets = {}
    for key in sorted(mgroups):
        bp = [mpairs[k] for k in mgroups[key]]
        Lm = max(round_up(max(len(mid[i]) for i, _ in bp), 128), 128)
        Ln = max(round_up(max(len(mid[j]) for _, j in bp), 128), 128)
        ms_b = np.array([len(mid[i]) for i, _ in bp])
        ns_b = np.array([len(mid[j]) for _, j in bp])
        if route_engine(len(bp), Lm, Ln, False, ms_b, ns_b) == "stream8":
            k8_buckets[key] = (stacked([mid[i] for i, _ in bp], Lm, PAD_S1),
                               stacked([mid[j] for _, j in bp], Ln, PAD_S2), ms_b, ns_b)
    big = k8_buckets[max(mgroups, key=lambda k: (k, len(mgroups[k])))]
    cases += [("K8 mid largest bucket", gs8.gotoh_scores_stream8, big, (False,)),
              ("K7 mid largest bucket", gseg.gotoh_scores_segmented, big, (True,)),
              ("K3 mid largest bucket", gs.gotoh_scores_stream, big, (False,))]
    if wanted("K8 mid every bucket local=False"):
        out["K8 mid every bucket local=False"] = {
            "ms": [cuda_ms(lambda b=b: gs8.gotoh_scores_stream8(*b, sc, False))
                   for b in k8_buckets.values()],
            "sum": sum(checksum(*gs8.gotoh_scores_stream8(*b, sc, False))
                       for b in k8_buckets.values())}
    # K6 at the reads' shapes: bench.py's 16,384 x 152 bp batch padded to
    # 256 (global and local scores, local with codes) and the map shape
    # (4,096 reads of 128 bp in 256 bp windows, local, codes); where the
    # build's wrapper takes a group size, also at each one. The checksum
    # reads the scores and start cells (codes past n are not the contract).
    from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr

    srng = np.random.default_rng(5)
    rd = (stacked(acgt[srng.integers(0, 4, (16_384, 152))], 256, PAD_S1),
          stacked(acgt[srng.integers(0, 4, (16_384, 152))], 256, PAD_S2),
          np.full(16_384, 152), np.full(16_384, 152))
    win = acgt[srng.integers(0, 4, (4096, 256))]
    rq = win[:, 64:192].copy()
    hit = srng.random(rq.shape) < 0.01
    rq[hit] = acgt[srng.integers(0, 4, int(hit.sum()))]
    mp = (torch.from_numpy(rq).to(dev), torch.from_numpy(win).to(dev), np.full(4096, 128),
          np.full(4096, 256))
    # the tier's longest reads: 4,096 pairs of 256 bp (rows 256: RT = 32 at
    # G = 8), local with codes, as align_reads fills them
    lr = (torch.from_numpy(acgt[srng.integers(0, 4, (4096, 256))]).to(dev),
          torch.from_numpy(acgt[srng.integers(0, 4, (4096, 256))]).to(dev), np.full(4096, 256),
          np.full(4096, 256))
    groups = (None,) + (tuple(gsr.GROUP_SIZES) if "group" in inspect.signature(
        gsr._shortread_cuda).parameters else ())
    for G in groups:
        tag = "" if G is None else f" G={G}"
        for name, inputs, is_local, dirs in (("K6 reads 16384 x 152", rd, False, False),
                                             ("K6 reads 16384 x 152", rd, True, False),
                                             ("K6 reads 16384 x 152 codes", rd, True, True),
                                             ("K6 map 4096 x 128 x 256 codes", mp, True, True),
                                             ("K6 reads 4096 x 256 codes", lr, True, True)):
            key = f"{name} local={is_local}{tag}"
            if not wanted(key):
                continue
            kw = {} if G is None else {"group": G}
            run = lambda: gsr._shortread_cuda(*inputs, sc, is_local, dirs, **kw)  # noqa: E731
            out[key] = {"ms": cuda_ms(run), "sum": checksum(*run()[:3])}
    for name, fn, inputs, modes in cases:
        for is_local in modes:
            if not wanted(f"{name} local={is_local}"):
                continue
            run = lambda: fn(*inputs, sc, is_local)  # noqa: E731
            out[f"{name} local={is_local}"] = {"ms": cuda_ms(run), "sum": checksum(*run())}

    # The banded fills: K10 on the 29.9 kb pair, K12 on 16 mutated copies,
    # both at band 2048; the checksum reads the codes of true in-band cells.
    V = 2048

    def band_sum(score, dirs, ms, ns, M, N) -> int:
        total = int(score.long().sum())
        v = torch.arange(V, device=dev)[None, :]
        for p in range(len(ms)):
            for r0 in range(0, int(ms[p]), 4096):
                r = np.arange(r0, min(int(ms[p]), r0 + 4096))
                off = torch.from_numpy(gb.band_offset(r + 1, M, N, V)).to(dev)[:, None]
                rows = torch.from_numpy(r).to(dev)
                codes = (dirs[p][rows // 16].long() >> (2 * (rows % 16))[:, None]) & 3
                total += int((codes * (off + v + 1 <= int(ns[p]))).sum())
        return total

    s1b, s2b = padded(a30, round_up(len(a30), 128), 0xFE), padded(b30, max(L30, V), PAD_S2)
    if wanted("K10 29.9 kb V=2048"):
        run = lambda: gb.gotoh_banded(s1b, s2b, len(a30), len(b30), sc, V)  # noqa: E731
        score, dirs = run()
        out["K10 29.9 kb V=2048"] = {"ms": cuda_ms(run), "sum": band_sum(
            torch.tensor([score]), dirs[None], [len(a30)], [len(b30)], len(a30), len(b30))}
    if wanted("K10 1 Mb V=2048"):
        g1b = padded(g1, round_up(len(g1), 128), 0xFE)
        p1b = padded(p1, max(round_up(len(p1), 128), V), PAD_S2)
        run = lambda: gb.gotoh_banded(g1b, p1b, len(g1), len(p1), sc, V)  # noqa: E731
        score, _ = run()
        out["K10 1 Mb V=2048"] = {"ms": cuda_ms(run), "sum": score}
    if wanted("align_banded 1 Mb wall"):
        from genomics_rs_tpu_torch.models.banded import align_banded
        from genomics_rs_tpu_torch.sequence import Sequence

        gs_, ps_ = Sequence("g", genome), Sequence("p", planted)
        walls = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aln = align_banded(gs_, ps_, sc, band=V, device="cuda")
            walls.append((time.perf_counter() - t0) * 1e3)
        out["align_banded 1 Mb wall"] = {"ms": walls[1:], "sum": aln.score}
    # One warp of the band sweep at a time (a grid of one block; a build
    # whose fill takes it).
    one_block = "max_blocks" in inspect.signature(gb.fill_cuda).parameters
    if one_block and wanted("K10 29.9 kb V=2048 blocks=1"):
        run = lambda: gb.fill_cuda(s1b[None], s2b[None], [len(a30)], [len(b30)], sc, V,  # noqa: E731
                                   {"kernel": 0}, max_blocks=1)
        score, dirs = run()
        out["K10 29.9 kb V=2048 blocks=1"] = {"ms": cuda_ms(run), "sum": band_sum(
            score, dirs, [len(a30)], [len(b30)], len(a30), len(b30))}
    copies = []
    for _ in range(16):  # 1%-mutated copies of a30, 0-39 bp shorter than b30
        c = a30[: len(b30) - int(rng.integers(0, 40))].copy()
        snp = rng.random(len(c)) < 0.01
        c[snp] = acgt[rng.integers(0, 4, int(snp.sum()))]
        copies.append(c)
    if wanted("K12 16 x 29.9 kb V=2048"):
        bms = np.full(16, len(a30))
        bns = np.array([len(c) for c in copies])
        k1b = torch.stack([s1b] * 16)
        k2b = torch.stack([padded(c, max(L30, V), PAD_S2) for c in copies])
        run = lambda: gbb.gotoh_banded_batch(k1b, k2b, bms, bns, sc, V)  # noqa: E731
        groups = run()
        out["K12 16 x 29.9 kb V=2048"] = {"ms": cuda_ms(run), "sum": band_sum(
            torch.cat([g.score for g in groups]), torch.cat([g.dirs for g in groups]), bms, bns,
            groups[0].M, groups[0].N)}

    mx = blosum62()
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    B, L = 8192, 383
    p1 = torch.from_numpy(aa[rng.integers(0, 20, (B, L))]).to(dev)
    p2 = torch.from_numpy(aa[rng.integers(0, 20, (B, L))]).to(dev)
    ms = ns = np.full(B, L)
    for is_local in (False, True):
        if not wanted(f"K14 8192 x 383 aa local={is_local}"):
            continue
        run = lambda: gm.gotoh_matrix_fill(p1, p2, ms, ns, mx, -1, -11, is_local,  # noqa: E731
                                           route="stream")
        res = run()
        out[f"K14 8192 x 383 aa local={is_local}"] = {
            "ms": cuda_ms(run), "sum": checksum(res[0], res[1], res[2])}

    # K3 and the matrix fill at the paths' shapes: K3 on the 55-pair corpus
    # of 10 x 29,900 bp genomes (global), on its first --alignments-out group
    # of 9 pairs with dirs, and on call's round (4,096 reads of 150 bp
    # against 380 bp windows, 256 x 384, local, dirs); the matrix fill on
    # 32,768 x 383 aa (route "stream", one launch), 1,024 x 192-384 aa
    # (route "pallas") and 256 x 383 aa with dirs; then, where the build's
    # wrappers take a strip height, each of them at every compiled one.
    sweep = "rows_per_strip" in inspect.signature(gs._stream_cuda).parameters

    def fill_sum(res) -> int:
        total = checksum(res.score, res.start_i, res.start_j)
        return total + (0 if res.dirs is None else int(res.dirs.sum(dtype=torch.int64)))

    enc = [np.frombuffer(x.encode(), np.uint8) for _, x in chip_smoke.corpus_genomes()]
    Lg = round_up(chip_smoke.GENOME_LEN, 128)

    def genome_batch(pairs):
        return (torch.stack([padded(enc[i], Lg, 0xFE) for i, _ in pairs]),
                torch.stack([padded(enc[j], Lg, PAD_S2) for _, j in pairs]),
                np.array([len(enc[i]) for i, _ in pairs]), np.array([len(enc[j]) for _, j in pairs]))

    N = len(enc)
    corpus = genome_batch([(i, j) for j in range(N) for i in range(N) if i <= j])
    group9 = genome_batch([(i, j) for j in range(N) for i in range(N) if i < j][:9])
    wins = acgt[rng.integers(0, 4, (4096, 380))]
    reads = wins[:, 100:250].copy()
    snp = rng.random(reads.shape) < 0.01
    reads[snp] = acgt[rng.integers(0, 4, int(snp.sum()))]
    call = (torch.stack([padded(r, 256, 0xFE) for r in reads]),
            torch.stack([padded(w, 384, PAD_S2) for w in wins]), np.full(4096, 150),
            np.full(4096, 380))
    k3_cases = [("K3 55 x 29.9 kb corpus", corpus, False, False),
                ("K3 dirs group of 9 x 29.9 kb", group9, False, True),
                ("K3 call round 4096 x 256 x 384", call, True, True)]
    prot = chip_smoke.protein_bench_data()
    u1, u2 = (torch.from_numpy(prot[k]).to(dev) for k in ("u1", "u2"))
    q1, q2 = (torch.from_numpy(prot[k]).to(dev) for k in ("p1", "p2"))
    uns = np.full(u1.shape[0], u1.shape[1])
    # K15 at the path's launch shape (1,024 x 384, chip_smoke.py phase 21)
    # and at 32,768 x 383: through its wrapper and its launch alone (the
    # launcher of whichever build runs: one byte table, or code and ext).
    for name, s2x, nsx in (("K15 1024 x 384", q2, prot["pns"]), ("K15 32768 x 383", u2, uns)):
        if not wanted(name):
            continue
        run = lambda: gm.matrix_profile(s2x, nsx, mx)  # noqa: E731
        prof_sum = checksum(run())
        out[f"{name} through the wrapper"] = {"ms": cuda_ms(run), "sum": prof_sum}
        if "ns_dev" in inspect.signature(gm.matrix_profile).parameters:
            # the grouped route's form: the lengths already on the card
            ns_on = torch.as_tensor(np.asarray(nsx), dtype=torch.int32).to(dev)
            run = lambda: gm.matrix_profile(s2x, nsx, mx, ns_on)  # noqa: E731
            out[f"{name} through the wrapper, lengths on the card"] = {
                "ms": cuda_ms(run), "sum": checksum(run())}
        tables = (gm.device_tables(mx, dev)[2:] if hasattr(gm, "device_tables")
                  else gm._tables(mx, dev))
        A = gm._ext_matrix(mx).shape[0]
        prof_x = torch.empty((s2x.shape[0], A, s2x.shape[1]), dtype=torch.int16, device=dev)
        ns_x = torch.as_tensor(np.asarray(nsx), dtype=torch.int32).to(dev)
        # a build whose launcher takes a cap on blocks an SM: at its default
        # and at each cap of the sweep
        caps = ([(gm.PROFILE_BLOCKS_PER_SM,), *((c,) for c in (1, 2, 8))]
                if hasattr(gm, "PROFILE_BLOCKS_PER_SM") else [()])
        for cap in caps:
            run = lambda: _build.check(lib.matrix_profile_launch(  # noqa: E731
                _build.ptr(s2x), _build.ptr(ns_x), *(_build.ptr(t) for t in tables),
                _build.ptr(prof_x), s2x.shape[0], s2x.shape[1], A, *cap, stream), "matrix_profile")
            tag = "" if cap in ((), (getattr(gm, "PROFILE_BLOCKS_PER_SM", 0),)) else (
                f" blocks_per_sm={cap[0]}")
            out[f"{name} alone{tag}"] = {"ms": cuda_ms(run), "sum": checksum(prof_x)}
        del prof_x
    code_u, prof_u = gm.row_codes(u1, mx), gm.matrix_profile(u2, uns, mx)
    code_q, prof_q = gm.row_codes(q1, mx), gm.matrix_profile(q2, prot["pns"], mx)
    m_cases = [("matrix 32768 x 383 aa stream", (code_u, prof_u, uns, uns), False, "stream"),
               ("matrix 1024 x 192-384 aa pallas", (code_q, prof_q, prot["pms"], prot["pns"]),
                False, "pallas"),
               ("matrix dirs 256 x 383 aa", (code_u[:256], prof_u[:256], uns[:256], uns[:256]),
                True, "stream")]
    heights = [None] + ([32 * r for r in gp.LANE_ROWS] if sweep else [])
    for rows in heights:
        tag = "" if rows is None else f" sweep rows={rows}"
        kw = {} if rows is None else {"rows_per_strip": rows}
        for name, inputs, is_local, dirs in k3_cases:
            if not wanted(name + tag):
                continue
            if rows is None:
                run = lambda: gs.gotoh_stream_fill(*inputs, sc, is_local, dirs)  # noqa: E731
            else:
                run = lambda: gs._stream_cuda(*inputs, sc, is_local, dirs, **kw)  # noqa: E731
            out[name + tag] = {"ms": cuda_ms(run), "sum": fill_sum(run())}
        for name, inputs, dirs, route in m_cases:
            if not wanted(name + tag):
                continue
            if rows is None:
                run = lambda: gm.matrix_fill(*inputs, -1, -11, False, dirs, route)  # noqa: E731
            else:
                run = lambda: gm._matrix_cuda(*inputs, -1, -11, False, dirs, route,  # noqa: E731
                                              **kw)
            out[name + tag] = {"ms": cuda_ms(run), "sum": fill_sum(run())}

    # K4 and K11 alone (they share the staged ring with K2): K4 on the dirs
    # group of 9's walks (chip_smoke.py phase 9), K11 on the 29.9 kb pair's
    # band walk (phase 18).
    def listed(fn, _reps):
        return [cuda_ms(fn)]

    if wanted("K4 dirs group of 9 walks alone"):
        res9 = gs.gotoh_stream_fill_dirs(*group9, sc)
        flat = res9.dirs.view(-1, res9.dirs.shape[2])
        wargs = (res9.start_i, res9.start_j, np.arange(9) * res9.KW, res9.KW,
                 round_up(2 * Lg + 1, 1024))
        walked = tw.walk_many(flat, *wargs)
        out["K4 dirs group of 9 walks alone"] = {
            "ms": chip_smoke.k4_alone(torch, tw, flat, wargs, listed)[0],
            "sum": int(np.asarray(walked[1], np.int64).sum()), "moves": int(np.sum(walked[1]))}
    if wanted("K11 29.9 kb walk alone"):
        _, dirs = gb.gotoh_banded(s1b, s2b, len(a30), len(b30), sc, V)
        moves = gb.walk_banded(dirs, len(a30), len(b30), V)
        out["K11 29.9 kb walk alone"] = {
            "ms": chip_smoke.k11_alone(torch, gb, dirs[None], [len(a30)], [len(b30)], V,
                                       (len(a30), len(b30)), listed)[0],
            "sum": int(np.asarray(moves, np.int64).sum()), "moves": len(moves)}

    # The walls of the two batch aligners that run K3's and the matrix
    # fill's dirs: align_batch on the corpus's first 9 pairs (one dirs
    # group, as align-matrix --alignments-out runs it), matrix_align_batch
    # on the first 256 pairs of 383 aa.
    from genomics_rs_tpu_torch.models.aligner import align_batch, matrix_align_batch
    from genomics_rs_tpu_torch.sequence import Sequence

    gpairs = [(Sequence(f"a{i}", enc[i].tobytes().decode()),
               Sequence(f"b{j}", enc[j].tobytes().decode()))
              for j in range(N) for i in range(N) if i < j][:9]
    ppairs = [(Sequence(f"p{t}", prot["u1"][t].tobytes().decode()),
               Sequence(f"q{t}", prot["u2"][t].tobytes().decode())) for t in range(256)]
    for name, fn in (("align_batch 9 x 29.9 kb wall", lambda: align_batch(gpairs, sc)),
                     ("matrix_align_batch 256 x 383 aa wall",
                      lambda: matrix_align_batch(ppairs, mx, -1, -11))):
        if not wanted(name):
            continue
        walls = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            alns = fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"ms": walls[1:], "sum": sum(a.score for a in alns)}

    from genomics_rs_tpu_torch.parallel.longseq import sharded_gotoh_score
    from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh
    from genomics_rs_tpu_torch.sequence import PAD_S1

    for P in (1, 4):
        if not wanted(f"sharded_gotoh_score P={P} wall"):
            continue
        R, Ln = round_up(len(a30), 128 * P) // P, round_up(len(b30), 128 * P)
        s1e = torch.from_numpy(np.full(R * P, PAD_S1, np.uint8))
        s1e[: len(a30)] = torch.from_numpy(a30)
        s2e = torch.from_numpy(np.full(Ln, PAD_S2, np.uint8))
        s2e[: len(b30)] = torch.from_numpy(b30)
        mesh = make_mesh(P, SEQ_AXIS, devices=[dev] * P)
        walls = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            score = int(sharded_gotoh_score(mesh, s1e, s2e, len(a30), len(b30), sc, False).score)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"sharded_gotoh_score P={P} wall"] = {"ms": walls[1:], "sum": score}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
