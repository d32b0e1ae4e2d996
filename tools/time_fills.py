"""Time the fills that share the cell recurrence of
``genomics_rs_tpu_torch/csrc/gotoh_stream_body.cuh`` on one CUDA card.

Inputs are made from a seed: K1 at the main path's three fills (the
29,903 bp pair's forward fill with column checkpoints and its refill
with dirs, one block of 30,719 rows; a 10 kb local fill with dirs), K5
at the P = 4 tile of that pair, K9 on the whole pair, K3 on 132 pairs
of 8,192 bp, the warp strips (K7) on 528 pairs of 2,048 bp, and the
matrix fill (K14) on 8,192 BLOSUM62 pairs of 383 aa; global and local
where the path has both; and the host wall of ``sharded_gotoh_score`` on
the 29,903 bp pair at P = 1 and 4 shards of the card. Prints the card's
name and power limit, then one JSON object: per fill the median
CUDA-event ms of ``--reps`` runs and a checksum of its outputs (per wall
every run, after a first), so that two builds of the kernels (two
checkouts, run one after the other in one session on one card) can be
compared for time and held equal for results.

    python3 tools/time_fills.py [--reps 5]
"""

from __future__ import annotations

import argparse
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
    reps = ap.parse_args().reps

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_fills: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])

    from genomics_rs_tpu_torch.config import Scores
    from genomics_rs_tpu_torch.ops import _build
    from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
    from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
    from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
    from genomics_rs_tpu_torch.ops import gotoh_segmented as gseg
    from genomics_rs_tpu_torch.ops import gotoh_stream as gs
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

    # K5: the interior tile (row and column shard 1) of the P = 4 pipeline.
    T4 = round_up(-(-len(a30) // 4), 128)
    s1 = padded(a30[T4: 2 * T4], T4, 0xFE)
    s2 = padded(b30[T4: 2 * T4], T4, PAD_S2)
    top = global_boundary_top(T4, T4, sc, device=dev)
    left = global_boundary_left(T4, T4, sc, device=dev)
    for is_local in (False, True):
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
    cases = (("K9 29.9 kb pair", gp.gotoh_scores_pallas_batch, pair),
             ("K3 132 x 8192", gs.gotoh_scores_stream, batch(132, 8192)),
             ("K7 528 x 2048", gseg.gotoh_scores_segmented, batch(528, 2048)))
    for name, fn, args in cases:
        for is_local in (False, True):
            run = lambda: fn(*args, sc, is_local)  # noqa: E731
            out[f"{name} local={is_local}"] = {"ms": cuda_ms(run), "sum": checksum(*run())}

    mx = blosum62()
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    B, L = 8192, 383
    p1 = torch.from_numpy(aa[rng.integers(0, 20, (B, L))]).to(dev)
    p2 = torch.from_numpy(aa[rng.integers(0, 20, (B, L))]).to(dev)
    ms = ns = np.full(B, L)
    for is_local in (False, True):
        run = lambda: gm.gotoh_matrix_fill(p1, p2, ms, ns, mx, -1, -11, is_local,  # noqa: E731
                                           route="stream")
        res = run()
        out[f"K14 8192 x 383 aa local={is_local}"] = {
            "ms": cuda_ms(run), "sum": checksum(res[0], res[1], res[2])}

    from genomics_rs_tpu_torch.parallel.longseq import sharded_gotoh_score
    from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh
    from genomics_rs_tpu_torch.sequence import PAD_S1

    for P in (1, 4):
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
