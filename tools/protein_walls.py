"""Time the protein batch alignment path on one CUDA card:
``matrix_align_batch`` of chip_smoke.py's 256 pairs of 383 aa under
BLOSUM62 (h = -11, g = -1), global and local, ``--reps`` times after a
warm run. Each run also times its host classification step
(``models/aligner._classify_group``: the end-of-walk check, then the
classifier), and the step is timed again alone on the last run's walked
moves: ``classify_moves`` pair by pair and, where the checkout has it,
``classify_moves_batch``, each keeping its results alive as the aligner
does; and, where the checkout has ``classify_moves_batch``, the same
pairs cut into groups of ``GROUP_SIZES`` pairs, one batched call a group
(a group of 1 is the per-pair cost). ``--no-gc`` turns Python's cyclic
collector off for the whole run.

``--root`` names the checkout whose ``genomics_rs_tpu_torch`` is imported
(default: this one), so one machine can time two checkouts on the same
data (A B B A).

Prints the card's name and power limit, then one JSON object with the
walls (s) and a digest of the alignments.

    python3 tools/protein_walls.py [--reps 5] [--root DIR] [--no-gc]
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: group sizes at which the classification alone is timed.
GROUP_SIZES = (1, 2, 4, 8, 15, 16, 32, 256)


def _digest(alns) -> str:
    h = hashlib.sha256()
    for a in alns:
        h.update(repr((a.score, [(c.value, i, j) for c, i, j in a.alignment], a.matches,
                       a.mismatches, a.opening_gaps, a.gap_extensions)).encode())
    return h.hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--no-gc", action="store_true")
    args = ap.parse_args()
    if args.no_gc:
        gc.disable()
    import torch

    if not torch.cuda.is_available():
        sys.exit("protein_walls: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    sys.path.insert(0, ROOT)
    from chip_smoke import PROT_ALIGN_B, PROT_G, PROT_H, protein_bench_data

    data = protein_bench_data()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from genomics_rs_tpu_torch.models import aligner
    from genomics_rs_tpu_torch.ops import subst
    from genomics_rs_tpu_torch.ops import traceback as tb
    from genomics_rs_tpu_torch.sequence import Sequence

    assert aligner.__file__.startswith(root), aligner.__file__
    os.environ["LOG_LEVEL"] = "WARNING"
    pairs = [(Sequence(f"a{i}", data["u1"][i].tobytes().decode()),
              Sequence(f"b{i}", data["u2"][i].tobytes().decode())) for i in range(PROT_ALIGN_B)]
    b62 = subst.blosum62()
    real_classify = aligner._classify_group
    groups: list = []

    def record_classify(chunk, walked, *a, **kw):
        t0 = time.perf_counter()
        got = real_classify(chunk, walked, *a, **kw)
        groups.append((chunk, walked, time.perf_counter() - t0))
        return got

    aligner._classify_group = record_classify
    out = {"root": root, "pairs": f"{PROT_ALIGN_B} x 383 aa", "gc": not args.no_gc}
    for is_local in (False, True):
        mode = "local" if is_local else "global"
        walls, steps = [], []
        for rep in range(args.reps + 1):
            groups.clear()
            t0 = time.perf_counter()
            alns = aligner.matrix_align_batch(pairs, b62, PROT_G, PROT_H, is_local=is_local)
            torch.cuda.synchronize()
            if rep:  # the first run is the warm-up
                walls.append(time.perf_counter() - t0)
                steps.append(sum(g[2] for g in groups))
        alone = {"per_pair": [], "batched": []}
        batched = getattr(tb, "classify_moves_batch", None)
        for _ in range(args.reps):
            t0 = time.perf_counter()
            kept = [tb.classify_moves(w[0][t, : w[1][t]], int(w[6][t]), int(w[7][t]),
                                      int(w[5][t]), a, b)
                    for chunk, w, _ in groups for t, (a, b) in enumerate(chunk)]
            alone["per_pair"].append(time.perf_counter() - t0)
            del kept
            if batched is not None:
                t0 = time.perf_counter()
                kept = [batched(w[0], w[1], w[6], w[7], w[5], chunk) for chunk, w, _ in groups]
                alone["batched"].append(time.perf_counter() - t0)
                del kept
        by_size: dict[str, list[float]] = {}
        for size in GROUP_SIZES if batched is not None else ():
            for _ in range(args.reps):
                t0 = time.perf_counter()
                kept = [batched(*(w[x][k: k + size] for x in (0, 1, 6, 7, 5)),
                                chunk[k: k + size])
                        for chunk, w, _ in groups for k in range(0, len(chunk), size)]
                by_size.setdefault(str(size), []).append(time.perf_counter() - t0)
                del kept
        out[mode] = {"wall_s": walls, "classify_in_run_s": steps,
                     "groups": [len(g[0]) for g in groups],
                     "classify_alone_s": {k: v for k, v in alone.items() if v},
                     "classify_by_group_size_s": by_size,
                     "sha256": _digest(alns)}
    aligner._classify_group = real_classify
    print(json.dumps(out))


if __name__ == "__main__":
    main()
