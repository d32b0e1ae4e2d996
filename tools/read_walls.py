"""Time the read path's CLI walls on one CUDA card: ``map`` of 100,000 x
128 bp reads against a seeded 1,078,175 bp genome (rounds of 4,096
windows on K6 and ``walk_rows16``) and ``reads --align --format sam`` on
16,384 pairs of 152 bp (four rounds), each run in this process through
``cli.main`` ``--reps`` times after a warm run. The data come from a seed,
so two checkouts time the same work: run it in each (A B B A) to compare
them within one machine.

Prints the card's name and power limit, then one JSON object with the
walls (s) and a digest of each workload's output file.

    python3 tools/read_walls.py [--reps 3]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GENOME_BP, MAP_N, MAP_LEN = 1_078_175, 100_000, 128
READS_B, READS_LEN = 16_384, 152


def _data(tmp: str) -> dict[str, list[str]]:
    """Write the inputs under ``tmp``; returns each workload's CLI args."""
    rng = np.random.default_rng(1207)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[rng.integers(0, 4, GENOME_BP)]
    comp = np.zeros(256, np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", np.uint8)

    def snps(x):
        hit = rng.random(x.shape) < 0.01
        return np.where(hit, acgt[(np.searchsorted(acgt, x) + rng.integers(1, 4, x.shape)) % 4], x)

    starts = rng.integers(0, GENOME_BP - MAP_LEN, MAP_N)
    reads = snps(genome[starts[:, None] + np.arange(MAP_LEN)])
    reads[1::2] = comp[reads[1::2, ::-1]]  # odd reads on the reverse strand
    starts = rng.integers(0, GENOME_BP - READS_LEN, READS_B)
    refs = genome[starts[:, None] + np.arange(READS_LEN)]
    qs = snps(refs)
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    with open(path("config.toml"), "w") as f:
        f.write("[scores]\ns_match = 1\ns_mismatch = -2\ng = -1\nh = -5\n")
    with open(path("genome.fasta"), "w") as f:
        f.write(f">chr12s random {GENOME_BP} bp\n{genome.tobytes().decode()}\n")
    for name, rows in (("map.fasta", reads), ("q.fasta", qs), ("r.fasta", refs)):
        with open(path(name), "w") as f:
            f.writelines(f">{name[0]}{i}\n{row.tobytes().decode()}\n" for i, row in enumerate(rows))
    base = ["-c", path("config.toml")]
    return {
        "map": base + ["map", "-q", path("map.fasta"), "-r", path("genome.fasta"), "-o",
                       path("map.sam")],
        "reads --align": base + ["reads", "-q", path("q.fasta"), "-r", path("r.fasta"), "-a",
                                 "local", "--align", "--format", "sam", "-o", path("reads.sam")],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    reps = ap.parse_args().reps
    import torch

    if not torch.cuda.is_available():
        sys.exit("read_walls: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    from genomics_rs_tpu_torch import cli

    os.environ["LOG_LEVEL"] = "WARNING"
    walls, digest = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in _data(tmp).items():
            walls[name] = []
            for rep in range(reps + 1):
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = cli.main(argv)
                torch.cuda.synchronize()
                if rc != 0:
                    sys.exit(f"read_walls: {name} exited {rc}")
                if rep:  # the first run is the warm-up
                    walls[name].append(time.perf_counter() - t0)
            with open(argv[-1], "rb") as f:
                digest[name] = hashlib.sha256(f.read()).hexdigest()[:16]
    print(json.dumps({"root": ROOT, "walls_s": walls, "output_sha256": digest}))


if __name__ == "__main__":
    main()
