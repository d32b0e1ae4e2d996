#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA device, ``nvcc`` (it builds the kernels from
``genomics_rs_tpu_torch/csrc/`` itself) and a host C++ compiler (for
``native/``: the score oracle, the suffix tree and SA-IS). Any failed
check exits nonzero.

Phases, one line each:
  0  the card (``nvidia-smi`` name and power limit); no CUDA -> exit 1
  1  build the kernels and the oracle; measure the staged walks' chain
     floor (one dependent shared-memory load, ``tools/smem_chase.cu``)
  2  K1 (row-block fill: a strip pipeline over many SMs) kernel == its
     plain version, on the card: small fills, the pipeline's edges
     (ragged and short strips, top rows of 63-65 columns, grids of 1-3
     blocks, a two-slot ring, a block past m, strips of 64-512 rows), and
     the path's 10 kb local fill with dirs and 29.9 kb forward fill with
     cols at 128, 256 and 512 rows a strip
  3  K2 (the single walk: K4's staged chase on one warp, with the block
     exits) kernel == its plain version, on the card: over phase 2's
     bitmaps (j0 windows, resumes) and on ``tests/walk_stage_cases.py``'s
     exit cases (up exits in a SUB run and off lane 0 after an INS run,
     left exits in SUB and INS runs, both at once, stop cells), one launch
     and resumed at 1, 15, 16 and 17 moves, on the TMA route and the 4-byte
     cp.async route (a view 4 bytes off alignment)
  4  ``align`` end to end through ``PairwiseAligner(device="cuda")``:
     reference goldens, a seeded ~10 kb local pair (monolithic path) and
     a seeded 29,903 bp global pair (checkpointed path), scores and start
     cells held against the C++ oracle; launch counters show both
     kernels ran and no plain version did; then the 29,903 bp path is
     replayed with every fill and walk recorded, and each is held
     against its plain version on the same inputs
  5  kernel and plain-version times at the main path's shapes (K1's three
     fills at 128, 256 and 512 rows a strip; K2 through its wrapper and
     its launch alone, ns a move beside phase 1's chain floor), and the
     wall time of the 29,903 bp ``align``
  6  K3 (batched fill on the warp-strip pipeline) kernel == its plain
     version, on the card: small mixed-length batches (global/local,
     classic/kimura, B = 1, empty sequences, dirs at every true cell; at
     the path's strip height and at every compiled one on 3 blocks), the
     full 55-pair corpus of 10
     x 29,900 bp genomes (bench.py's synthetic recipe) in global mode and
     a 4-genome subset in local mode
  7  ``allpairs_scores(device="cuda")`` on the corpus, global and local,
     scores and start cells held against the C++ oracle; launch counters
     show K3 ran and no plain version did
  8  ``align-matrix --alignments-out`` (the CLI) on the corpus: K3 and K4
     launched, no plain version; one group's K3 dirs fill == plain and
     every walk of it K4 == plain, as on ``tests/walk_stage_cases.py``'s
     edge paths (word-row boundaries, a stop cell, lane offsets, 300-move
     gaps, li held at 0); three pairs equal the per-pair
     ``PairwiseAligner.align`` (moves, score, stats, written FASTA); a
     mixed 1–5 kb corpus through the CLI, global and local, every pair's
     file equal to the per-pair aligner's
  9  K3/K4 kernel times (median of 3, CUDA events; K4 through its wrapper
     and its launch alone), plain times, and the wall times of
     ``allpairs_scores`` and ``align-matrix``
 10  K6 (short-read fill: a sub-warp wavefront, G lanes a pair) kernel ==
     its plain version, on the card: ragged fills of 1–256 bp (global/local,
     classic/kimura, codes at every true cell; rows that end inside a lane,
     tie-heavy local batches), bench.py's 16,384 x 152 bp batch (padded
     256) and the map shape, each at the wrapper's G and at G = 8, 16, 32
 11  ``walk_rows16`` kernel == its plain version over K6's codes: 4,096
     reads at the ``map`` shape (local) and 4,096 of the 152 bp batch
     (global)
 12  ``align_reads`` on the card, both fill routes (<= 256 bp on K6 +
     ``walk_rows16``, wider on K3 + K4), global and local: scores and start
     cells == the C++ oracle, path, stats and CIGAR == the per-pair
     ``PairwiseAligner.align``
 13  the read path's CLI at real size (the main path of this slice, launch
     counters reset just before it): ``reads`` scores and ``reads --align
     --format sam`` on the 16,384 x 152 bp batch, ``map`` of 100,000
     simulated 128 bp reads and ``map -2`` of 10,000 pairs against a
     seeded 1,078,175 bp genome (positions and strands against the reads'
     origins), ``call`` on 100,000 x 150 bp reads with 50 planted SNPs
     (>= 49 recovered, no false call); K6, ``walk_rows16``, K3 and K4
     launched, no plain version; then ``call``'s first K3 + K4 round
     (4,096 reads, 256 x 384, local) is replayed from its recorded inputs:
     K3 dirs == plain (codes at every true cell), 64 reads' scores == the
     C++ oracle, and the diag16 walks (K4) == plain
 14  K6 / ``walk_rows16`` / call-round K3 and K4 kernel times (median of 3,
     CUDA events), plain times and bounds, K6 at every G on the reads batch
     and the map shape (the sweep ``group_size`` was set from), and K4's
     device and host time on
     that round from one ``torch.profiler`` capture and from its launch
     alone (CUDA events); ``walk_rows16``'s launch alone; the walls of
     ``reads``,
     ``map`` (seeding and extension) and ``call``; ``map``'s device-busy
     share from ``torch.profiler``
 15  the banded fill (K10 one pair, K12 a batch; one kernel) == its plain
     version, on the card: small fills at V = 1024 and 2048 (full cover and
     narrow, classic and kimura), an 11-pair batch at W = 128, 384 and 2048,
     the 29,903 bp planted pair at V = 2048, one fill at each width that
     had its own compiled form before the warp-strip sweep (V = 8192,
     16,384, 32,768, 33,792 and 34,816; one kernel since), and the sweep's
     edges: a band at column 0, a band that slides a column a row and a
     mixed batch, each on the whole grid and on two blocks; codes at every
     true in-band cell
 16  K11 (banded walker) == its plain version over phase 15's bitmaps,
     resumed past 1,000 moves, the batch walks in one launch with the
     shared geometry, and ``tests/walk_stage_cases.py``'s paths (gaps wider
     than the lane window both ways, both band edges, starts on rows 16k,
     16k+1, 16k+15) whole and resumed at 1, 15, 16, 17 and 1,000 moves a
     launch; an all-INS bitmap raises
 17  the banded path at real size (launch counters reset just before it):
     ``align_banded`` of a seeded 1,078,175 bp genome with itself (score ==
     length) and with its planted copy (score == the planted optimum) at
     band 2048, the CLI ``align --band 2048`` (stats == the library's), and
     ``banded_align_batch`` of 16 planted copies of a 29,903 bp genome
     (scores == planted, two == the C++ oracle); K10, K12 and K11 launched,
     no plain version; then K10 == its plain version on the first 32,768
     rows of the 1 Mb window, K11 == its plain version on the 1 Mb planted
     pair's walk and the 16 batch walks, and each of those paths, rescored
     from its strings, runs end to end at a cost <= its score
 18  K10 / K11 / K12 times (median of 3, CUDA events) at 1 Mb and 29,903 bp,
     plain times and bounds, and the banded walls; K11 through its wrapper
     (also cut into 65,536-move launches) and its launch alone on the 29.9
     kb, the 1 Mb planted and self walks and the 16-walk batch
 19  K15 (the query profile) kernel == its plain version, on the card: small
     mixed batches under four matrices (BLOSUM62, asymmetric, |v| near 200,
     no X; zero lengths, unknown bytes), the tail shapes (rows of every
     alignment, n_p inside and at the edge of a 16-byte chunk, n_p = 0,
     B = 1, two column tiles) and every entry of the 32,768 x 383 aa
     batch's profile
 20  the matrix fill (K13 and K14; one kernel) == its plain version: the
     small batches global and local (zero lengths, B = 1, codes at every
     true cell), 256 pairs of the 383 aa batch global and local with dirs,
     every compiled strip height on 3 blocks, and the ``dna_matrix``
     bridge == K3's plain version (classic/kimura, dirs)
 21  the protein path at real size (launch counters reset just before it),
     BLOSUM62 at h = -11, g = -1: ``gotoh_scores_matrix`` on bench.py's
     1,024 x 192-384 aa and 32,768 x 383 aa batches (global and local; 512
     sampled scores and starts == the C++ LUT oracle), its pallas route on
     1,024 pairs == the stream route, ``matrix_align_batch`` of 256 x 383
     aa global and local (3 pairs == ``PairwiseAligner(matrix=)``; every
     alignment of both modes == per-pair ``classify_moves`` of the same
     walked moves, every group classified by one ``classify_moves_batch``
     pass; each mode's wall and its classification
     step, in the run and alone batched and per pair), the CLI ``align
     --matrix``, ``align-matrix --matrix`` on 256 seeded proteins of
     100-1,000 aa (TSV == the library's, a sample == the oracle) and with
     ``--alignments-out`` on a 32-protein family, ``msa --matrix`` on
     bench.py's 16 x 400 aa corpus and ``msa`` on 24 x 1.5 kb of DNA (rows
     spell their sequences, the center is the argmax of the summed
     scores); the profile kernel, both fill routes, K4, K2 and K3 launched,
     no plain version; K15's launches there each timed through its wrapper,
     launches x (time - bound); then the 256-pair group's walks, K4 == plain
 22  profile, fill and K4 times (CUDA events; K15 at 32,768 x 383 and at
     1,024 x 384 through its wrapper and its launch alone; K4 through its
     wrapper and its launch alone), the one PyTorch call that computes the
     profile (a (256, A) byte table indexed by the batch) at both shapes,
     plain times, bounds, and the walls of phase 21's calls
 23  the warp-strip kernel (K7) and the warp-strip pipeline (K9, and K8 on
     K3's kernel) == their plain versions on small batches (empty and
     one-base pairs, global/local, classic/kimura; K9 also at 32-row strips
     on a 3-block grid, so tickets and ring slots cycle, K9 and K8 on a ring
     of five slots, which splits the batch into launches of two or more
     slots a pair, each counted),
     then a sweep of B in {1, 8, 32, 132, 528} x L in {512, 2048, 8192},
     global and local: K3 and K9 (both on the pipeline) == the warp-strip
     kernel on every pair and == the C++ oracle on each bucket's first and
     last pairs, each one's time (median of 3, CUDA events), cells/s and
     bound
 24  the main path of this slice from here to phase 26 (launch counters
     reset just before it; each call of the path must launch exactly the
     routes its buckets take (a K8 bucket one launch a pipeline group), and
     the kernels' launches are the sum of those calls'): ``align-matrix``
     (auto) on 128 seeded random genomes of 300-8,000 bp (8,256 pairs, every
     bucket on K7 or K8; each K8 launch timed by CUDA events) and
     ``allpairs_scores`` local (auto: K7): 128 sampled pairs a mode, auto's
     and K3's (``engine="stream"``) scores, == the C++ oracle, and auto ==
     K3 on every pair; auto against K3 end to end (``allpairs_scores``
     walls)
 25  K9 at size: phase 4's 29,903 x 29,892 bp pair through ``score_pairs``
     (auto at B = 1: "pallas") == the C++ oracle and K1;
     ``align-matrix --engine pallas`` on the 10 x 29.9 kb corpus == phase
     8's TSV; phase 17's 1,078,175 bp planted pair == its closed form;
     then, off the path, K9 and K3 == the C++ oracle on the 29.9 kb pair
     (global/local), K9 also at strips of 128, 256 and 512 rows on the
     whole grid and on 7 blocks, and each timed at B = 1
 26  ``reads -a global|local --engine segmented|stream8|pallas`` on phase
     10's 16,384 x 152 bp batch == ``--engine auto``'s TSV (K6); the path's
     launches by route, no plain version; then each route (K7, K9: the
     strips of 256 rows; K8: K3's plain version) == its plain version at the
     path's shapes: the
     16,384 x 152 bp batch, phase 24's largest bucket and the 29.9 kb pair,
     both cut to their first 300 rows (two strips, every column); kernel
     and plain times there, and K7/K8/K3 on the whole bucket (K7 five
     readings, with their share of its bound)
 27  K5 (the tile fill: K1's kernel at a column offset, with the right
     column out) == its plain version ``tile_fill`` on the card, global and
     local: bottom, right, best and the (m, n) value of an interior tile
     and of the tile holding (m, n) of the P = 4 pipeline over phase 4's
     29,903 x 29,892 bp pair (boundaries captured by
     ``sharded_fill_checkpoints``), and of a tile wholly past n; each also
     at 128 rows a strip on one block and 512 rows on two
 28  the main path of this slice from here to phase 30 (launch counters
     reset just before it): ``sharded_gotoh_score`` on that pair at P in
     {1, 2, 4, 8} shards of the one card, C = P column blocks, global and
     local: == the C++ oracle (global also == K1's score), P * C K5
     launches a call, walls (median of 3 after a first call)
 29  ``align_sharded`` at P = 4 == ``PairwiseAligner.align`` (moves, stats,
     rendered bytes), global and local; ``batched_sharded_scores`` on a
     (data 2 x seq 2) mesh of the card over 4 pairs of bench.py's 29.9 kb
     corpus == K3; ``allpairs_hybrid`` over three of those genomes cut to
     5,000 bp and one whole, with the long self-pair split, ==
     ``allpairs_scores``
 30  ``gotoh_scores_blocked`` (K16: K9's pipeline at R = 4096, strips of
     512 rows) on 4 planted copies of a random 155,000 bp genome: global
     == the planted optima, local == K9 at its own strips; the path
     launched K5, K16, K1 and K2 and no plain version
 31  K16 == its plain version (strips of 4,096 rows, on the host) on the
     batch's first 300 rows, global and local, also at 64-row strips on 3
     blocks; K16 there and on the whole
     batch, K5 on the interior tile, and one tile alone at each P against
     the phase 28 walls (times: CUDA events, median of 3)
 32  the suffix array and BWT on the card (torch ops, no hand-written
     kernel): ``suffix_array`` of a seeded 1,078,175 bp genome (phase 13's)
     == native SA-IS on the host over every entry, also on four contigs
     joined by '#' and on edge texts ("", "A", "AAAAAAAA", "ACGT" x 50);
     ``bwt_device`` == the SA-IS BWT; ``FMIndex.build(host=False)`` ==
     ``build(host=True)`` field by field; times of the device suffix array,
     SA-IS and both builds
 33  the FM-index search at size (counters reset just before it):
     ``search_batch`` on the card over bench.py's fmindex_chr12 recipe
     (100,000 patterns of 20-40 bp from default_rng(1)) plus patterns with
     absent bytes, '$', '#' and empty ones == the host loop (counts and
     (lo, hi)), every sampled pattern found, one device search and no host
     range, the Occ table on the card; ``MultiFMIndex`` over 4 contigs ==
     the host path (``locate_range``); the CLI ``search --locate`` on
     10,000 reads, ``--engine device`` TSV == ``--engine host``; the
     search's wall (median of 3 after a warm call) and patterns/s
 34  ``suffixtree --stats --suffix-links`` on a seeded 29,903 bp genome:
     ``BWT_out`` == ``bwt_device`` on the card; ``compare --threads 4`` on
     the phase 6 corpus: its TSV == ``compare_all_pairs``, and pair 0-1 cut
     to 2,000 bp: native == the Python oracle; walls
 35  the scan engines (the JAX package's oracle, torch ops on the card, no
     kernel launched): ``align --engine scan`` on a 2,000 x 2,100 bp pair
     global and local (score and start == the C++ oracle, path == the
     kernel route's, CLI stdout == ``--engine auto``'s); ``batch_scores``
     on one bucket of 64 x 1,024 bp, global and local, == the oracle and
     ``score_pairs`` auto; ``align_reads(engine="scan")`` on 4,096 reads of
     128 bp against 256 bp windows in pipelined rounds == ``engine="auto"``
     (K6) and, sampled, the oracle; the matrix scan on 256 x 383 aa under
     BLOSUM62 == the kernel route and the oracle; the sequence-parallel
     scan at P = 2 shards of the card on a 2 kb pair == K5's and the
     oracle; the wall of each beside its kernel route's
 36  device seeding at the map recipe's size: 100,000 x 128 bp reads, both
     strands, against a seeded 1,078,175 bp genome at k = 15: the device
     vote's five arrays == the host vote's; ``map -k 15 --seed-engine
     device`` SAM == ``--seed-engine host``; seeding walls of both engines,
     ``map``'s walls and device-busy shares (``torch.profiler``)
 37  ``entry()`` (the 256 bp global scan step) on the card == its CPU run;
     ``dryrun_multichip(1)`` on the card

Bounds count interior DP cells (m x n per pair), band cells (rows x
lanes), for a walk the code words its path must read, and for the
profile the bytes it reads and writes.

The second-to-last line is a JSON summary of the kernels (K1–K4, K6,
``walk_rows16``, K10–K12, K13–K15, K7–K9, K5 and K16, with each one's
launches on its own path, bound and times; phases 32–37 add none); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TEST_SCORES = (1, -2, -2, -5)
#: bench.py's synthetic all-pairs corpus (config 4 scale): 10 genomes of
#: 29,900 bp from default_rng(0); 55 pairs i <= j, 45 alignments i < j.
N_GENOMES, GENOME_LEN = 10, 29_900
#: genomes of the local-mode K3 comparison (10 pairs).
LOCAL_SUBSET = 4
#: K3's compiled strip heights (32 x RT rows), each held against the plain
#: version in phase 6 (the matrix fill's in phase 20).
K3_ROWS = (32, 64, 128, 256, 512)
#: the mixed-length CLI corpus: MIXED_N genomes of MIXED_MIN..MIXED_MAX bp.
MIXED_N, MIXED_MIN, MIXED_MAX = 12, 1_000, 5_000
#: The read workloads at the sizes of bench.py's read rows: the
#: short-read batch (16,384 pairs of 152 bp, padded to 256), ``map`` of
#: 100,000 x 128 bp reads (window 128 + 4 x 32 = 256 bytes, so K6) and
#: ``call`` on 100,000 x 150 bp reads (window 278, so K3 + K4) with 50
#: planted SNPs, on a random genome of chr12.fasta's length.
SR_B, SR_LEN, SR_PAD = 16_384, 152, 256
GENOME_BP = 1_078_175
MAP_N, MAP_LEN, PAIRS_N = 100_000, 128, 10_000
CALL_N, CALL_LEN, CALL_SNPS = 100_000, 150, 50

#: The banded path at the sizes of the JAX bench rows chr12_banded_align (a
#: 1,078,175 bp pair at band 2048; here GENOME_BP bp from a seed and its
#: planted copy) and banded_batch (16 planted copies of a 29,903 bp genome
#: at W = 2048). WIDE_FILLS: phase 15's one fill at each width that had its
#: own compiled form before the warp-strip sweep (one kernel for every V
#: since), (V, m, n): 16 lanes a thread (V = 8192), 32 lanes at 512 and
#: 1,024 threads, and the wide form (row state in device memory) on a band
#: that slides and on one cut to n = 33,100 lanes.
BAND, BATCH_B, BATCH_LEN = 2048, 16, 29_903
WIDE_FILLS = ((8_192, 8_600, 8_500), (16_384, 17_000, 16_900), (32_768, 33_100, 33_000),
              (33_792, 34_100, 34_000), (34_816, 33_500, 33_100))
#: rows of the 1 Mb window over which phase 17 holds K10's codes against
#: the plain fill.
PREFIX_ROWS = 32_768
#: device memory rate, H100 SXM (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
#: ns of one dependent shared-memory load on this card (the staged walks'
#: chain floor, a move each), measured in phase 1 with tools/smem_chase.cu.
CHAIN_NS: float | None = None
#: integer ops per DP cell, counted from the recurrence in
#: csrc/gotoh_rowblock.cu and csrc/gotoh_stream.cu: I 3 (two adds, max),
#: S 3 (compare, select, add), Q 1, M 1, A 3 (two adds, max), P 1; local
#: adds three zero floors and the argmax update (compare, three selects);
#: dirs adds the code chain (three compares, three selects) and its
#: packing (shift, or, flush test).
OPS_PER_CELL = {"global": 12, "local": 19, "dirs": 9}
#: strip heights (threads a block) at which phases 2 and 5 hold and time K1.
STRIP_ROWS = (128, 256, 512)
#: integer ops per move of a walk (csrc/traceback_walk.cu): bounds test 4,
#: decode 3, two saturating steps 4, stop/origin tests 2, packing 3.
OPS_PER_MOVE = 16
#: integer ops per band cell that the banded recurrence needs (not the
#: kernel's lane shifts or scan fix-up): sub 2, S 1, P 1, seed 1, the I
#: step 2 (add, max), the cell max 1, the code chain 6 (three compares,
#: three selects), packing 3, A 4 (two adds, two maxes).
OPS_PER_BAND_CELL = 21


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        fail("nvidia-smi not found: this machine has no NVIDIA GPU stack")
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def mutate(rng, s: str, snp: float, n_indels: int) -> str:
    """~snp substitutions per base plus n_indels short indels."""
    b = np.frombuffer(s.encode(), np.uint8).copy()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    hit = np.nonzero(rng.random(b.size) < snp)[0]
    idx = np.searchsorted(acgt, b[hit])
    b[hit] = acgt[(idx + rng.integers(1, 4, hit.size)) % 4]
    out = b.tobytes().decode()
    for _ in range(n_indels):
        p = int(rng.integers(0, len(out) - 20))
        L = int(rng.integers(1, 12))
        if rng.random() < 0.5:
            out = out[:p] + out[p + L :]
        else:
            out = out[:p] + "".join(rng.choice(list("ACGT"), L)) + out[p:]
    return out


def random_dna(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), n))


def planted_copy(rng, genome: str, sc, every: int = 400) -> tuple[str, int]:
    """A copy of ``genome`` with one planted event every ``every`` bp: a SNP
    to another base (1/4 of events), a 1-3 bp deletion (1/2) or a 1-3 bp
    insertion of random bases (1/4). Returns ``(copy, score)``: the global
    score of the planted alignment of ``genome`` (first) with the copy,
    ``(m - snps - deleted) s_match + snps s_mismatch + sum(h + L g)``,
    which is the optimum for events this sparse in random sequence
    (tests/test_torch_banded.py holds it against the C++ full DP)."""
    g = np.frombuffer(genome.encode(), np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pos = np.arange(every, g.size - every, every)
    kind = rng.choice(3, pos.size, p=[0.25, 0.5, 0.25])  # SNP, deletion, insertion
    lens = rng.integers(1, 4, pos.size)
    parts, prev, snps, deleted, gaps = [], 0, 0, 0, 0
    for p, k, L in zip(pos, kind, lens):
        parts.append(g[prev:p])
        if k == 0:
            parts.append(acgt[(np.searchsorted(acgt, g[p]) + rng.integers(1, 4, 1)) % 4])
            prev, snps = p + 1, snps + 1
        elif k == 1:
            prev, deleted, gaps = p + L, deleted + L, gaps + sc.h + L * sc.g
        else:
            parts.append(acgt[rng.integers(0, 4, L)])
            prev, gaps = p, gaps + sc.h + L * sc.g
    parts.append(g[prev:])
    score = (g.size - snps - deleted) * sc.s_match + snps * sc.s_mismatch + gaps
    return np.concatenate(parts).tobytes().decode(), int(score)


def words_read(moves, counts, si, sj, layout: str) -> int:
    """4-byte code words a batch of walks must read, counted from their
    paths (the least traffic a walk can make). ``moves`` (B, T) in
    traceback order from ``(si, sj)``; ``counts`` live moves per walk. A
    walk is monotone in i and j, so the cells it takes moves at that share
    a word are consecutive: each run of them reads the word once.
    ``"rows16"`` words are (i - 1, (j - 1) // 16) over interior cells (the
    boundary codes are synthesized), ``"diag16"`` words ((i + j) // 16, i)
    over every cell."""
    from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_SUB

    moves = np.asarray(moves)
    live = np.arange(moves.shape[1])[None, :] < np.asarray(counts)[:, None]
    di = (live & ((moves == DIR_SUB) | (moves == DIR_DEL))).astype(np.int64)
    dj = (live & ((moves == DIR_SUB) | (moves == DIR_INS))).astype(np.int64)
    i_at = np.asarray(si, np.int64)[:, None] - np.cumsum(di, 1) + di
    j_at = np.asarray(sj, np.int64)[:, None] - np.cumsum(dj, 1) + dj
    if layout == "rows16":
        word = np.where((i_at > 0) & (j_at > 0), (i_at - 1) * (1 << 24) + (j_at - 1) // 16, -1)
    else:
        word = (i_at + j_at) // 16 * (1 << 24) + i_at
    first = np.ones_like(live)
    first[:, 1:] = word[:, 1:] != word[:, :-1]
    return int((live & first & (word >= 0)).sum())


def chain_floor(moves: float) -> str:
    """``moves`` x one dependent shared-memory load, in ms."""
    return "not measured" if CHAIN_NS is None else f"{moves * CHAIN_NS * 1e-6:.4f} ms"


def k11_alone(torch, gb, dirs, ms, ns, V, geom, cuda_ms) -> list[float]:
    """CUDA-event ms of one K11 launch alone (the C launcher on tensors made
    beforehand) carrying the walks of ``dirs`` (B, KW, V) from ``(ms, ns)``
    whole, under the window geometry ``geom``."""
    from genomics_rs_tpu_torch.ops import _build
    from genomics_rs_tpu_torch.ops.walk_stage import slide_words

    B, KW, _ = dirs.shape
    ms, ns = np.asarray(ms, np.int64), np.asarray(ns, np.int64)
    off, deltas, _ = gb.plan_streams(*geom, V)
    slides = torch.from_numpy(slide_words(deltas, geom[0])).to(dirs.device)
    cap = gb.whole_walk_steps(ms, ns)
    nw = -(-cap // 16)
    starts = torch.from_numpy(np.stack([ms, ns, off[ms - 1], np.arange(B) * KW], 1)
                              .astype(np.int32)).to(dirs.device)
    words = torch.empty((B, nw), dtype=torch.int32, device=dirs.device)
    meta = torch.empty((B, 6), dtype=torch.int32, device=dirs.device)
    lib, stream = _build.library(), _build.stream_handle(dirs.device)
    return cuda_ms(lambda: _build.check(lib.walk_banded_launch(
        _build.ptr(dirs), _build.ptr(slides), _build.ptr(starts), _build.ptr(words),
        _build.ptr(meta), B, KW, V, B * KW, int(deltas.size), nw, cap, stream), "walk_banded"), 3)


def same_walks(got, want) -> bool:
    return all(np.array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))
               for a, b in zip(got, want))


def k4_alone(torch, tw, flat, wargs, cuda_ms) -> list[float]:
    """CUDA-event ms of one K4 launch alone (the C launcher on tensors made
    beforehand) carrying ``walk_many``'s walks ``wargs`` over ``flat``."""
    from genomics_rs_tpu_torch.ops import _build

    si, sj, koffs, KW, max_steps = wargs
    W = len(si)
    KWT, V = flat.shape
    nw = -(-max_steps // tw.MPW)
    starts = torch.from_numpy(np.stack([np.asarray(si, np.int64), np.asarray(sj, np.int64),
                                        np.asarray(koffs, np.int64), np.zeros(W, np.int64)], 1)
                              .astype(np.int32)).to(flat.device)
    words = torch.zeros((W, nw), dtype=torch.int32, device=flat.device)
    meta = torch.empty((W, 5), dtype=torch.int32, device=flat.device)
    lib, stream = _build.library(), _build.stream_handle(flat.device)
    return cuda_ms(lambda: _build.check(lib.walk_many_launch(
        _build.ptr(flat), _build.ptr(starts), _build.ptr(words), _build.ptr(meta), W, KW, KWT,
        V, nw, max_steps, stream), "walk_many"), 3)


def int32_ops_per_s(torch) -> float:
    """Peak int32 rate: SMs x 64 INT32 lanes per SM (Hopper) x the
    card's maximum SM clock as ``nvidia-smi`` reports it."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    mhz = float(proc.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 64 * mhz * 1e6


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over the memory rate vs integer
    ops over the int32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, prof) -> dict[str, float]:
    """Device milliseconds by kernel name from a ``torch.profiler`` run."""
    out = {}
    for e in prof.key_averages():
        if str(e.device_type) != str(torch.autograd.DeviceType.CUDA):
            continue  # a host op: its kernels are listed on their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = us / 1e3
    return out


def corpus_genomes() -> list[tuple[str, str]]:
    """bench.py's synthetic corpus (copied, not imported)."""
    rng = np.random.default_rng(0)
    return [(f"s{k}", "".join(rng.choice(list("ACGT"), GENOME_LEN)))
            for k in range(N_GENOMES)]


def write_fasta_dir(path: str, genomes) -> None:
    os.makedirs(path)
    for k, (name, s) in enumerate(genomes):
        with open(os.path.join(path, f"g{k:02d}.fasta"), "w") as f:
            f.write(f">{name}\n{s}\n")


def align_matrix_phases(torch, dev, card, sc, cuda_ms, codes_at, rate):
    """Phases 6-9: the ``align-matrix`` path (K3 and K4). Returns the two
    kernels' rows of the summary line and phase 8's TSV text."""
    from genomics_rs_tpu_torch import cli, native
    from genomics_rs_tpu_torch.comparison.driver import load_fasta_dir
    from genomics_rs_tpu_torch.models.aligner import (
        PairwiseAligner,
        _stream_group_pairs,
        align_batch,
    )
    from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
    from genomics_rs_tpu_torch.ops import gotoh_stream as gs
    from genomics_rs_tpu_torch.ops import traceback_batch as tb
    from genomics_rs_tpu_torch.ops import traceback_device as td
    from genomics_rs_tpu_torch.ops import traceback_walker as tw
    from walk_stage_cases import diag_edge_walks
    from genomics_rs_tpu_torch.config import Scores
    from genomics_rs_tpu_torch.parallel.allpairs import allpairs_scores, bucketize_pairs
    from genomics_rs_tpu_torch.sequence import (
        PAD_S1,
        PAD_S2,
        Sequence,
        SequenceContainer,
        round_up,
    )

    counted = (rb, gs, td, tw, tb)

    def reset_counts():
        for mod in counted:
            for key in mod.COUNTS:
                mod.COUNTS[key] = 0

    def plain_calls() -> int:
        return (rb.COUNTS["plain"] + gs.COUNTS["plain"] + td.COUNTS["plain"]
                + tw.COUNTS["many_plain"] + tb.COUNTS["plain"])

    def batch_of(pairs, Lm, Ln):
        """(s1, s2) uint8 (B, Lm), (B, Ln) on the card, ms, ns."""
        s1 = np.stack([Sequence("a", a).encoded(Lm, PAD_S1) for a, _ in pairs])
        s2 = np.stack([Sequence("b", b).encoded(Ln, PAD_S2) for _, b in pairs])
        ms = np.array([len(a) for a, _ in pairs])
        ns = np.array([len(b) for _, b in pairs])
        return torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev), ms, ns

    def stream_err(got, want, ms, ns) -> int:
        """Max |difference| of scores and start cells, and of the codes
        at every true cell when both fills have dirs."""
        errs = [int((g.long() - w.long()).abs().max()) for g, w in zip(got[:3], want[:3])]
        if want.dirs is not None:
            for p in range(len(ms)):
                d = (codes_at(got.dirs[p], int(ms[p]), int(ns[p]))
                     - codes_at(want.dirs[p], int(ms[p]), int(ns[p])))
                errs.append(int(d.abs().max()))
        return max(errs)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def cells(ms, ns) -> float:
        """Interior DP cells, m x n per pair (row 0 and column 0 are closed
        forms, not recurrence cells)."""
        return float(np.sum(np.asarray(ms, np.float64) * np.asarray(ns, np.float64)))

    def seq_bytes(ms, ns) -> float:
        """Each pair's true characters, read once."""
        return float(np.sum(np.asarray(ms, np.float64) + np.asarray(ns, np.float64)))

    # ---- phase 6: K3 kernel vs plain ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    base = random_dna(rng, 700)
    small = [(base[:600], mutate(rng, base[20:560], 0.05, 3)),
             (base[100:500], mutate(rng, base[:600], 0.05, 3)),
             ("", base[:30]), (base[:17], "")]
    k3_err, n_small = 0, 0
    for is_local in (False, True):
        for st in (None, -1):
            sck = Scores(2, -3, -2, -4, st)
            for group in (small, small[:1]):
                args = batch_of(group, 640, 640)
                want = gs.gotoh_stream_plain(*args, sck, is_local, emit_dirs=True)
                # The path's strip height, then every compiled one on 3
                # blocks (multi-strip pairs; tickets and ring slots cycle).
                runs = [gs.gotoh_stream_fill(*args, sck, is_local, emit_dirs=True)]
                runs += [gs._stream_cuda(*args, sck, is_local, True, r, 3) for r in K3_ROWS]
                for rows, got in zip((None,) + K3_ROWS, runs):
                    err = max(stream_err(got, want, args[2], args[3]), int(got.err))
                    k3_err = max(k3_err, err)
                    n_small += 1
                    check(err == 0, f"K3 kernel != plain (B={len(group)}, local={is_local}, "
                                    f"st={st}, rows={rows}): max |err| {err}")

    genomes = corpus_genomes()
    seqs = [Sequence(n, s) for n, s in genomes]
    N = len(seqs)
    Lc = round_up(GENOME_LEN, 128)
    all_pairs = [(i, j) for j in range(N) for i in range(N) if i <= j]
    corpus = batch_of([(seqs[i].sequence, seqs[j].sequence) for i, j in all_pairs], Lc, Lc)
    glob, _ = timed(lambda: gs.gotoh_stream_fill(*corpus, sc, False))
    want, k3_plain_ms = timed(lambda: gs.gotoh_stream_plain(*corpus, sc, False))
    err = stream_err(glob, want, corpus[2], corpus[3])
    k3_err = max(k3_err, err)
    check(err == 0, f"K3 kernel != plain on the {len(all_pairs)}-pair corpus: max |err| {err}")
    sub_pairs = [(i, j) for i, j in all_pairs if j < LOCAL_SUBSET]
    subset = batch_of([(seqs[i].sequence, seqs[j].sequence) for i, j in sub_pairs], Lc, Lc)
    loc = gs.gotoh_stream_fill(*subset, sc, True)
    want, k3_plain_local_ms = timed(lambda: gs.gotoh_stream_plain(*subset, sc, True))
    err = stream_err(loc, want, subset[2], subset[3])
    k3_err = max(k3_err, err)
    check(err == 0, f"K3 local kernel != plain on {len(sub_pairs)} pairs: max |err| {err}")
    del want
    print(f"[phase 6] K3 kernel == plain on {n_small} small fills (640 x 640 bucket, "
          f"global/local, classic/kimura, B = 1, empty sequences, dirs at every true "
          f"cell; the path's strip height and strips of {', '.join(map(str, K3_ROWS))} rows "
          f"on 3 blocks), the {len(all_pairs)}-pair {N} x {GENOME_LEN} bp corpus global "
          f"(plain {k3_plain_ms:.0f} ms) and {len(sub_pairs)} pairs local (plain "
          f"{k3_plain_local_ms:.0f} ms); max |err| {k3_err} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 7: allpairs_scores on the card, against the C++ oracle ----
    t_phase = time.perf_counter()
    container = SequenceContainer(list(seqs))
    reset_counts()
    t0 = time.perf_counter()
    ap_g = allpairs_scores(container, sc, device="cuda")
    t_ap_g = time.perf_counter() - t0
    ap_launches, ap_plain = gs.COUNTS["kernel"], plain_calls()
    t0 = time.perf_counter()
    ap_l = allpairs_scores(container, sc, is_local=True, device="cuda")
    t_ap_l = time.perf_counter() - t0
    check(ap_launches == 1 and ap_plain == 0,
          f"allpairs_scores: K3 launches {ap_launches}, plain calls {ap_plain}")
    glob_scores = glob.score.cpu().numpy()
    for k, (i, j) in enumerate(all_pairs):
        check(ap_g.matrix[j, i] == int(glob_scores[k]),
              f"allpairs_scores != the phase-6 K3 fill at ({i}, {j})")
    checks = [((0, 1), False), ((2, 3), False), ((8 % N, 9 % N), False),
              ((0, 1), True), ((1, 3), True), ((2, 3), True)]
    with ThreadPoolExecutor(len(checks)) as pool:  # ctypes drops the GIL
        oracle = list(pool.map(
            lambda c: native.gotoh_score_cpu(seqs[c[0][0]].sequence,
                                             seqs[c[0][1]].sequence, sc, c[1]),
            checks))
    for ((i, j), is_local), o in zip(checks, oracle):
        got = ap_l.matrix[j, i] if is_local else ap_g.matrix[j, i]
        if is_local:
            k = sub_pairs.index((i, j))
            start = (int(loc.start_i[k]), int(loc.start_j[k]))
        else:
            start = (len(seqs[i]), len(seqs[j]))
        check((int(got),) + start == o,
              f"pair ({i}, {j}) local={is_local}: port {(int(got),) + start} != oracle {o}")
    print(f"[phase 7] allpairs_scores on cuda: {len(all_pairs)} pairs global "
          f"({t_ap_g:.3f} s, {ap_g.cells_per_s:.4g} cells/s) and local ({t_ap_l:.3f} s); "
          f"{len(checks)} scores and start cells == C++ oracle; K3 launches {ap_launches}, "
          f"plain calls {ap_plain} ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 8: align-matrix --alignments-out through the CLI ----
    t_phase = time.perf_counter()
    os.environ["LOG_LEVEL"] = "WARNING"
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "config.toml")
        with open(cfg, "w") as f:
            f.write(f"[scores]\ns_match = {sc.s_match}\ns_mismatch = {sc.s_mismatch}\n"
                    f"g = {sc.g}\nh = {sc.h}\n")
        cdir, adir, tsv = (os.path.join(tmp, x) for x in ("corpus", "aln", "scores.tsv"))
        write_fasta_dir(cdir, genomes)
        reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-c", cfg, "align-matrix", "-f", cdir, "-o", tsv,
                           "--alignments-out", adir])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        main_launches = {"gotoh_stream": gs.COUNTS["kernel"],
                         "walk_many": tw.COUNTS["many_kernel"],
                         "gotoh_rowblock": rb.COUNTS["kernel"],
                         "traceback_walk": tw.COUNTS["kernel"]}
        main_plain = plain_calls()
        check(rc == 0, f"align-matrix exited {rc}")
        check(main_launches["gotoh_stream"] > 0 and main_launches["walk_many"] > 0,
              f"align-matrix did not launch K3 and K4: {main_launches}")
        check(main_plain == 0, f"align-matrix ran a plain version {main_plain} times")
        idx = [(i, j) for j in range(N) for i in range(N) if i < j]
        check(len(os.listdir(adir)) == len(idx), "align-matrix wrote the wrong number of files")
        with open(tsv) as f:
            rows_tsv = [ln.split("\t") for ln in f.read().splitlines()[1:]]
        check(all(int(rows_tsv[j][1 + i]) == ap_g.matrix[j, i] for i, j in all_pairs),
              "align-matrix TSV != allpairs_scores")
        with open(tsv) as f:
            corpus_tsv = f.read()  # phase 25 holds K9's align-matrix to it

        # One group of the run, replayed: K3 dirs == plain, K4 == plain.
        max_steps = round_up(2 * Lc + 1, 8192)
        group = idx[: _stream_group_pairs(Lc, Lc, max_steps)]  # the run's first group
        G = len(group)
        gargs = batch_of([(seqs[i].sequence, seqs[j].sequence) for i, j in group], Lc, Lc)
        dfill = gs.gotoh_stream_fill(*gargs, sc, False, emit_dirs=True)
        want, k3_plain_dirs_ms = timed(
            lambda: gs.gotoh_stream_plain(*gargs, sc, False, emit_dirs=True))
        err = stream_err(dfill, want, gargs[2], gargs[3])
        k3_err = max(k3_err, err)
        check(err == 0, f"K3 dirs kernel != plain on a group of {G}: max |err| {err}")
        del want
        KW = dfill.dirs.shape[1]
        flat = dfill.dirs.view(G * KW, -1)
        wargs = (dfill.start_i.cpu().numpy(), dfill.start_j.cpu().numpy(),
                 np.arange(G) * KW, KW, max_steps)
        walked = tw.walk_many(flat, *wargs)
        host = flat.cpu()
        t0 = time.perf_counter()
        want = tw.walk_many_plain(host, *wargs)
        k4_plain_ms = (time.perf_counter() - t0) * 1e3
        del host
        k4_err = 0 if all(np.array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))
                          for a, b in zip(walked, want)) else 1
        check(k4_err == 0 and all(walked[4]), "K4 kernel != plain on the group's walks")
        k4_moves = int(np.sum(walked[1]))
        # K4 on the edge paths (word-row boundaries, a stop cell, lane
        # offsets, 300-move gaps, li held at 0).
        for name, edirs, *eargs in diag_edge_walks():
            got = tw.walk_many(edirs.to(dev), *eargs[:5], eargs[5])
            check(same_walks(got, tw.walk_many_plain(edirs, *eargs[:5], eargs[5])),
                  f"K4 != plain on the edge path {name!r}")
        k4_words = words_read(tb._unpack(walked[0], np.asarray(walked[1], np.int64), max_steps),
                              walked[1], wargs[0], wargs[1], "diag16")

        # Three pairs against the per-pair aligner (slice 1's path).
        three = group[:3]
        batch_alns = align_batch([(seqs[i], seqs[j]) for i, j in three], sc, device="cuda")
        for (i, j), aln in zip(three, batch_alns):
            ref = PairwiseAligner(sc, device="cuda").align(seqs[i], seqs[j])
            check((aln.score, aln.alignment, aln.matches, aln.mismatches,
                   aln.opening_gaps, aln.gap_extensions)
                  == (ref.score, ref.alignment, ref.matches, ref.mismatches,
                      ref.opening_gaps, ref.gap_extensions),
                  f"align_batch != PairwiseAligner.align on pair ({i}, {j})")
            name, text = cli.pair_alignment_fasta(i, j, seqs[i], seqs[j], ref, False)
            with open(os.path.join(adir, name)) as f:
                check(f.read() == text, f"align-matrix file {name} != the per-pair aligner's")
        print(f"[phase 8] align-matrix --alignments-out on cuda: {len(idx)} alignments in "
              f"groups of {G} ({t_cli:.3f} s wall); launches {main_launches}, plain calls "
              f"{main_plain}; a group's K3 dirs fill == plain ({k3_plain_dirs_ms:.0f} ms plain) "
              f"and its {G} walks ({k4_moves} moves) K4 == plain (and on "
              f"{len(diag_edge_walks())} edge paths); {len(three)} pairs == "
              f"PairwiseAligner.align (moves, score, stats, file)", flush=True)

        # The same CLI run again under torch.profiler: device time by
        # kernel and the device's busy share of the wall.
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["-c", cfg, "align-matrix", "-f", cdir, "-o", tsv,
                          "--alignments-out", os.path.join(tmp, "aln2")])
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
        dev_ms = device_ms(torch, prof)
        top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:4]
        profile_line = (f"profiled align-matrix run: wall {t_prof:.3f} s, device time "
                        f"{sum(dev_ms.values()):.1f} ms (busy "
                        f"{sum(dev_ms.values()) / 10 / t_prof:.1f}%); "
                        + "; ".join(f"{k[:40]} {v:.1f} ms" for k, v in top))

        # A mixed-length corpus (several buckets), global and local.
        rng = np.random.default_rng(77)
        mbase = random_dna(rng, MIXED_MAX + 13 * MIXED_N)
        lens = rng.integers(MIXED_MIN, MIXED_MAX + 1, MIXED_N)
        mdir = os.path.join(tmp, "mixed")
        write_fasta_dir(mdir, [(f"m{k} len={L}", mutate(rng, mbase[13 * k : 13 * k + L], 0.02, 4))
                               for k, L in enumerate(lens)])
        mseqs = load_fasta_dir(mdir).sequences
        for is_local in (False, True):
            madir = os.path.join(tmp, f"mixed_aln_{int(is_local)}")
            mtsv = os.path.join(tmp, f"mixed_{int(is_local)}.tsv")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["-c", cfg, "align-matrix", "-a", "local" if is_local else "global",
                               "-f", mdir, "-o", mtsv, "--alignments-out", madir])
            check(rc == 0, f"align-matrix on the mixed corpus exited {rc}")
            with open(mtsv) as f:
                mrows = [ln.split("\t") for ln in f.read().splitlines()[1:]]
            aligner = PairwiseAligner(sc, is_local=is_local, device="cuda")
            for j in range(len(mseqs)):
                for i in range(j):
                    ref = aligner.align(mseqs[i], mseqs[j])
                    name, text = cli.pair_alignment_fasta(i, j, mseqs[i], mseqs[j], ref, is_local)
                    with open(os.path.join(madir, name)) as f:
                        check(f.read() == text and int(mrows[j][1 + i]) == ref.score,
                              f"mixed corpus pair ({i}, {j}) local={is_local} != per-pair aligner")
        n_buckets = len(bucketize_pairs([(i, j) for j in range(len(mseqs)) for i in range(j)],
                                        [len(s) for s in mseqs]))
    print(f"[phase 8] mixed corpus of {len(mseqs)} genomes ({min(lens)}-{max(lens)} bp, "
          f"{n_buckets} buckets) through align-matrix --alignments-out, global and local: "
          f"every pair's file "
          f"and score == PairwiseAligner.align ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # ---- phase 9: times ----
    fmt = lambda ts: ", ".join(f"{t:.3f}" for t in ts)  # noqa: E731
    k3_g = cuda_ms(lambda: gs.gotoh_stream_fill(*corpus, sc, False), 3)
    k3_l = cuda_ms(lambda: gs.gotoh_stream_fill(*corpus, sc, True), 3)
    k3_d = cuda_ms(lambda: gs.gotoh_stream_fill(*gargs, sc, False, emit_dirs=True), 3)
    k4 = cuda_ms(lambda: tw.walk_many(flat, *wargs), 3)
    k4_a = k4_alone(torch, tw, flat, wargs, cuda_ms)
    c_all, c_grp = cells(corpus[2], corpus[3]), cells(gargs[2], gargs[3])
    nb = len(all_pairs)
    k3_bytes = seq_bytes(corpus[2], corpus[3]) + nb * 20
    k3_bound = bound(k3_bytes, c_all * OPS_PER_CELL["global"], rate)
    k3_bound_l = bound(k3_bytes, c_all * OPS_PER_CELL["local"], rate)
    k3_bound_d = bound(seq_bytes(gargs[2], gargs[3]) + G * 20 + c_grp / 4,
                       c_grp * (OPS_PER_CELL["global"] + OPS_PER_CELL["dirs"]), rate)
    k4_bound = bound(4 * k4_words + k4_moves / 4 + 36 * G, OPS_PER_MOVE * k4_moves, rate)
    med = lambda ts: float(np.median(ts))  # noqa: E731
    print(f"[phase 9] card {card} | K3 {nb} pairs of {GENOME_LEN} bp ({c_all:.4g} cells): "
          f"global [{fmt(k3_g)}] ms = {c_all / med(k3_g) * 1e3:.4g} cells/s (plain "
          f"{k3_plain_ms:.1f} ms, bound {k3_bound[0]:.3f} ms by {k3_bound[1]}); local "
          f"[{fmt(k3_l)}] ms = {c_all / med(k3_l) * 1e3:.4g} cells/s (bound "
          f"{k3_bound_l[0]:.3f} ms; plain on {len(sub_pairs)} pairs "
          f"{k3_plain_local_ms:.1f} ms) | K3 dirs group of {G}: [{fmt(k3_d)}] ms (plain "
          f"{k3_plain_dirs_ms:.1f} ms, bound {k3_bound_d[0]:.3f} ms by {k3_bound_d[1]}) | "
          f"K4 {G} walks, {k4_moves} moves reading {k4_words} words: [{fmt(k4)}] ms = "
          f"{med(k4) * 1e6 / max(k4_moves // G, 1):.1f} ns per move of one walk (plain "
          f"{k4_plain_ms:.1f} ms, bound {k4_bound[0]:.6f} ms by {k4_bound[1]}, chain floor "
          f"{chain_floor(k4_moves / G)}; alone [{fmt(k4_a)}] ms = "
          f"{med(k4_a) * 1e6 / max(k4_moves // G, 1):.1f} ns per move of one walk) "
          f"| wall: "
          f"allpairs_scores global {t_ap_g:.3f} s, local {t_ap_l:.3f} s; align-matrix "
          f"--alignments-out {t_cli:.3f} s | {profile_line}", flush=True)
    return [
        {"name": "gotoh_stream", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_stream.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_stream.py:505",
         "launches": main_launches["gotoh_stream"], "max_abs_err": float(k3_err),
         "ms": med(k3_g), "plain_ms": float(k3_plain_ms),
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None},
        {"name": "walk_many", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/traceback_walk.cu",
         "replaces": "genomics_rs_tpu/ops/traceback_pallas.py:397",
         "launches": main_launches["walk_many"], "max_abs_err": float(k4_err),
         "ms": med(k4), "plain_ms": float(k4_plain_ms),
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None},
    ], corpus_tsv


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def sam_rows(path: str) -> list[list[str]]:
    with open(path) as f:
        return [ln.split("\t") for ln in f.read().splitlines() if not ln.startswith("@")]


def read_phases(torch, dev, card, sc, cuda_ms, rate) -> list[dict]:
    """Phases 10-14: the read workloads (``reads``, ``map``, ``call``) on
    K6 and ``walk_rows16``, and on K3 and K4 for windows over 256 bytes.
    Returns the two new kernels' rows of the summary line."""
    from genomics_rs_tpu_torch import cli, native
    from genomics_rs_tpu_torch.models import reads as rd
    from genomics_rs_tpu_torch.models.aligner import PairwiseAligner, stream_walk_group
    from genomics_rs_tpu_torch.models.mapper import KmerIndex, map_reads
    from genomics_rs_tpu_torch.ops import _build
    from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
    from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
    from genomics_rs_tpu_torch.ops import gotoh_stream as gs
    from genomics_rs_tpu_torch.ops import traceback_batch as tb
    from genomics_rs_tpu_torch.ops import traceback_device as td
    from genomics_rs_tpu_torch.ops import traceback_walker as tw
    from genomics_rs_tpu_torch.config import Scores
    from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, SequenceContainer

    counted = (rb, gs, td, tw, gsr, tb)

    def reset_counts():
        for mod in counted:
            for key in mod.COUNTS:
                mod.COUNTS[key] = 0

    def plain_calls() -> int:
        return sum(n for mod in counted for key, n in mod.COUNTS.items() if "plain" in key)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    acgt = np.frombuffer(b"ACGT", np.uint8)
    med = lambda ts: float(np.median(ts))  # noqa: E731
    fmt = lambda ts: ", ".join(f"{t:.3f}" for t in ts)  # noqa: E731

    def on_card(s1, s2, ms, ns):
        return (torch.from_numpy(np.ascontiguousarray(s1)).to(dev),
                torch.from_numpy(np.ascontiguousarray(s2)).to(dev),
                np.asarray(ms, np.int64), np.asarray(ns, np.int64))

    def k6_err(got, want, ms, ns) -> int:
        """Max |difference| of scores and start cells, and of the codes at
        every true cell (rows 1..m, columns 1..n) when both have codes."""
        errs = [int((g.long() - w.long()).abs().max()) for g, w in zip(got[:3], want[:3])]
        if len(want) == 4:
            B, L1, W = want[3].shape
            shifts = 2 * torch.arange(16, device=dev)
            ms_t = torch.as_tensor(ms, device=dev)[:, None, None]
            ns_t = torch.as_tensor(ns, device=dev)[:, None, None]
            rows = torch.arange(L1, device=dev)[None, :, None]
            cols = torch.arange(W * 16, device=dev)[None, None, :]
            for c0 in range(0, B, 512):
                g, w = (x[c0 : c0 + 512].long() for x in (got[3], want[3]))
                d = ((g[..., None] >> shifts) & 3) - ((w[..., None] >> shifts) & 3)
                live = (rows < ms_t[c0 : c0 + 512]) & (cols < ns_t[c0 : c0 + 512])
                errs.append(int((d.flatten(2).abs() * live).max()))
        return max(errs)

    def diag16_err(got, want, ms, ns, chunk=256) -> int:
        """Max |difference| of K3 scores and start cells, and of the diag16
        codes ``dirs[b, (i + j) // 16, i]`` at every true cell (0 <= i <= m,
        0 <= j <= n)."""
        errs = [int((g.long() - w.long()).abs().max()) for g, w in zip(got[:3], want[:3])]
        i = torch.arange(int(max(ms)) + 1, device=dev)[:, None]
        j = torch.arange(int(max(ns)) + 1, device=dev)[None, :]
        k = i + j
        ms_t = torch.as_tensor(np.asarray(ms), device=dev)[:, None, None]
        ns_t = torch.as_tensor(np.asarray(ns), device=dev)[:, None, None]
        for c0 in range(0, len(ms), chunk):
            g, w = (((x[c0 : c0 + chunk][:, k // 16, i].long()) >> (2 * (k % 16))) & 3
                    for x in (got.dirs, want.dirs))
            live = (i <= ms_t[c0 : c0 + chunk]) & (j <= ns_t[c0 : c0 + chunk])
            errs.append(int(((g - w).abs() * live).max()))
        return max(errs)

    def ragged_batch(rng, B, L1, L2, ties=False):
        """Reads and 10%-mutated copies, lengths 1..L, one pair filling the
        bucket; ``ties``: both sides repeat a unit of 1-4 bases, so local
        bests tie on many rows and columns."""
        ms, ns = rng.integers(1, L1 + 1, B), rng.integers(1, L2 + 1, B)
        ms[0], ns[0] = L1, L2
        s1 = np.full((B, L1), PAD_S1, np.uint8)
        s2 = np.full((B, L2), PAD_S2, np.uint8)
        for b in range(B):
            if ties:
                unit = acgt[rng.integers(0, 4, int(rng.integers(1, 5)))]
                s1[b, : ms[b]], s2[b, : ns[b]] = np.resize(unit, ms[b]), np.resize(unit, ns[b])
                continue
            s1[b, : ms[b]] = acgt[rng.integers(0, 4, ms[b])]
            k = min(ms[b], ns[b])
            s2[b, :k] = s1[b, :k]
            s2[b, k : ns[b]] = acgt[rng.integers(0, 4, ns[b] - k)]
            flip = np.nonzero(rng.random(k) < 0.1)[0]
            s2[b, flip] = acgt[rng.integers(0, 4, flip.size)]
        return on_card(s1, s2, ms, ns)

    def k6_every_group(args, sck, is_local, want) -> int:
        """K6 at the wrapper's group size and at each of ``GROUP_SIZES``,
        scores-only and with codes, against the plain version's ``want``
        (with codes); the largest |error|."""
        runs = [gsr.gotoh_scores_shortread(*args, sck, is_local, emit_dirs=True),
                gsr.gotoh_scores_shortread(*args, sck, is_local)]
        for G in gsr.GROUP_SIZES:
            runs += [gsr._shortread_cuda(*args, sck, is_local, True, G),
                     gsr._shortread_cuda(*args, sck, is_local, False, G)]
        return max(k6_err(r, want if len(r) == 4 else want[:3], args[2], args[3]) for r in runs)

    # ---- phase 10: K6 kernel vs plain ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(51)
    k6_max, n_fills = 0, 0
    # (L1, L2, ties): the contract's corners, the paths' shapes, rows that
    # end inside a lane (160 and 224 rows: G x RT = 160 or 256 rows at G = 8),
    # and tie-heavy local batches.
    for L1, L2, ties in ((256, 256, False), (32, 16, False), (128, 256, False),
                         (160, 160, False), (224, 48, False), (128, 256, True),
                         (160, 160, True)):
        args = ragged_batch(rng, 300, L1, L2, ties)
        for is_local in ((True,) if ties else (False, True)):
            for st in (None, -1):
                sck = Scores(2, -3, -2, -4, st)
                want = gsr.gotoh_shortread_plain(*args, sck, is_local, emit_dirs=True)
                err = k6_every_group(args, sck, is_local, want)
                k6_max = max(k6_max, err)
                n_fills += 1
                check(err == 0, f"K6 kernel != plain ({L1} x {L2} ragged{', ties' * ties}, "
                                f"local={is_local}, st={st}): max |err| {err}")

    # bench.py's short-read batch: unrelated 152 bp pairs from default_rng(5)
    rng = np.random.default_rng(5)
    s1r = np.full((SR_B, SR_PAD), PAD_S1, np.uint8)
    s2r = np.full((SR_B, SR_PAD), PAD_S2, np.uint8)
    s1r[:, :SR_LEN] = acgt[rng.integers(0, 4, (SR_B, SR_LEN))]
    s2r[:, :SR_LEN] = acgt[rng.integers(0, 4, (SR_B, SR_LEN))]
    sr = on_card(s1r, s2r, np.full(SR_B, SR_LEN), np.full(SR_B, SR_LEN))
    sr_scores, k6_plain_ms = {}, {}
    for is_local in (False, True):
        _, k6_plain_ms[is_local] = timed(lambda: gsr.gotoh_shortread_plain(*sr, sc, is_local))
        want = gsr.gotoh_shortread_plain(*sr, sc, is_local, emit_dirs=True)
        err = k6_every_group(sr, sc, is_local, want)
        k6_max = max(k6_max, err)
        check(err == 0, f"K6 kernel != plain on the {SR_B} x {SR_LEN} batch (local={is_local}): "
                        f"max |err| {err}")
        sr_scores[is_local] = gsr.gotoh_scores_shortread(*sr, sc, is_local)[0].cpu().numpy()
        del want

    # the map shape: 4,096 reads of 128 bp (1% SNPs) in 256 bp windows
    MB = 4096
    win = acgt[rng.integers(0, 4, (MB, 256))]
    s1m = win[:, 64:192].copy()
    hit = rng.random(s1m.shape) < 0.01
    s1m[hit] = acgt[rng.integers(0, 4, int(hit.sum()))]
    mp = on_card(s1m, win, np.full(MB, 128), np.full(MB, 256))
    fill_m = gsr.gotoh_scores_shortread(*mp, sc, True, emit_dirs=True)
    want, k6_plain_dirs_ms = timed(lambda: gsr.gotoh_shortread_plain(*mp, sc, True, emit_dirs=True))
    err = k6_every_group(mp, sc, True, want)
    k6_max = max(k6_max, err)
    check(err == 0, f"K6 dirs kernel != plain at the map shape: max |err| {err}")
    del want
    print(f"[phase 10] K6 kernel == plain on {n_fills} ragged fills (1-256 bp, global/local, "
          f"classic/kimura, tie-heavy local batches, rows ending inside a lane), the {SR_B} x "
          f"{SR_LEN} bp batch padded {SR_PAD} global and local and {MB} reads at the map shape "
          f"(128 x 256, local), each at the wrapper's group size and at G = "
          f"{', '.join(map(str, gsr.GROUP_SIZES))} lanes a pair, scores-only and with codes at "
          f"every true cell; max |err| {k6_max} ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # ---- phase 11: walk_rows16 kernel vs plain ----
    t_phase = time.perf_counter()
    sr4 = (sr[0][:MB], sr[1][:MB], sr[2][:MB], sr[3][:MB])
    fill_g = gsr.gotoh_scores_shortread(*sr4, sc, False, emit_dirs=True)
    walk_cases = (("map shape, local", fill_m, True, 128 + 256 + 1),
                  (f"{SR_LEN} bp batch, global", fill_g, False, 2 * SR_PAD + 1))
    walk_max, walk_plain_ms, walk_moves = 0, {}, {}
    for name, (_, si, sj, codes), is_local, max_steps in walk_cases:
        got = tb.walk_batch(codes, si, sj, sc, is_local, "rows16", max_steps)
        want, walk_plain_ms[name] = timed(lambda: tb.walk_batch_plain(
            codes, si.cpu().numpy(), sj.cpu().numpy(), sc, is_local, "rows16", max_steps))
        same = all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want))
        walk_max = max(walk_max, 0 if same else 1)
        check(same and all(got[4]), f"walk_rows16 != plain ({name})")
        if not is_local:
            check(not got[2].any() and not got[3].any(), "a global walk did not end at (0, 0)")
        walk_moves[name] = int(np.sum(got[1]))
        if is_local:
            wr_words = words_read(got[0], got[1], si.cpu().numpy(), sj.cpu().numpy(), "rows16")
    print(f"[phase 11] walk_rows16 kernel == plain on {MB} walks at the map shape (local, "
          f"{walk_moves[walk_cases[0][0]]} moves) and {sr4[2].size} of the {SR_LEN} bp batch (global, "
          f"{walk_moves[walk_cases[1][0]]} moves, all ending at (0, 0)); plain "
          + ", ".join(f"{k} {v:.0f} ms" for k, v in walk_plain_ms.items())
          + f" ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 12: align_reads on both routes vs oracle and per-pair aligner ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(61)
    routes = {"K6": (60, 240), "K3": (260, 420)}
    n_checked = 0
    for route, (lo, hi) in routes.items():
        qs, rs = [], []
        for k in range(24):
            r = random_dna(rng, int(rng.integers(lo, hi)))
            q = mutate(rng, r[int(rng.integers(0, 20)) :], 0.03, 1)[: hi - 10]
            qs.append(Sequence(f"q{k}", q))
            rs.append(Sequence(f"r{k}", r))
        for is_local in (False, True):
            reset_counts()
            aligned, cigars = rd.align_reads(qs, rs, sc, is_local=is_local, with_cigars=True,
                                             device="cuda")
            ran = ((gsr.COUNTS["kernel"], tb.COUNTS["kernel"]) if route == "K6"
                   else (gs.COUNTS["kernel"], tw.COUNTS["many_kernel"]))
            check(min(ran) > 0 and plain_calls() == 0,
                  f"align_reads {route} route: launches {ran}, plain calls {plain_calls()}")
            with ThreadPoolExecutor(8) as pool:  # ctypes drops the GIL
                oracle = list(pool.map(lambda qr: native.gotoh_score_cpu(
                    qr[0].sequence, qr[1].sequence, sc, is_local), zip(qs, rs)))
            aligner = PairwiseAligner(sc, is_local=is_local, device="cuda")
            for k, (a, cg, o) in enumerate(zip(aligned, cigars, oracle)):
                check((a.score,) + a.alignment[0][1:] == o,
                      f"align_reads {route} local={is_local} read {k}: "
                      f"{(a.score,) + a.alignment[0][1:]} != oracle {o}")
                ref = aligner.align(qs[k], rs[k])
                check((a.alignment, a.matches, a.mismatches, a.opening_gaps, a.gap_extensions)
                      == (ref.alignment, ref.matches, ref.mismatches, ref.opening_gaps,
                          ref.gap_extensions) and cg == rd.cigar(ref),
                      f"align_reads {route} local={is_local} read {k} != PairwiseAligner.align")
                n_checked += 1
    print(f"[phase 12] align_reads on cuda: {n_checked} reads over both routes (K6 + "
          f"walk_rows16 for 60-240 bp, K3 + K4 for 260-420 bp), global and local: scores and "
          f"start cells == C++ oracle, path, stats and CIGAR == PairwiseAligner.align "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 13: the read path's CLI at real size ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1207)
    genome = acgt[rng.integers(0, 4, GENOME_BP)].tobytes().decode()
    # map: 128 bp reads, 1% SNPs, a short indel in every fifth (cut from a
    # longer fragment so every read stays 128 bp), odd reads reversed
    map_pos = rng.integers(0, GENOME_BP - MAP_LEN - 12, MAP_N)
    map_reads_txt = []
    for i, p in enumerate(map_pos):
        frag = mutate(rng, genome[p : p + MAP_LEN + 12], 0.01, int(i % 5 == 0))[:MAP_LEN]
        map_reads_txt.append(revcomp(frag) if i % 2 else frag)
    # map -2: fragments of 300-500 bp, mate 1 forward, mate 2 reversed
    ins = rng.integers(300, 501, PAIRS_N)
    pair_pos = rng.integers(0, GENOME_BP - 501, PAIRS_N)
    mates = [(genome[p : p + MAP_LEN], revcomp(genome[p + n - MAP_LEN : p + n]))
             for p, n in zip(pair_pos, ins)]
    # call: bench.py's recipe (50 SNPs, 0.3% errors at q8, q38 elsewhere);
    # a random genome has no repeats, so every locus is callable
    truth_pos = np.sort(rng.choice(np.arange(500, GENOME_BP - 500), CALL_SNPS, replace=False))
    flip = {"A": "G", "C": "T", "G": "A", "T": "C"}
    donor = np.frombuffer(genome.encode(), np.uint8).copy()
    for p in truth_pos:
        donor[p] = ord(flip[chr(donor[p])])
    code4 = np.zeros(256, np.uint8)
    code4[acgt] = np.arange(4)
    starts = rng.integers(0, GENOME_BP - CALL_LEN, CALL_N)
    cwin = donor[starts[:, None] + np.arange(CALL_LEN)]
    errs = rng.random((CALL_N, CALL_LEN)) < 0.003
    bump = rng.integers(1, 4, (CALL_N, CALL_LEN))
    cwin = np.where(errs, acgt[(code4[cwin] + bump) % 4], cwin)
    quals = np.where(errs, np.uint8(33 + 8), np.uint8(33 + 38))
    truth = {(int(p) + 1, chr(donor[p])) for p in truth_pos}

    os.environ["LOG_LEVEL"] = "WARNING"
    with tempfile.TemporaryDirectory() as tmp:
        path = lambda name: os.path.join(tmp, name)  # noqa: E731
        with open(path("config.toml"), "w") as f:
            f.write(f"[scores]\ns_match = {sc.s_match}\ns_mismatch = {sc.s_mismatch}\n"
                    f"g = {sc.g}\nh = {sc.h}\n")
        with open(path("genome.fasta"), "w") as f:
            f.write(f">chr12s random {GENOME_BP} bp\n{genome}\n")
        for name, prefix, rows in (("q.fasta", "q", s1r), ("r.fasta", "r", s2r)):
            with open(path(name), "w") as f:
                f.writelines(f">{prefix}{i}\n{row[:SR_LEN].tobytes().decode()}\n"
                             for i, row in enumerate(rows))
        with open(path("map.fasta"), "w") as f:
            f.writelines(f">m{i}\n{s}\n" for i, s in enumerate(map_reads_txt))
        for k, name in enumerate(("p1.fasta", "p2.fasta")):
            with open(path(name), "w") as f:
                f.writelines(f">p{i}/{k + 1}\n{m[k]}\n" for i, m in enumerate(mates))
        with open(path("call.fastq"), "w") as f:
            for i in range(CALL_N):
                s, q = cwin[i].tobytes().decode(), quals[i].tobytes().decode()
                if i % 2:
                    s, q = revcomp(s), q[::-1]
                f.write(f"@c{i}\n{s}\n+\n{q}\n")
        t_data = time.perf_counter() - t_phase

        base = ["-c", path("config.toml")]
        runs = {
            "reads": ["reads", "-q", path("q.fasta"), "-r", path("r.fasta"), "-a", "global",
                      "-o", path("reads.tsv")],
            "reads --align": ["reads", "-q", path("q.fasta"), "-r", path("r.fasta"), "-a",
                              "global", "--align", "--format", "sam", "-o", path("reads.sam")],
            "map": ["map", "-q", path("map.fasta"), "-r", path("genome.fasta"),
                    "-o", path("map.sam")],
            "map -2": ["map", "-q", path("p1.fasta"), "-2", path("p2.fasta"), "-r",
                       path("genome.fasta"), "-o", path("pairs.sam")],
            "call": ["call", "-q", path("call.fastq"), "-r", path("genome.fasta"), "--weighted",
                     "--min-baseq", "13", "--min-mapq", "0", "--min-alt-conf", "0.8",
                     "--min-depth", "5", "--min-frac", "0.6", "-o", path("calls.vcf")],
        }
        walls, stdout = {}, {}
        # The inputs of the run's first K3 + K4 round (a round of `call`)
        # are kept, to hold both kernels against their plain versions at
        # that shape below; keeping them launches nothing.
        k3_rounds = []

        def record_round(*args):
            if not k3_rounds:
                k3_rounds.append(args)
            return stream_walk_group(*args)

        # Each K6 call of the path is timed by CUDA events around its
        # wrapper (the kernel, with the characters' encoding and the codes'
        # zeroing): launches x (time - bound) over the path's own shapes.
        k6_runs, k6_cuda = [], gsr._shortread_cuda

        def timed_k6(s1b, s2b, ms, ns, scores, is_local, emit_dirs=False, group=None):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = k6_cuda(s1b, s2b, ms, ns, scores, is_local, emit_dirs, group)
            e1.record()
            m, n = (np.asarray(x, np.float64) for x in (ms, ns))
            k6_runs.append((e0, e1, (len(m), s1b.shape[1], s2b.shape[1], bool(is_local),
                                     bool(emit_dirs)), float(np.sum(m * n)), float(np.sum(m + n))))
            return out

        rd.stream_walk_group, gsr._shortread_cuda = record_round, timed_k6
        try:
            reset_counts()
            for name, argv in runs.items():
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = cli.main(base + argv)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
                stdout[name] = out.getvalue()
                check(rc == 0, f"CLI {name} exited {rc}")
        finally:
            rd.stream_walk_group, gsr._shortread_cuda = stream_walk_group, k6_cuda
        check(len(k6_runs) == gsr.COUNTS["kernel"],
              f"recorded {len(k6_runs)} K6 calls, the path launched {gsr.COUNTS['kernel']}")
        k6_shapes: dict = {}  # (B, L1, L2, local, codes) -> [launches, ms, bound ms]
        for e0, e1, shape, cells_k, chars_k in k6_runs:
            mode = "local" if shape[3] else "global"
            b_k = bound(chars_k + 12.0 * shape[0] + (cells_k / 4 if shape[4] else 0.0),
                        cells_k * (OPS_PER_CELL[mode] + (OPS_PER_CELL["dirs"] if shape[4] else 0)),
                        rate)[0]
            acc_k = k6_shapes.setdefault(shape, [0, 0.0, 0.0])
            acc_k[0] += 1
            acc_k[1] += e0.elapsed_time(e1)
            acc_k[2] += b_k
        main_launches = {"gotoh_shortread": gsr.COUNTS["kernel"],
                         "walk_rows16": tb.COUNTS["kernel"],
                         "gotoh_stream": gs.COUNTS["kernel"],
                         "walk_many": tw.COUNTS["many_kernel"]}
        main_plain = plain_calls()
        check(all(v > 0 for v in main_launches.values()),
              f"the read path did not launch every kernel: {main_launches}")
        check(main_plain == 0, f"the read path ran a plain version {main_plain} times")

        # reads: the TSV's scores are phase 10's K6 scores (== plain)
        with open(path("reads.tsv")) as f:
            tsv = [ln.split("\t") for ln in f.read().splitlines()[1:]]
        check(len(tsv) == SR_B and all(int(r[2]) == int(s) for r, s in zip(tsv, sr_scores[False])),
              "reads TSV scores != the K6 scores of phase 10")
        # reads --align --format sam: a sample of records == the per-pair aligner's
        sam = sam_rows(path("reads.sam"))
        check(len(sam) == SR_B, f"reads --align wrote {len(sam)} records, not {SR_B}")
        aligner = PairwiseAligner(sc, device="cuda")
        for k in range(0, SR_B, SR_B // 16):
            q = Sequence(f"q{k}", s1r[k, :SR_LEN].tobytes().decode())
            r = Sequence(f"r{k}", s2r[k, :SR_LEN].tobytes().decode())
            ref = aligner.align(q, r)
            rec = rd.sam_records([r], [ref], [rd.cigar(ref)], [(0, 0, SR_LEN, SR_LEN)])[0]
            check("\t".join(sam[k]) + "\n" == rd._sam_line(rec),
                  f"reads --align SAM record {k} != the per-pair aligner's")

        # map: strands and positions against the reads' origins
        rows = sam_rows(path("map.sam"))
        check(len(rows) == MAP_N, f"map wrote {len(rows)} records, not {MAP_N}")
        flags = np.array([int(r[1]) for r in rows])
        pos = np.array([int(r[3]) for r in rows])
        # The reference retrace may walk a zero-score plateau before the
        # read's true start (long D runs ahead of the first M block), so
        # either end of the alignment on the reference may be the
        # exact one.
        end = pos - 1 + np.array([sum(int(n) for n, op in re.findall(r"(\d+)([MD])", r[5]))
                                  for r in rows])
        strand_ok = (flags & 16) == (np.arange(MAP_N) % 2) * 16
        near = (np.abs(pos - (map_pos + 1)) <= 32) | (np.abs(end - (map_pos + MAP_LEN)) <= 32)
        placed = (flags & 4 == 0) & strand_ok & near
        n_unmapped = int((flags & 4 != 0).sum())
        check(placed.mean() >= 0.995, f"map placed {int(placed.sum())}/{MAP_N} reads "
                                      f"({n_unmapped} unmapped)")
        prs = sam_rows(path("pairs.sam"))
        check(len(prs) == 2 * PAIRS_N, f"map -2 wrote {len(prs)} records")
        proper = sum(int(r[1]) & 2 != 0 for r in prs[::2])
        pair_ok = sum(int(r[3]) == p + 1 and (int(r[1]) & 16) == 0 for r, p in zip(prs[::2], pair_pos))
        check(proper >= 0.99 * PAIRS_N and pair_ok >= 0.99 * PAIRS_N,
              f"map -2: {proper} proper pairs, {pair_ok} first mates placed of {PAIRS_N}")

        # call: planted SNPs recovered, no false call
        with open(path("calls.vcf")) as f:
            vcf = [ln.split("\t") for ln in f.read().splitlines() if not ln.startswith("#")]
        got_snps = {(int(v[1]), v[4]) for v in vcf if len(v[3]) == 1 and len(v[4]) == 1}
        recovered = len(got_snps & truth)
        false_calls = len(vcf) - recovered
        check(recovered >= CALL_SNPS - 1 and false_calls == 0,
              f"call: {recovered}/{CALL_SNPS} SNPs recovered, {false_calls} false calls")

        # call's first K3 + K4 round, replayed: K3 dirs == plain, and the
        # diag16 walk (K4) == its plain version, on the same inputs
        check(len(k3_rounds) == 1, "the read path ran no K3 + K4 round")
        s1c, s2c, ms_c, ns_c, sc_c, loc_c, steps_c = k3_rounds[0][:7]
        cr = on_card(s1c, s2c, ms_c, ns_c)
        CB, (CL1, CL2) = len(ms_c), (cr[0].shape[1], cr[1].shape[1])
        k3_call = gs.gotoh_stream_fill(*cr, sc_c, loc_c, emit_dirs=True)
        want, k3_call_plain_ms = timed(lambda: gs.gotoh_stream_plain(*cr, sc_c, loc_c,
                                                                     emit_dirs=True))
        k3_call_err = diag16_err(k3_call, want, cr[2], cr[3])
        check(k3_call_err == 0, f"K3 dirs kernel != plain on call's first round ({CB} reads, "
                                f"{CL1} x {CL2}): max |err| {k3_call_err}")
        del want
        # ... and its scores and start cells == the C++ oracle on 64 of its reads.
        pick = np.linspace(0, CB - 1, 64).astype(int)
        with ThreadPoolExecutor(8) as pool:  # ctypes drops the GIL
            oracle = list(pool.map(lambda t: native.gotoh_score_cpu(
                s1c[t, : ms_c[t]].tobytes().decode(), s2c[t, : ns_c[t]].tobytes().decode(),
                sc_c, loc_c), pick))
        got3 = [tuple(int(x[t]) for x in k3_call[:3]) for t in pick]
        bad = [(int(t), g, tuple(o)) for t, g, o in zip(pick, got3, oracle) if g != tuple(o)]
        check(not bad, f"K3 on call's first round != the C++ oracle: {bad[:3]}")
        si_c, sj_c = (x.cpu().numpy().astype(np.int64) for x in k3_call[1:3])
        walk_c = lambda: tb.walk_batch(k3_call.dirs, si_c, sj_c, sc_c, loc_c,  # noqa: E731
                                       "diag16", steps_c)
        got = walk_c()
        want, k4_call_plain_ms = timed(lambda: tb.walk_batch_plain(
            k3_call.dirs, si_c, sj_c, sc_c, loc_c, "diag16", steps_c))
        same = all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want))
        check(same and all(got[4]), f"K4 diag16 walk != plain on call's first round ({CB} walks)")
        k4_call_moves = int(np.sum(got[1]))
        k4_call_words = words_read(got[0], got[1], si_c, sj_c, "diag16")
        del want
        print(f"[phase 13] call's first round replayed ({CB} reads, {CL1} x {CL2}, "
              f"local={loc_c}): K3 dirs == plain (scores, starts, codes at every true cell; "
              f"plain {k3_call_plain_ms:.0f} ms), 64 reads' scores and starts == the C++ "
              f"oracle, {CB} diag16 walks ({k4_call_moves} moves) "
              f"K4 == plain (plain {k4_call_plain_ms:.0f} ms); max |err| 0", flush=True)
        print(f"[phase 13] read path CLI on cuda ({t_data:.1f} s to make the data): reads "
              f"{SR_B} x {SR_LEN} bp scores == K6 and 16 SAM records == PairwiseAligner.align; "
              f"map placed {int(placed.sum())}/{MAP_N} reads (strand, start or end within 32 "
              f"bp of the origin's; "
              f"{n_unmapped} unmapped); map -2 {proper}/{PAIRS_N} proper pairs; call "
              f"{recovered}/{CALL_SNPS} SNPs recovered, {false_calls} false calls; launches "
              f"{main_launches}, plain calls {main_plain} ({time.perf_counter() - t_phase:.1f} s)",
              flush=True)
        for name in runs:
            said = [ln for ln in stdout[name].splitlines() if ln.strip() and "wrote" not in ln]
            stdout[name] = said[-1]
            print(f"[phase 13] {name}: {stdout[name]}", flush=True)

        # ---- phase 14: times ----
        k6_g = cuda_ms(lambda: gsr.gotoh_scores_shortread(*sr, sc, False), 3)
        k6_l = cuda_ms(lambda: gsr.gotoh_scores_shortread(*sr, sc, True), 3)
        k6_d = cuda_ms(lambda: gsr.gotoh_scores_shortread(*mp, sc, True, emit_dirs=True), 3)
        # The group-size sweep at the paths' shapes: every G on the reads
        # batch (global and local scores, local with codes: ``reads`` and
        # ``reads --align``) and at the map shape (local, codes).
        lr = on_card(acgt[rng.integers(0, 4, (MB, 256))], acgt[rng.integers(0, 4, (MB, 256))],
                     np.full(MB, 256), np.full(MB, 256))  # the tier's longest reads
        g_cases = (("reads global", sr, False, False), ("reads local", sr, True, False),
                   ("reads local+codes", sr, True, True), ("map local+codes", mp, True, True),
                   (f"{MB} x 256 x 256 local+codes", lr, True, True))
        g_sweep = {(name, G): med(cuda_ms(lambda a=a, loc=loc, d=d, G=G: gsr._shortread_cuda(
                       *a, sc, loc, d, G), 3))
                   for name, a, loc, d in g_cases for G in gsr.GROUP_SIZES}
        _, si, sj, codes = fill_m
        wr = cuda_ms(lambda: tb.walk_batch(codes, si, sj, sc, True, "rows16", 385), 3)
        lib, stream = _build.library(), _build.stream_handle(dev)
        Br, L1r, Wr = codes.shape
        starts_r = torch.stack([torch.as_tensor(si), torch.as_tensor(sj)], 1).to(
            device=dev, dtype=torch.int32).contiguous()
        words_r = torch.zeros((Br, -(-385 // 16)), dtype=torch.int32, device=dev)
        meta_r = torch.empty((Br, 5), dtype=torch.int32, device=dev)
        wr_alone = cuda_ms(lambda: _build.check(lib.walk_rows16_launch(
            _build.ptr(codes), _build.ptr(starts_r), _build.ptr(words_r), _build.ptr(meta_r), Br,
            L1r, Wr, words_r.shape[1], 385, sc.h, sc.g, 1, stream), "walk_rows16"), 3)
        k3_c = cuda_ms(lambda: gs.gotoh_stream_fill(*cr, sc_c, loc_c, emit_dirs=True), 3)
        k4_c = cuda_ms(walk_c, 3)
        # interior cells only: row 0 and column 0 are closed forms
        c_sr = SR_B * float(SR_LEN) ** 2
        c_mp = MB * 128.0 * 256.0
        sr_bytes = SR_B * (2 * SR_LEN + 20)
        k6_bound = bound(sr_bytes, c_sr * OPS_PER_CELL["global"], rate)
        k6_bound_l = bound(sr_bytes, c_sr * OPS_PER_CELL["local"], rate)
        k6_bound_d = bound(MB * (128 + 256 + 20) + c_mp / 4,
                           c_mp * (OPS_PER_CELL["local"] + OPS_PER_CELL["dirs"]), rate)
        m_moves = walk_moves[walk_cases[0][0]]
        wr_bound = bound(4 * wr_words + m_moves / 4 + 28 * MB, OPS_PER_MOVE * m_moves, rate)
        # call's round: K3 with dirs over the recorded buckets, K4 over
        # the words its 4,096 diag16 paths read
        c_call = float(np.sum(np.asarray(ms_c, np.float64) * np.asarray(ns_c, np.float64)))
        mode = "local" if loc_c else "global"
        k3_call_bound = bound(float(np.sum(np.asarray(ms_c) + np.asarray(ns_c))) + CB * 20
                              + c_call / 4, c_call * (OPS_PER_CELL[mode] + OPS_PER_CELL["dirs"]),
                              rate)
        k4_call_bound = bound(4 * k4_call_words + k4_call_moves / 4 + 36 * CB,
                              OPS_PER_MOVE * k4_call_moves, rate)
        # K4's wrapper time on call's round, split into device and host
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof4:
            t0 = time.perf_counter()
            walk_c()
            torch.cuda.synchronize()
            t_k4_prof = (time.perf_counter() - t0) * 1e3
        dev4 = device_ms(torch, prof4)
        k4_dev = sum(v for k, v in dev4.items() if "walk_many" in k)
        # The same launch alone by CUDA events: a capture made after phase
        # 9's can lack the kernel's record.
        B4, KW4, V4 = k3_call.dirs.shape
        nw4 = -(-steps_c // 16)
        starts4 = torch.from_numpy(np.stack([si_c, sj_c, np.arange(B4) * KW4, np.zeros(B4, np.int64)],
                                            1).astype(np.int32)).to(dev)
        words4 = torch.zeros((B4, nw4), dtype=torch.int32, device=dev)
        meta4 = torch.empty((B4, 5), dtype=torch.int32, device=dev)
        k4_alone = cuda_ms(lambda: _build.check(lib.walk_many_launch(
            _build.ptr(k3_call.dirs), _build.ptr(starts4), _build.ptr(words4), _build.ptr(meta4),
            B4, KW4, B4 * KW4, V4, nw4, steps_c, stream), "walk_many"), 3)

        # map split into seeding and extension, and its device-busy share
        genome_seq = SequenceContainer().from_fasta(path("genome.fasta")).sequences
        reads_m = SequenceContainer().from_reads(path("map.fasta")).sequences
        t0 = time.perf_counter()
        index = KmerIndex(genome_seq, 21)
        t_index = time.perf_counter() - t0
        t0 = time.perf_counter()
        map_reads(reads_m, genome_seq, sc, index=index, min_seeds=10**9, device="cuda")
        t_seed = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            map_reads(reads_m, genome_seq, sc, index=index, device="cuda")
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
    dev_ms = device_ms(torch, prof)
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:4]
    print(f"[phase 14] card {card} | K6 {SR_B} x {SR_LEN} bp ({c_sr:.4g} cells): global "
          f"[{fmt(k6_g)}] ms = {c_sr / med(k6_g) * 1e3:.4g} cells/s (plain "
          f"{k6_plain_ms[False]:.1f} ms, bound {k6_bound[0]:.4f} ms by {k6_bound[1]}); local "
          f"[{fmt(k6_l)}] ms (plain {k6_plain_ms[True]:.1f} ms, bound {k6_bound_l[0]:.4f} ms) | "
          f"K6 dirs at the map shape ({MB} x 128 x 256, local): [{fmt(k6_d)}] ms (plain "
          f"{k6_plain_dirs_ms:.1f} ms, bound {k6_bound_d[0]:.4f} ms by {k6_bound_d[1]}) | "
          f"walk_rows16 {MB} walks, {m_moves} moves reading {wr_words} words: wrapper "
          f"[{fmt(wr)}] ms, kernel alone [{fmt(wr_alone)}] ms (plain "
          f"{walk_plain_ms[walk_cases[0][0]]:.1f} ms, bound {wr_bound[0]:.6f} ms by "
          f"{wr_bound[1]}, chain floor {chain_floor(m_moves / MB)}) | call's round ({CB} reads, {CL1} x {CL2}): K3 dirs [{fmt(k3_c)}] "
          f"ms (plain {k3_call_plain_ms:.1f} ms, bound {k3_call_bound[0]:.4f} ms by "
          f"{k3_call_bound[1]}, {c_call:.4g} cells), K4 diag16 walks [{fmt(k4_c)}] ms (plain "
          f"{k4_call_plain_ms:.1f} ms, bound {k4_call_bound[0]:.6f} ms by {k4_call_bound[1]}, "
          f"{k4_call_moves} moves reading {k4_call_words} words; profiled: wall "
          f"{t_k4_prof:.3f} ms, walk_many_kernel {k4_dev:.3f} ms on the device, all device "
          f"{sum(dev4.values()):.3f} ms, host {t_k4_prof - sum(dev4.values()):.3f} ms; chain "
          f"floor {chain_floor(k4_call_moves / CB)}; the kernel alone by CUDA events "
          f"[{fmt(k4_alone)}] ms)", flush=True)
    k6_loss = sum(ms_k - b_k for _, ms_k, b_k in k6_shapes.values())
    print(f"[phase 14] card {card} | K6's {sum(v[0] for v in k6_shapes.values())} calls in "
          f"phase 13 by shape (B x L1 x L2, mode, codes: calls, device ms, bound ms): "
          + "; ".join(f"{k[0]} x {k[1]} x {k[2]} {'local' if k[3] else 'global'}"
                      f"{' codes' if k[4] else ''}: {v[0]}, {v[1]:.3f}, {v[2]:.3f}"
                      for k, v in sorted(k6_shapes.items()))
          + f" | launches x (time - bound) {k6_loss:.3f} ms", flush=True)
    print(f"[phase 14] card {card} | K6 by lanes a pair (G; the wrapper takes G = "
          f"{gsr.group_size(SR_LEN)} at {SR_LEN} rows, {gsr.group_size(128)} at 128, "
          f"{gsr.group_size(256)} at 256): "
          + "; ".join(f"{name}: " + ", ".join(
              f"G {G} (RT {gsr.lane_rows(int(max(a[2])), G)}) "
              f"{g_sweep[name, G]:.4f} ms" for G in gsr.GROUP_SIZES)
              for name, a, _, _ in g_cases), flush=True)
    print(f"[phase 14] walls: reads scores {walls['reads']:.3f} s, reads --align sam "
          f"{walls['reads --align']:.3f} s, map {walls['map']:.3f} s (CLI: {stdout['map']}; "
          f"library: index {t_index:.3f} s, seeding only {t_seed:.3f} s), map -2 "
          f"{walls['map -2']:.3f} s, call {walls['call']:.3f} s | profiled map_reads: wall "
          f"{t_prof:.3f} s, device time {sum(dev_ms.values()):.1f} ms (busy "
          f"{sum(dev_ms.values()) / 10 / t_prof:.2f}%); "
          + "; ".join(f"{k[:40]} {v:.1f} ms" for k, v in top), flush=True)
    return [
        {"name": "gotoh_shortread", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_shortread.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_shortread.py:196",
         "launches": main_launches["gotoh_shortread"], "max_abs_err": float(k6_max),
         "ms": med(k6_g), "plain_ms": float(k6_plain_ms[False]),
         "bound_ms": k6_bound[0], "bound_by": k6_bound[1], "library_ms": None},
        {"name": "walk_rows16", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/traceback_walk.cu",
         "replaces": "genomics_rs_tpu/ops/traceback_batch.py:71",
         "launches": main_launches["walk_rows16"], "max_abs_err": float(walk_max),
         "ms": med(wr), "plain_ms": float(walk_plain_ms[walk_cases[0][0]]),
         "bound_ms": wr_bound[0], "bound_by": wr_bound[1], "library_ms": None},
    ]


def banded_words(moves: np.ndarray, m: int, n: int, V: int) -> int:
    """4-byte code words a banded walk from (m, n) must read: interior
    cells' words ((i - 1) // 16, j - off(i) - 1), each run of consecutive
    moves on one word read once."""
    from genomics_rs_tpu_torch.ops.gotoh_banded import band_offset
    from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_SUB

    offs = band_offset(np.arange(m + 1), m, n, V)
    mv = np.asarray(moves)
    di = ((mv == DIR_SUB) | (mv == DIR_DEL)).astype(np.int64)
    dj = ((mv == DIR_SUB) | (mv == DIR_INS)).astype(np.int64)
    i_at = m - np.cumsum(di) + di
    j_at = n - np.cumsum(dj) + dj
    word = np.where((i_at > 0) & (j_at > 0),
                    (i_at - 1) // 16 * (1 << 32) + (j_at - offs[i_at] - 1), -1)
    first = np.ones(word.size, bool)
    first[1:] = word[1:] != word[:-1]
    return int((first & (word >= 0)).sum())


def path_score(moves: np.ndarray, a: str, b: str, sc) -> int:
    """The global score of the alignment that ``moves`` (walk order, from
    (len(a), len(b))) spells, recomputed from the strings: s_match or
    s_mismatch per diagonal move on a[i-1], b[j-1], and h + L g per gap
    run. Fails unless the path ends at the origin."""
    from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_SUB

    mv = np.asarray(moves)
    di = (mv != DIR_INS).astype(np.int64)
    dj = (mv != DIR_DEL).astype(np.int64)
    check(int(di.sum()) == len(a) and int(dj.sum()) == len(b),
          f"a path of {len(mv)} moves does not run from ({len(a)}, {len(b)}) to the origin")
    sub = mv == DIR_SUB
    i_at = (len(a) - np.cumsum(di) + di)[sub]
    j_at = (len(b) - np.cumsum(dj) + dj)[sub]
    same = (np.frombuffer(a.encode(), np.uint8)[i_at - 1]
            == np.frombuffer(b.encode(), np.uint8)[j_at - 1])
    gap = ~sub
    opens = gap & np.concatenate([[True], mv[1:] != mv[:-1]])
    return int(same.sum() * sc.s_match + (~same).sum() * sc.s_mismatch
               + opens.sum() * sc.h + gap.sum() * sc.g)


def banded_phases(torch, dev, card, sc, cuda_ms, rate) -> list[dict]:
    """Phases 15-18: the banded path (``align --band``, ``align_banded``,
    ``banded_align_batch``) on K10, K11 and K12. Returns their rows of the
    summary line."""
    from genomics_rs_tpu_torch import cli, native
    from genomics_rs_tpu_torch.config import Scores
    from genomics_rs_tpu_torch.display.alignment import format_aligned_sequences
    from genomics_rs_tpu_torch.models.banded import align_banded
    from genomics_rs_tpu_torch.ops import gotoh_banded as gb
    from genomics_rs_tpu_torch.ops import gotoh_banded_batch as gbb
    from genomics_rs_tpu_torch.ops.traceback import classify_moves
    from walk_stage_cases import BAND_EDGE_SPECS, band_edge_walk
    from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, round_up

    med = lambda ts: float(np.median(ts))  # noqa: E731
    fmt = lambda ts: ", ".join(f"{t:.3f}" for t in ts)  # noqa: E731

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def encode(seqs, width, pad):
        """(B, width) uint8 on the card."""
        return torch.from_numpy(np.stack([Sequence("s", x).encoded(width, pad) for x in seqs])).to(dev)

    def shorter_copy(rng, genome: str) -> tuple[str, int]:
        """A planted copy no longer than ``genome`` (banded alignment puts
        the longer sequence first)."""
        while True:
            copy, score = planted_copy(rng, genome, sc)
            if len(copy) <= len(genome):
                return copy, score

    def pair_on_card(a: str, b: str, V: int):
        """One pair padded as ``align_banded`` pads it: (1, L1), (1, L2)."""
        return (encode([a], max(round_up(len(a), 128), 128), PAD_S1),
                encode([b], max(round_up(len(b), 128), V), PAD_S2))

    def band_err(got, want, ms, ns, V, geom=None) -> int:
        """Max |difference| of the scores, and of the codes at every true
        in-band cell of each pair (1 <= i <= m_p, j = off(i) + v + 1 <= n_p,
        the window planned from ``geom``, default (max ms, max ns))."""
        errs = [int((got[0].long().cpu() - want[0].long().cpu()).abs().max())]
        M, N = geom or (int(max(ms)), int(max(ns)))
        v = torch.arange(V, device=dev)[None, :]
        for p in range(len(ms)):
            for r0 in range(0, int(ms[p]), 2048):
                r = np.arange(r0, min(int(ms[p]), r0 + 2048))  # i - 1
                off = torch.from_numpy(gb.band_offset(r + 1, M, N, V)).to(dev)[:, None]
                rows = torch.from_numpy(r).to(dev)
                sh = (2 * (rows % 16))[:, None]
                g_, w_ = ((x[p][rows // 16].long() >> sh) & 3 for x in (got[1], want[1]))
                live = off + v + 1 <= int(ns[p])
                errs.append(int(((g_ - w_).abs() * live).max()))
        return max(errs)

    # ---- phase 15: K10 and K12 kernels vs plain ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1515)
    k10_err, k12_err, n_k10 = 0, 0, 0
    walks = []  # (dirs (KW, V) on the card, m, n, V, geom) for phase 16
    for V in (1024, 2048):
        for m, n in ((V + 100, V - 24), (2 * V + 200, 2 * V + 120)):  # full cover, narrow
            a = random_dna(rng, m)
            b = mutate(rng, a, 0.04, 6)[:n]
            for st in (None, -1):
                sck = Scores(2, -3, -2, -4, st)
                s1, s2 = pair_on_card(a, b, V)
                score, dirs = gb.gotoh_banded(s1[0], s2[0], m, len(b), sck, V)
                want = gb.gotoh_banded_plain(s1, s2, [m], [len(b)], sck, V)
                err = band_err((torch.tensor([score]), dirs[None]), want, [m], [len(b)], V)
                k10_err = max(k10_err, err)
                n_k10 += 1
                check(err == 0, f"K10 kernel != plain ({m} x {len(b)}, V={V}, st={st}): "
                                f"max |err| {err}")
                walks.append((dirs, m, len(b), V, None))
    # a batch of 11 mixed-length pairs (two result groups) at three widths
    base = random_dna(rng, 2_200)
    a11 = [base[: 2_100 - int(rng.integers(0, 12))] for _ in range(11)]
    b11 = [mutate(rng, a, 0.04, 2)[: len(a)] for a in a11]
    ms11, ns11 = np.array([len(a) for a in a11]), np.array([len(b) for b in b11])
    batches = {}
    for W in (128, 384, 2048):
        sck = Scores(2, -3, -2, -4, -1 if W == 384 else None)
        s1b = encode(a11, 2_176, PAD_S1)
        s2b = encode(b11, max(2_304, W), PAD_S2)
        groups = gbb.gotoh_banded_batch(s1b, s2b, ms11, ns11, sck, W)
        got = (torch.cat([g.score for g in groups]), torch.cat([g.dirs for g in groups]))
        want = gb.gotoh_banded_plain(s1b, s2b, ms11, ns11, sck, W, gbb.COUNTS)
        err = band_err(got, want, ms11, ns11, W)
        k12_err = max(k12_err, err)
        check(len(groups) == 2 and err == 0,
              f"K12 kernel != plain (11 pairs, W={W}): max |err| {err}")
        batches[W] = (got[1], (groups[0].M, groups[0].N))
    # the 29,903 bp planted pair at V = 2048, and one fill per wider form
    g29 = random_dna(rng, BATCH_LEN)
    p29, planted29 = shorter_copy(rng, g29)
    s1_29, s2_29 = pair_on_card(g29, p29, BAND)
    score29, dirs29 = gb.gotoh_banded(s1_29[0], s2_29[0], BATCH_LEN, len(p29), sc, BAND)
    want, k10_plain_ms = timed(lambda: gb.gotoh_banded_plain(
        s1_29, s2_29, [BATCH_LEN], [len(p29)], sc, BAND))
    err = band_err((torch.tensor([score29]), dirs29[None]), want, [BATCH_LEN], [len(p29)], BAND)
    k10_err = max(k10_err, err)
    check(err == 0 and score29 == planted29,
          f"K10 at 29,903 bp: max |err| {err} vs plain, score {score29} (planted {planted29})")
    walks.append((dirs29, BATCH_LEN, len(p29), BAND, None))
    wide_plain_ms, wide_ms = {}, {}
    for V, m, n in WIDE_FILLS:
        a = random_dna(rng, m)
        b = mutate(rng, a, 0.02, 4)[:n]
        s1, s2 = pair_on_card(a, b, V)
        score, dirs = gb.gotoh_banded(s1[0], s2[0], m, len(b), sc, V)
        wide_ms[V] = cuda_ms(lambda: gb.gotoh_banded(s1[0], s2[0], m, len(b), sc, V), 1)[0]
        want, wide_plain_ms[V] = timed(lambda: gb.gotoh_banded_plain(
            s1, s2, [m], [len(b)], sc, V))
        err = band_err((torch.tensor([score]), dirs[None]), want, [m], [len(b)], V)
        k10_err = max(k10_err, err)
        check(err == 0, f"K10 at V={V} ({m} x {len(b)}) != plain: max |err| {err}")
        walks.append((dirs, m, len(b), V, None))
        del want
    # The sweep's edges at small shapes: a band at column 0 all along (n <=
    # V), one that slides a column a row (m = n), and a mixed K12 batch
    # whose last strips end mid-lane, each on the whole grid and on two
    # persistent blocks (tickets and ring slots cycle).
    edges = (("column 0", [1_500], [900], 1024), ("sliding", [1_300], [1_300], 256),
             ("mixed", [2_000, 1_990, 1_700, 1_111], [1_900, 1_950, 1_650, 1_100], 384))
    for name, ems, ens, V in edges:
        a = [random_dna(rng, m) for m in ems]
        b = [mutate(rng, x, 0.04, 2)[:n] for x, n in zip(a, ens)]
        ens = [len(x) for x in b]
        s1 = encode(a, round_up(max(ems), 128), PAD_S1)
        s2 = encode(b, max(round_up(max(ens), 128), V), PAD_S2)
        want = gb.gotoh_banded_plain(s1, s2, ems, ens, sc, V)
        for blocks in (None, 2):
            got = gb.fill_cuda(s1, s2, ems, ens, sc, V, {"kernel": 0}, max_blocks=blocks)
            err = band_err(got, want, ems, ens, V)
            k10_err = max(k10_err, err)
            check(err == 0, f"K10/K12 sweep edge '{name}' (V={V}, grid {blocks}) != plain: "
                            f"max |err| {err}")
        n_k10 += 1
    print(f"[phase 15] K10 kernel == plain on {n_k10} fills (V = 1024 and 2048, full cover "
          f"and narrow, classic and kimura; a band at column 0, a sliding band and a mixed "
          f"batch, each also on two blocks), the 29,903 bp planted pair at V = {BAND} (score "
          f"{score29} == planted; plain {k10_plain_ms:.0f} ms) and one fill at each width "
          f"that had its own compiled form before the warp-strip sweep, "
          f"(V, m, n) kernel / plain ms: "
          f"{', '.join(f'({V}, {m}, {n}) {wide_ms[V]:.2f} / {wide_plain_ms[V]:.0f}' for V, m, n in WIDE_FILLS)}; "
          f"K12 kernel == plain on 11 pairs of "
          f"{ms11.min()}-{ms11.max()} bp at W = 128, 384 (kimura), 2048; codes at every true "
          f"in-band cell; max |err| {max(k10_err, k12_err)} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 16: K11 vs plain ----
    t_phase = time.perf_counter()
    k11_err, n_moves = 0, 0
    for dirs, m, n, V, geom in walks:
        got = gb.walk_banded(dirs, m, n, V, geom=geom)
        want = gb.walk_banded_plain(dirs.cpu(), m, n, V, geom)
        same = np.array_equal(got, want)
        k11_err = max(k11_err, 0 if same else 1)
        check(same, f"K11 != plain on the {m} x {n} bitmap at V={V}")
        n_moves += len(got)
    resumed = gb.walk_banded(dirs29, BATCH_LEN, len(p29), BAND, max_steps=1000)
    t0 = time.perf_counter()
    want29 = gb.walk_banded_plain(dirs29.cpu(), BATCH_LEN, len(p29), BAND)
    k11_plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(resumed, want29), "K11 resumed past 1,000 moves != plain")
    n_batch_walks = 0
    for W, (dirs, geom) in batches.items():
        got = gb.walk_banded_batch(dirs, ms11, ns11, W, geom=geom)
        for p in range(len(ms11)):
            want = gb.walk_banded_plain(dirs[p].cpu(), int(ms11[p]), int(ns11[p]), W, geom)
            same = np.array_equal(got[p], want)
            k11_err = max(k11_err, 0 if same else 1)
            check(same, f"K11 batch walk {p} (W={W}, geom {geom}) != plain")
            n_batch_walks += 1
    # walk_stage's edge paths: gaps wider than the lane window both ways,
    # both band edges, starts on rows 16k, 16k+1 and 16k+15; carried whole
    # and resumed at 1, 15, 16, 17 and 1,000 moves a launch.
    for k in range(len(BAND_EDGE_SPECS)):
        name, edirs, em, en = band_edge_walk(k)
        want = gb.walk_banded_plain(edirs, em, en, 1024)
        for cap in (None, 1, 15, 16, 17, 1000):
            same = np.array_equal(gb.walk_banded(edirs.to(dev), em, en, 1024, max_steps=cap), want)
            k11_err = max(k11_err, 0 if same else 1)
            check(same, f"K11 != plain on the edge path {name!r} (max_steps {cap})")
    try:
        gb.walk_banded(torch.full((18, 256), 0x55555555, dtype=torch.int32, device=dev),
                       280, 100, 256, geom=(300, 290))
        fail("K11 walked an all-INS bitmap out of the band without an error")
    except RuntimeError as e:
        check("left the band" in str(e), f"K11 on the all-INS bitmap: {e}")
    print(f"[phase 16] K11 kernel == plain on {len(walks)} walks ({n_moves} moves; the "
          f"29,903 bp one also resumed from 1,000-move launches, plain {k11_plain_ms:.0f} ms) "
          f"and {n_batch_walks} batch walks in one launch per width with the shared geometry; "
          f"{len(BAND_EDGE_SPECS)} edge paths (gaps wider than the lane window both ways, both "
          f"band edges, starts on rows 16k, 16k+1, 16k+15), each whole and resumed at 1, 15, "
          f"16, 17 and 1,000 moves a launch; the all-INS bitmap raises; max |err| {k11_err} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 17: the path at real size ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(12_2048)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, GENOME_BP)].tobytes().decode()
    planted, planted_score = shorter_copy(rng, genome)
    bgenome = random_dna(rng, BATCH_LEN)
    copies = [shorter_copy(rng, bgenome) for _ in range(BATCH_B)]
    bms = np.full(BATCH_B, BATCH_LEN)
    bns = np.array([len(c) for c, _ in copies])
    s1b = encode([bgenome] * BATCH_B, round_up(BATCH_LEN, 128), PAD_S1)
    s2b = encode([c for c, _ in copies], max(round_up(int(bns.max()), 128), BAND), PAD_S2)
    t_data = time.perf_counter() - t_phase
    os.environ["LOG_LEVEL"] = "WARNING"
    for mod in (gb, gbb):
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0
    g_seq = Sequence("chr12s", genome)
    t0 = time.perf_counter()
    self_aln = align_banded(g_seq, g_seq, sc, band=BAND, device="cuda")
    t_self = time.perf_counter() - t0
    t0 = time.perf_counter()
    aln = align_banded(g_seq, Sequence("planted", planted), sc, band=BAND, device="cuda")
    t_planted = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        cfg, fasta, out = (os.path.join(tmp, x) for x in ("config.toml", "pair.fasta", "out.txt"))
        with open(cfg, "w") as f:
            f.write(f"[scores]\ns_match = {sc.s_match}\ns_mismatch = {sc.s_mismatch}\n"
                    f"g = {sc.g}\nh = {sc.h}\n")
        with open(fasta, "w") as f:
            f.write(f">chr12s\n{genome}\n>planted\n{planted}\n")
        t0 = time.perf_counter()
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            rc = cli.main(["-c", cfg, "align", "-a", "global", "--band", str(BAND), "-f", fasta,
                           "--device", "cuda"])
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t0
        with open(out) as f:
            cli_tail = f.read().splitlines()[-6:]
    t0 = time.perf_counter()
    batch = gbb.banded_align_batch(s1b, s2b, bms, bns, sc, BAND)
    t_batch = time.perf_counter() - t0
    launches = {"gotoh_banded": gb.COUNTS["kernel"], "walk_banded": gb.COUNTS["walk_kernel"],
                "gotoh_banded_batch": gbb.COUNTS["kernel"]}
    plain = gb.COUNTS["plain"] + gb.COUNTS["walk_plain"] + gbb.COUNTS["plain"]
    check(rc == 0, f"align --band exited {rc}")
    check(launches["gotoh_banded"] >= 2 and launches["gotoh_banded_batch"] >= 1
          and launches["walk_banded"] >= 3 and plain == 0,
          f"the banded path: launches {launches}, plain calls {plain}")
    check(self_aln.score == GENOME_BP and self_aln.matches == GENOME_BP,
          f"self alignment: score {self_aln.score}, matches {self_aln.matches}")
    check(aln.score == planted_score, f"planted pair: score {aln.score} != {planted_score}")
    check(cli_tail == format_aligned_sequences(aln).splitlines()[-6:],
          f"align --band's stats {cli_tail} != the library call's")
    check([s for s, _ in batch] == [p for _, p in copies],
          f"banded_align_batch scores {[s for s, _ in batch]} != planted")
    with ThreadPoolExecutor(2) as pool:  # ctypes drops the GIL
        oracle = list(pool.map(lambda k: native.gotoh_score_cpu(bgenome, copies[k][0], sc, False),
                               (0, 1)))
    check([o[0] for o in oracle] == [batch[0][0], batch[1][0]],
          f"banded_align_batch pairs 0-1 {[batch[0][0], batch[1][0]]} != oracle {oracle}")
    # The path's kernels at its own shapes against their plain versions:
    # K10's codes over the first PREFIX_ROWS rows of the 1 Mb window (the
    # plain fill of all its rows takes tens of minutes), K11's walk of the 1
    # Mb planted pair (refilled: the fill is deterministic) and the 16 batch
    # walks. Each path, rescored from its strings, runs end to end and
    # costs at most its score: the walk follows each cell's best arm (S > I
    # > D on ties), which can break a gap run the score extended.
    m, n = GENOME_BP, len(planted)
    s1e, s2e = pair_on_card(genome, planted, BAND)
    _, dirs_big = gb.gotoh_banded(s1e[0], s2e[0], m, n, sc, BAND)
    rows = min(PREFIX_ROWS, m)
    want, k10_prefix_ms = timed(lambda: gb.gotoh_banded_plain(
        s1e, s2e, [m], [n], sc, BAND, rows=rows))
    kw = want[1].shape[1]
    err = band_err((want[0], dirs_big[None, :kw]), want, [rows], [n], BAND, geom=(m, n))
    k10_err = max(k10_err, err)
    check(err == 0, f"K10 at {m} x {n}, rows 1..{rows} != plain: max |err| {err}")
    del want
    moves_big = gb.walk_banded(dirs_big, m, n, BAND)
    t0 = time.perf_counter()
    plain_big = gb.walk_banded_plain(dirs_big.cpu(), m, n, BAND)
    k11_plain_big_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(moves_big, plain_big),
          f"K11 at {m} x {n} ({len(moves_big)} moves) != plain ({len(plain_big)} moves)")
    again = classify_moves(moves_big, m, n, aln.score, g_seq, Sequence("planted", planted))
    check(again == aln, "the refilled 1 Mb walk's alignment != align_banded's")
    rescored = [path_score(moves_big, genome, planted, sc)]
    check(rescored[0] <= planted_score,
          f"the 1 Mb path rescores to {rescored[0]}, above its score {planted_score}")
    groups = gbb.gotoh_banded_batch(s1b, s2b, bms, bns, sc, BAND)
    dirs12 = torch.cat([g.dirs for g in groups])
    for p, (copy, planted_p) in enumerate(copies):
        want = gb.walk_banded_plain(dirs12[p].cpu(), BATCH_LEN, int(bns[p]), BAND,
                                    (groups[0].M, groups[0].N))
        check(np.array_equal(batch[p][1], want), f"K11 batch walk {p} at 29,903 bp != plain")
        rescored.append(path_score(batch[p][1], bgenome, copy, sc))
        check(rescored[-1] <= planted_p,
              f"batch pair {p}: its path rescores to {rescored[-1]}, above {planted_p}")
    del dirs12, groups
    print(f"[phase 17] banded path on cuda ({t_data:.1f} s to make the data): align_banded of "
          f"the {GENOME_BP} bp genome with itself at band {BAND}: score {self_aln.score} == "
          f"length, {self_aln.matches} matches ({t_self:.3f} s); with its planted copy "
          f"({len(planted)} bp): score {aln.score} == planted ({t_planted:.3f} s); the CLI "
          f"align --band {BAND}: stats == the library's ({t_cli:.3f} s wall); "
          f"banded_align_batch of {BATCH_B} planted copies of {BATCH_LEN} bp at W = {BAND}: "
          f"every score == planted, pairs 0-1 == C++ oracle ({t_batch:.3f} s); launches "
          f"{launches}, plain calls {plain}; then K10 == plain on rows 1..{rows} of the 1 Mb "
          f"window (plain {k10_prefix_ms:.0f} ms), K11 == plain on the path's walks (the 1 Mb "
          f"planted pair's {len(moves_big)} moves, plain {k11_plain_big_ms:.0f} ms, and the "
          f"{BATCH_B} batch walks), each path rescored from its strings <= its score (1 Mb: "
          f"{rescored[0]} of {planted_score}; batch, summed: {sum(rescored[1:])} of {sum(p for _, p in copies)}) "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 18: times ----
    k10_big = cuda_ms(lambda: gb.gotoh_banded(s1e[0], s2e[0], m, n, sc, BAND), 3)
    k10_29 = cuda_ms(lambda: gb.gotoh_banded(s1_29[0], s2_29[0], BATCH_LEN, len(p29), sc, BAND), 3)
    k11_big = cuda_ms(lambda: gb.walk_banded(dirs_big, m, n, BAND), 3)
    k11_29 = cuda_ms(lambda: gb.walk_banded(dirs29, BATCH_LEN, len(p29), BAND), 3)
    # K11 alone (one launch carrying the whole walk) beside its wrapper, and
    # the wrapper cut into MAX_STEPS_CAP-move launches as before whole walks
    # (each launch's copies back and unpack on the host).
    a11 = {"29,903 bp": k11_alone(torch, gb, dirs29[None], [BATCH_LEN], [len(p29)], BAND,
                                  (BATCH_LEN, len(p29)), cuda_ms),
           "1 Mb planted": k11_alone(torch, gb, dirs_big[None], [m], [n], BAND, (m, n), cuda_ms)}
    chunked = cuda_ms(lambda: gb.walk_banded(dirs_big, m, n, BAND, max_steps=gb.MAX_STEPS_CAP), 3)
    n_chunks = -(-len(moves_big) // gb.MAX_STEPS_CAP)
    s1s, s2s = pair_on_card(genome, genome, BAND)
    _, dirs_self = gb.gotoh_banded(s1s[0], s2s[0], m, m, sc, BAND)
    k11_self = cuda_ms(lambda: gb.walk_banded(dirs_self, m, m, BAND), 3)
    a11["1 Mb self"] = k11_alone(torch, gb, dirs_self[None], [m], [m], BAND, (m, m), cuda_ms)
    del dirs_self, s1s, s2s
    k12 = cuda_ms(lambda: gbb.gotoh_banded_batch(s1b, s2b, bms, bns, sc, BAND), 3)
    got = gbb.gotoh_banded_batch(s1b, s2b, bms, bns, sc, BAND)
    bgeom = (got[0].M, got[0].N)
    got = (torch.cat([g.score for g in got]), torch.cat([g.dirs for g in got]))
    k11_batch = cuda_ms(lambda: gb.walk_banded_batch(got[1], bms, bns, BAND, geom=bgeom), 3)
    a11[f"{BATCH_B} x 29,903 bp batch"] = k11_alone(torch, gb, got[1], bms, bns, BAND, bgeom,
                                                     cuda_ms)
    want, k12_plain_ms = timed(lambda: gb.gotoh_banded_plain(s1b, s2b, bms, bns, sc, BAND,
                                                             gbb.COUNTS))
    err = band_err(got, want, bms, bns, BAND)
    k12_err = max(k12_err, err)
    check(err == 0, f"K12 at {BATCH_B} x {BATCH_LEN} bp != plain: max |err| {err}")
    del got, want, dirs_big
    cells_big, cells29 = float(m) * BAND, float(BATCH_LEN) * BAND
    cells12 = float(np.sum(bms)) * BAND
    k10_bound = bound(BATCH_LEN + len(p29) + cells29 / 4 + 4, cells29 * OPS_PER_BAND_CELL, rate)
    k10_bound_big = bound(m + n + cells_big / 4 + 4, cells_big * OPS_PER_BAND_CELL, rate)
    k12_bound = bound(float(np.sum(bms + bns)) + cells12 / 4 + 4 * BATCH_B,
                      cells12 * OPS_PER_BAND_CELL, rate)
    w29 = banded_words(want29, BATCH_LEN, len(p29), BAND)
    k11_bound = bound(4 * w29 + 4 * BATCH_LEN + len(want29) / 4, OPS_PER_MOVE * len(want29), rate)
    print(f"[phase 18] card {card} | K10 {m} x {n} at V = {BAND} ({cells_big:.4g} band cells): "
          f"[{fmt(k10_big)}] ms = {cells_big / med(k10_big) * 1e3:.4g} band cells/s "
          f"({med(k10_big) * 1e6 / m:.1f} ns a row; bound {k10_bound_big[0]:.4f} ms by "
          f"{k10_bound_big[1]}) | K10 {BATCH_LEN} bp: [{fmt(k10_29)}] ms (plain "
          f"{k10_plain_ms:.1f} ms, bound {k10_bound[0]:.4f} ms by {k10_bound[1]}) | K11 "
          f"{len(moves_big)} moves at 1 Mb: [{fmt(k11_big)}] ms = "
          f"{med(k11_big) * 1e6 / len(moves_big):.1f} ns a move (in {n_chunks} launches of "
          f"{gb.MAX_STEPS_CAP} moves [{fmt(chunked)}] ms: {(med(chunked) - med(k11_big)) / max(n_chunks - 1, 1):.3f} "
          f"ms of host a launch more); self walk [{fmt(k11_self)}] ms; {len(want29)} moves at "
          f"29,903 bp reading {w29} words: [{fmt(k11_29)}] ms (plain {k11_plain_ms:.1f} ms, bound "
          f"{k11_bound[0]:.6f} ms by {k11_bound[1]}, chain floor {chain_floor(len(want29))}); "
          f"batch of {BATCH_B} walks in one launch [{fmt(k11_batch)}] ms; K11 alone "
          + ", ".join(f"{k} [{fmt(v)}] ms" for k, v in a11.items())
          + f" (1 Mb: {med(a11['1 Mb planted']) * 1e6 / len(moves_big):.2f} ns a move) | K12 {BATCH_B} x {BATCH_LEN} bp "
          f"({cells12:.4g} band cells): [{fmt(k12)}] ms (plain {k12_plain_ms:.1f} ms, bound "
          f"{k12_bound[0]:.4f} ms by {k12_bound[1]}) | plain on phase 15's fills: "
          f"{k10_plain_ms:.1f} ms at 29,903 bp, "
          f"{', '.join(f'{wide_plain_ms[V]:.1f} ms at V = {V}' for V, _, _ in WIDE_FILLS)}; "
          f"K11 plain at 1 Mb {k11_plain_big_ms:.1f} ms | walls: "
          f"align_banded 1 Mb self {t_self:.3f} s, planted {t_planted:.3f} s, CLI align --band "
          f"{t_cli:.3f} s, banded_align_batch {t_batch:.3f} s", flush=True)
    return [
        {"name": "gotoh_banded", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_banded.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_banded.py:263",
         "launches": launches["gotoh_banded"], "max_abs_err": float(k10_err),
         "ms": med(k10_29), "plain_ms": float(k10_plain_ms),
         "bound_ms": k10_bound[0], "bound_by": k10_bound[1], "library_ms": None},
        {"name": "walk_banded", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/traceback_walk.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_banded.py:624",
         "launches": launches["walk_banded"], "max_abs_err": float(k11_err),
         "ms": med(k11_29), "plain_ms": float(k11_plain_ms),
         "bound_ms": k11_bound[0], "bound_by": k11_bound[1], "library_ms": None},
        {"name": "gotoh_banded_batch", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_banded.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_banded_batch.py:203",
         "launches": launches["gotoh_banded_batch"], "max_abs_err": float(k12_err),
         "ms": med(k12), "plain_ms": float(k12_plain_ms),
         "bound_ms": k12_bound[0], "bound_by": k12_bound[1], "library_ms": None},
    ]



#: The protein path at the sizes of bench.py's protein rows (copied, not
#: imported; one default_rng(17) stream in bench.py's order):
#: protein_blosum_batch, 1,024 pairs of 192-384 aa padded to 384;
#: protein_stream_batch, 32,768 pairs of 383 aa; protein_align_batch, its
#: first 256 pairs; protein_msa, 16 point-mutated copies of a 400 aa base.
#: BLOSUM62 at NCBI BLASTP's gap defaults (existence 11, extension 1).
PROT_B, PROT_L = 1_024, 384
PROT_STREAM_B, PROT_STREAM_L, PROT_ALIGN_B = 32_768, 383, 256
PROT_MSA_N, PROT_MSA_L = 16, 400
PROT_G, PROT_H = -1, -11
#: the CLI's protein corpora: a directory of PROT_DIR_N seeded proteins of
#: PROT_DIR_MIN..PROT_DIR_MAX aa (32,896 pairs i <= j) and a
#: PROT_FAM_N-protein family (mutated copies of a PROT_FAM_L aa base,
#: substitutions and indels); ``msa``'s DNA corpus, DNA_MSA_N copies of a
#: DNA_MSA_L bp base.
PROT_DIR_N, PROT_DIR_MIN, PROT_DIR_MAX = 256, 100, 1_000
PROT_FAM_N, PROT_FAM_L = 32, 400
DNA_MSA_N, DNA_MSA_L = 24, 1_500
#: oracle checks of phase 21: sampled pairs per (batch, mode), 4 x 128.
PROT_ORACLE_PER = 128
#: phase 19's K15 tail shapes, (B, Ln, n_p per pair): rows of every
#: alignment (Ln % 8 != 0), n_p inside a 16-byte chunk and at a chunk's
#: edge, n_p = 0, B = 1, rows shorter than a chunk, two column tiles of
#: 2,048 and a tail.
PROFILE_TAILS = ((5, 383, (383, 0, 200, 17, 1)), (1, 384, (384,)), (3, 7, (7, 3, 0)),
                 (6, 9, (9, 8, 1, 0, 2, 5)), (3, 16, (16, 15, 9)), (2, 4101, (4101, 4096)))
#: integer ops per interior cell of the matrix recurrence
#: (csrc/gotoh_stream_body.cuh under the profile substitution): I 3 (two
#: adds, max), S 1 (add the profile value), Q 1, M 1, A 3 (two adds, max),
#: P 1; local adds three zero floors and the argmax update (compare, three
#: selects); dirs the code chain (three compares, three selects) and its
#: packing (shift, or, flush test).
OPS_PER_MATRIX_CELL = {"global": 10, "local": 17, "dirs": 9}


def protein_bench_data() -> dict:
    """bench.py's protein rows' data (bench.py:349-360, 394-399, 465-473,
    497-505), drawn in its order from one default_rng(17)."""
    prng = np.random.default_rng(17)
    aa20 = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    pms = prng.integers(PROT_L // 2, PROT_L + 1, PROT_B).astype(np.int32)
    pns = prng.integers(PROT_L // 2, PROT_L + 1, PROT_B).astype(np.int32)
    p1 = np.full((PROT_B, PROT_L), 0xFE, np.uint8)
    p2 = np.full((PROT_B, PROT_L), 0xFF, np.uint8)
    for i in range(PROT_B):
        p1[i, : pms[i]] = aa20[prng.integers(0, 20, pms[i])]
        p2[i, : pns[i]] = aa20[prng.integers(0, 20, pns[i])]
    shape = (PROT_STREAM_B, PROT_STREAM_L)
    u1 = aa20[prng.integers(0, 20, shape)].astype(np.uint8)
    u2 = aa20[prng.integers(0, 20, shape)].astype(np.uint8)
    base = aa20[prng.integers(0, 20, PROT_MSA_L)]
    msa = []
    for k in range(PROT_MSA_N):
        mut = base.copy()
        for _ in range(20):
            mut[prng.integers(0, PROT_MSA_L)] = aa20[prng.integers(0, 20)]
        msa.append((f"prot{k}", bytes(mut).decode()))
    return dict(p1=p1, p2=p2, pms=pms, pns=pns, u1=u1, u2=u2, msa=msa)


def protein_family(rng, n: int, length: int) -> list[tuple[str, str]]:
    """Mutated copies of one random protein: ~8% substitutions and 0-3
    indels of 1-5 aa each."""
    aa = list("ARNDCQEGHILKMFPSTWYV")
    base = "".join(rng.choice(aa, length))
    out = []
    for k in range(n):
        s = list(base)
        for p in rng.integers(0, length, length // 12):
            s[p] = str(rng.choice(aa))
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(s) - 8))
            if rng.random() < 0.5:
                del s[p : p + int(rng.integers(1, 6))]
            else:
                s[p:p] = list(rng.choice(aa, int(rng.integers(1, 6))))
        out.append((f"fam{k} len={len(s)}", "".join(s)))
    return out


class FillLaunchRecorder:
    """Record every launch of K3 and the matrix fill until ``stop()``: its
    device time (CUDA events around the launch itself, read later), pairs,
    padded shape, true cells and characters, mode, codes and route. The
    launches still count where they count."""

    def __init__(self, torch, gm, gs):
        from genomics_rs_tpu_torch.ops import gotoh_pallas as gp

        self.rows, self._pending, ctx = [], [], {}
        self._undo = [(gm, "run_matrix", gm.run_matrix), (gs, "run_stream", gs.run_stream),
                      (gp, "launch_groups", gp.launch_groups)]
        real_matrix, real_stream, real_groups = (x[2] for x in self._undo)

        def run_matrix(lib, code1, prof, ms_h, ns_h, g, h, is_local, emit_dirs, route, *a):
            ctx.update(route=route, local=is_local, dirs=emit_dirs, Lm=code1.shape[1],
                       Ln=prof.shape[2])
            return real_matrix(lib, code1, prof, ms_h, ns_h, g, h, is_local, emit_dirs, route, *a)

        def run_stream(lib, s1eb, s2eb, ms_h, ns_h, scores, is_local, emit_dirs, *a):
            ctx.update(route="stream", local=is_local, dirs=emit_dirs, Lm=s1eb.shape[1],
                       Ln=s2eb.shape[1])
            return real_stream(lib, s1eb, s2eb, ms_h, ns_h, scores, is_local, emit_dirs, *a)

        def launch_groups(launch, ms_h, ns_h, Ln, rows, resident, dev, counts, what):
            if what not in ("gotoh_matrix", "gotoh_stream", "gotoh_stream8"):
                return real_groups(launch, ms_h, ns_h, Ln, rows, resident, dev, counts, what)

            def timed_launch(lo, hi, *rest):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                out = launch(lo, hi, *rest)
                e1.record()
                m = np.asarray(ms_h[lo:hi], np.float64)
                n = np.asarray(ns_h[lo:hi], np.float64)
                self._pending.append((e0, e1, dict(
                    ctx, what=what, B=hi - lo, rows=rows, cells=float(np.sum(m * n)),
                    chars=float(np.sum(m + n)))))
                return out

            return real_groups(timed_launch, ms_h, ns_h, Ln, rows, resident, dev, counts, what)

        gm.run_matrix, gs.run_stream, gp.launch_groups = run_matrix, run_stream, launch_groups

    def stop(self) -> None:
        """Put the wrappers back and read the events."""
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        for e0, e1, row in self._pending:
            e1.synchronize()
            self.rows.append(dict(row, ms=e0.elapsed_time(e1)))
        self._pending.clear()


class CallRecorder:
    """Time every call of ``mod.name`` until ``stop()`` by CUDA events
    around it (the wrapper: its host work and its launches), keeping
    ``info(*args)`` beside each."""

    def __init__(self, torch, mod, name, info):
        self.rows, self._pending = [], []
        real = getattr(mod, name)
        self._undo = (mod, name, real)

        def timed_call(*args, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = real(*args, **kw)
            e1.record()
            self._pending.append((e0, e1, info(*args)))
            return out

        setattr(mod, name, timed_call)

    def stop(self) -> None:
        """Put the wrapper back and read the events."""
        setattr(*self._undo)
        for e0, e1, row in self._pending:
            e1.synchronize()
            self.rows.append(dict(row, ms=e0.elapsed_time(e1)))
        self._pending.clear()


def protein_phases(torch, dev, card, cuda_ms, codes_at, rate) -> list[dict]:
    """Phases 19-22: the protein path (``--matrix``) and ``msa`` on the
    query-profile kernel (K15) and the matrix fill (K13/K14). Returns their
    rows of the summary line."""
    from collections import Counter

    from genomics_rs_tpu_torch import cli, native
    from genomics_rs_tpu_torch.comparison.driver import load_fasta_dir
    from genomics_rs_tpu_torch.config import Scores
    from genomics_rs_tpu_torch.display.alignment import format_aligned_sequences
    from genomics_rs_tpu_torch.models import aligner as aligner_mod
    from genomics_rs_tpu_torch.models.aligner import PairwiseAligner, matrix_align_batch
    from genomics_rs_tpu_torch.models.msa import center_star_msa, format_msa_clustal
    from genomics_rs_tpu_torch.ops import _build
    from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
    from genomics_rs_tpu_torch.ops import gotoh_matrix_stream as gms
    from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
    from genomics_rs_tpu_torch.ops import gotoh_stream as gs
    from genomics_rs_tpu_torch.ops import subst
    from genomics_rs_tpu_torch.ops import traceback_batch as tb
    from genomics_rs_tpu_torch.ops import traceback_device as td
    from genomics_rs_tpu_torch.ops import traceback_walker as tw
    from genomics_rs_tpu_torch.ops.traceback import classify_moves, classify_moves_batch
    from genomics_rs_tpu_torch.parallel.allpairs import allpairs_matrix_scores
    from genomics_rs_tpu_torch.sequence import (
        PAD_S1,
        PAD_S2,
        Sequence,
        SequenceContainer,
        round_up,
    )

    med = lambda ts: float(np.median(ts))  # noqa: E731
    fmt = lambda ts: ", ".join(f"{t:.3f}" for t in ts)  # noqa: E731
    b62 = subst.blosum62()
    psc = Scores(0, 0, PROT_G, PROT_H)
    counted = (gm, gs, gsr, tw, td, tb)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def on_card(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)

    def fill_err(got, want, ms, ns) -> int:
        """Max |difference| of scores and start cells, and of the codes at
        every true cell when both fills have dirs."""
        errs = [int((g.long().cpu() - w.long().cpu()).abs().max()) if g.numel() else 0
                for g, w in zip(got[:3], want[:3])]
        if want.dirs is not None:
            for p in range(len(ms)):
                d = (codes_at(got.dirs[p], int(ms[p]), int(ns[p]))
                     - codes_at(want.dirs[p].to(dev), int(ms[p]), int(ns[p])))
                errs.append(int(d.abs().max()))
        return max(errs)

    def fill_both(s1, s2, ms, ns, mx, is_local, emit_dirs, g=PROT_G, h=PROT_H):
        """The fill kernel and its plain version on the same inputs (the
        plain fill on the card); returns (kernel, plain, plain ms)."""
        code1 = gm.row_codes(s1, mx)
        prof = gm.matrix_profile_plain(s2, ns, mx)
        got = gm.matrix_fill(code1, prof, ms, ns, g, h, is_local, emit_dirs)
        want, ms_plain = timed(lambda: gm.matrix_fill_plain(code1, prof, ms, ns, g, h,
                                                            is_local, emit_dirs))
        return got, want, ms_plain

    def fields(a):
        return (a.score, a.alignment, a.matches, a.mismatches, a.opening_gaps,
                a.gap_extensions)

    t_data = time.perf_counter()
    data = protein_bench_data()
    t_data = time.perf_counter() - t_data

    # ---- phase 19: K15 (the query profile) kernel vs plain ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1919)
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    mats = {"blosum62": b62,
            "asymmetric": subst.SubstMatrix(aa.tobytes().decode(), rng.integers(-6, 9, (20, 20))),
            "near200": subst.SubstMatrix(aa.tobytes().decode(), rng.integers(-200, 201, (20, 20))),
            "no X": subst.dna_matrix(Scores(2, -3, -2, -4))}
    small = {}
    for kind, mx in mats.items():
        letters = np.frombuffer(b"ACGT", np.uint8) if kind == "no X" else aa
        ms = np.array([300, 0, 17, 250, 383])
        ns = np.array([280, 40, 0, 260, 383])
        s1 = letters[rng.integers(0, len(letters), (5, 384))].astype(np.uint8)
        s2 = letters[rng.integers(0, len(letters), (5, 384))].astype(np.uint8)
        s1[0, :4] = np.frombuffer(b"acUO", np.uint8)  # unknown bytes
        s2[3, 5:8] = np.frombuffer(b"xu*", np.uint8)
        small[kind] = (*on_card(s1, s2), ms, ns)
    k15_err = 0
    for kind, mx in mats.items():
        _, s2, _, ns = small[kind]
        got = gm.matrix_profile(s2, ns, mx)
        err = int((got.int() - gm.matrix_profile_plain(s2, ns, mx).int()).abs().max())
        k15_err = max(k15_err, err)
        check(err == 0, f"K15 kernel != plain ({kind}): max |err| {err}")
    n_tails = 0
    for B, Ln, ns in PROFILE_TAILS:
        s2 = rng.integers(0, 256, (B, Ln)).astype(np.uint8)
        s2[:, : Ln // 2] = aa[rng.integers(0, 20, (B, Ln // 2))]
        (s2,) = on_card(s2)
        for kind, mx in mats.items():
            got = gm.matrix_profile(s2, np.array(ns), mx)
            err = int((got.int() - gm.matrix_profile_plain(s2, np.array(ns), mx).int()).abs().max())
            k15_err = max(k15_err, err)
            n_tails += 1
            check(err == 0, f"K15 kernel != plain at {B} x {Ln} ({kind}): max |err| {err}")
    u1, u2 = on_card(data["u1"], data["u2"])
    uns = np.full(PROT_STREAM_B, PROT_STREAM_L)
    prof_big = gm.matrix_profile(u2, uns, b62)
    want, k15_plain_ms = timed(lambda: gm.matrix_profile_plain(u2, uns, b62))
    err = int((prof_big != want).sum())
    k15_err = max(k15_err, err)
    check(err == 0, f"K15 kernel != plain on the {PROT_STREAM_B} x {PROT_STREAM_L} batch: "
                    f"{err} entries differ")
    del want
    print(f"[phase 19] K15 (query profile) kernel == plain on {len(mats)} small mixed batches "
          f"(BLOSUM62, asymmetric, |v| near 200, no X; zero lengths, unknown bytes), on "
          f"{n_tails} tail batches (B x Ln: "
          + ", ".join(f"{b} x {ln}" for b, ln, _ in PROFILE_TAILS)
          + "; n_p inside a chunk, at its edge and 0; every matrix) and on "
          f"every entry of the {PROT_STREAM_B} x {PROT_STREAM_L} aa batch's profile "
          f"({prof_big.numel() * 2 / 1e6:.0f} MB; plain {k15_plain_ms:.1f} ms); max |err| "
          f"{k15_err} ({t_data:.1f} s to make the data, {time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # ---- phase 20: the matrix fill kernel vs plain ----
    t_phase = time.perf_counter()
    fill_errs, n_small = [0], 0
    for kind, mx in mats.items():
        s1, s2, ms, ns = small[kind]
        for is_local in (False, True):
            for sel in (slice(0, 4), slice(4, 5)):  # zero lengths; B = 1
                got, want, _ = fill_both(s1[sel], s2[sel], ms[sel], ns[sel], mx, is_local, True)
                err = fill_err(got, want, ms[sel], ns[sel])
                fill_errs.append(err)
                n_small += 1
                check(err == 0, f"matrix fill kernel != plain ({kind}, local={is_local}, "
                                f"B={len(ms[sel])}): max |err| {err}")
    a1, a2 = u1[:PROT_ALIGN_B], u2[:PROT_ALIGN_B]
    ams = np.full(PROT_ALIGN_B, PROT_STREAM_L)
    plain_ms = {}
    for is_local in (False, True):
        got, want, plain_ms[is_local] = fill_both(a1, a2, ams, ams, b62, is_local, True)
        err = fill_err(got, want, ams, ams)
        fill_errs.append(err)
        check(err == 0, f"matrix fill kernel != plain on {PROT_ALIGN_B} x {PROT_STREAM_L} aa "
                        f"(local={is_local}, dirs): max |err| {err}")
    _, _, plain_ms["scores"] = fill_both(a1, a2, ams, ams, b62, False, False)
    del got, want
    drng = np.random.default_rng(2020)
    dbase = random_dna(drng, 900)
    dpairs = [(dbase[:800], mutate(drng, dbase[50:850], 0.05, 3)), ("", dbase[:40]),
              (dbase[:700], mutate(drng, dbase[:760], 0.05, 2))]
    d1 = np.stack([Sequence("a", a).encoded(896, PAD_S1) for a, _ in dpairs])
    d2 = np.stack([Sequence("b", b).encoded(896, PAD_S2) for _, b in dpairs])
    dms = np.array([len(a) for a, _ in dpairs])
    dns = np.array([len(b) for _, b in dpairs])
    d1, d2 = on_card(d1, d2)
    for is_local in (False, True):
        for st in (None, -1):
            sck = Scores(2, -3, -2, -4, st)
            want = gs.gotoh_stream_plain(d1, d2, dms, dns, sck, is_local, emit_dirs=True)
            got = gm.gotoh_matrix_fill(d1, d2, dms, dns, subst.dna_matrix(sck), sck.g, sck.h,
                                       is_local, emit_dirs=True)
            err = fill_err(got, want, dms, dns)
            fill_errs.append(err)
            check(err == 0, f"dna_matrix bridge != K3's plain version (local={is_local}, "
                            f"st={st}): {err}")
    # Every compiled strip height on 3 blocks, on the 383-aa pairs and the
    # zero-length batch, with dirs.
    for rows in K3_ROWS:
        for is_local in (False, True):
            for s1, s2, ms, ns in ((a1[:16], a2[:16], ams[:16], ams[:16]), small["blosum62"]):
                code1, prof = gm.row_codes(s1, b62), gm.matrix_profile_plain(s2, ns, b62)
                got = gm._matrix_cuda(code1, prof, ms, ns, PROT_G, PROT_H, is_local, True,
                                      "stream", rows, 3)
                want = gm.matrix_fill_plain(code1, prof, ms, ns, PROT_G, PROT_H, is_local, True)
                err = max(fill_err(got, want, ms, ns), int(got.err))
                fill_errs.append(err)
                n_small += 1
                check(err == 0, f"matrix fill at {rows} rows a strip (3 blocks) != plain "
                                f"(local={is_local}): max |err| {err}")
    fill_err_max = max(fill_errs)
    print(f"[phase 20] matrix fill kernel == plain on {n_small} small fills ({len(mats)} "
          f"matrices, global/local, zero lengths, B = 1, codes at every true cell) and on "
          f"{PROT_ALIGN_B} x {PROT_STREAM_L} aa global and local with dirs (plain "
          f"{plain_ms[False]:.0f} / {plain_ms[True]:.0f} ms), at every strip height "
          f"({', '.join(map(str, K3_ROWS))} rows, 3 blocks); the dna_matrix bridge == K3's "
          f"plain version (classic/kimura, global/local, dirs); max |err| {fill_err_max} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 21: the protein path at real size ----
    t_phase = time.perf_counter()
    os.environ["LOG_LEVEL"] = "WARNING"
    for mod in counted:
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0
    walls = {}
    fill_launches = FillLaunchRecorder(torch, gm, gs)
    profile_calls = CallRecorder(torch, gm, "_profile_cuda", lambda s2eb, ns, mx, *a: dict(
        B=s2eb.shape[0], Ln=s2eb.shape[1], A=int(gm._ext_matrix(mx).shape[0])))
    p1, p2 = on_card(data["p1"], data["p2"])
    pms, pns = data["pms"], data["pns"]
    results = {}
    for is_local in (False, True):
        t0 = time.perf_counter()
        results["batch", is_local] = [x.cpu().numpy() for x in gm.gotoh_scores_matrix(
            p1, p2, pms, pns, b62, PROT_G, PROT_H, is_local)]
        walls[f"blosum_batch_{'local' if is_local else 'global'}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results["stream", is_local] = [x.cpu().numpy() for x in gm.gotoh_scores_matrix(
            u1, u2, uns, uns, b62, PROT_G, PROT_H, is_local)]
        walls[f"stream_batch_{'local' if is_local else 'global'}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg = [x.cpu().numpy() for x in gm.gotoh_scores_matrix(
        u1[:PROT_B], u2[:PROT_B], uns[:PROT_B], uns[:PROT_B], b62, PROT_G, PROT_H,
        engine="pallas")]
    walls["pallas_route"] = time.perf_counter() - t0
    apairs = [(Sequence(f"a{i}", data["u1"][i].tobytes().decode()),
               Sequence(f"b{i}", data["u2"][i].tobytes().decode())) for i in range(PROT_ALIGN_B)]
    # matrix_align_batch in both modes, each group's classification step
    # (``_classify_group``: the end-of-walk check, then the classifier)
    # recorded with its walked moves and timed inside the run.
    alns, classified = {}, {}
    real_classify = aligner_mod._classify_group
    for is_local in (False, True):
        rec = classified[is_local] = []

        def record_classify(chunk, walked, *args, rec=rec, **kw):
            t0 = time.perf_counter()
            got = real_classify(chunk, walked, *args, **kw)
            rec.append((chunk, walked, time.perf_counter() - t0, got))
            return got

        aligner_mod._classify_group = record_classify
        try:
            t0 = time.perf_counter()
            alns[is_local] = matrix_align_batch(apairs, b62, PROT_G, PROT_H, is_local=is_local)
            walls[f"matrix_align_batch {'local' if is_local else 'global'}"] = (
                time.perf_counter() - t0)
        finally:
            aligner_mod._classify_group = real_classify
    three = [0, PROT_ALIGN_B // 2, PROT_ALIGN_B - 1]
    one = PairwiseAligner(psc, device="cuda", matrix=b62)
    t0 = time.perf_counter()
    per_pair = [one.align(*apairs[t]) for t in three]
    walls["aligner_3"] = time.perf_counter() - t0

    crng = np.random.default_rng(2121)
    lens = crng.integers(PROT_DIR_MIN, PROT_DIR_MAX + 1, PROT_DIR_N)
    dir_prots = [(f"p{k} len={L}", "".join(crng.choice(list("ARNDCQEGHILKMFPSTWYV"), L)))
                 for k, L in enumerate(lens)]
    family = protein_family(crng, PROT_FAM_N, PROT_FAM_L)
    dna_base = random_dna(crng, DNA_MSA_L)
    dna_msa = [(f"d{k}", mutate(crng, dna_base, 0.03, 2)) for k in range(DNA_MSA_N)]
    stdout = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "config.toml")
        with open(cfg, "w") as f:
            f.write(f"[scores]\ns_match = 2\ns_mismatch = -3\ng = {PROT_G}\nh = {PROT_H}\n")
        pair_fa = os.path.join(tmp, "pair.fasta")
        with open(pair_fa, "w") as f:
            f.write(f">a0\n{apairs[0][0].sequence}\n>b0\n{apairs[0][1].sequence}\n")
        pdir, fdir = os.path.join(tmp, "prots"), os.path.join(tmp, "family")
        write_fasta_dir(pdir, dir_prots)
        write_fasta_dir(fdir, family)
        msa_fa, dna_fa = os.path.join(tmp, "msa.fasta"), os.path.join(tmp, "dna.fasta")
        with open(msa_fa, "w") as f:
            f.write("".join(f">{n}\n{s}\n" for n, s in data["msa"]))
        with open(dna_fa, "w") as f:
            f.write("".join(f">{n}\n{s}\n" for n, s in dna_msa))
        runs = {
            "align": ["align", "-a", "global", "-f", pair_fa, "--matrix", "BLOSUM62"],
            "align-matrix": ["align-matrix", "-f", pdir, "--matrix", "BLOSUM62",
                             "-o", os.path.join(tmp, "prots.tsv")],
            "align-matrix --alignments-out": [
                "align-matrix", "-f", fdir, "--matrix", "BLOSUM62",
                "-o", os.path.join(tmp, "family.tsv"), "--alignments-out",
                os.path.join(tmp, "family_aln")],
            "msa --matrix": ["msa", "-f", msa_fa, "--matrix", "BLOSUM62"],
            "msa": ["msa", "-f", dna_fa],
        }
        for name, argv in runs.items():
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["-c", cfg, *argv])
            torch.cuda.synchronize()
            walls[f"cli {name}"] = time.perf_counter() - t0
            check(rc == 0, f"the CLI {name} exited {rc}")
            stdout[name] = out.getvalue()
        fill_launches.stop()
        profile_calls.stop()
        launches = {k: v for k, v in gm.COUNTS.items() if k.endswith("kernel")}
        launches.update(walk_many=tw.COUNTS["many_kernel"], traceback_walk=tw.COUNTS["kernel"],
                        gotoh_stream=gs.COUNTS["kernel"])
        check(sum(1 for r in fill_launches.rows if r["what"] == "gotoh_matrix")
              == launches["pallas_kernel"] + launches["stream_kernel"],
              "the recorder missed a matrix fill launch")
        check(len(profile_calls.rows) == launches["profile_kernel"],
              "the recorder missed a profile launch")
        plain = (sum(v for k, v in gm.COUNTS.items() if k.endswith("plain"))
                 + gs.COUNTS["plain"] + gsr.COUNTS["plain"] + tw.COUNTS["many_plain"]
                 + td.COUNTS["plain"] + tb.COUNTS["plain"])
        t_path = time.perf_counter() - t_phase
        check(all(v > 0 for v in launches.values()) and plain == 0,
              f"the protein path: launches {launches}, plain calls {plain}")

        # What came out, held against the oracle and the library.
        with open(os.path.join(tmp, "prots.tsv")) as f:
            prow = [ln.split("\t") for ln in f.read().splitlines()[1:]]
        with open(os.path.join(tmp, "family.tsv")) as f:
            frow = [ln.split("\t") for ln in f.read().splitlines()[1:]]
        fam_files = {n: open(os.path.join(tmp, "family_aln", n)).read()
                     for n in os.listdir(os.path.join(tmp, "family_aln"))}
        pseqs = load_fasta_dir(pdir).sequences  # the CLI's order (sorted file names)
        fam = load_fasta_dir(fdir).sequences
    lib = allpairs_matrix_scores(SequenceContainer(list(pseqs)), b62, PROT_G, PROT_H)
    npairs = PROT_DIR_N * (PROT_DIR_N + 1) // 2
    check(all(int(prow[j][1 + i]) == lib.matrix[j, i]
              for j in range(PROT_DIR_N) for i in range(j + 1)),
          "align-matrix --matrix TSV != allpairs_matrix_scores")
    lut = b62.byte_lut()
    samples = []
    srng = np.random.default_rng(2222)
    for key in (("batch", False), ("batch", True), ("stream", False), ("stream", True)):
        B = PROT_B if key[0] == "batch" else PROT_STREAM_B
        for t in srng.choice(B, PROT_ORACLE_PER, replace=False):
            if key[0] == "batch":
                a = data["p1"][t, : data["pms"][t]].tobytes().decode()
                b = data["p2"][t, : data["pns"][t]].tobytes().decode()
            else:
                a, b = data["u1"][t].tobytes().decode(), data["u2"][t].tobytes().decode()
            samples.append((key, int(t), a, b))
    dir_samples = [(int(i), int(j)) for i, j in
                   sorted(srng.choice(PROT_DIR_N, (8, 2)).tolist()) if i <= j]
    with ThreadPoolExecutor(8) as pool:  # ctypes drops the GIL
        oracle = list(pool.map(
            lambda s: native.gotoh_score_cpu_subst(s[2], s[3], lut, PROT_G, PROT_H, s[0][1]),
            samples))
        dir_oracle = list(pool.map(
            lambda ij: native.gotoh_score_cpu_subst(pseqs[ij[0]].sequence, pseqs[ij[1]].sequence,
                                                    lut, PROT_G, PROT_H, False), dir_samples))
    for (key, t, _, _), o in zip(samples, oracle):
        got = tuple(int(x[t]) for x in results[key])
        check(got == o, f"{key} pair {t}: port {got} != oracle {o}")
    for (i, j), o in zip(dir_samples, dir_oracle):
        check(int(prow[j][1 + i]) == o[0], f"align-matrix --matrix ({i}, {j}) != oracle {o}")
    check(all(np.array_equal(a, b) for a, b in zip(seg, [x[:PROT_B] for x in
                                                         results["stream", False]])),
          "the pallas route != the stream route on the first 1,024 pairs")
    for t, ref in zip(three, per_pair):
        check(fields(alns[False][t]) == fields(ref),
              f"matrix_align_batch pair {t} != PairwiseAligner(matrix=)")
    # Every alignment of both modes against per-pair classify_moves of the
    # same walked moves; the classification step alone, batched and per
    # pair, timed on those moves (median of 3).
    classify_line = []
    for is_local in (False, True):
        mode = "local" if is_local else "global"
        rec = classified[is_local]
        check(sum(len(c) for c, *_ in rec) == PROT_ALIGN_B,
              f"matrix_align_batch {mode}: groups {[len(c) for c, *_ in rec]} "
              f"!= its {PROT_ALIGN_B} pairs")
        check([fields(a) for *_, got in rec for a in got] == [fields(a) for a in alns[is_local]],
              f"matrix_align_batch {mode}: the recorded groups != its result")
        t_batch, t_pair = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            by_batch = [a for chunk, w, *_ in rec
                        for a in classify_moves_batch(w[0], w[1], w[6], w[7], w[5], chunk)]
            t_batch.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            by_pair = [classify_moves(w[0][t, : w[1][t]], int(w[6][t]), int(w[7][t]),
                                      int(w[5][t]), a, b)
                       for chunk, w, *_ in rec for t, (a, b) in enumerate(chunk)]
            t_pair.append(time.perf_counter() - t0)
        same = [fields(a) for a in by_pair]
        check([fields(a) for a in alns[is_local]] == same
              and [fields(a) for a in by_batch] == same,
              f"matrix_align_batch {mode}: an alignment != per-pair classify_moves")
        classify_line.append(
            f"{mode} {walls[f'matrix_align_batch {mode}']:.4f} s wall (classification in the run "
            f"{sum(r[2] for r in rec):.4f} s over groups of "
            f"{', '.join(str(len(r[0])) for r in rec)}; alone: batched {med(t_batch):.4f} s, "
            f"per pair {med(t_pair):.4f} s)")
    print(f"[phase 21] card {card} | matrix_align_batch of {PROT_ALIGN_B} x {PROT_STREAM_L} aa: "
          + "; ".join(classify_line) + f"; all {PROT_ALIGN_B} x 2 alignments == per-pair "
          f"classify_moves of the same walked moves", flush=True)
    check(stdout["align"].splitlines()[-6:]
          == format_aligned_sequences(per_pair[0]).splitlines()[-6:],
          "align --matrix's stats != the library's")
    fam_lib = allpairs_matrix_scores(SequenceContainer(list(fam)), b62, PROT_G, PROT_H)
    check(all(int(frow[j][1 + i]) == fam_lib.matrix[j, i]
              for j in range(PROT_FAM_N) for i in range(j + 1)),
          "the family's TSV != allpairs_matrix_scores")
    check(len(fam_files) == PROT_FAM_N * (PROT_FAM_N - 1) // 2,
          f"--alignments-out wrote {len(fam_files)} files")
    for i, j in ((0, 1), (3, PROT_FAM_N // 2 + 1), (PROT_FAM_N - 2, PROT_FAM_N - 1)):
        ref = one.align(fam[i], fam[j])
        name, text = cli.pair_alignment_fasta(i, j, fam[i], fam[j], ref, False)
        check(fam_files.get(name) == text, f"--alignments-out {name} != the per-pair aligner's")
    msa_checks = []
    for name, corpus, mx, sc_msa in (("msa --matrix", data["msa"], b62, psc),
                                     ("msa", dna_msa, None, Scores(2, -3, PROT_G, PROT_H))):
        res = center_star_msa(SequenceContainer([Sequence(n, s) for n, s in corpus]), sc_msa,
                              matrix=mx)
        check(all(r.replace("-", "") == s for r, (_, s) in zip(res.rows, corpus))
              and len({len(r) for r in res.rows}) == 1,
              f"{name}: a row does not spell its sequence")
        full = res.score_matrix + res.score_matrix.T
        np.fill_diagonal(full, 0)
        check(res.center_index == int(np.argmax(full.sum(axis=1))),
              f"{name}: the center is not the argmax of the summed scores")
        check(format_msa_clustal(res) in stdout[name], f"{name}: the CLI's alignment != the library's")
        msa_checks.append(f"{name}: {len(corpus)} rows of width {res.width}, center "
                          f"{res.names[res.center_index]}")
    # K15's launches on the path, each timed through its wrapper, against
    # their bounds (bytes: s2 in, A rows of int16 out).
    k15_path = [(r["ms"], bound(float(r["B"]) * r["Ln"] * (1 + 2 * r["A"]), 0.0, rate)[0], r)
                for r in profile_calls.rows]
    k15_shapes = Counter((r["B"], r["Ln"], r["A"]) for _, _, r in k15_path)
    print(f"[phase 21] card {card} | K15 on the path: {len(k15_path)} launches through the "
          f"wrapper, {sum(t for t, _, _ in k15_path):.3f} ms against a bound of "
          f"{sum(b for _, b, _ in k15_path):.4f} ms: launches x (time - bound) "
          f"{sum(t - b for t, b, _ in k15_path):.3f} ms; (B, Ln, A) x count "
          + ", ".join(f"{k} x {c}" for k, c in k15_shapes.most_common(6)), flush=True)
    print(f"[phase 21] protein path on cuda ({t_path:.1f} s): gotoh_scores_matrix on the "
          f"{PROT_B} x {PROT_L // 2}-{PROT_L} aa batch ({walls['blosum_batch_global']:.3f} / "
          f"{walls['blosum_batch_local']:.3f} s global / local) and the {PROT_STREAM_B} x "
          f"{PROT_STREAM_L} aa batch ({walls['stream_batch_global']:.3f} / "
          f"{walls['stream_batch_local']:.3f} s, grouped), {len(samples)} sampled scores and "
          f"starts == C++ oracle; the pallas route on {PROT_B} pairs == the stream route "
          f"({walls['pallas_route']:.3f} s); matrix_align_batch of {PROT_ALIGN_B} x "
          f"{PROT_STREAM_L} aa ({walls['matrix_align_batch global']:.3f} / "
          f"{walls['matrix_align_batch local']:.3f} s global / local), 3 pairs == "
          f"PairwiseAligner(matrix=); CLI: align --matrix stats == the library's "
          f"({walls['cli align']:.3f} s), align-matrix --matrix on {PROT_DIR_N} proteins of "
          f"{lens.min()}-{lens.max()} aa ({npairs} pairs, {walls['cli align-matrix']:.3f} s): "
          f"TSV == allpairs_matrix_scores, {len(dir_samples)} == oracle; --alignments-out on "
          f"the {PROT_FAM_N}-protein family ({walls['cli align-matrix --alignments-out']:.3f} "
          f"s): 3 files == per-pair aligner; {'; '.join(msa_checks)} (msa --matrix "
          f"{walls['cli msa --matrix']:.3f} s, msa {walls['cli msa']:.3f} s); launches "
          f"{launches}, plain calls {plain} ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # Replay: the 256-pair alignment group's dirs fill, walked by K4 and by
    # the plain walker on the same bitmap.
    La = round_up(PROT_STREAM_L, 128)  # matrix_align_batch's padding and walk buffer
    s1a = torch.from_numpy(np.stack([a.encoded(La, PAD_S1) for a, _ in apairs])).to(dev)
    s2a = torch.from_numpy(np.stack([b.encoded(La, PAD_S2) for _, b in apairs])).to(dev)
    res = gms.gotoh_matrix_stream_fill_dirs(s1a, s2a, ams, ams, b62, PROT_G, PROT_H)
    max_steps = round_up(2 * La + 1, 1024)
    flat = res.dirs.view(PROT_ALIGN_B * res.KW, -1)
    wargs = (res.start_i, res.start_j, np.arange(PROT_ALIGN_B) * res.KW, res.KW, max_steps)
    walked = tw.walk_many(flat, *wargs)
    host = flat.cpu()
    want, k4_plain_ms = timed(lambda: tw.walk_many_plain(host, *wargs))
    check(same_walks(walked, want) and all(walked[4]), "K4 != plain on the protein group's walks")
    k4_moves = int(np.sum(walked[1]))
    k4_a = k4_alone(torch, tw, flat, wargs, cuda_ms)

    # ---- phase 22: times ----
    t_phase = time.perf_counter()
    code_u1 = gm.row_codes(u1, b62)
    code_p1 = gm.row_codes(p1, b62)
    prof_p = gm.matrix_profile(p2, pns, b62)
    code_a1, prof_a = code_u1[:PROT_ALIGN_B], prof_big[:PROT_ALIGN_B]
    # K15 at the two shapes: through its wrapper, its launch alone (the raw
    # matrix_profile_launch into a buffer made once), and the one PyTorch
    # call: a (256, A) byte -> profile-column table indexed by the batch's
    # bytes (as int64; uint8 would index as a mask; no zeros past n_p).
    lib_k = _build.library()
    code_t, ext_t = gm._tables(b62, dev)
    tab_t = ext_t[:, code_t].T.to(torch.int16).contiguous()
    k15_times = {}
    for shape, (s2x, nsx) in ((f"{PROT_STREAM_B} x {PROT_STREAM_L}", (u2, uns)),
                              (f"{PROT_B} x {PROT_L}", (p2, pns))):
        Bx, Lx = s2x.shape
        prof_x = torch.empty((Bx, gm.device_tables(b62, dev)[2].shape[0], Lx), dtype=torch.int16,
                             device=dev)
        ns_x = torch.as_tensor(np.asarray(nsx), dtype=torch.int32).to(dev)
        tab_k = gm.device_tables(b62, dev)[2]
        idx_x = s2x.long()
        alone = cuda_ms(lambda: _build.check(lib_k.matrix_profile_launch(
            _build.ptr(s2x), _build.ptr(ns_x), _build.ptr(tab_k), _build.ptr(prof_x), Bx, Lx,
            tab_k.shape[0], gm.PROFILE_BLOCKS_PER_SM, _build.stream_handle(dev)),
            "matrix_profile"), 5)
        check(torch.equal(prof_x, gm.matrix_profile_plain(s2x, nsx, b62)),
              f"K15's launch alone != plain at {shape}")
        k15_times[shape] = dict(
            wrapper=cuda_ms(lambda: gm.matrix_profile(s2x, nsx, b62), 5), alone=alone,
            library=cuda_ms(lambda: tab_t[idx_x], 5),
            bound=bound(float(Bx) * Lx * (1 + 2 * tab_k.shape[0]), 0.0, rate))
        del prof_x, idx_x
    k15_big = k15_times[f"{PROT_STREAM_B} x {PROT_STREAM_L}"]
    k15_ms, lib_ms = k15_big["wrapper"], k15_big["library"]
    fill_ms = {}
    for is_local in (False, True):
        fill_ms["stream", is_local] = cuda_ms(lambda: gm.matrix_fill(
            code_u1, prof_big, uns, uns, PROT_G, PROT_H, is_local, route="stream"), 5)
        fill_ms["batch", is_local] = cuda_ms(lambda: gm.matrix_fill(
            code_p1, prof_p, pms, pns, PROT_G, PROT_H, is_local), 5)
    fill_ms["dirs"] = cuda_ms(lambda: gm.matrix_fill(
        code_a1, prof_a, ams, ams, PROT_G, PROT_H, False, True, "stream"), 5)
    k4_ms = cuda_ms(lambda: tw.walk_many(flat, *wargs), 3)
    sub_ms = {}
    for is_local in (False, True):
        _, sub_ms[is_local] = timed(lambda: gm.matrix_fill_plain(
            code_a1, prof_a, ams, ams, PROT_G, PROT_H, is_local))
    c_stream = float(PROT_STREAM_B) * PROT_STREAM_L * PROT_STREAM_L
    c_batch = float(np.sum(pms.astype(np.float64) * pns))
    c_align = float(PROT_ALIGN_B) * PROT_STREAM_L * PROT_STREAM_L
    A = prof_big.shape[1]
    k15_bound = k15_big["bound"]

    def fill_bound(B, Lm, Ln, cells, kind, dirs=False):
        nbytes = B * Lm * 4 + B * A * Ln * 2 + 12 * B + (cells / 4 if dirs else 0)
        ops = cells * (OPS_PER_MATRIX_CELL[kind] + (OPS_PER_MATRIX_CELL["dirs"] if dirs else 0))
        return bound(nbytes, ops, rate)

    b_stream = {k: fill_bound(PROT_STREAM_B, PROT_STREAM_L, PROT_STREAM_L, c_stream, k)
                for k in ("global", "local")}
    b_batch = {k: fill_bound(PROT_B, PROT_L, PROT_L, c_batch, k) for k in ("global", "local")}
    b_dirs = fill_bound(PROT_ALIGN_B, PROT_STREAM_L, PROT_STREAM_L, c_align, "global", True)
    k4_words = words_read(tb._unpack(walked[0], np.asarray(walked[1], np.int64), max_steps),
                          walked[1], wargs[0], wargs[1], "diag16")
    k4_bound = bound(4 * k4_words + k4_moves / 4 + 36 * PROT_ALIGN_B, OPS_PER_MOVE * k4_moves,
                     rate)
    rate_of = lambda cells, ts: cells / med(ts) * 1e3  # noqa: E731
    # Every fill launch of phase 21's path, timed where it ran (CUDA events
    # around the launch), against its own bound: launches x (time - bound).
    per_route = {}
    for r in fill_launches.rows:
        key = (r["what"], r["route"])
        if r["what"] == "gotoh_matrix":
            b = fill_bound(r["B"], r["Lm"], r["Ln"], r["cells"],
                           "local" if r["local"] else "global", r["dirs"])
        else:
            b = bound(r["chars"] + 12 * r["B"] + (r["cells"] / 4 if r["dirs"] else 0),
                      r["cells"] * (OPS_PER_CELL["local" if r["local"] else "global"]
                                    + (OPS_PER_CELL["dirs"] if r["dirs"] else 0)), rate)
        agg = per_route.setdefault(key, [0, 0.0, 0.0, Counter()])
        agg[0] += 1
        agg[1] += r["ms"]
        agg[2] += b[0]
        agg[3][(r["B"], r["Lm"], r["Ln"], r["dirs"], r["local"])] += 1
    launch_line = "; ".join(
        f"{what} {route}: {n} launches, {t:.3f} ms against a bound of {bd:.3f} ms "
        f"(launches x (time - bound) {t - bd:.3f} ms; (B, Lm, Ln, dirs, local) x count "
        + ", ".join(f"{k} x {c}" for k, c in shapes.most_common(6)) + ")"
        for (what, route), (n, t, bd, shapes) in sorted(per_route.items()))
    print(f"[phase 22] card {card} | phase 21's fill launches, each timed where it ran: "
          f"{launch_line}", flush=True)
    print(f"[phase 22] card {card} | K15 profile (A = {A}; plain {k15_plain_ms:.3f} ms at "
          f"{PROT_STREAM_B} x {PROT_STREAM_L}): "
          + "; ".join(f"{k}: through the wrapper [{fmt(v['wrapper'])}] ms, its launch alone "
                      f"[{fmt(v['alone'])}] ms, table[s2] [{fmt(v['library'])}] ms, bound "
                      f"{v['bound'][0]:.4f} ms by {v['bound'][1]} (alone at "
                      f"{v['bound'][0] / med(v['alone']):.0%} of it)"
                      for k, v in k15_times.items())
          + f" | fill "
          f"{PROT_STREAM_B} x {PROT_STREAM_L} aa ({c_stream:.4g} cells): global "
          f"[{fmt(fill_ms['stream', False])}] ms = {rate_of(c_stream, fill_ms['stream', False]):.4g} "
          f"cells/s (bound {b_stream['global'][0]:.3f} ms by {b_stream['global'][1]}), local "
          f"[{fmt(fill_ms['stream', True])}] ms = {rate_of(c_stream, fill_ms['stream', True]):.4g} "
          f"cells/s (bound {b_stream['local'][0]:.3f} ms) | fill {PROT_B} x {PROT_L // 2}-{PROT_L} aa "
          f"({c_batch:.4g} cells): global [{fmt(fill_ms['batch', False])}] ms (bound "
          f"{b_batch['global'][0]:.3f} ms), local [{fmt(fill_ms['batch', True])}] ms (bound "
          f"{b_batch['local'][0]:.3f} ms) | fill with dirs {PROT_ALIGN_B} x {PROT_STREAM_L}: "
          f"[{fmt(fill_ms['dirs'])}] ms (bound {b_dirs[0]:.4f} ms by {b_dirs[1]}) | plain fill "
          f"on {PROT_ALIGN_B} pairs: scores global {sub_ms[False]:.1f} ms, local "
          f"{sub_ms[True]:.1f} ms, with dirs {plain_ms[False]:.1f} ms | K4 {PROT_ALIGN_B} "
          f"protein walks, {k4_moves} moves: [{fmt(k4_ms)}] ms (plain {k4_plain_ms:.1f} ms, "
          f"bound {k4_bound[0]:.6f} ms by {k4_bound[1]}, chain floor "
          f"{chain_floor(k4_moves / PROT_ALIGN_B)}; alone [{fmt(k4_a)}] ms = "
          f"{med(k4_a) * 1e6 / max(k4_moves // PROT_ALIGN_B, 1):.1f} ns a move of one walk) "
          f"| walls: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f" ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return [
        {"name": "gotoh_matrix_pallas", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_matrix.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_matrix.py:502",
         "launches": launches["pallas_kernel"], "max_abs_err": float(fill_err_max),
         "ms": med(fill_ms["batch", False]), "plain_ms": float(sub_ms[False]),
         "bound_ms": b_batch["global"][0], "bound_by": b_batch["global"][1],
         "library_ms": None},
        {"name": "gotoh_matrix_stream", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_matrix.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_matrix_stream.py:735",
         "launches": launches["stream_kernel"], "max_abs_err": float(fill_err_max),
         "ms": med(fill_ms["stream", False]), "plain_ms": float(sub_ms[False]),
         "bound_ms": b_stream["global"][0], "bound_by": b_stream["global"][1],
         "library_ms": None},
        {"name": "matrix_profile", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_matrix.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_matrix_stream.py:559",
         "launches": launches["profile_kernel"], "max_abs_err": float(k15_err),
         "ms": med(k15_ms), "plain_ms": float(k15_plain_ms),
         "bound_ms": k15_bound[0], "bound_by": k15_bound[1], "library_ms": med(lib_ms)},
    ]


#: Phase 23's sweep: batch sizes (1 pair up to 4 waves of the 132 SMs) by
#: padded lengths across the segmented tier, lengths drawn from 0.9 L..L.
SWEEP_B, SWEEP_L = (1, 8, 32, 132, 528), (512, 2048, 8192)
#: phase 24's corpus: MID_N seeded random genomes of MID_MIN..MID_MAX bp
#: (MID_N (MID_N + 1) / 2 pairs i <= j), every bucket on K7 or K8; the
#: C++ oracle checks MID_ORACLE sampled pairs in each mode.
MID_N, MID_MIN, MID_MAX, MID_ORACLE = 128, 300, 8_000, 128
#: rows kept of a long input where a kernel is held against its plain
#: version at the path's shape (two strips of 256 rows, every column).
SLICE_ROWS = 300


def strip_phases(torch, dev, card, sc, cuda_ms, rate, main) -> list[dict]:
    """Phases 23-26: the segmented, stream8 and pallas tiers of
    ``score_pairs`` (the warp-strip kernel for K7 and K8, the strip
    pipeline for K9). ``main`` carries phase 4's 29.9 kb pair, its oracle
    score and K1's, and phase 8's TSV. Returns the three kernels' rows of
    the summary line."""
    from collections import Counter

    from genomics_rs_tpu_torch import cli, native
    from genomics_rs_tpu_torch.comparison.driver import load_fasta_dir
    from genomics_rs_tpu_torch.config import Scores
    from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
    from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
    from genomics_rs_tpu_torch.ops import gotoh_segmented as gseg
    from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
    from genomics_rs_tpu_torch.ops import gotoh_stream as gs
    from genomics_rs_tpu_torch.ops import gotoh_stream8 as gs8
    from genomics_rs_tpu_torch.parallel.allpairs import allpairs_scores, bucketize_pairs
    from genomics_rs_tpu_torch.parallel.batch import route_engine, score_pairs
    from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, SequenceContainer, round_up

    acgt = np.frombuffer(b"ACGT", np.uint8)
    med = lambda ts: float(np.median(ts))  # noqa: E731
    fmt = lambda ts: ", ".join(f"{t:.3f}" for t in ts)  # noqa: E731
    routes = {"K7": gseg, "K8": gs8, "K9": gp, "K3": gs, "K6": gsr}
    of_engine = {"segmented": "K7", "stream8": "K8", "pallas": "K9", "stream": "K3",
                 "shortread": "K6"}
    launches = dict.fromkeys(routes, 0)  # the main path's, summed over its calls

    def counts() -> dict[str, int]:
        out = {k: mod.COUNTS["kernel"] for k, mod in routes.items()}
        out["plain"] = sum(n for mod in routes.values() for k, n in mod.COUNTS.items()
                           if "plain" in k)
        return out

    def path_call(what, fn, want):
        """One call of the main path: its launches by route must be
        ``want`` exactly (no plain call, no other route); they add to
        ``launches``."""
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in counts().items()}
        check(got == {k: want.get(k, 0) for k in got}, f"{what}: launches {got} != {want}")
        for k in routes:
            launches[k] += got[k]
        return out

    def err_of(got, want) -> int:
        return max(int((g.long().cpu() - w.long().cpu()).abs().max()) if g.numel() else 0
                   for g, w in zip(got, want))

    def random_bucket(rng, B, Lm, Ln, lo):
        """(B, Lm) x (B, Ln) random DNA on the card, lengths lo..L (the
        first pair fills the bucket)."""
        ms, ns = rng.integers(lo, Lm + 1, B), rng.integers(lo, Ln + 1, B)
        ms[0], ns[0] = Lm, Ln
        s1 = np.where(np.arange(Lm)[None, :] < ms[:, None],
                      acgt[rng.integers(0, 4, (B, Lm))], PAD_S1).astype(np.uint8)
        s2 = np.where(np.arange(Ln)[None, :] < ns[:, None],
                      acgt[rng.integers(0, 4, (B, Ln))], PAD_S2).astype(np.uint8)
        return torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev), ms, ns

    def cells(ms, ns) -> float:
        return float(np.sum(np.asarray(ms, np.float64) * np.asarray(ns, np.float64)))

    def bound_of(ms, ns, is_local):
        """Inputs once (one byte a character), 12 bytes out a pair; 12 or 19
        integer ops an interior cell."""
        nbytes = float(np.sum(ms) + np.sum(ns)) + 12.0 * len(ms)
        return bound(nbytes, cells(ms, ns) * OPS_PER_CELL["local" if is_local else "global"], rate)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def k9_launches(ms, Lm, Ln) -> int:
        return len(gp.pipeline_groups(ms, Ln, gp.pipe_rows(Lm)))

    def k8_launches(ms, ns, Lm, Ln) -> int:
        """K8's launches on a bucket of B >= 2 pairs: one a pipeline group
        at the scores-only strip height."""
        return len(gp.pipeline_groups(ms, Ln, gs.stream_rows(ms, ns, Lm, False)))

    def write_cfg(tmp) -> str:
        cfg = os.path.join(tmp, "config.toml")
        with open(cfg, "w") as f:
            f.write(f"[scores]\ns_match = {sc.s_match}\ns_mismatch = {sc.s_mismatch}\n"
                    f"g = {sc.g}\nh = {sc.h}\n")
        return cfg

    H = 32 * gseg.ROWS_PER_LANE
    err = {"seg": 0, "s8": 0, "pipe": 0}

    # ---- phase 23: each kernel vs its plain version, then the B x L sweep ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(2323)
    n_small = 0
    for is_local in (False, True):
        for st in (None, -1):
            sck = Scores(2, -3, -2, -4, st)
            args = random_bucket(rng, 8, 512, 512, 0)
            args[2][1], args[3][2], args[2][3], args[3][3] = 0, 0, 1, 1
            want = gp.gotoh_strips_plain(*args, sck, is_local, H)
            for key, fn in (("seg", gseg.gotoh_scores_segmented), ("s8", gs8.gotoh_scores_stream8)):
                e = err_of(fn(*args, sck, is_local), want)
                err[key] = max(err[key], e)
                check(e == 0, f"{key} kernel != plain (8 x 512, local={is_local}, st={st}): {e}")
            want9 = gp.gotoh_strips_plain(*args, sck, is_local, gp.pipe_rows(512))
            e = err_of(gp.gotoh_scores_pallas_batch(*args, sck, is_local), want9)
            err["pipe"] = max(err["pipe"], e)
            check(e == 0, f"K9 kernel != plain (8 x 512, local={is_local}, st={st}): {e}")
            # 32-row strips on a grid of 3 blocks: 33 strips a pair cycle the
            # tickets and the ring (the plain version as one strip).
            ring = random_bucket(rng, 4, 1024, 1024, 1000)
            e = err_of(gp._pallas_cuda(*ring, sck, is_local, 32, 3),
                       gp.gotoh_strips_plain(*ring, sck, is_local, 1025))
            err["pipe"] = max(err["pipe"], e)
            check(e == 0, f"K9 (32-row strips, 3 blocks) != plain (local={is_local}, st={st}): {e}")
            # A ring of five slots for seven pairs of up to 17 strips: three
            # launches, two or more slots a pair.
            tight = random_bucket(rng, 7, 1024, 768, 0)
            ring_bytes, gp.PIPE_RING_BYTES = gp.PIPE_RING_BYTES, 5 * 8 * 769
            try:
                groups = len(gp.pipeline_groups(tight[2], 768, 64))
                before = gp.COUNTS["kernel"]
                got = gp._pallas_cuda(*tight, sck, is_local, 64, 3)
                check(gp.COUNTS["kernel"] - before == groups > 1,
                      f"K9 on a tight ring: {gp.COUNTS['kernel'] - before} launches, {groups} groups")
            finally:
                gp.PIPE_RING_BYTES = ring_bytes
            e = err_of(got, gp.gotoh_strips_plain(*tight, sck, is_local, 64))
            err["pipe"] = max(err["pipe"], e)
            check(e == 0, f"K9 (tight ring, 3 blocks) != plain (local={is_local}, st={st}): {e}")
            # K8 on a ring of five slots: seven pairs of 1,000-1,024 rows need
            # seven or more, so the bucket runs as the plan's launches, each
            # counted on K8's route; == its plain version (K3's).
            split = random_bucket(rng, 7, 1024, 1024, 1000)
            ring_bytes, gp.PIPE_RING_BYTES = gp.PIPE_RING_BYTES, 5 * 8 * 1025
            try:
                groups = k8_launches(split[2], split[3], 1024, 1024)
                before = gs8.COUNTS["kernel"]
                got = gs8.gotoh_scores_stream8(*split, sck, is_local)
                check(gs8.COUNTS["kernel"] - before == groups > 1,
                      f"K8 on a tight ring: {gs8.COUNTS['kernel'] - before} launches, {groups} groups")
            finally:
                gp.PIPE_RING_BYTES = ring_bytes
            e = err_of(got, gs.gotoh_stream_plain(*split, sck, is_local)[:3])
            err["s8"] = max(err["s8"], e)
            check(e == 0, f"K8 (tight ring) != plain (local={is_local}, st={st}): {e}")
            n_small += 1
    # The sweep's independent side is the C++ oracle on each bucket's first
    # and last pairs; on every pair the pipeline's K3 and K9 are held to K7's
    # warp strips (csrc/gotoh_segmented.cu, another kernel).
    sweep, sampled = [], []
    kernels = (("K3", gs.gotoh_scores_stream), ("K7", gseg.gotoh_scores_segmented),
               ("K9", gp.gotoh_scores_pallas_batch))
    for L in SWEEP_L:
        for B in SWEEP_B:
            args = random_bucket(rng, B, L, L, int(0.9 * L))
            host = [x.cpu().numpy() for x in args[:2]]
            for is_local in (False, True):
                outs = {k: [x.cpu() for x in f(*args, sc, is_local)] for k, f in kernels}
                for name in ("K3", "K9"):
                    key = "pipe" if name == "K9" else "seg"
                    e = err_of(outs[name], outs["K7"])
                    err[key] = max(err[key], e)
                    check(e == 0, f"{name} != K7 on the {B} x {L} bucket (local={is_local}): {e}")
                for t in sorted({0, B - 1}):
                    pair = (host[0][t, : args[2][t]].tobytes().decode(),
                            host[1][t, : args[3][t]].tobytes().decode())
                    sampled.append((pair, is_local, {k: tuple(int(x[t]) for x in o)
                                                     for k, o in outs.items()}, (B, L)))
                ts = {k: med(cuda_ms(lambda f=f: f(*args, sc, is_local), 3)) for k, f in kernels}
                c = cells(args[2], args[3])
                b = bound_of(args[2], args[3], is_local)
                sweep.append((L, B, is_local, c, ts, b))
    with ThreadPoolExecutor(8) as pool:  # ctypes drops the GIL
        oracle = list(pool.map(lambda c: native.gotoh_score_cpu(*c[0], sc, c[1]), sampled))
    for (_, is_local, got, (B, L)), o in zip(sampled, oracle):
        for name, g in got.items():
            e = max(abs(x - y) for x, y in zip(g, o))
            err["pipe" if name == "K9" else "seg"] = max(err["pipe" if name == "K9" else "seg"], e)
            check(e == 0, f"{name} != the C++ oracle on the {B} x {L} bucket "
                          f"(local={is_local}): {g} != {tuple(o)}")
    print(f"[phase 23] card {card} | warp strips (K7, R = {gseg.ROWS_PER_LANE}) and the "
          f"warp-strip pipeline (K9 at strips of {gp.PIPE_ROWS} rows, K8 at K3's) == plain on "
          f"{n_small} small batches "
          f"(8 x 512 with empty and "
          f"one-base pairs, global/local, classic/kimura; K9 also at 32-row strips on 3 "
          f"blocks, 4 x 1,024, and K9 and K8 on a five-slot ring, 7 x 1,024, split into "
          f"launches); on every sweep bucket "
          f"K3 == K9 == K7 and {len(sampled)} sampled pairs == the C++ oracle; max |err| K7 "
          f"{err['seg']}, K8 {err['s8']}, K9 {err['pipe']} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    for L, B, is_local, c, ts, b in sweep:
        print(f"[phase 23] {'local ' if is_local else 'global'} B {B:>3} x L {L:>4} "
              f"({c:.4g} cells, bound {b[0]:.4f} ms by {b[1]}): "
              + "; ".join(f"{k} {t:.3f} ms = {c / t * 1e3:.4g} cells/s ({b[0] / t:.2%} of bound)"
                          for k, t in ts.items()), flush=True)

    # ---- phase 24: align-matrix (auto) over a mid-length corpus ----
    # The main path of this slice runs from here to the end of phase 26,
    # each call through path_call; comparisons and timings in between are
    # outside its counts.
    t_phase = time.perf_counter()
    os.environ["LOG_LEVEL"] = "WARNING"
    rng = np.random.default_rng(2424)
    lens = rng.integers(MID_MIN, MID_MAX + 1, MID_N)
    mid = [(f"mid{k} len={L}", random_dna(rng, int(L))) for k, L in enumerate(lens)]
    walls = {}
    for mod in routes.values():
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_cfg(tmp)
        mdir, tsv = os.path.join(tmp, "mid"), os.path.join(tmp, "mid.tsv")
        write_fasta_dir(mdir, mid)
        seqs = load_fasta_dir(mdir).sequences  # the CLI's order
        N = len(seqs)
        pairs = [(i, j) for j in range(N) for i in range(N) if i <= j]
        buckets = bucketize_pairs(pairs, [len(s) for s in seqs])
        by_route = {False: Counter(), True: Counter()}
        for idxs in buckets.values():
            bms = np.array([len(seqs[pairs[k][0]]) for k in idxs])
            bns = np.array([len(seqs[pairs[k][1]]) for k in idxs])
            Lm_b, Ln_b = max(round_up(int(bms.max()), 128), 128), max(round_up(int(bns.max()), 128), 128)
            for is_local in (False, True):
                eng = route_engine(len(idxs), Lm_b, Ln_b, is_local, bms, bns)
                by_route[is_local][of_engine[eng]] += (
                    k8_launches(bms, bns, Lm_b, Ln_b) if eng == "stream8" else 1)
        # Each K8 launch of the global call is timed by CUDA events around
        # the launch itself (no other work on the stream between them).
        recorder = FillLaunchRecorder(torch, gm, gs)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = path_call("align-matrix (auto), mid corpus",
                               lambda: cli.main(["-c", cfg, "align-matrix", "-f", mdir, "-o", tsv]),
                               by_route[False])
        finally:
            recorder.stop()
        walls["align-matrix mid"] = time.perf_counter() - t0
        k8_runs = [r for r in recorder.rows if r["what"] == "gotoh_stream8"]
        check(len(k8_runs) == by_route[False]["K8"],
              f"recorded {len(k8_runs)} K8 launches, the path made {by_route[False]['K8']}")
        check(rc == 0, f"align-matrix on the mid-length corpus exited {rc}")
        container = SequenceContainer(list(seqs))
        with open(tsv) as f:
            mrows = [ln.split("\t") for ln in f.read().splitlines()[1:]]
        t0 = time.perf_counter()
        loc = path_call("allpairs_scores local (auto), mid corpus",
                        lambda: allpairs_scores(container, sc, is_local=True, device="cuda"),
                        by_route[True])
        walls["allpairs_scores mid local"] = time.perf_counter() - t0
        # K3 on the same corpus: the reference, and auto's end-to-end yardstick.
        timings = {}
        for engine in ("auto", "stream", "auto", "stream"):
            t0 = time.perf_counter()
            out = allpairs_scores(container, sc, engine=engine, device="cuda")
            timings.setdefault(engine, []).append(time.perf_counter() - t0)
            if engine == "stream":
                ref_g = out
        ref_l = allpairs_scores(container, sc, is_local=True, engine="stream", device="cuda")
    # The independent side: the C++ oracle on MID_ORACLE sampled pairs of
    # each mode, for auto (K7/K8) and K3 alike; then auto == K3 on every pair.
    pick = rng.choice(len(pairs), MID_ORACLE, replace=False)
    sample = [(pairs[k], is_local) for k in pick for is_local in (False, True)]
    with ThreadPoolExecutor(8) as pool:  # ctypes drops the GIL
        oracle = list(pool.map(lambda c: native.gotoh_score_cpu(
            seqs[c[0][0]].sequence, seqs[c[0][1]].sequence, sc, c[1])[0], sample))
    for ((i, j), is_local), o in zip(sample, oracle):
        auto = loc.matrix[j, i] if is_local else int(mrows[j][1 + i])
        k3 = (ref_l if is_local else ref_g).matrix[j, i]
        e = max(abs(int(auto) - o), abs(int(k3) - o))
        err["seg" if is_local else "s8"] = max(err["seg" if is_local else "s8"], e)
        check(e == 0, f"mid corpus pair ({i}, {j}) local={is_local}: auto {auto}, K3 {k3} != "
                      f"oracle {o}")
    e = max(abs(int(mrows[j][1 + i]) - int(ref_g.matrix[j, i])) for i, j in pairs)
    err["s8"] = max(err["s8"], e)
    check(e == 0, f"align-matrix (auto) TSV != K3's allpairs_scores: max |err| {e}")
    e = int(np.abs(loc.matrix - ref_l.matrix).max())
    err["seg"] = max(err["seg"], e)
    check(e == 0, f"allpairs_scores local (auto) != K3's: max |err| {e}")
    # The largest bucket, for the K7 (local) and K8 (global) times.
    key = max(buckets, key=lambda k: (k, len(buckets[k])))
    bp = [pairs[k] for k in buckets[key]]
    Lm = round_up(max(len(seqs[i]) for i, _ in bp), 128)
    Ln = round_up(max(len(seqs[j]) for _, j in bp), 128)
    big = (torch.from_numpy(np.stack([seqs[i].encoded(Lm, PAD_S1) for i, _ in bp])).to(dev),
           torch.from_numpy(np.stack([seqs[j].encoded(Ln, PAD_S2) for _, j in bp])).to(dev),
           np.array([len(seqs[i]) for i, _ in bp]), np.array([len(seqs[j]) for _, j in bp]))
    k8_bounds = [bound(r["chars"] + 12.0 * r["B"], r["cells"] * OPS_PER_CELL["global"], rate)[0]
                 for r in k8_runs]
    k8_launch_ms = [r["ms"] for r in k8_runs]
    print(f"[phase 24] card {card} | K8's {len(k8_runs)} launches in align-matrix (auto), each "
          f"(B x Lm x Ln: kernel ms / bound ms): "
          + "; ".join(f"{r['B']} x {r['Lm']} x {r['Ln']}: {r['ms']:.3f} / {b:.3f}"
                      for r, b in zip(k8_runs, k8_bounds))
          + f" | sum {sum(k8_launch_ms):.3f} ms against {sum(k8_bounds):.3f} ms of bound: "
          f"launches x (time - bound) {sum(k8_launch_ms) - sum(k8_bounds):.3f} ms", flush=True)
    print(f"[phase 24] align-matrix (auto) on {N} random genomes of {MID_MIN}-{MID_MAX} bp "
          f"({len(pairs)} pairs, {len(buckets)} buckets): {walls['align-matrix mid']:.3f} s wall, "
          f"launches K7 {by_route[False]['K7']}, K8 {by_route[False]['K8']}; allpairs_scores "
          f"local (auto: K7 {by_route[True]['K7']}) {walls['allpairs_scores mid local']:.3f} s; "
          f"{MID_ORACLE} sampled pairs a mode, auto and K3, == the C++ oracle; auto == K3 on "
          f"every pair | allpairs_scores global, auto [{fmt(timings['auto'])}] s vs engine="
          f"stream (K3) [{fmt(timings['stream'])}] s ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # ---- phase 25: K9 at size ----
    t_phase = time.perf_counter()
    a, b = main["base"], main["var"]
    one = (np.stack([Sequence("a", a).encoded(round_up(len(a), 128), PAD_S1)]),
           np.stack([Sequence("b", b).encoded(round_up(len(b), 128), PAD_S2)]),
           np.array([len(a)]), np.array([len(b)]))
    got, walls["score_pairs 29.9 kb"] = timed(lambda: path_call(
        "score_pairs, the 29.9 kb pair", lambda: score_pairs(*one, sc, device="cuda"), {"K9": 1}))
    check((int(got[0][0]), int(got[1][0]), int(got[2][0])) == tuple(main["oracle"])
          and int(got[0][0]) == main["k1_score"],
          f"29.9 kb pair on K9: {[int(x[0]) for x in got]} != oracle {main['oracle']} "
          f"(K1 {main['k1_score']})")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_cfg(tmp)
        cdir, tsv = os.path.join(tmp, "corpus"), os.path.join(tmp, "scores.tsv")
        corpus = corpus_genomes()
        write_fasta_dir(cdir, corpus)
        clen = [len(x) for _, x in corpus]
        cpairs = [(i, j) for j in range(len(corpus)) for i in range(j + 1)]
        want = sum(k9_launches([clen[cpairs[k][0]] for k in idxs],
                               round_up(max(clen[cpairs[k][0]] for k in idxs), 128),
                               round_up(max(clen[cpairs[k][1]] for k in idxs), 128))
                   for idxs in bucketize_pairs(cpairs, clen).values())
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = path_call("align-matrix --engine pallas, the corpus", lambda: cli.main(
                ["-c", cfg, "align-matrix", "-f", cdir, "-o", tsv, "--engine", "pallas"]),
                {"K9": want})
        walls["align-matrix --engine pallas"] = time.perf_counter() - t0
        check(rc == 0, f"align-matrix --engine pallas exited {rc}")
        with open(tsv) as f:
            check(f.read() == main["corpus_tsv"], "align-matrix --engine pallas TSV != phase 8's")
    # The banded phase's 1 Mb planted pair (phase 17's seed and draws).
    rng = np.random.default_rng(12_2048)
    genome = acgt[rng.integers(0, 4, GENOME_BP)].tobytes().decode()
    while True:
        planted, planted_score = planted_copy(rng, genome, sc)
        if len(planted) <= len(genome):
            break
    mb = (np.stack([Sequence("g", genome).encoded(round_up(GENOME_BP, 128), PAD_S1)]),
          np.stack([Sequence("p", planted).encoded(round_up(len(planted), 128), PAD_S2)]),
          np.array([GENOME_BP]), np.array([len(planted)]))
    got, walls["score_pairs 1 Mb"] = timed(lambda: path_call(
        "score_pairs, the 1 Mb planted pair", lambda: score_pairs(*mb, sc, device="cuda"),
        {"K9": k9_launches(mb[2], mb[0].shape[1], mb[1].shape[1])}))
    check(int(got[0][0]) == planted_score,
          f"1 Mb planted pair on K9: {int(got[0][0])} != planted {planted_score}")
    # Outside the path: K9 and K3 == the C++ oracle on the 29.9 kb pair
    # (global: phase 4's; local: computed here), and the times.
    one_d = tuple(torch.from_numpy(x).to(dev) for x in one[:2]) + one[2:]
    with ThreadPoolExecutor(1) as pool:
        local_oracle = pool.submit(native.gotoh_score_cpu, a, b, sc, True)
        oracle_of = {False: tuple(main["oracle"])}
        got_of = {(k, is_local): [x.cpu() for x in fn(*one_d, sc, is_local)]
                  for k, fn in (("K9", gp.gotoh_scores_pallas_batch),
                                ("K3", gs.gotoh_scores_stream)) for is_local in (False, True)}
        oracle_of[True] = tuple(local_oracle.result())
    for (k, is_local), got_k in got_of.items():
        g = tuple(int(x[0]) for x in got_k)
        e = max(abs(x - y) for x, y in zip(g, oracle_of[is_local]))
        err["pipe"] = max(err["pipe"], e)
        check(e == 0, f"{k} on the 29.9 kb pair (local={is_local}): {g} != the C++ oracle "
                      f"{oracle_of[is_local]}")
    k9_one = cuda_ms(lambda: gp.gotoh_scores_pallas_batch(*one_d, sc, False), 3)
    k3_one = cuda_ms(lambda: gs.gotoh_scores_stream(*one_d, sc, False), 3)
    # The pipeline at each timed strip height (16 rows a lane down to 4),
    # on the whole grid and on 7 blocks (tickets and ring slots cycle).
    k9_rows = {}
    oracle_t = [torch.tensor([x], dtype=torch.int32) for x in oracle_of[False]]
    for r in (128, 256, 512):
        for blocks in (None, 7):
            e = err_of(gp._pallas_cuda(*one_d, sc, False, r, blocks), oracle_t)
            err["pipe"] = max(err["pipe"], e)
            check(e == 0, f"K9 at {r} rows a strip (grid {blocks}) != the C++ oracle on the "
                          f"29.9 kb pair: {e}")
        k9_rows[r] = cuda_ms(lambda r=r: gp._pallas_cuda(*one_d, sc, False, r), 3)
    rows_mb = gp.pipe_rows(mb[0].shape[1])
    strips_mb = (GENOME_BP + rows_mb) // rows_mb
    c_one, c_mb = cells(one[2], one[3]), float(GENOME_BP) * len(planted)
    b_one = bound_of(one[2], one[3], False)
    print(f"[phase 25] card {card} | K9 on the {len(a)} x {len(b)} bp pair (auto at B = 1: "
          f"score_pairs {walls['score_pairs 29.9 kb']:.1f} ms wall) == C++ oracle and K1 "
          f"({main['k1_score']}), K9 and K3 global/local == the C++ oracle: K9 [{fmt(k9_one)}] ms = "
          f"{c_one / med(k9_one) * 1e3:.4g} cells/s vs K3 at B = 1 [{fmt(k3_one)}] ms (bound "
          f"{b_one[0]:.4f} ms by {b_one[1]}); K9 at strips of "
          + ", ".join(f"{r} rows [{fmt(t)}] ms" for r, t in k9_rows.items())
          + f" (each == the oracle, also on 7 blocks) | align-matrix --engine pallas on {N_GENOMES} x "
          f"{GENOME_LEN} bp: TSV == phase 8's, {walls['align-matrix --engine pallas']:.3f} s "
          f"wall, {want} launch(es) | 1 Mb planted pair {GENOME_BP} x {len(planted)} "
          f"({strips_mb} strips of {rows_mb} rows): score {int(got[0][0])} == planted, "
          f"{walls['score_pairs 1 Mb'] / 1e3:.3f} s wall = "
          f"{c_mb / walls['score_pairs 1 Mb'] * 1e3:.4g} cells/s "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 26: reads --engine segmented|stream8|pallas on phase 10's batch ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(5)  # phase 10's draws of bench.py's short-read batch
    s1r = acgt[rng.integers(0, 4, (SR_B, SR_LEN))]
    s2r = acgt[rng.integers(0, 4, (SR_B, SR_LEN))]
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_cfg(tmp)
        for name, rows in (("q.fasta", s1r), ("r.fasta", s2r)):
            with open(os.path.join(tmp, name), "w") as f:
                f.writelines(f">{name[0]}{i}\n{row.tobytes().decode()}\n" for i, row in enumerate(rows))
        for kind in ("global", "local"):
            for engine in ("auto", "segmented", "stream8", "pallas"):
                out = os.path.join(tmp, f"{kind}_{engine}.tsv")
                argv = ["-c", cfg, "reads", "-q", os.path.join(tmp, "q.fasta"), "-r",
                        os.path.join(tmp, "r.fasta"), "-a", kind, "--engine", engine, "-o", out]
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = path_call(f"reads -a {kind} --engine {engine}", lambda: cli.main(argv), {
                        "K6" if engine == "auto" else of_engine[engine]:
                        k8_launches(np.full(SR_B, SR_LEN), np.full(SR_B, SR_LEN), SR_PAD, SR_PAD)
                        if engine == "stream8" else 1})
                walls[f"reads {kind} {engine}"] = time.perf_counter() - t0
                check(rc == 0, f"reads -a {kind} --engine {engine} exited {rc}")
                with open(out) as f:
                    outs[kind, engine] = f.read()
                check(outs[kind, engine] == outs[kind, "auto"],
                      f"reads -a {kind} --engine {engine} TSV != --engine auto's (K6)")
    path_launches = dict(launches)
    check(all(path_launches[k] > 0 for k in ("K7", "K8", "K9")) and counts()["plain"] == 0,
          f"phases 24-26: launches {path_launches}, plain calls {counts()['plain']}")
    print(f"[phase 26] reads -a global|local --engine segmented|stream8|pallas on {SR_B} x "
          f"{SR_LEN} bp: every TSV == --engine auto's (K6); walls "
          + ", ".join(f"{k[6:]} {v:.3f} s" for k, v in walls.items() if k.startswith("reads "))
          + f" | the main path's launches (phases 24-26, each call's exact) {path_launches}, "
          f"no plain call ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- each route vs its plain version at the path's shapes ----
    t_phase = time.perf_counter()
    sr_batch = (torch.from_numpy(np.full((SR_B, SR_PAD), PAD_S1, np.uint8)),
                torch.from_numpy(np.full((SR_B, SR_PAD), PAD_S2, np.uint8)))
    sr_batch[0][:, :SR_LEN] = torch.from_numpy(s1r)
    sr_batch[1][:, :SR_LEN] = torch.from_numpy(s2r)
    sr_batch = (sr_batch[0].to(dev), sr_batch[1].to(dev), np.full(SR_B, SR_LEN), np.full(SR_B, SR_LEN))
    # Phase 24's largest bucket and the 29.9 kb pair cut to SLICE_ROWS rows
    # (two strips of the kernels' 256 rows), every column kept.
    Lc = round_up(SLICE_ROWS, 128)
    big_cut = (big[0][:, :Lc].contiguous(), big[1], np.minimum(big[2], SLICE_ROWS), big[3])
    one_cut = (one_d[0][:, :Lc].contiguous(), one_d[1], np.minimum(one_d[2], SLICE_ROWS), one_d[3])
    check(gp.pipe_rows(Lc) == H and (SLICE_ROWS + H) // H == 2, "the slices are two strips")
    held, plain_ms, plain8_ms = [], {}, {}
    for name, batch, modes, on_cpu in (
            (f"reads {SR_B} x {SR_LEN}", sr_batch, (False, True), False),
            (f"phase 24's largest bucket {len(bp)} x ({SLICE_ROWS} of {Lm}, {Ln})", big_cut,
             (False, True), False),
            (f"the 29.9 kb pair ({SLICE_ROWS} of {len(a)} rows, {len(b)})", one_cut, (False,), True)):
        for is_local in modes:
            # The plain version of all three routes: strips of 256 rows (the
            # 29.9 kb slice's long single-pair loop runs it on the host).
            src = tuple(x.cpu() for x in batch[:2]) + batch[2:] if on_cpu else batch
            want, plain_ms[name, is_local] = timed(
                lambda: gp.gotoh_strips_plain(*src, sc, is_local, H))
            if len(batch[2]) > 1:  # K8's own plain version: K3's, at scores only
                want8, plain8_ms[name, is_local] = timed(
                    lambda: gs.gotoh_stream_plain(*src, sc, is_local)[:3])
            else:  # one pair: K8 runs K7's kernel
                want8 = want
            for key, fn, w in (("seg", gseg.gotoh_scores_segmented, want),
                               ("s8", gs8.gotoh_scores_stream8, want8),
                               ("pipe", gp.gotoh_scores_pallas_batch, want)):
                e = err_of(fn(*batch, sc, is_local), w)
                err[key] = max(err[key], e)
                check(e == 0, f"{key} != plain on {name} (local={is_local}): {e}")
            held.append(f"{name} {'local' if is_local else 'global'} (plain {plain_ms[name, is_local]:.0f} ms"
                        + (f", K8's {plain8_ms[name, is_local]:.0f} ms" if len(batch[2]) > 1 else "")
                        + f"{' on the host' if on_cpu else ''})")
    big_name = f"phase 24's largest bucket {len(bp)} x ({SLICE_ROWS} of {Lm}, {Ln})"
    one_name = f"the 29.9 kb pair ({SLICE_ROWS} of {len(a)} rows, {len(b)})"
    k7 = cuda_ms(lambda: gseg.gotoh_scores_segmented(*big_cut, sc, True), 3)
    k8 = cuda_ms(lambda: gs8.gotoh_scores_stream8(*big_cut, sc, False), 3)
    k9 = cuda_ms(lambda: gp.gotoh_scores_pallas_batch(*one_cut, sc, False), 3)
    b7, b8 = bound_of(big_cut[2], big_cut[3], True), bound_of(big_cut[2], big_cut[3], False)
    b9 = bound_of(one_cut[2], one_cut[3], False)
    # K7 on the whole bucket, five readings (whether it reaches half its
    # bound; earlier calls read it at 33-62% of the bound).
    k7_full = cuda_ms(lambda: gseg.gotoh_scores_segmented(*big, sc, True), 5)
    k8_full = cuda_ms(lambda: gs8.gotoh_scores_stream8(*big, sc, False), 3)
    k3_full = cuda_ms(lambda: gs.gotoh_scores_stream(*big, sc, False), 3)
    bf7, bf8 = bound_of(big[2], big[3], True), bound_of(big[2], big[3], False)
    print(f"[phase 26] card {card} | K7 and K9 each == the plain version (strips of {H} "
          f"rows), K8 == its plain version (K3's, scores only; K7's at B = 1) on "
          + "; ".join(held) + f" | kernel times there: K7 local [{fmt(k7)}] ms "
          f"(bound {b7[0]:.4f} by {b7[1]}), K8 global [{fmt(k8)}] ms (bound {b8[0]:.4f} by "
          f"{b8[1]}), K9 global on {one_name} [{fmt(k9)}] ms (bound {b9[0]:.4f} by {b9[1]}) | the "
          f"whole bucket {len(bp)} x ({Lm}, {Ln}) ({cells(big[2], big[3]):.4g} cells): K7 local "
          f"[{fmt(k7_full)}] ms (bound {bf7[0]:.4f}: {bf7[0] / max(k7_full):.0%}-"
          f"{bf7[0] / min(k7_full):.0%} of it), K8 global [{fmt(k8_full)}] ms (bound "
          f"{bf8[0]:.4f}), K3 global [{fmt(k3_full)}] ms ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)
    return [
        {"name": "gotoh_segmented", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_segmented.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_segmented.py:227",
         "launches": path_launches["K7"], "max_abs_err": float(err["seg"]),
         "ms": med(k7), "plain_ms": float(plain_ms[big_name, True]),
         "bound_ms": b7[0], "bound_by": b7[1], "library_ms": None},
        {"name": "gotoh_stream8", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_stream.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_stream8.py:372",
         "launches": path_launches["K8"], "max_abs_err": float(err["s8"]),
         "ms": med(k8), "plain_ms": float(plain8_ms[big_name, False]),
         "bound_ms": b8[0], "bound_by": b8[1], "library_ms": None},
        {"name": "gotoh_pallas", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_pallas.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_pallas.py:1213",
         "launches": path_launches["K9"], "max_abs_err": float(err["pipe"]),
         "ms": med(k9), "plain_ms": float(plain_ms[one_name, False]),
         "bound_ms": b9[0], "bound_by": b9[1], "library_ms": None},
    ]


#: The sequence-parallel sweep: P shards and C = P column blocks on one
#: card over phase 4's 29,903 x 29,892 bp pair.
SEQPAR_P = (1, 2, 4, 8)
#: K16's batch: BLOCKED_B planted copies of a random BLOCKED_LEN bp genome
#: at the JAX entry's default block height.
BLOCKED_B, BLOCKED_LEN, BLOCKED_R = 4, 155_000, 4096
#: phase 29's hybrid corpus: three of the corpus genomes cut to this many
#: bp and one whole, so that only the long self-pair outgrows a share.
HYBRID_SHORT = 5_000
#: columns of phase 31's local K16-vs-plain slice (the global one keeps
#: all of them).
BLOCKED_LOCAL_COLS = 38_912


def seqpar_phases(torch, dev, card, sc, cuda_ms, rate, main) -> list[dict]:
    """Phases 27-31: the sequence-parallel pipeline (K5), the multi-device
    paths on one card, and K16. ``main`` carries phase 4's 29.9 kb pair,
    its oracle tuple, K1's score and K1's global alignment. Returns the
    rows of K5 and K16."""
    from genomics_rs_tpu_torch import native
    from genomics_rs_tpu_torch.display.alignment import (
        format_aligned_sequences,
        format_alignment_table,
    )
    from genomics_rs_tpu_torch.models.aligner import PairwiseAligner
    from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
    from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
    from genomics_rs_tpu_torch.ops import traceback_device as td
    from genomics_rs_tpu_torch.ops import traceback_walker as tw
    from genomics_rs_tpu_torch.ops.gotoh_tile import (
        global_boundary_left,
        global_boundary_top,
        tile_fill,
    )
    from genomics_rs_tpu_torch.parallel import longseq
    from genomics_rs_tpu_torch.parallel.allpairs import allpairs_scores
    from genomics_rs_tpu_torch.parallel.batch import score_pairs
    from genomics_rs_tpu_torch.parallel.distributed import allpairs_hybrid
    from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh, make_mesh_2d
    from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, SequenceContainer, round_up

    med = lambda ts: float(np.median(ts))  # noqa: E731
    fmt = lambda ts: ", ".join(f"{t:.3f}" for t in ts)  # noqa: E731
    base, var = main["base"], main["var"]
    m, n = len(base), len(var)
    a_seq, b_seq = Sequence("a", base), Sequence("b", var)

    def mesh_of(P):
        return make_mesh(P, SEQ_AXIS, devices=[dev] * P)

    def padded(P, C):
        """(s1e, s2e, R, B) of the pair for P shards x C blocks, as
        ``align_sharded`` pads it."""
        R = max(round_up(m, 128 * P), 128 * P) // P
        Ln = max(round_up(n, 128 * C), 128 * C)
        return (torch.from_numpy(a_seq.encoded(pad_to=R * P, pad_value=PAD_S1).copy()),
                torch.from_numpy(b_seq.encoded(pad_to=Ln, pad_value=PAD_S2).copy()), R, Ln // C)

    def tile_err(got, want) -> int:
        errs = [abs(int(got.err)), int((got.bottom.long() - want.bottom.long()).abs().max()),
                int((got.right.long() - want.right.long()).abs().max()),
                abs(int(got.score_at_mn) - int(want.at_mn))]
        errs += [abs(int(x) - int(y)) for x, y in zip(got.best, want.best)]
        return max(errs)

    def tile_bound(R, B, cells, is_local):
        """top, left, bottom and right once (int32 I/S/D), the characters
        once; 12 or 19 integer ops a true cell."""
        nbytes = 12.0 * (2 * (B + 1) + 2 * R) + R + B
        return bound(nbytes, cells * OPS_PER_CELL["local" if is_local else "global"], rate)

    # ---- phase 27: K5 vs its plain version on the P = 4 pipeline's tiles ----
    t_phase = time.perf_counter()
    s1e4, s2e4, R4, B4 = padded(4, 4)
    check(3 * R4 < m <= 4 * R4 and 3 * B4 < n <= 4 * B4, "tile (3, 3) must hold (m, n)")
    s1d, s2d = s1e4.to(dev), s2e4.to(dev)
    threads = torch.get_num_threads()
    k5_err, held, k5_plain_ms, interior = 0, [], {}, {}
    for is_local in (False, True):
        fill = longseq.sharded_fill_checkpoints(mesh_of(4), s1e4, s2e4, m, n, sc, is_local)
        torch.cuda.synchronize()

        def tile(p, c):
            return (s1d[p * R4 : (p + 1) * R4], s2d[c * B4 : (c + 1) * B4],
                    fill.tops[p * 4 + c].contiguous(), fill.lefts[p * 4 + c].contiguous(),
                    m, n, p * R4, c * B4)

        # A tile wholly past n: 256 padding columns at j0 = 4 B, its
        # boundaries carried from tile (1, 3).
        past = (s1d[R4 : 2 * R4], torch.full((256,), PAD_S2, dtype=torch.uint8, device=dev),
                fill.tops[7][:, :257].contiguous(), fill.lefts[7].contiguous(), m, n, R4, 4 * B4)
        for name, args in (("interior (1, 2)", tile(1, 2)), ("(m, n) (3, 3)", tile(3, 3)),
                           ("past n", past)):
            got = gp.gotoh_tile_pallas(*args, sc, is_local, emit_dirs=False, emit_bottom=True,
                                       emit_right=True)
            torch.cuda.synchronize()
            # The plain loop's ops are small: it runs on the host, one thread.
            s1, s2, top, left, mm, nn, i0, j0 = args
            host = [x.cpu() for x in (s1, s2, top, left)]
            torch.set_num_threads(1)
            t0 = time.perf_counter()
            want = tile_fill(*host, sc, is_local, i0, j0, mm, nn)
            ms = (time.perf_counter() - t0) * 1e3
            torch.set_num_threads(threads)
            got = got._replace(bottom=got.bottom.cpu(), right=got.right.cpu())
            err = tile_err(got, want)
            k5_err = max(k5_err, err)
            check(err == 0, f"K5 != tile_fill on tile {name} (local={is_local}): max |err| {err}")
            # The same tile on grids of one and two persistent blocks at
            # strips of 128 and 512 rows: tickets and ring slots cycle.
            for rows, max_blocks in ((128, 1), (512, 2)):
                cap = rb.launch(*args[:8], sc, is_local, False, True, False, True, True,
                                {"kernel": 0}, rows, max_blocks)
                cap = cap._replace(bottom=cap.bottom.cpu(), right=cap.right.cpu())
                err = tile_err(cap, want)
                k5_err = max(k5_err, err)
                check(err == 0, f"K5 != tile_fill on tile {name} (local={is_local}) at {rows} rows "
                                f"a strip on {max_blocks} blocks: max |err| {err}")
            if name.startswith("interior"):
                k5_plain_ms[is_local] = ms
                interior[is_local] = args
                # The tile's outputs are the pipeline's next entries.
                check(torch.equal(got.bottom, fill.tops[2 * 4 + 2].cpu())
                      and torch.equal(got.right, fill.lefts[1 * 4 + 3].cpu()),
                      f"K5's bottom/right != the captured tops/lefts (local={is_local})")
            held.append(f"{name} {'local' if is_local else 'global'} (best "
                        f"{tuple(int(x) for x in got.best)}, plain {ms:.0f} ms)")
    print(f"[phase 27] card {card} | K5 == tile_fill (bottom, right, best, (m, n)) on the P = 4 "
          f"pipeline's {R4} x {B4} tiles of the {m} x {n} bp pair, each also at 128 rows a strip "
          f"on one block and 512 rows on two: " + "; ".join(held)
          + f"; max |err| {k5_err} ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # References for the path's checks, made before its counters are reset.
    t_phase = time.perf_counter()
    o_loc = native.gotoh_score_cpu(base, var, sc, True)
    ref_aln = {False: main["glob"],
               True: PairwiseAligner(sc, is_local=True, device="cuda").align(a_seq, b_seq)}
    genomes = corpus_genomes()
    Lb = round_up(GENOME_LEN, 256)
    s1b = np.stack([Sequence("a", genomes[2 * k][1]).encoded(pad_to=Lb, pad_value=PAD_S1)
                    for k in range(4)])
    s2b = np.stack([Sequence("b", genomes[2 * k + 1][1]).encoded(pad_to=Lb, pad_value=PAD_S2)
                    for k in range(4)])
    lens4 = np.full(4, GENOME_LEN)
    k3_4 = {loc: score_pairs(s1b, s2b, lens4, lens4, sc, loc, engine="stream") for loc in (0, 1)}
    hyb = SequenceContainer([Sequence(f"h{k}", g[:HYBRID_SHORT])
                             for k, (_, g) in enumerate(genomes[:3])]
                            + [Sequence("h3", genomes[3][1])])
    hyb_want = allpairs_scores(hyb, sc, device="cuda").matrix
    brng = np.random.default_rng(30)
    genome = random_dna(brng, BLOCKED_LEN)
    copies = [planted_copy(brng, genome, sc) for _ in range(BLOCKED_B)]
    Lm_k, Ln_k = round_up(BLOCKED_LEN, 128), round_up(max(len(c) for c, _ in copies), 128)
    kb1 = torch.from_numpy(np.stack([Sequence("g", genome).encoded(pad_to=Lm_k, pad_value=PAD_S1)]
                                    * BLOCKED_B)).to(dev)
    kb2 = torch.from_numpy(np.stack([Sequence("c", c).encoded(pad_to=Ln_k, pad_value=PAD_S2)
                                     for c, _ in copies])).to(dev)
    kms, kns = np.full(BLOCKED_B, BLOCKED_LEN), np.array([len(c) for c, _ in copies])
    k9_loc = [x.cpu() for x in gp.gotoh_scores_pallas_batch(kb1, kb2, kms, kns, sc, True)]
    torch.cuda.synchronize()
    t_refs = time.perf_counter() - t_phase

    # ---- phase 28: the main path of this slice from here to phase 30 ----
    counted = {"K5": gp.TILE_COUNTS, "K16": gp.BLOCKED_COUNTS, "K1": rb.COUNTS, "K2": tw.COUNTS}
    for c in (*counted.values(), td.COUNTS):
        for key in c:
            c[key] = 0
    t_phase = time.perf_counter()
    walls = {}
    for P in SEQPAR_P:
        s1e, s2e, R, B = padded(P, P)
        mesh = mesh_of(P)
        for is_local in (False, True):
            ts = []
            for rep in range(4):  # the first call, then three timed
                before = gp.TILE_COUNTS["kernel"]
                t0 = time.perf_counter()
                out = longseq.sharded_gotoh_score(mesh, s1e, s2e, m, n, sc, is_local)
                got = (int(out.score), tuple(out.best.tolist()))
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
                check(gp.TILE_COUNTS["kernel"] - before == P * P,
                      f"P = {P}: {gp.TILE_COUNTS['kernel'] - before} K5 launches, not {P * P}")
                if is_local:
                    check(got[1] == tuple(o_loc), f"P = {P} local {got[1]} != oracle {o_loc}")
                else:
                    check(got[0] == main["oracle"][0] == main["k1_score"],
                          f"P = {P} global {got[0]} != oracle {main['oracle'][0]} / K1")
            walls[P, is_local] = ts[1:]
    print(f"[phase 28] card {card} | sharded_gotoh_score on the {m} x {n} bp pair, P shards "
          f"of one card (C = P), == the C++ oracle (global == K1's whole-table score "
          f"{main['k1_score']}, local {tuple(o_loc)}), P * C K5 launches a call; walls "
          "(s, median of 3 after a first call): " + "; ".join(
              f"P = {P} global [{fmt(walls[P, False])}] local [{fmt(walls[P, True])}]"
              for P in SEQPAR_P) + f" ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 29: align_sharded, batched_sharded_scores, allpairs_hybrid ----
    t_phase = time.perf_counter()
    aln_walls = {}
    for is_local in (False, True):
        t0 = time.perf_counter()
        got = longseq.align_sharded(mesh_of(4), a_seq, b_seq, sc, is_local=is_local)
        aln_walls[is_local] = time.perf_counter() - t0
        ref = ref_aln[is_local]
        check(got.alignment == ref.alignment and got.score == ref.score
              and (got.matches, got.mismatches, got.opening_gaps, got.gap_extensions)
              == (ref.matches, ref.mismatches, ref.opening_gaps, ref.gap_extensions),
              f"align_sharded (local={is_local}) != PairwiseAligner.align")
        check(format_aligned_sequences(got) == format_aligned_sequences(ref)
              and format_alignment_table(got, color=False)
              == format_alignment_table(ref, color=False),
              f"align_sharded (local={is_local}) renders other bytes")
    mesh22 = make_mesh_2d(2, 2, devices=[dev] * 4)
    for is_local in (False, True):
        got = longseq.batched_sharded_scores(mesh22, s1b, s2b, lens4, lens4, sc, is_local)
        want = k3_4[is_local]
        if is_local:
            check(np.array_equal(got.best.cpu().numpy(), np.stack(want, 1)),
                  "batched_sharded_scores local != K3")
        else:
            check(np.array_equal(got.score.cpu().numpy(), want[0]),
                  "batched_sharded_scores global != K3")
    before = gp.TILE_COUNTS["kernel"]
    t0 = time.perf_counter()
    hres = allpairs_hybrid(hyb, sc, n_shares=8, devices=[dev])
    t_hyb = time.perf_counter() - t0
    hyb_tiles = gp.TILE_COUNTS["kernel"] - before
    check(hyb_tiles > 0, "allpairs_hybrid split no pair")
    check(np.array_equal(hres.matrix, hyb_want), "allpairs_hybrid != allpairs_scores")
    print(f"[phase 29] card {card} | align_sharded at P = 4 == PairwiseAligner.align (moves, "
          f"stats, rendered bytes): global {aln_walls[False]:.3f} s, local {aln_walls[True]:.3f} "
          f"s | batched_sharded_scores on a (data 2 x seq 2) mesh of one card, 4 pairs of "
          f"{GENOME_LEN} bp == K3, global and local | allpairs_hybrid (3 x {HYBRID_SHORT} + 1 x "
          f"{GENOME_LEN} bp, 8 shares; the long self-pair split, {hyb_tiles} K5 tiles) == "
          f"allpairs_scores, {t_hyb:.3f} s ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 30: K16 on planted copies of a 155 kb genome ----
    t_phase = time.perf_counter()
    k16_walls = {}
    for is_local in (False, True):
        t0 = time.perf_counter()
        got = [x.cpu() for x in gp.gotoh_scores_blocked(kb1, kb2, kms, kns, sc, is_local,
                                                         R=BLOCKED_R)]
        k16_walls[is_local] = time.perf_counter() - t0
        if is_local:
            check(all(torch.equal(g, w) for g, w in zip(got, k9_loc)),
                  f"K16 local {[g.tolist() for g in got]} != K9 {[w.tolist() for w in k9_loc]}")
        else:
            check(got[0].tolist() == [s for _, s in copies],
                  f"K16 global {got[0].tolist()} != planted {[s for _, s in copies]}")
    path = {k: c["kernel"] for k, c in counted.items()}
    plain = sum(c.get("plain", 0) for c in counted.values()) + td.COUNTS["plain"]
    check(all(v > 0 for v in path.values()), f"the path missed a kernel: {path}")
    check(plain == 0, f"the path ran a plain version {plain} times")
    print(f"[phase 30] card {card} | gotoh_scores_blocked (K16, R = {BLOCKED_R}: strips of "
          f"{gp.blocked_rows(BLOCKED_R)} rows) on {BLOCKED_B} planted copies of a {BLOCKED_LEN} "
          f"bp genome: global == the planted optima {[s for _, s in copies]} "
          f"({k16_walls[False]:.3f} s), local == K9 at its own strips "
          f"{[tuple(int(x[b]) for x in k9_loc) for b in range(BLOCKED_B)]} "
          f"({k16_walls[True]:.3f} s) | the path's launches {path}, plain calls {plain} "
          f"({t_refs:.1f} s of references before phase 28; {time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # ---- phase 31: K16 vs plain at the path's shape, and times ----
    t_phase = time.perf_counter()
    Lc = round_up(SLICE_ROWS, 128)
    cut = (kb1[:, :Lc].contiguous(), kb2, np.minimum(kms, SLICE_ROWS), kns)
    # Local mode's plain loop costs twice global's a step: it holds the
    # first BLOCKED_LOCAL_COLS columns of the slice.
    Lw = BLOCKED_LOCAL_COLS
    cut_loc = (cut[0], kb2[:, :Lw].contiguous(), cut[2], np.minimum(kns, Lw))
    k16_err, k16_plain_ms, held16 = 0, {}, []
    for is_local, c in ((False, cut), (True, cut_loc)):
        got = gp.gotoh_scores_blocked(*c, sc, is_local, R=BLOCKED_R)
        torch.set_num_threads(1)  # the plain loop's ops are small: one host thread
        t0 = time.perf_counter()
        want = gp.gotoh_strips_plain(c[0].cpu(), c[1].cpu(), c[2], c[3], sc, is_local,
                                     BLOCKED_R)
        k16_plain_ms[is_local] = (time.perf_counter() - t0) * 1e3
        torch.set_num_threads(threads)
        err = max(int((g.long().cpu() - w.long()).abs().max()) for g, w in zip(got, want))
        k16_err = max(k16_err, err)
        check(err == 0, f"K16 != plain on the first {SLICE_ROWS} rows (local={is_local}): {err}")
        # The same launch at 64-row strips on 3 blocks: tickets and ring slots cycle.
        before = gp.BLOCKED_COUNTS["kernel"]
        got = gp._pallas_cuda(*c, sc, is_local, gp.blocked_rows(64), 3, gp.BLOCKED_COUNTS)
        err = max(int((g.long().cpu() - w.long()).abs().max()) for g, w in zip(got, want))
        k16_err = max(k16_err, err)
        check(err == 0 and gp.BLOCKED_COUNTS["kernel"] == before + 1,
              f"K16 at 64-row strips on 3 blocks != plain (local={is_local}): {err}")
        held16.append(f"{'local' if is_local else 'global'} on {SLICE_ROWS} x {c[1].shape[1]} "
                      f"({k16_plain_ms[is_local]:.0f} ms plain)")
    k16_ms = cuda_ms(lambda: gp.gotoh_scores_blocked(*cut, sc, False, R=BLOCKED_R), 3)
    k16_full = cuda_ms(lambda: gp.gotoh_scores_blocked(kb1, kb2, kms, kns, sc, False,
                                                        R=BLOCKED_R), 1)
    cells_cut = float(np.sum(cut[2].astype(np.float64) * kns))
    cells_full = float(np.sum(kms.astype(np.float64) * kns))
    b16 = bound(float(np.sum(cut[2]) + np.sum(kns)) + 12.0 * BLOCKED_B,
                cells_cut * OPS_PER_CELL["global"], rate)
    b16_full = bound(float(np.sum(kms) + np.sum(kns)) + 12.0 * BLOCKED_B,
                     cells_full * OPS_PER_CELL["global"], rate)
    # K5 at the interior tile, global, and one tile alone at each P (the
    # serial sum a wave could overlap).
    k5_ms = cuda_ms(lambda: gp.gotoh_tile_pallas(*interior[False], sc, False, emit_dirs=False,
                                                 emit_bottom=True, emit_right=True), 3)
    b5 = tile_bound(R4, B4, float(R4) * B4, False)
    tile_alone = {}
    for P in SEQPAR_P:
        s1e, s2e, R, B = padded(P, P)
        args = (s1e[:R].to(dev), s2e[:B].to(dev), global_boundary_top(0, B, sc, device=dev),
                global_boundary_left(0, R, sc, device=dev), m, n, 0, 0)
        tile_alone[P] = med(cuda_ms(lambda: gp.gotoh_tile_pallas(
            *args, sc, False, emit_dirs=False, emit_bottom=True, emit_right=True), 2))
    # One global call at P = 1 and at P = 8 under torch.profiler: the
    # device's busy share of the wall.
    from torch.profiler import ProfilerActivity, profile

    busy = {}
    for P in (SEQPAR_P[0], SEQPAR_P[-1]):
        s1e, s2e, R, B = padded(P, P)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            longseq.sharded_gotoh_score(mesh_of(P), s1e, s2e, m, n, sc, False)
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
        dev_ms = device_ms(torch, prof)
        k5_dev = sum(v for k, v in dev_ms.items() if "rowblock" in k)
        busy[P] = (f"P = {P}: wall {1e3 * t_prof:.1f} ms, device {sum(dev_ms.values()):.1f} ms "
                   f"(K5 {k5_dev:.1f} ms over {P * P} launches)")
    overlap = "; ".join(
        f"P = {P}: {P * P} tiles x {tile_alone[P]:.2f} ms = {P * P * tile_alone[P]:.1f} ms "
        f"serial, {(2 * P - 1) * tile_alone[P]:.1f} ms if a wave's tiles overlap, wall "
        f"{1e3 * med(walls[P, False]):.1f} ms" for P in SEQPAR_P)
    print(f"[phase 31] card {card} | K16 == plain (strips of {BLOCKED_R} rows, on the host) on the "
          f"batch's first rows: " + "; ".join(held16) + f" (the kernel at {gp.blocked_rows(BLOCKED_R, Lc)} "
          f"rows a strip, and at 64 on 3 blocks); max |err| {k16_err} | K16 on "
          f"{SLICE_ROWS} x {Ln_k} [{fmt(k16_ms)}] ms (bound {b16[0]:.4f} by {b16[1]}), the whole "
          f"batch global [{fmt(k16_full)}] ms ({cells_full:.4g} cells, bound {b16_full[0]:.3f}) "
          f"| K5 on the {R4} x {B4} interior tile global [{fmt(k5_ms)}] ms (bound {b5[0]:.4f} "
          f"by {b5[1]}), plain {k5_plain_ms[False]:.0f} ms | one tile alone against the "
          f"walls (global): {overlap} | profiled calls: {'; '.join(busy.values())} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return [
        {"name": "gotoh_tile", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_rowblock.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_pallas.py:441",
         "launches": path["K5"], "max_abs_err": float(k5_err),
         "ms": med(k5_ms), "plain_ms": float(k5_plain_ms[False]),
         "bound_ms": b5[0], "bound_by": b5[1], "library_ms": None},
        {"name": "gotoh_scores_blocked", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_pallas.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_pallas.py:826",
         "launches": path["K16"], "max_abs_err": float(k16_err),
         "ms": med(k16_ms), "plain_ms": float(k16_plain_ms[False]),
         "bound_ms": b16[0], "bound_by": b16[1], "library_ms": None},
    ]


#: the suffix structures (phases 32-34): the FM-index over a random genome
#: of chr12.fasta's length (phase 13's), bench.py's fmindex_chr12 query
#: recipe (SEARCH_N patterns of 20-40 bp from default_rng(1)), the CLI
#: ``search`` on SEARCH_CLI_N reads over four contigs, ``suffixtree`` on a
#: 29,903 bp genome and ``compare`` on the phase 6 corpus, whose one pair is
#: held against the Python oracle on a COMPARE_CUT bp cut.
SEARCH_N, SEARCH_CLI_N, TREE_BP, COMPARE_CUT = 100_000, 10_000, 29_903, 2_000


def suffix_phases(torch, dev, card, cuda_ms) -> None:
    """Phases 32-34: the suffix array and BWT, the FM-index search and the
    suffix tree and compare CLI. No hand-written kernel runs here: the
    suffix array and the search are torch ops on the card (sort, scatter,
    cumsum, gather), the tree and SA-IS host C++."""
    from genomics_rs_tpu_torch import cli
    from genomics_rs_tpu_torch.comparison.driver import (
        compare_all_pairs,
        load_fasta_dir,
        recursive_lcs_similarity,
    )
    from genomics_rs_tpu_torch.ops.bwt_device import bwt_device, suffix_array
    from genomics_rs_tpu_torch.sequence import Sequence
    from genomics_rs_tpu_torch.suffixtree import fmindex as fm
    from genomics_rs_tpu_torch.suffixtree.native import native_suffix_array, similarity_native

    acgt = np.frombuffer(b"ACGT", np.uint8)
    sep = chr(fm.SEPARATOR)
    fmt = lambda ts: ", ".join(f"{t:.3f}" for t in ts)  # noqa: E731

    # ---- phase 32: the suffix array and BWT on the card ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1207)  # phase 13's genome
    genome = acgt[rng.integers(0, 4, GENOME_BP)].tobytes().decode()
    q = GENOME_BP // 4
    contigs = [genome[k * q : (k + 1) * q - 11 * (k + 1)] for k in range(4)]
    texts = {"genome": genome, "4 contigs joined by '#'": sep.join(contigs), "empty": "",
             "A": "A", "AAAAAAAA": "AAAAAAAA", "ACGT x 50": "ACGT" * 50}
    sa_ms = host_ms = None
    for name, text in texts.items():
        got = suffix_array(text, device=dev)
        t0 = time.perf_counter()
        want = native_suffix_array(text.encode("latin-1") + b"$")
        t_host = (time.perf_counter() - t0) * 1e3
        check(got.dtype == np.int32 and np.array_equal(got, want),
              f"suffix array on the card != SA-IS on {name} ({len(text)} bp)")
        if name == "genome":
            host_ms = t_host
            sa_ms = cuda_ms(lambda: suffix_array(text, device=dev), 3)
            bwt_genome = bwt_device(text, device=dev)
            s = np.frombuffer(text.encode("latin-1") + b"$", np.uint8)
            check(bwt_genome == s[(want - 1) % len(s)].tobytes().decode("latin-1"),
                  "bwt_device != the SA-IS BWT")
    dev_idx = fm.FMIndex.build(genome, host=False, device=dev)
    host_idx = fm.FMIndex.build(genome, host=True, device=dev)
    for f in ("text", "sa", "bwt", "alphabet", "code", "cvec", "occ"):
        a, b = getattr(dev_idx, f), getattr(host_idx, f)
        check(a == b if isinstance(a, bytes) else np.array_equal(a, b),
              f"FMIndex.build(host=False) != build(host=True) in {f}")
    build_dev_ms = cuda_ms(lambda: fm.FMIndex.build(genome, host=False, device=dev), 3)
    build_host_ms = cuda_ms(lambda: fm.FMIndex.build(genome, host=True, device=dev), 3)
    del dev_idx
    print(f"[phase 32] card {card} | suffix_array on the card == SA-IS on the host over all "
          f"{GENOME_BP + 1:,} entries of the {GENOME_BP:,} bp genome, on 4 contigs joined by "
          f"'#' and on {len(texts) - 2} edge texts; bwt_device == the SA-IS BWT; "
          f"FMIndex.build(host=False) == build(host=True) (sa, bwt, occ, cvec) | times (CUDA "
          f"events, ms, 3 runs after a warm call): suffix_array [{fmt(sa_ms)}] against SA-IS "
          f"{host_ms:.1f} (host clock, one run); FMIndex.build device SA [{fmt(build_dev_ms)}], "
          f"host SA [{fmt(build_host_ms)}] ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 33: search at size (the main path of this slice) ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1)  # bench.py's fmindex_chr12 recipe
    pats = []
    for _ in range(SEARCH_N):
        L = int(rng.integers(20, 40))
        st = int(rng.integers(0, len(genome) - L))
        pats.append(genome[st : st + L])
    extra = ["", "ACGN", "NNNN", "$", "A$C", "#", "GA#TT", "", "A", "ACGT" * 10]
    queries = pats + extra
    for k in fm.COUNTS:
        fm.COUNTS[k] = 0
    t0 = time.perf_counter()
    counts, ranges = host_idx.search_batch(queries, device=True)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    path_counts = dict(fm.COUNTS)
    check(path_counts == {"device": 1, "host_range": 0},
          f"search_batch(device=True) did not run one device search alone: {path_counts}")
    check(host_idx._dev[0].device.type == "cuda" and host_idx._dev[1].device.type == "cuda",
          "the Occ table is not on the card")
    hc, hr = host_idx.search_batch(queries, device=False)
    check(np.array_equal(counts, hc) and ranges == hr,
          "device search != host search (counts or ranges)")
    check(bool((counts[:SEARCH_N] >= 1).all()), "a sampled pattern missed its own text")
    check(counts[SEARCH_N:].tolist() == [GENOME_BP + 1, 0, 0, 0, 0, 0, 0, GENOME_BP + 1,
                                         host_idx.count("A"), host_idx.count("ACGT" * 10)],
          f"edge patterns counted {counts[SEARCH_N:].tolist()}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        host_idx.search_batch(pats, device=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # One more under torch.profiler: the device's share of the wall.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        host_idx.search_batch(pats, device=True)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    search_dev_ms = sum(device_ms(torch, prof).values())
    multi = fm.MultiFMIndex.build([Sequence(f"chr{k} part", c) for k, c in enumerate(contigs)],
                                  device=dev)
    mq = pats[:20_000] + extra
    mc, mr = multi.search_batch(mq, device=True)
    hmc, hmr = multi.search_batch(mq, device=False)
    check(np.array_equal(mc, hmc) and mr == hmr, "MultiFMIndex device search != host search")
    located = [multi.locate_range(r) for r in mr]
    check(located == [multi.locate_range(r) for r in hmr]
          and all(len(h) == c for h, c in zip(located, mc)),
          "MultiFMIndex locate_range differs from the host path")
    # The CLI on 10,000 reads over the four contigs, both engines.
    rng = np.random.default_rng(33)
    with tempfile.TemporaryDirectory() as tmp:
        ref, q = os.path.join(tmp, "ref.fasta"), os.path.join(tmp, "reads.fasta")
        with open(ref, "w") as f:
            f.writelines(f">chr{k} part\n{c}\n" for k, c in enumerate(contigs))
        with open(q, "w") as f:
            for r in range(SEARCH_CLI_N):
                k = int(rng.integers(0, 4))
                L = int(rng.integers(12, 40))
                st = int(rng.integers(0, len(contigs[k]) - L))
                f.write(f">read{r} c{k}\n{contigs[k][st : st + L]}\n")
        tsvs, cli_s = {}, {}
        for engine in ("device", "host"):
            out = os.path.join(tmp, f"{engine}.tsv")
            fm.COUNTS.update(device=0, host_range=0)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["-c", write_config(tmp), "search", "-r", ref, "-q", q, "--locate",
                               "--engine", engine, "-o", out])
            cli_s[engine] = time.perf_counter() - t0
            check(rc == 0, f"search --engine {engine} exited {rc}")
            with open(out, "rb") as f:
                tsvs[engine] = f.read()
            if engine == "device":
                check(fm.COUNTS == {"device": 1, "host_range": 0},
                      f"search --engine device ran {fm.COUNTS}")
    check(tsvs["device"] == tsvs["host"], "search --locate TSV: device != host")
    n_rows = tsvs["device"].count(b"\n") - 1
    check(n_rows == SEARCH_CLI_N and b"\tchr0:" in tsvs["device"],
          f"search TSV has {n_rows} rows")
    print(f"[phase 33] card {card} | search_batch on the card == the host loop on "
          f"{len(queries):,} patterns ({SEARCH_N:,} of 20-40 bp, all found, and {len(extra)} "
          f"with absent bytes, '$', '#' or empty): counts and (lo, hi); one device search, "
          f"0 host ranges; Occ on the card; MultiFMIndex over 4 contigs == host "
          f"(locate_range); CLI search --locate on {SEARCH_CLI_N:,} reads: device TSV == host "
          f"TSV ({len(tsvs['device']):,} bytes; walls device {cli_s['device']:.3f} s, host "
          f"{cli_s['host']:.3f} s) | search wall (host clock, {SEARCH_N:,} patterns, first "
          f"{t_first:.3f} s): [{fmt(walls)}] s, median {np.median(walls):.4f} s = "
          f"{SEARCH_N / np.median(walls):,.0f} patterns/s; profiled {t_prof:.4f} s wall, "
          f"device time {search_dev_ms:.2f} ms (busy {search_dev_ms / 10 / t_prof:.1f}%) "
          f"({time.perf_counter() - t_phase:.1f} s)",
          flush=True)
    del host_idx, multi

    # ---- phase 34: suffixtree and compare through the CLI ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(34)
    tree_genome = acgt[rng.integers(0, 4, TREE_BP)].tobytes().decode()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        alphabet = os.path.join(tmp, "dna.txt")
        with open(alphabet, "w") as f:
            f.write("ACGT\n")
        fasta = os.path.join(tmp, "tree29903.fasta")
        with open(fasta, "w") as f:
            f.write(f">tree test\n{tree_genome}\n")
        cdir = os.path.join(tmp, "corpus")
        write_fasta_dir(cdir, corpus_genomes())
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = cli.main(["-c", write_config(tmp), "suffixtree", "-a", alphabet, "-f", fasta,
                               "--stats", "--suffix-links"])
            t_tree = time.perf_counter() - t0
            check(rc == 0, f"suffixtree exited {rc}")
            with open(os.path.join("BWT_out", "tree29903_bwt.txt")) as f:
                tree_bwt = f.read()
            check(tree_bwt == "".join(c + "\n" for c in bwt_device(tree_genome, device=dev)),
                  "suffixtree's BWT_out != bwt_device on the card")
            check(f"BWT Length: {TREE_BP + 1}" in out.getvalue(), "suffixtree printed no stats")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = cli.main(["-c", write_config(tmp), "compare", "-a", alphabet, "-f", cdir,
                               "--threads", "4"])
            t_compare = time.perf_counter() - t0
            check(rc == 0, f"compare exited {rc}")
            with open("similarity_matrix.tsv") as f:
                tsv = f.read()
        finally:
            os.chdir(cwd)
        result = compare_all_pairs(load_fasta_dir(cdir), alphabet, threads=4)
        n = N_GENOMES
        want_tsv = "\t" + "\t".join(map(str, range(n))) + "\t\n" + "".join(
            f"{j}\t" + "\t".join(str(int(result.matrix[j, i, 0])) for i in range(n)) + "\t\n"
            for j in range(n))
        check(tsv == want_tsv and want_tsv in out.getvalue(),
              "compare's similarity TSV != compare_all_pairs' matrix")
        a, b = (g[:COMPARE_CUT] for _, g in corpus_genomes()[:2])
        t0 = time.perf_counter()
        oracle = recursive_lcs_similarity(a, b, alphabet, engine="python")
        t_oracle = time.perf_counter() - t0
        check(similarity_native(a, b, alphabet) == oracle,
              f"compare pair on a {COMPARE_CUT} bp cut: native != the Python oracle {oracle}")
    print(f"[phase 34] suffixtree --stats --suffix-links on {TREE_BP:,} bp: BWT_out == "
          f"bwt_device on the card ({t_tree:.3f} s); compare --threads 4 on {n} x "
          f"{GENOME_LEN:,} bp: TSV == compare_all_pairs ({t_compare:.3f} s wall, "
          f"{n * (n + 1) // 2} pairs); pair 0-1 cut to {COMPARE_CUT} bp == the Python oracle "
          f"{oracle} ({t_oracle:.2f} s) ({time.perf_counter() - t_phase:.1f} s)", flush=True)


def write_config(tmp: str) -> str:
    cfg = os.path.join(tmp, "config.toml")
    with open(cfg, "w") as f:
        f.write("[scores]\ns_match = 1\ns_mismatch = -2\ng = -2\nh = -5\n")
    return cfg


#: The scan engines (the JAX package's oracle, a Python loop of torch ops a
#: diagonal) where an oracle is used: an ``align --engine scan`` pair of
#: SCAN_PAIR bp, one bucket of SCAN_BUCKET pairs of SCAN_BUCKET_LEN bp,
#: ``align_reads(engine="scan")`` on SCAN_READS 128 bp reads against 256 bp
#: windows in rounds of SCAN_ROUND, SCAN_PROT pairs of SCAN_PROT_LEN aa and a
#: SCAN_SEQPAR_LEN bp pair over two shards of the card.
SCAN_PAIR = (2_000, 2_100)
SCAN_BUCKET, SCAN_BUCKET_LEN = 64, 1_024
SCAN_READS, SCAN_ROUND = 4_096, 1_024
SCAN_PROT, SCAN_PROT_LEN = 256, 383
SCAN_SEQPAR_LEN = 2_000
#: Device seeding at the map recipe's size: SEED_N reads of MAP_LEN bp,
#: both strands, against a seeded GENOME_BP genome, at k = SEED_K.
SEED_N, SEED_K = 100_000, 15


def scan_phases(torch, dev, card, sc) -> None:
    """Phases 35-37: the scan engines held against the C++ oracle, the
    kernel routes and ``engine="auto"``; device seeding at the map
    recipe's size; the port's entry points. None of them launches a
    hand-written kernel on a scan path; they add no row to the kernels'
    line."""
    from torch.profiler import ProfilerActivity, profile

    from genomics_rs_tpu_torch import cli, native
    from genomics_rs_tpu_torch.entry import dryrun_multichip, entry
    from genomics_rs_tpu_torch.models import mapper
    from genomics_rs_tpu_torch.models.aligner import PairwiseAligner
    from genomics_rs_tpu_torch.models.reads import align_reads, encode_batch
    from genomics_rs_tpu_torch.ops import gotoh_matrix as gm
    from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
    from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
    from genomics_rs_tpu_torch.ops import gotoh_segmented as gseg
    from genomics_rs_tpu_torch.ops import gotoh_shortread as gsr
    from genomics_rs_tpu_torch.ops import gotoh_stream as gs
    from genomics_rs_tpu_torch.ops import gotoh_stream8 as gs8
    from genomics_rs_tpu_torch.ops import traceback_batch as tb
    from genomics_rs_tpu_torch.ops import traceback_walker as tw
    from genomics_rs_tpu_torch.ops.subst import blosum62
    from genomics_rs_tpu_torch.parallel import batch as pb
    from genomics_rs_tpu_torch.parallel import longseq
    from genomics_rs_tpu_torch.parallel.mesh import SEQ_AXIS, make_mesh
    from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, round_up

    counters = [m.COUNTS for m in (rb, gs, gs8, gseg, gsr, tb, tw, gm, gp)]
    counters += [gp.TILE_COUNTS, gp.BLOCKED_COUNTS]

    def kernels() -> int:
        return sum(v for c in counters for k, v in c.items() if k.endswith("kernel"))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def fields(r):
        return (r.score, r.alignment, r.matches, r.mismatches, r.opening_gaps, r.gap_extensions)

    # ---- phase 35: the scan engines ----
    t_phase = time.perf_counter()
    os.environ["LOG_LEVEL"] = "WARNING"
    rng = np.random.default_rng(3535)
    times = {}
    before = kernels()
    a = random_dna(rng, SCAN_PAIR[0])
    b = mutate(rng, a, 0.02, 6)[: SCAN_PAIR[1] - 100] + random_dna(rng, 100)
    x, y = Sequence("a", a), Sequence("b", b)
    for is_local in (False, True):
        mode = "local" if is_local else "global"
        got, times[f"align {mode}"] = wall(
            lambda: PairwiseAligner(sc, is_local, device=dev, engine="scan").align(x, y))
        oracle = native.gotoh_score_cpu(a, b, sc, is_local)
        start = (got.alignment[0][1], got.alignment[0][2]) if got.alignment else (0, 0)
        check((got.score,) + start == oracle,
              f"align --engine scan {mode}: {(got.score,) + start} != oracle {oracle}")
        check(kernels() == before, "the scan aligner launched a kernel")
        kern, times[f"align {mode} auto"] = wall(
            lambda: PairwiseAligner(sc, is_local, device=dev).align(x, y))
        check(fields(got) == fields(kern), f"align --engine scan {mode}: path != the kernels'")
        before = kernels()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "pair.fasta"), "w") as f:
            f.write(f">a\n{a}\n>b\n{b}\n")
        with open(os.path.join(tmp, "config.toml"), "w") as f:
            f.write(f"[scores]\ns_match = {sc.s_match}\ns_mismatch = {sc.s_mismatch}\n"
                    f"g = {sc.g}\nh = {sc.h}\n")
        outs = {}
        for engine in ("scan", "auto"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["-c", os.path.join(tmp, "config.toml"), "align", "-a", "global",
                               "-f", os.path.join(tmp, "pair.fasta"), "--engine", engine,
                               "--device", dev.type])
            times[f"CLI align --engine {engine}"] = time.perf_counter() - t0
            check(rc == 0, f"align --engine {engine} exited {rc}")
            outs[engine] = buf.getvalue()
        check(outs["scan"] == outs["auto"] and "Alignment Score" in outs["scan"],
              "CLI align --engine scan != --engine auto")

    B, L = SCAN_BUCKET, SCAN_BUCKET_LEN
    pairs = []
    for _ in range(B):
        s = random_dna(rng, int(rng.integers(L - 120, L + 1)))
        t = mutate(rng, s, 0.03, 3)[:L]
        pairs.append((s, t))
    s1b = np.stack([Sequence("a", s).encoded(L, PAD_S1) for s, _ in pairs])
    s2b = np.stack([Sequence("b", t).encoded(L, PAD_S2) for _, t in pairs])
    ms = np.array([len(s) for s, _ in pairs], np.int32)
    ns = np.array([len(t) for _, t in pairs], np.int32)
    s1d, s2d = torch.from_numpy(s1b).to(dev), torch.from_numpy(s2b).to(dev)
    with ThreadPoolExecutor(8) as pool:
        oracles = {loc: list(pool.map(lambda p: native.gotoh_score_cpu(p[0], p[1], sc, loc), pairs))
                   for loc in (False, True)}
    for is_local in (False, True):
        mode = "local" if is_local else "global"
        before = kernels()
        got, times[f"bucket {mode}"] = wall(lambda: pb.batch_scores(s1d, s2d, ms, ns, sc, is_local))
        check(kernels() == before, "batch_scores launched a kernel")
        want = [tuple(o) for o in oracles[is_local]]
        have = list(zip(got.score.tolist(), got.start_i.tolist(), got.start_j.tolist()))
        check(have == want, f"batch_scores {mode} != the C++ oracle")
        auto, times[f"bucket {mode} auto"] = wall(
            lambda: pb.score_pairs(s1b, s2b, ms, ns, sc, is_local, device=dev))
        check(all(np.array_equal(p, q) for p, q in zip(auto, got[:3])),
              f"batch_scores {mode} != engine auto")

    genome = random_dna(rng, 200_000)
    pos = rng.integers(64, len(genome) - 200, SCAN_READS)
    rreads, rrefs = [], []
    for k, p in enumerate(pos):
        q = mutate(rng, genome[p : p + 140], 0.01, int(k % 5 == 0))[:128]
        rreads.append(Sequence(f"q{k}", revcomp(q) if k % 7 == 0 else q))
        rrefs.append(Sequence(f"w{k}", genome[p - 64 : p + 192]))
    kw = dict(is_local=True, with_paths=False, with_cigars=True, with_mapinfo=True)
    for c in counters:
        for key in c:
            c[key] = 0
    scan_r, times["align_reads scan"] = wall(
        lambda: align_reads(rreads, rrefs, sc, engine="scan", batch=SCAN_ROUND, device=dev, **kw))
    diag_walks = tb.COUNTS["diag"]
    check(kernels() == 0 and diag_walks >= 2,
          f"align_reads(engine='scan'): {kernels()} kernel launches, {diag_walks} diag walks")
    auto_r, times["align_reads auto"] = wall(
        lambda: align_reads(rreads, rrefs, sc, batch=SCAN_ROUND, device=dev, **kw))
    check([fields(r) for r in scan_r[0]] == [fields(r) for r in auto_r[0]]
          and scan_r[1:] == auto_r[1:], "align_reads(engine='scan') != engine='auto'")
    for k in range(0, SCAN_READS, SCAN_READS // 16):
        o = native.gotoh_score_cpu(rreads[k].sequence, rrefs[k].sequence, sc, True)
        check((scan_r[0][k].score, scan_r[2][k][2], scan_r[2][k][3]) == o,
              f"align_reads scan read {k} != the C++ oracle {o}")

    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    P, PL = SCAN_PROT, SCAN_PROT_LEN
    p1 = np.full((P, PL), PAD_S1, np.uint8)
    p2 = np.full((P, PL), PAD_S2, np.uint8)
    pm = rng.integers(PL // 2, PL + 1, P).astype(np.int32)
    pn = rng.integers(PL // 2, PL + 1, P).astype(np.int32)
    for i in range(P):
        p1[i, : pm[i]] = aa[rng.integers(0, 20, pm[i])]
        src = p1[i, : pm[i]].copy()
        hit = rng.random(src.size) < 0.3
        src[hit] = aa[rng.integers(0, 20, int(hit.sum()))]
        p2[i, : pn[i]] = np.resize(src, pn[i])
    mx = blosum62()
    lut = mx.byte_lut()
    for is_local in (False, True):
        mode = "local" if is_local else "global"
        before = kernels()
        got, times[f"matrix {mode}"] = wall(lambda: gm.gotoh_scores_matrix(
            torch.from_numpy(p1).to(dev), torch.from_numpy(p2).to(dev), pm, pn, mx, PROT_G, PROT_H,
            is_local, engine="scan"))
        check(kernels() == before, "the matrix scan launched a kernel")
        auto, times[f"matrix {mode} auto"] = wall(lambda: gm.gotoh_scores_matrix(
            torch.from_numpy(p1).to(dev), torch.from_numpy(p2).to(dev), pm, pn, mx, PROT_G, PROT_H,
            is_local))
        check(all(torch.equal(g_, w_) for g_, w_ in zip(got, auto)),
              f"matrix scan {mode} != engine auto")
        for i in range(0, P, P // 16):
            o = native.gotoh_score_cpu_subst(p1[i, : pm[i]].tobytes().decode(),
                                             p2[i, : pn[i]].tobytes().decode(), lut, PROT_G,
                                             PROT_H, is_local)
            check((int(got[0][i]), int(got[1][i]), int(got[2][i])) == o,
                  f"matrix scan {mode} pair {i} != the C++ oracle {o}")

    a2 = random_dna(rng, SCAN_SEQPAR_LEN)
    b2 = mutate(rng, a2, 0.02, 4)
    Lp = round_up(max(len(a2), len(b2)), 256)
    e1 = Sequence("a", a2).encoded(Lp, PAD_S1)
    e2 = Sequence("b", b2).encoded(Lp, PAD_S2)
    mesh = make_mesh(2, SEQ_AXIS, devices=[dev, dev])
    for is_local in (False, True):
        mode = "local" if is_local else "global"
        before = kernels()
        got, times[f"seqpar {mode}"] = wall(lambda: longseq.sharded_gotoh_score(
            mesh, e1, e2, len(a2), len(b2), sc, is_local, engine="scan"))
        check(kernels() == before, "the sequence-parallel scan launched a kernel")
        auto, times[f"seqpar {mode} auto"] = wall(lambda: longseq.sharded_gotoh_score(
            mesh, e1, e2, len(a2), len(b2), sc, is_local))
        o = native.gotoh_score_cpu(a2, b2, sc, is_local)
        have = (tuple(got.best.tolist()) if is_local
                else (int(got.score), len(a2), len(b2)))
        check(have == o, f"sequence-parallel scan {mode} {have} != the C++ oracle {o}")
        check((int(got.score), got.best.tolist()) == (int(auto.score), auto.best.tolist()),
              f"sequence-parallel scan {mode} != engine auto (K5)")
    print(f"[phase 35] card {card} | the scan engines (torch ops, no kernel launched) == the "
          f"C++ oracle and the kernel routes: align --engine scan {len(a)} x {len(b)} bp "
          f"global/local (paths == auto's, CLI stdout == auto's); batch_scores {B} x {L} bp "
          f"global/local == oracle and auto; align_reads(engine='scan') {SCAN_READS} x 128 bp vs "
          f"256 bp, rounds of {SCAN_ROUND} pipelined ({diag_walks} diag walks) == auto (K6) and "
          f"oracle; matrix scan {P} x {PL} aa == auto and oracle; sequence-parallel scan P = 2 "
          f"on {len(a2)} x {len(b2)} bp == K5 and oracle | walls (s, scan vs kernels): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f" ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 36: device seeding at the map recipe's size ----
    t_phase = time.perf_counter()
    rng = np.random.default_rng(3636)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    gbytes = acgt[rng.integers(0, 4, GENOME_BP)]
    gtxt = gbytes.tobytes().decode()
    starts = rng.integers(0, GENOME_BP - MAP_LEN, SEED_N)
    win = gbytes[starts[:, None] + np.arange(MAP_LEN)]
    hit = rng.random(win.shape) < 0.01
    win = np.where(hit, acgt[(np.searchsorted(acgt, win) + rng.integers(1, 4, win.shape)) % 4], win)
    comp = np.zeros(256, np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", np.uint8)
    win[1::2] = comp[win[1::2, ::-1]]  # odd reads on the reverse strand
    reads = [Sequence(f"m{i}", win[i].tobytes().decode()) for i in range(SEED_N)]
    index = mapper.KmerIndex([Sequence("chr12s", gtxt)], SEED_K)
    oriented = reads + [r.reverse_complement() for r in reads]
    enc4 = mapper._BASE[encode_batch(oriented, MAP_LEN, 0xFE)]
    stride, max_hits, band = SEED_K // 2, 64, 32
    host, t_host = wall(lambda: mapper._vote_windows(index, enc4, stride, max_hits, band))
    mapper._vote_windows_device(index, enc4[:4096], stride, max_hits, band, device=dev)  # warm
    devv, t_dev = wall(lambda: mapper._vote_windows_device(index, enc4, stride, max_hits, band,
                                                           device=dev))
    for name, g_, h_ in zip(("votes", "wlo", "whi", "anchor", "votes2"), devv, host):
        check(np.array_equal(g_, h_), f"device vote {name} != the host vote")
    ties = int(((devv[0] == devv[4]) & (devv[0] > 0)).sum())
    seeded = int((np.maximum(devv[0][:SEED_N], devv[0][SEED_N:]) >= 2).sum())
    check(seeded >= 0.99 * SEED_N, f"device vote: only {seeded} of {SEED_N} reads have 2+ votes")
    os.environ["LOG_LEVEL"] = "WARNING"
    maps = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = lambda name: os.path.join(tmp, name)  # noqa: E731
        with open(path("config.toml"), "w") as f:
            f.write(f"[scores]\ns_match = {sc.s_match}\ns_mismatch = {sc.s_mismatch}\n"
                    f"g = {sc.g}\nh = {sc.h}\n")
        with open(path("genome.fasta"), "w") as f:
            f.write(f">chr12s random {GENOME_BP} bp\n{gtxt}\n")
        with open(path("map.fasta"), "w") as f:
            f.writelines(f">{r.name}\n{r.sequence}\n" for r in reads)
        for engine in ("host", "device"):
            buf = io.StringIO()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["-c", path("config.toml"), "map", "-q", path("map.fasta"),
                                   "-r", path("genome.fasta"), "-k", str(SEED_K),
                                   "--seed-engine", engine, "-o", path(f"{engine}.sam"),
                                   "--device", dev.type])
                sync()
                t_map = time.perf_counter() - t0
            check(rc == 0, f"map --seed-engine {engine} exited {rc}")
            busy = sum(device_ms(torch, prof).values())
            with open(path(f"{engine}.sam"), "rb") as f:
                sam = f.read()
            line = next((ln for ln in buf.getvalue().splitlines() if "mapped" in ln), "")
            maps[engine] = (sam, line.split(" in ")[0], t_map, busy)
    check(maps["device"][0] == maps["host"][0],
          "map --seed-engine device SAM != --seed-engine host")
    check(maps["device"][1] == maps["host"][1], f"map stdout differs: {maps['device'][1]!r} vs "
          f"{maps['host'][1]!r}")
    print(f"[phase 36] card {card} | device seeding, {SEED_N} x {MAP_LEN} bp reads, both strands, "
          f"{GENOME_BP} bp genome, k = {SEED_K} ({len(index)} k-mers): vote arrays == the host "
          f"vote on all {2 * SEED_N} rows ({ties} rows tied with their runner-up); seeding wall "
          f"host {t_host:.3f} s, device {t_dev:.3f} s | map -k {SEED_K} (profiled): "
          + "; ".join(f"--seed-engine {e} wall {v[2]:.3f} s, device {v[3]:.1f} ms (busy "
                      f"{v[3] / 10 / v[2]:.2f}%)" for e, v in maps.items())
          + f"; SAM bytes equal ({len(maps['host'][0])} B; {maps['host'][1]}) "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # ---- phase 37: the entry points ----
    t_phase = time.perf_counter()
    fn, args = entry(dev)
    out, t_entry = wall(lambda: fn(*args))
    cfn, cargs = entry("cpu")
    want = cfn(*cargs)
    check(all(torch.equal(g_.cpu(), w_) for g_, w_ in zip(out, want)),
          "entry() on the card != its CPU run")
    _, t_dry = wall(lambda: dryrun_multichip(1, devices=[dev]))
    print(f"[phase 37] card {card} | entry(): the 256 bp global scan step on {dev} == its CPU "
          f"run (score {int(out[0])}, dirs {tuple(out[3].shape)}) in {t_entry:.3f} s; "
          f"dryrun_multichip(1) on the card in {t_dry:.3f} s "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)


def main() -> None:
    # ---- phase 0: the card ----
    card = card_line()
    print(card)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    print(f"[phase 0] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | card {card}", flush=True)

    from genomics_rs_tpu_torch import native
    from genomics_rs_tpu_torch.config import Scores
    from genomics_rs_tpu_torch.models.aligner import PairwiseAligner
    from genomics_rs_tpu_torch.models.longalign import align_checkpointed
    from genomics_rs_tpu_torch.ops import _build
    from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
    from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
    from genomics_rs_tpu_torch.ops import traceback_device as td
    from genomics_rs_tpu_torch.ops import traceback_walker as tw
    from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_top
    from genomics_rs_tpu_torch.ops.traceback import AlignmentChoice as C
    from genomics_rs_tpu_torch.sequence import PAD_S2, Sequence, round_up

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    _build.library()
    native.library()
    ptxas = [ln.strip() for ln in _build.BUILD_INFO.get("ptxas", "").splitlines()
             if "registers" in ln or "spill" in ln]
    global CHAIN_NS
    # tools/chain_floor.py here; tests/walk_stage_cases.py in phases 8 and 16
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.join(root, "tools"), os.path.join(root, "tests")]
    from chain_floor import chain_floor_ns

    CHAIN_NS = chain_floor_ns(torch, 3)
    print(f"[phase 1] built kernels + oracle in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_INFO['seconds']:.2f} s); ptxas: {' | '.join(ptxas)}; the "
          f"walks' chain floor: {CHAIN_NS:.3f} ns a dependent shared-memory load "
          f"(tools/smem_chase.cu)", flush=True)

    def codes_at(dirs, R, B, rows=512):
        """Direction codes at every block cell (li <= R, j <= B), on device."""
        out = []
        j = torch.arange(B + 1, device=dirs.device)[None, :]
        for r0 in range(0, R + 1, rows):
            li = torch.arange(r0, min(R + 1, r0 + rows), device=dirs.device)[:, None]
            k = li + j
            w = dirs[k // 16, li].to(torch.int64)
            out.append((w >> (2 * (k % 16))) & 3)
        return torch.cat(out)

    def fill_err(got, want, R, n, B):
        """Max |difference| over every output both fills give (and the
        kernel's error word, which must be clear)."""
        errs = [abs(int(got.score_at_mn) - int(want.score_at_mn)), abs(int(got.err))]
        errs += [abs(int(a) - int(b)) for a, b in zip(got.best, want.best)]
        if want.bottom is not None:
            errs.append(int((got.bottom.long() - want.bottom.long()).abs().max()))
        if want.cols is not None:
            V = rb.lane_count(R)
            for c in range(want.cols.shape[0]):
                if c * V <= n:
                    d = got.cols[c, :, 1 : R + 1].long() - want.cols[c, :, 1 : R + 1].long()
                    errs.append(int(d.abs().max()))
        if want.dirs is not None:
            d = codes_at(got.dirs, R, B) - codes_at(want.dirs, R, B)
            errs.append(int(d.abs().max()))
        return max(errs)

    # The main path's pairs (phase 4), made first: phase 2 holds K1 at their
    # fills' shapes.
    rng = np.random.default_rng(7)
    s10 = random_dna(rng, 10_000)
    t10 = random_dna(rng, 1_000) + mutate(rng, s10[2_000:9_500], 0.01, 6) + random_dna(rng, 1_500)
    base = random_dna(rng, 29_903)
    var = mutate(rng, base, 0.01, 8)

    # ---- phase 2: K1 kernel vs plain ----
    rng = np.random.default_rng(2024)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    k1_err = 0
    bitmaps = []  # (dirs, R, B, i0, start_li, start_j) for phase 3
    cases = []
    for is_local in (False, True):
        for st in (None, -1):
            for with_left in (False, True):
                cases.append((300, 512, 480, 1000, 300, is_local, st, with_left))
    cases += [
        (2047, 3072, 3000, 2047, 0, False, None, False),
        (2047, 3072, 3000, 2047, 0, True, -1, True),
    ]
    t0 = time.perf_counter()
    for R, B, n, m, i0, is_local, st, with_left in cases:
        sc = Scores(2, -3, -2, -4, st)
        s1 = torch.from_numpy(acgt[rng.integers(0, 4, R)].copy()).to(dev)
        s2 = np.full(B, PAD_S2, np.uint8)
        s2[:n] = acgt[rng.integers(0, 4, n)]
        s2 = torch.from_numpy(s2).to(dev)
        top = global_boundary_top(0, B, sc, device=dev)
        if i0 > 0:  # a carried row, not the table's first
            top = top + torch.from_numpy(rng.integers(-6, 3, (3, B + 1)).astype(np.int32)).to(dev)
            top[:, 0] = torch.tensor([-1 << 30, -1 << 30, sc.h + i0 * sc.g], dtype=torch.int32)
        left = None
        if with_left:
            left = torch.from_numpy(rng.integers(-60, 8, (3, R)).astype(np.int32)).to(dev)
        args = (s1, s2, top, m, n, i0, sc, is_local)
        emit = dict(emit_dirs=True, emit_bottom=True, emit_cols=True, left=left)
        got = rb.gotoh_rowblock(*args, **emit)
        want = rb.gotoh_rowblock_plain(*args, **emit)
        torch.cuda.synchronize()
        err = fill_err(got, want, R, n, B)
        k1_err = max(k1_err, err)
        check(err == 0, f"K1 kernel != plain (R={R}, B={B}, local={is_local}, "
                        f"st={st}, left={with_left}): max |err| {err}")
        if i0 == 0 and not with_left:
            si, sj = ((int(got.best[1]), int(got.best[2])) if is_local
                      else (min(m, R), n))
            bitmaps.append((got.dirs, R, B, i0, si, sj))
        if i0 > 0 and not with_left and not is_local:
            bitmaps.append((got.dirs, R, B, i0, R, n))
    # The strip pipeline's edges, on the card's own grid unless capped:
    # (R, B, n, m, i0, local, kimura, left, rows a strip, max blocks, ring
    # slots) for ragged and whole strips, a block shorter than a strip, top
    # rows narrower than, as wide as and just wider than a published chunk,
    # grids of one and two blocks, a ring of two slots, a block wholly past
    # m and the probe inside a later block.
    edges = [
        (1000, 700, 690, 1000, 0, True, -1, True, 256, None, None),
        (767, 320, 300, 900, 133, False, None, True, 256, None, None),
        (100, 300, 280, 100, 0, True, None, False, 256, None, None),
        (600, 63, 63, 600, 0, True, None, False, 128, None, None),
        (600, 64, 64, 600, 0, False, -1, True, 128, None, None),
        (600, 65, 65, 600, 0, True, -1, False, 128, None, None),
        (2047, 900, 880, 2047, 0, True, -1, True, 128, 1, None),
        (2047, 900, 880, 1900, 0, False, None, False, 256, 2, None),
        (2047, 900, 880, 2047, 0, True, None, True, 64, 3, 2),
        (1023, 400, 390, 500, 1024, True, None, False, 256, None, None),
        (3071, 1000, 990, 5000, 3071, True, -1, True, 512, None, None),
    ]
    for R, B, n, m, i0, is_local, st, with_left, rows, max_blocks, slots in edges:
        sc = Scores(2, -3, -2, -4, st)
        s1 = torch.from_numpy(acgt[rng.integers(0, 4, R)].copy()).to(dev)
        s2 = np.full(B, PAD_S2, np.uint8)
        s2[:n] = acgt[rng.integers(0, 4, n)]
        s2 = torch.from_numpy(s2).to(dev)
        top = global_boundary_top(0, B, sc, device=dev)
        left = (torch.from_numpy(rng.integers(-60, 8, (3, R)).astype(np.int32)).to(dev)
                if with_left else None)
        ring = gp.RING_BYTES
        if slots is not None:
            gp.RING_BYTES = slots * 8 * (B + 1)
        try:
            got = rb.launch(s1, s2, top, left, m, n, i0, 0, sc, is_local, True, True, True,
                            False, False, {"kernel": 0}, rows, max_blocks)
        finally:
            gp.RING_BYTES = ring
        want = rb.gotoh_rowblock_plain(s1, s2, top, m, n, i0, sc, is_local, emit_dirs=True,
                                       emit_bottom=True, emit_cols=True, left=left)
        torch.cuda.synchronize()
        err = fill_err(got, want, R, n, B)
        k1_err = max(k1_err, err)
        check(err == 0, f"K1 kernel != plain at a pipeline edge (R={R}, B={B}, m={m}, i0={i0}, "
                        f"local={is_local}, rows={rows}, blocks={max_blocks}, slots={slots}): "
                        f"max |err| {err}")

    # The main path's fills at three strip heights against one plain fill
    # each: the 10 kb pair's monolithic local fill with dirs and the
    # 29.9 kb pair's checkpointed forward fill with bottom and cols.
    sc = Scores()  # the main path's scores, from here on
    path_fills = {}
    Lm10, Ln10 = round_up(len(s10), 128), round_up(len(t10), 128)
    R30, L30 = round_up(len(base) + 1, 1024) - 1, round_up(len(var), 128)
    for name, a, b, R, L, is_local, emit in (
            ("10 kb local+dirs", s10, t10, Lm10, Ln10, True,
             dict(emit_dirs=True, emit_bottom=False)),
            ("29.9 kb forward+cols", base, var, R30, L30, False,
             dict(emit_dirs=False, emit_bottom=True, emit_cols=True))):
        s1 = torch.from_numpy(Sequence("a", a).encoded(R, 0xFE).copy()).to(dev)
        s2 = torch.from_numpy(Sequence("b", b).encoded(L, PAD_S2).copy()).to(dev)
        top = global_boundary_top(0, L, sc, device=dev)
        args = (s1, s2, top, len(a), len(b), 0, sc, is_local)
        t1 = time.perf_counter()
        want = rb.gotoh_rowblock_plain(*args, **emit)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        path_fills[name] = (args, emit, plain_ms, want)
        for rows in STRIP_ROWS:
            got = rb.launch(s1, s2, top, None, len(a), len(b), 0, 0, sc, is_local,
                            emit["emit_dirs"], emit["emit_bottom"], emit.get("emit_cols", False),
                            False, False, {"kernel": 0}, rows)
            err = fill_err(got, want, R, len(b), L)
            k1_err = max(k1_err, err)
            check(err == 0, f"K1 kernel != plain on the {name} fill ({R} x {L}) at {rows} rows "
                            f"a strip: max |err| {err}")
            del got
    print(f"[phase 2] K1 kernel == plain on {len(cases)} fills "
          f"(global/local, classic/kimura, dirs+bottom+cols, left; up to "
          f"2047 x 3072), {len(edges)} pipeline edges (ragged and short strips, top rows "
          f"of 63-65 columns, grids of 1-3 blocks, a two-slot ring, a block past m, strips of "
          f"64-512 rows) and the path's 10 kb local fill with dirs and 29.9 kb forward fill "
          f"with cols at {'/'.join(map(str, STRIP_ROWS))} rows a strip (plain "
          + ", ".join(f"{k} {v[2]:.0f} ms" for k, v in path_fills.items())
          + f"); max |err| {k1_err} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- phase 3: K2 kernel vs plain ----
    t0 = time.perf_counter()
    k2_err = 0
    n_walks = 0
    for dirs, R, B, i0, si, sj in bitmaps:
        for j0, max_steps in ((0, 8192), (0, 100), (1024, 100)):
            got = td.device_walk(dirs, si, sj, i0, max_steps=max_steps, j0=j0)
            want = td.device_walk(dirs.cpu(), si, sj, i0, max_steps=max_steps, j0=j0)
            same_len = len(got[0]) == len(want[0])
            err = (int(np.abs(got[0].astype(int) - want[0].astype(int)).max(initial=0))
                   if same_len else 1 << 30)
            err = max(err, *(abs(int(a) - int(b)) for a, b in zip(got[1:], want[1:])))
            k2_err = max(k2_err, err)
            n_walks += 1
            check(err == 0, f"K2 kernel != plain (i0={i0}, start=({si},{sj}), "
                            f"j0={j0}, max_steps={max_steps})")
    # The staged chase's exits and runs (tests/walk_stage_cases.py), one
    # launch and resumed at 1, 15, 16 and 17 moves a launch, on both copy
    # routes: the bitmap as its own tensor (TMA boxes) and as a view 4 bytes
    # into a larger buffer (4-byte cp.async copies).
    from walk_stage_cases import exit_walks

    n_exit = 0
    for name, dirs, li, j, i0, j0 in exit_walks():
        want = td.device_walk(dirs, li, j, i0, max_steps=4096, j0=j0)
        flat = torch.zeros(dirs.numel() + 1, dtype=torch.int32, device=dev)
        flat[1:] = dirs.reshape(-1).to(dev)
        for route, view in (("TMA", dirs.to(dev)), ("cp.async", flat[1:].view(dirs.shape))):
            words, count, i_f, j_f, done = tw.walk_kernel(view, li, j, i0, 4096, j0)
            got = [(tw.unpack_moves(words, count), i_f, j_f, done)]
            got += [tw.walk_full(view, li, j, i0, max_steps=cap, j0=j0) for cap in (1, 15, 16, 17)]
            for g in got:
                same = np.array_equal(g[0], want[0]) and tuple(g[1:]) == tuple(want[1:])
                k2_err = max(k2_err, 0 if same else 1)
                n_exit += 1
                check(same, f"K2 kernel != plain on {name} ({route} route)")
    print(f"[phase 3] K2 kernel == plain on {n_walks} walks over phase-2 bitmaps "
          f"(j0 windows, max_steps=100 resumes) and on {n_exit} walks of "
          f"{len(exit_walks())} exit cases (up exits in a SUB run and off lane 0 after an INS "
          f"run, left exits in SUB and INS runs, both at once, stop cells), one launch and "
          f"resumed at 1/15/16/17 moves, TMA and cp.async routes; max |err| {k2_err} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- phase 4: the main path ----
    def rescore(a: str, b: str, aln, sc) -> int:
        """Sum of the path's move costs with the true characters."""
        tot = 0
        for ch, i, j in aln:
            if ch in (C.MATCH, C.MISMATCH):
                tot += sc.s_match if a[i - 1] == b[j - 1] else sc.s_mismatch
            elif ch in (C.OPEN_INSERT, C.OPEN_DELETE):
                tot += sc.h + sc.g
            else:
                tot += sc.g
        return tot

    def path_cells(aln):
        """(rows, cols) the path consumes."""
        di = sum(ch not in (C.INSERT, C.OPEN_INSERT) for ch, _, _ in aln)
        dj = sum(ch not in (C.DELETE, C.OPEN_DELETE) for ch, _, _ in aln)
        return di, dj

    for mod in (rb, td, tw):
        for key in mod.COUNTS:
            mod.COUNTS[key] = 0
    t_phase = time.perf_counter()
    gold = PairwiseAligner(Scores(*TEST_SCORES), device="cuda")
    r = gold.align(Sequence("s1", "ACGT"), Sequence("s2", "ACGT"))
    check((r.score, r.matches) == (4, 4) and r.alignment == [
        (C.MATCH, 4, 4), (C.MATCH, 3, 3), (C.MATCH, 2, 2), (C.MATCH, 1, 1)],
        "golden simple_matches")
    r = gold.align(Sequence("s1", "ACGT"), Sequence("s2", "AGCGT"))
    check(r.alignment == [(C.MATCH, 4, 5), (C.MATCH, 3, 4), (C.MATCH, 2, 3),
                          (C.OPEN_INSERT, 1, 2), (C.MISMATCH, 1, 1)]
          and (r.matches, r.mismatches, r.opening_gaps, r.gap_extensions) == (3, 1, 1, 0),
          "golden gaps")
    r = gold.align(Sequence("s1", "ACGGATAAAAAAAATC"), Sequence("s2", "ACGGATAAAATC"))
    check((r.matches, r.mismatches, r.opening_gaps, r.gap_extensions) == (12, 0, 1, 3)
          and [c for c, _, _ in r.alignment[6:10]]
          == [C.OPEN_DELETE, C.DELETE, C.DELETE, C.DELETE], "golden affine_gap")
    r = PairwiseAligner(Scores(*TEST_SCORES), is_local=True, device="cuda").align(
        Sequence("s1", "TTTACGTTTT"), Sequence("s2", "ACGT"))
    check(r.score == 4 and r.matches + r.mismatches == 4, "golden local_simple")

    t0 = time.perf_counter()
    loc = PairwiseAligner(sc, is_local=True, device="cuda").align(
        Sequence("a", s10), Sequence("b", t10))
    t_10k = time.perf_counter() - t0
    t0 = time.perf_counter()
    glob = PairwiseAligner(sc, is_local=False, device="cuda").align(
        Sequence("a", base), Sequence("b", var))
    t_30k_first = time.perf_counter() - t0
    launches = {"gotoh_rowblock": rb.COUNTS["kernel"], "traceback_walk": tw.COUNTS["kernel"]}
    plain_calls = rb.COUNTS["plain"] + td.COUNTS["plain"]
    t_phase = time.perf_counter() - t_phase
    check(launches["gotoh_rowblock"] > 0 and launches["traceback_walk"] > 0,
          f"main path did not launch both kernels: {launches}")
    check(plain_calls == 0, f"main path ran a plain version {plain_calls} times")

    o10 = native.gotoh_score_cpu(s10, t10, sc, True)
    o30 = native.gotoh_score_cpu(base, var, sc, False)
    start10 = (loc.alignment[0][1], loc.alignment[0][2])
    check((loc.score,) + start10 == o10,
          f"10 kb local: port {(loc.score,) + start10} != oracle {o10}")
    check((glob.score, glob.alignment[0][1], glob.alignment[0][2]) == o30,
          f"29.9 kb global: port {glob.score} != oracle {o30}")
    # The path's cost need not reach the score: the reference retrace
    # picks each move by the cell's max, not by the matrix a gap came
    # from, so its path can cost less than the optimum it starts from
    # (the JAX aligner's own path does so on seeded pairs;
    # tests/test_torch_align.py). So the cost is bounded here, and the
    # path itself is held against the plain versions, step by step, in
    # the replay below. Every prefix of a local path is a local
    # alignment: none beats the optimum.
    rs30, rs10 = rescore(base, var, glob.alignment, sc), rescore(s10, t10, loc.alignment, sc)
    rs10_max = int(np.cumsum([rescore(s10, t10, [x], sc) for x in loc.alignment]).max())
    check(path_cells(glob.alignment) == (len(base), len(var)),
          "29.9 kb global path does not cover both sequences")
    check(glob.alignment[-1][1:] in ((1, 1), (1, 0), (0, 1)),
          f"29.9 kb global path ends at {glob.alignment[-1][1:]}, not the origin")
    check(rs30 <= glob.score, f"29.9 kb path re-scores above the optimum ({rs30})")
    check(rs10_max <= loc.score, "10 kb local path re-scores above the optimum")
    # Cross-route check (after the counters were read): the 29.9 kb pair
    # through one monolithic fill, and the 10 kb pair through the
    # checkpointed path, give the same alignments as the routes above.
    mono = PairwiseAligner(sc, is_local=False, device="cuda")
    mono.DIRS_BYTE_BUDGET = 1 << 40
    g2 = mono.align(Sequence("a", base), Sequence("b", var))
    check((g2.score, g2.alignment) == (glob.score, glob.alignment),
          "29.9 kb: checkpointed and monolithic paths differ")
    l2 = align_checkpointed(Sequence("a", s10), Sequence("b", t10), sc, is_local=True,
                            block_rows=1023, device="cuda")
    check((l2.score, l2.alignment) == (loc.score, loc.alignment),
          "10 kb: monolithic and checkpointed paths differ")
    print(f"[phase 4] align on cuda: goldens ok; 10 kb local "
          f"{len(s10)}x{len(t10)} score {loc.score} start {start10} == oracle "
          f"({t_10k:.3f} s); 29.9 kb global {len(base)}x{len(var)} score "
          f"{glob.score} == oracle, checkpointed == monolithic "
          f"({t_30k_first:.3f} s cold); path costs (reference retrace, "
          f"<= score): 10 kb local {rs10} (best prefix {rs10_max}), 29.9 kb {rs30}; "
          f"launches {launches}, plain calls {plain_calls} ({t_phase:.1f} s)", flush=True)

    # Replay the 29.9 kb checkpointed path with each fill and walk it
    # makes recorded, and hold each against its plain version on the same
    # inputs: the fills on the card, the walks on the host.
    from genomics_rs_tpu_torch.models import longalign as la

    fills, walks = [], []

    def rec_fill(*args, **kw):
        out = rb.gotoh_rowblock(*args, **kw)
        fills.append((args, kw, out))
        return out

    def rec_walk(*args, **kw):
        out = td.device_walk(*args, **kw)
        walks.append((args, kw, out))
        return out

    t0 = time.perf_counter()
    la.gotoh_rowblock, la.device_walk = rec_fill, rec_walk
    try:
        g3 = PairwiseAligner(sc, device="cuda").align(Sequence("a", base), Sequence("b", var))
    finally:
        la.gotoh_rowblock, la.device_walk = rb.gotoh_rowblock, td.device_walk
    check((g3.score, g3.alignment) == (glob.score, glob.alignment),
          "29.9 kb: the recorded replay differs from the main run")
    # One block with n < 2V: the route's one fill with dirs, no forward pass.
    check(len(fills) == 1 and fills[0][1].get("emit_dirs") and walks,
          f"29.9 kb replay recorded {len(fills)} fills, not one with dirs, or no walk")
    replay, plain30 = [], {}
    for args, kw, got in fills:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = rb.gotoh_rowblock_plain(*args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        R, B, n = args[0].shape[0], args[1].shape[0], int(args[4])
        err = fill_err(got, want, R, n, B)
        k1_err = max(k1_err, err)
        kind = "dirs" if kw.get("emit_dirs") else "bottom+cols"
        plain30.setdefault(kind, ms)
        replay.append(f"K1 {R}x{B} {kind} == plain ({ms:.0f} ms)")
        check(err == 0, f"29.9 kb path: K1 {kind} fill {R}x{B} != plain: max |err| {err}")
        del want
    for args, kw, got in walks:
        want = td.device_walk(args[0].cpu(), *args[1:], **kw)
        same = np.array_equal(got[0], want[0]) and tuple(got[1:]) == tuple(want[1:])
        k2_err = max(k2_err, 0 if same else 1)
        replay.append(f"K2 walk {len(got[0])} moves == plain")
        check(same, f"29.9 kb path: K2 walk from {args[1:4]} != plain")
    print(f"[phase 4] 29.9 kb path replayed, each step held against its plain "
          f"version: {'; '.join(replay)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    del fills, walks

    # ---- phase 5: timings at the main path's shapes ----
    def cuda_ms(fn, reps):
        fn()  # warm
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return ts

    # K1 at the main path's three fills (the 10 kb pair's monolithic local
    # fill with dirs; the 29.9 kb pair's checkpointed forward with cols and
    # its refill with dirs, one block of R30 rows), at each strip height.
    fill_args, fill_kw, k1_plain_ms, plain = path_fills["10 kb local+dirs"]
    fwd_args = path_fills["29.9 kb forward+cols"][0]
    del path_fills
    k1_times = {}
    for rows in STRIP_ROWS:
        k1_times["10 kb local+dirs", rows] = cuda_ms(lambda: rb.launch(
            *fill_args[:3], None, *fill_args[3:6], 0, sc, True, True, False, False, False,
            False, {"kernel": 0}, rows), 3)
        k1_times["29.9 kb forward+cols", rows] = cuda_ms(lambda: rb.launch(
            *fwd_args[:3], None, *fwd_args[3:6], 0, sc, False, False, True, True, False,
            False, {"kernel": 0}, rows), 3)
        k1_times["29.9 kb refill+dirs", rows] = cuda_ms(lambda: rb.launch(
            *fwd_args[:3], None, *fwd_args[3:6], 0, sc, False, True, False, False, False,
            False, {"kernel": 0}, rows), 3)
    k1_ms = k1_times["10 kb local+dirs", rb.PIPE_ROWS]
    kern = rb.gotoh_rowblock(*fill_args, **fill_kw)
    err = fill_err(kern, plain, Lm10, len(t10), Ln10)
    k1_err = max(k1_err, err)
    check(err == 0, f"K1 kernel != plain at the 10 kb shape: max |err| {err}")

    si, sj = int(kern.best[1]), int(kern.best[2])
    max_steps = 24_576
    k2_ms = cuda_ms(lambda: tw.walk_full(kern.dirs, si, sj, 0, max_steps=max_steps), 5)
    t0 = time.perf_counter()
    want = td.device_walk(kern.dirs.cpu(), si, sj, 0, max_steps=max_steps)
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    got = tw.walk_full(kern.dirs, si, sj, 0, max_steps=max_steps)
    check(np.array_equal(got[0], want[0]) and got[1:] == want[1:],
          "K2 kernel != plain at the 10 kb shape")
    n_moves = len(got[0])
    k2_words = words_read(got[0][None, :], [n_moves], [si], [sj], "diag16")
    # K2's launch alone (the whole walk fits one launch of max_steps moves)
    KW2, V2 = kern.dirs.shape
    out2 = torch.empty(tw.META_SLOTS + -(-max_steps // 16), dtype=torch.int32, device=dev)
    lib = _build.library()
    k2_alone = cuda_ms(lambda: _build.check(lib.traceback_walk_launch(
        _build.ptr(kern.dirs), _build.ptr(out2), KW2, V2, si, sj, 0, 0, max_steps,
        _build.stream_handle(dev)), "traceback_walk"), 5)

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        PairwiseAligner(sc, device="cuda").align(Sequence("a", base), Sequence("b", var))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # One more under torch.profiler: device time by kernel and the device's
    # busy share of the wall.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        PairwiseAligner(sc, device="cuda").align(Sequence("a", base), Sequence("b", var))
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    dev_ms = device_ms(torch, prof)
    align_profile = (f"profiled align wall {t_prof:.4f} s, device time "
                     f"{sum(dev_ms.values()):.2f} ms (busy {sum(dev_ms.values()) / 10 / t_prof:.1f}%); "
                     + "; ".join(f"{k[:40]} {v:.2f} ms"
                                 for k, v in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:3]))
    fmt = lambda ts: ", ".join(f"{t:.3f}" for t in ts)  # noqa: E731
    rate = int32_ops_per_s(torch)
    m10, n10 = len(s10), len(t10)
    k1_cells = float(m10) * n10  # interior cells; row 0 and column 0 are closed forms
    k1_bound = bound(m10 + n10 + 12 * (n10 + 1) + k1_cells / 4 + 16,
                     k1_cells * (OPS_PER_CELL["local"] + OPS_PER_CELL["dirs"]), rate)
    # The 29.9 kb fills: characters and the top row in; bottom and cols
    # (forward) or 2 bits of dirs a cell (refill) out.
    m30, n30 = len(base), len(var)
    c30 = float(m30) * n30
    fwd_bound = bound(m30 + n30 + 12 * (n30 + 1) * 2 + 12 * m30,
                      c30 * OPS_PER_CELL["global"], rate)
    dirs_bound = bound(m30 + n30 + 12 * (n30 + 1) + c30 / 4,
                       c30 * (OPS_PER_CELL["global"] + OPS_PER_CELL["dirs"]), rate)
    k2_bound = bound(4 * k2_words + n_moves / 4 + 24, OPS_PER_MOVE * n_moves, rate)
    print(f"[phase 5] card {card} | K1 (CUDA events, ms, 3 runs) at "
          + "; ".join(f"{rows} rows a strip: " + ", ".join(
              f"{name} [{fmt(k1_times[name, rows])}]"
              for name in ("10 kb local+dirs", "29.9 kb forward+cols", "29.9 kb refill+dirs"))
              for rows in STRIP_ROWS)
          + f" | plain: 10 kb local+dirs {k1_plain_ms:.1f} ms, 29.9 kb (phase 4's path fills) "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in plain30.items())
          + f" | K2 walk of {n_moves} moves ({k2_words} words read): through walk_full "
          f"[{fmt(k2_ms)}] ms = {np.median(k2_ms) * 1e6 / n_moves:.1f} ns a move, its launch "
          f"alone [{fmt(k2_alone)}] ms = {np.median(k2_alone) * 1e6 / n_moves:.1f} ns a move "
          f"(chain floor {chain_floor(n_moves)}, {CHAIN_NS:.2f} ns a move), plain "
          f"{k2_plain_ms:.1f} ms | align 29903 bp global wall [{fmt(walls)}] s; {align_profile}",
          flush=True)

    print(f"[phase 5] bounds (int32 {rate:.4g} ops/s, {HBM_BYTES_PER_S:.3g} B/s): "
          f"K1 10 kb local+dirs {k1_bound[0]:.4f} ms ({k1_bound[1]}), 29.9 kb forward+cols "
          f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}), 29.9 kb refill+dirs {dirs_bound[0]:.4f} ms "
          f"({dirs_bound[1]}), K2 {k2_bound[0]:.6f} ms ({k2_bound[1]})", flush=True)

    rows = [
        {"name": "gotoh_rowblock", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/gotoh_rowblock.cu",
         "replaces": "genomics_rs_tpu/ops/gotoh_rowblock.py:403",
         "launches": launches["gotoh_rowblock"], "max_abs_err": float(k1_err),
         "ms": float(np.median(k1_ms)), "plain_ms": float(k1_plain_ms),
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "traceback_walk", "route": "cuda",
         "source": "genomics_rs_tpu_torch/csrc/traceback_walk.cu",
         "replaces": "genomics_rs_tpu/ops/traceback_pallas.py:260",
         "launches": launches["traceback_walk"], "max_abs_err": float(k2_err),
         "ms": float(np.median(k2_ms)), "plain_ms": float(k2_plain_ms),
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
    ]
    del kern, plain, want, got
    am_rows, corpus_tsv = align_matrix_phases(torch, dev, card, sc, cuda_ms, codes_at, rate)
    rows += am_rows
    rows += read_phases(torch, dev, card, sc, cuda_ms, rate)
    rows += banded_phases(torch, dev, card, sc, cuda_ms, rate)
    rows += protein_phases(torch, dev, card, cuda_ms, codes_at, rate)
    rows += strip_phases(torch, dev, card, sc, cuda_ms, rate,
                         dict(base=base, var=var, oracle=o30, k1_score=glob.score,
                              corpus_tsv=corpus_tsv))
    rows += seqpar_phases(torch, dev, card, sc, cuda_ms, rate,
                          dict(base=base, var=var, oracle=o30, k1_score=glob.score, glob=glob))
    suffix_phases(torch, dev, card, cuda_ms)
    scan_phases(torch, dev, card, sc)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
