"""Command-line interface (counterpart of ``genomics_rs_tpu/cli.py``; all
nine of its subcommands).

  align         --alignment-type {local,global,1,0} --fasta-path FILE
                [--band N | --matrix NAME_OR_FILE]
  suffixtree    --alphabet-file FILE --fasta-path FILE [--suffix-links]
                [--stats]
  compare       --alphabet-file FILE --fasta-dir DIR [--suffix-links]
                [--threads N]
  align-matrix  --fasta-dir DIR [--alignment-type global] [-o TSV]
                [--alignments-out DIR] [--matrix NAME_OR_FILE]
  msa           --fasta-path FILE_OR_DIR... [--matrix NAME_OR_FILE]
                [--format {clustal,fasta}] [-o OUT]
  reads         -q READS -r REFS [-a local] [--align [--format {tsv,sam}]]
                [--both-strands] [--engine ...] [-o OUT]
  map           -q READS [-2 MATES] -r REF [-k 21] [--band 32] [...]
                [--format {sam,tsv}] [-o OUT]
  call          -q READS -r REF [-k 21] [--band 32] [--min-depth 8]
                [--min-frac 0.7] [...] [-o VCF]
  search        -r REF -q QUERIES [--locate] [--engine {device,host}]
                [-o OUT]

each but ``suffixtree`` and ``compare`` (host programs: the suffix tree
and its C++ core) with ``--device {cuda,cpu}``, plus the global
``--config-path`` (default ``config.toml``). The flags, the standard
output and the files written are those of the JAX package's subcommands
(timing lines aside); ``--device`` picks the CUDA kernels (default) or
their plain CPU versions, and for ``search --engine device`` the device
the backward search runs on. ``is_local`` is true iff the type is exactly
"local" or "1". ``--engine scan`` (``align``, ``align-matrix``, ``msa``,
``reads``, ``map``, ``call``) runs the JAX package's scan oracle as torch
ops on ``--device``; ``map --seed-engine device`` votes on ``--device``
(``-k`` at most 15).
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import sys

BANNER = r"""
        GENOMICS-RS-TPU
        -. .-.   .-. .-.   .-. .-.   .
        ||\|||\ /|||\|||\ /|||\|||\ /|
        |/ \|||\|||/ \|||\|||/ \|||\||
        ~   `-~ `-`   `-~ `-`   `-~ `-
"""

def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genomics-rs-tpu-torch",
        description="FASTA pairwise alignment (Smith-Waterman / "
        "Needleman-Wunsch) on PyTorch and CUDA, suffix trees + BWT, all-pairs "
        "genome comparison and FM-index search",
    )
    p.add_argument("-c", "--config-path", default="config.toml")
    sub = p.add_subparsers(dest="mode", required=True)

    a = sub.add_parser("align", help="pairwise alignment of two FASTA sequences")
    a.add_argument("-a", "--alignment-type", default="local")
    a.add_argument("-f", "--fasta-path", required=True)
    a.add_argument(
        "--engine",
        default="auto",
        choices=["auto", "scan", "pallas"],
        help="auto and pallas run the row-block fill; scan the scan fill and "
        "the host walk (the oracle)",
    )
    a.add_argument(
        "--matrix",
        default=None,
        help="full substitution matrix: a built-in name (BLOSUM62) or an "
        "NCBI-format file; protein alignment, gap costs still from the "
        "config's g/h",
    )
    a.add_argument(
        "--band",
        type=int,
        default=0,
        help="global-only: restrict the fill to a diagonal band this "
        "many columns wide (exact when the optimal path stays in "
        "band — similar pairs; chromosome-scale in seconds)",
    )
    _device_flag(a)

    st = sub.add_parser("suffixtree", help="suffix tree stats + BWT")
    st.add_argument("-a", "--alphabet-file", required=True)
    st.add_argument("--suffix-links", action="store_true")
    st.add_argument("--stats", action="store_true")
    st.add_argument("-f", "--fasta-path", required=True)

    c = sub.add_parser("compare", help="all-pairs similarity matrix over a FASTA dir")
    c.add_argument("-a", "--alphabet-file", required=True)
    c.add_argument("-f", "--fasta-dir", required=True)
    c.add_argument("--suffix-links", action="store_true",
                   help="accepted and ignored: the per-pair trees always use suffix links")
    c.add_argument("--threads", type=int, default=1)

    am = sub.add_parser(
        "align-matrix",
        help="all-pairs DP alignment-score matrix over a FASTA dir",
    )
    am.add_argument("-f", "--fasta-dir", required=True)
    am.add_argument("-a", "--alignment-type", default="global")
    am.add_argument(
        "--engine",
        default="auto",
        choices=["auto", "scan", "pallas"],
        help="auto tiers each length bucket (K6, K7/K8, K3 or K9), pallas runs "
        "K9 on every bucket; scan the scan fill (the oracle)",
    )
    am.add_argument("-o", "--output", default="alignment_scores.tsv")
    am.add_argument(
        "--alignments-out",
        default=None,
        help="also write every pair's full alignment (i < j) as a "
        "2-sequence gapped FASTA in this directory",
    )
    am.add_argument(
        "--matrix",
        default=None,
        help="score under a full substitution matrix (BLOSUM62 or an "
        "NCBI-format file): protein all-vs-all; gap costs still from the "
        "config's g/h",
    )
    _device_flag(am)

    ms = sub.add_parser(
        "msa",
        help="multiple sequence alignment (center-star over the batched aligner)",
    )
    ms.add_argument(
        "-f",
        "--fasta-path",
        required=True,
        nargs="+",
        help="FASTA file(s) or a directory of .fasta files; all sequences "
        "found are aligned together",
    )
    ms.add_argument(
        "--engine",
        default="auto",
        choices=["auto", "scan", "pallas"],
        help="auto and pallas run the batched kernels (pallas: the DNA score pass "
        "on K9); scan the scan fill and aligner (the oracle)",
    )
    ms.add_argument(
        "--matrix",
        default=None,
        help="full substitution matrix (BLOSUM62 or an NCBI-format file): "
        "protein MSA; gap costs from the config's g/h",
    )
    ms.add_argument("--format", choices=["clustal", "fasta"], default="clustal")
    ms.add_argument(
        "-o",
        "--output",
        default=None,
        help="write the alignment here as well (format follows --format); "
        "stdout always gets the clustal rendering",
    )
    _device_flag(ms)
    _reads_parsers(sub)
    return p


def _reads_parsers(sub) -> None:
    rd = sub.add_parser(
        "reads",
        help="batch-score read pairs: query[i] vs ref[i] from two FASTA/FASTQ "
        "files, auto-detected",
    )
    rd.add_argument("-q", "--queries", required=True)
    rd.add_argument("-r", "--refs", required=True)
    rd.add_argument("-a", "--alignment-type", default="local")
    rd.add_argument(
        "--engine",
        default="auto",
        choices=["auto", "shortread", "segmented", "stream", "stream8", "pallas", "scan"],
        help="auto tiers by padded length; shortread (K6), segmented (K7), stream8 "
        "(K8), stream (K3) and pallas (K9) run that kernel; scan the scan fill "
        "(the oracle)",
    )
    rd.add_argument(
        "--align",
        action="store_true",
        help="full per-read alignments (stats + CIGAR columns) instead of score-only",
    )
    rd.add_argument(
        "--both-strands",
        action="store_true",
        help="also align each query's reverse complement and keep the better "
        "orientation (adds a strand column; forward wins ties)",
    )
    rd.add_argument(
        "--format",
        choices=["tsv", "sam"],
        default="tsv",
        help="output format for --align: per-read TSV or SAM 1.6",
    )
    rd.add_argument("-o", "--output", default="read_scores.tsv")
    _device_flag(rd)

    mp = sub.add_parser(
        "map",
        help="seed-and-extend read mapping against one reference (host k-mer "
        "index + diagonal voting, batched device extension)",
    )
    mp.add_argument("-q", "--queries", required=True)
    mp.add_argument(
        "-2", "--queries2", default=None,
        help="mate file for paired-end mapping (record i pairs with record i of -q)",
    )
    mp.add_argument("--max-insert", type=int, default=1000,
                    help="max outer distance for a proper pair (paired-end only)")
    mp.add_argument("-r", "--ref", required=True)
    mp.add_argument("-k", type=int, default=21, help="seed k-mer size")
    mp.add_argument(
        "--band", type=int, default=32,
        help="diagonal vote band / extension window slack (bases); windows are "
        "read_len + 4*band wide",
    )
    mp.add_argument("--stride", type=int, default=None,
                    help="sample every stride-th read k-mer as a seed (default k//2)")
    mp.add_argument("--max-hits", type=int, default=64,
                    help="skip seeds with more reference hits than this (repeats)")
    mp.add_argument("--min-seeds", type=int, default=2,
                    help="vote threshold below which a read is unmapped")
    mp.add_argument("--single-strand", action="store_true",
                    help="map the forward orientation only")
    mp.add_argument("--engine", default="auto", choices=["auto", "pallas", "scan"],
                    help="auto and pallas extend on the kernels; scan on the scan fill")
    mp.add_argument("--seed-engine", default="host", choices=["host", "device"],
                    help="where diagonal voting runs; device needs -k <= 15 (int32 "
                    "packed keys) and is bit-identical to host")
    mp.add_argument("--format", choices=["sam", "tsv"], default="sam")
    mp.add_argument("-o", "--output", default="mapped.sam")
    _device_flag(mp)

    cl = sub.add_parser(
        "call",
        help="variant calling: map reads, pile up on the device, call consensus "
        "SNPs/deletions/insertions",
    )
    cl.add_argument("-q", "--queries", required=True)
    cl.add_argument("-r", "--ref", required=True)
    cl.add_argument("-k", type=int, default=21, help="seed k-mer size")
    cl.add_argument("--band", type=int, default=32)
    cl.add_argument("--min-seeds", type=int, default=2)
    cl.add_argument("--min-depth", type=int, default=8,
                    help="minimum pileup depth to consider a position")
    cl.add_argument("--min-frac", type=float, default=0.7,
                    help="minimum alt-supporting fraction of the depth")
    cl.add_argument("--min-baseq", type=int, default=0,
                    help="drop M/X/= bases below this Phred quality (implies "
                    "quality-weighted consensus)")
    cl.add_argument("--min-mapq", type=int, default=0,
                    help="drop reads below this mapping quality (implies "
                    "quality-weighted consensus)")
    cl.add_argument("--min-alt-conf", type=float, default=0.0,
                    help="minimum mean weight of alt-supporting bases (implies the "
                    "quality-weighted pileup)")
    cl.add_argument("--weighted", action="store_true",
                    help="weight votes by Phred*MAPQ correctness probability")
    cl.add_argument("--single-strand", action="store_true",
                    help="map the forward orientation only")
    cl.add_argument("--engine", default="auto", choices=["auto", "pallas", "scan"],
                    help="auto and pallas extend on the kernels; scan on the scan fill")
    cl.add_argument("-o", "--output", default="calls.vcf")
    _device_flag(cl)

    se = sub.add_parser(
        "search",
        help="FM-index substring search: count/locate every query in a reference "
        "(host SA-IS build, batched backward search on the device)",
    )
    se.add_argument("-r", "--ref", required=True, help="reference FASTA")
    se.add_argument("-q", "--queries", required=True,
                    help="query patterns, FASTA or FASTQ (auto-detected)")
    se.add_argument("--locate", action="store_true",
                    help="also report every match position (comma-separated)")
    se.add_argument("--engine", default="device", choices=["device", "host"],
                    help="where the batched backward search runs: on --device, or in a "
                    "host loop")
    se.add_argument("-o", "--output", default="search_hits.tsv")
    _device_flag(se)


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="cuda runs the CUDA kernels (an error without CUDA); cpu "
        "runs their plain PyTorch versions",
    )


def pair_alignment_fasta(i: int, j: int, a, b, aln, is_local: bool) -> tuple[str, str]:
    """File name and text of pair (i, j)'s gapped 2-sequence FASTA, as
    ``align-matrix --alignments-out`` writes it. A local alignment
    covers a region: its rows are the gapped region, with the spans in
    the headers (the retrace start cell, ``alignment[0]``, is the
    region's end)."""
    from genomics_rs_tpu_torch.models.msa import _alignment_ops, _gapped_pair

    ops = _alignment_ops(aln)
    if is_local:
        n1 = sum(1 for o in ops if o in "MD")
        n2 = sum(1 for o in ops if o in "MI")
        si = aln.alignment[0][1] if aln.alignment else 0
        sj = aln.alignment[0][2] if aln.alignment else 0
        rowa, rowb = _gapped_pair(a.sequence[si - n1 : si], b.sequence[sj - n2 : sj], ops)
        spans = (f" span={si - n1}-{si}", f" span={sj - n2}-{sj}")
    else:
        rowa, rowb = _gapped_pair(a.sequence, b.sequence, ops)
        spans = ("", "")
    tag = re.sub(r"[^A-Za-z0-9._-]+", "_", a.name[:24])
    tag2 = re.sub(r"[^A-Za-z0-9._-]+", "_", b.name[:24])
    lines = []
    for name, row, span in ((a.name, rowa, spans[0]), (b.name, rowb, spans[1])):
        lines.append(f">{name} score={aln.score}{span}\n")
        lines += [row[p0 : p0 + 60] + "\n" for p0 in range(0, len(row), 60)]
    return f"pair_{i}_{j}_{tag}_{tag2}.fasta", "".join(lines)


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)

    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO").upper(),
        format="%(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("genomics_rs_tpu_torch")
    print(f"\x1b[94m{BANNER}\x1b[0m")

    from genomics_rs_tpu_torch.config import get_config
    from genomics_rs_tpu_torch.sequence import SequenceContainer

    config = get_config(args.config_path)

    from genomics_rs_tpu_torch.device import resolve_device

    device = None
    if hasattr(args, "device"):
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print(e, file=sys.stderr)
            return 2

    if args.mode == "align":
        log.info("MODE: Alignment")
        container = SequenceContainer().from_fasta(args.fasta_path)
        sc = config.scores
        log.info("Using the following values for scoring:")
        log.info("Match: %d", sc.s_match)
        log.info("Mismatch: %d", sc.s_mismatch)
        log.info("Gap: %d", sc.g)
        log.info("Opening Gap: %d", sc.h)
        if sc.s_transition is not None:
            log.info("Transition: %d", sc.s_transition)
        is_local = args.alignment_type in ("local", "1")
        log.info("Alignment Type: %s", args.alignment_type)

        from genomics_rs_tpu_torch.display.alignment import (
            format_aligned_sequences,
            print_alignment_tables,
        )
        from genomics_rs_tpu_torch.models.aligner import align_pair
        from genomics_rs_tpu_torch.utils.profiling import trace

        matrix = None
        if args.matrix:
            from genomics_rs_tpu_torch.ops.subst import get_matrix

            matrix = get_matrix(args.matrix)
            log.info("Substitution matrix: %s (%d chars)", matrix.name or args.matrix,
                     len(matrix.alphabet))
            if args.band:
                print("--matrix and --band are mutually exclusive", file=sys.stderr)
                return 2

        if args.band:
            if is_local:
                print(
                    "--band is global-only (banded local alignment is "
                    "served by the map/reads modes)",
                    file=sys.stderr,
                )
                return 2
            from genomics_rs_tpu_torch.models.banded import align_banded

            seqs = container.sequences
            if len(seqs) > 2:
                log.warning("More than two sequences found. Only the first two will be used.")
            with trace("align"):
                aligned = align_banded(seqs[0], seqs[1], sc, band=args.band, device=device)
        else:
            with trace("align"):
                aligned = align_pair(container, sc, is_local=is_local, device=device,
                                     matrix=matrix, engine=args.engine)
        print_alignment_tables(aligned, sc, is_local, matrix=matrix)
        print(format_aligned_sequences(aligned))
        return 0

    from genomics_rs_tpu_torch.utils.profiling import trace

    modes = {"suffixtree": _suffixtree, "compare": _compare, "align-matrix": _align_matrix,
             "msa": _msa, "reads": _reads, "map": _map, "call": _call, "search": _search}
    with trace(args.mode):
        return modes[args.mode](args, config, device, log)


def _suffixtree(args, config, device, log) -> int:
    from genomics_rs_tpu_torch.display.tree import format_tree, format_tree_stats
    from genomics_rs_tpu_torch.sequence import SequenceContainer
    from genomics_rs_tpu_torch.suffixtree import make_tree
    from genomics_rs_tpu_torch.suffixtree.tree import SuffixTree

    log.info("MODE: Suffix Tree")
    log.info("Suffix links: %s", args.suffix_links)
    seq = SequenceContainer().from_fasta(args.fasta_path).sequences[0].sequence
    # Small trees take the Python tree, whose nodes the full display
    # (Graphviz DOT for < 100 nodes) walks.
    small = len(seq) < 64
    tree = SuffixTree(args.alphabet_file, len(seq)) if small else make_tree(
        args.alphabet_file, len(seq))
    tree.insert_string(seq, args.suffix_links, True)
    if args.stats:
        tree.compute_stats(0)
        stem = os.path.basename(args.fasta_path).replace(".fasta", "")
        bwt_path = os.path.join("BWT_out", f"{stem}_bwt.txt")
        log.info("BWT Path: %s", bwt_path)
        os.makedirs("BWT_out", exist_ok=True)
        with open(bwt_path, "w") as f:
            for ch in tree.stats.bwt:
                f.write(ch + "\n")
        if small:
            # LOG_LEVEL=DEBUG adds the string-depth dump, as RUST_LOG=debug
            # does in the reference.
            debug = os.environ.get("LOG_LEVEL", "INFO").upper() == "DEBUG"
            print(format_tree(tree, debug=debug))
        else:
            print(format_tree_stats(tree.stats))
    return 0


def _compare(args, config, device, log) -> int:
    from genomics_rs_tpu_torch.comparison.display import print_similarity_matrix
    from genomics_rs_tpu_torch.comparison.driver import (
        compare_all_pairs,
        load_fasta_dir,
        write_similarity_tsv,
    )

    log.info("MODE: Compare")
    log.info("Alphabet file: %s", args.alphabet_file)
    log.info("Suffix links: %s", args.suffix_links)
    log.info("FASTA directory: %s", args.fasta_dir)
    container = load_fasta_dir(args.fasta_dir)
    log.info("Number of sequences: %d", len(container.sequences))
    result = compare_all_pairs(container, args.alphabet_file, threads=args.threads)
    print_similarity_matrix(result.matrix)
    tsv = write_similarity_tsv(result)
    print("Similarity TSV:")
    print(tsv)
    print("\nLCS Length TSV:")
    num = len(result.names)
    print(" \t" + "\t".join(str(i) for i in range(num)) + "\t")
    for j in range(num):
        print(f"{j}\t" + "\t".join(str(int(result.matrix[j, i, 3])) for i in range(num))
              + "\t")
    return 0


def _align_matrix(args, config, device, log) -> int:
    from genomics_rs_tpu_torch.comparison.driver import load_fasta_dir
    from genomics_rs_tpu_torch.parallel.allpairs import allpairs_scores, write_scores_tsv

    log.info("MODE: Align-Matrix (all-pairs DP scores)")
    container = load_fasta_dir(args.fasta_dir)
    log.info("Number of sequences: %d", len(container.sequences))
    is_local = args.alignment_type in ("local", "1")
    mx = None
    if args.matrix:
        from genomics_rs_tpu_torch.ops.subst import get_matrix
        from genomics_rs_tpu_torch.parallel.allpairs import allpairs_matrix_scores

        mx = get_matrix(args.matrix)
        log.info("Substitution matrix: %s (%d chars)", mx.name or args.matrix, len(mx.alphabet))
        result = allpairs_matrix_scores(container, mx, g=config.scores.g, h=config.scores.h,
                                        is_local=is_local, device=device)
    else:
        result = allpairs_scores(container, config.scores, is_local=is_local,
                                 engine=args.engine, device=device)
    print(
        f"{len(result.names)} sequences, {result.cells:.3g} DP cells "
        f"in {result.elapsed_s:.2f}s ({result.cells_per_s:.3g} cells/s)"
    )
    tsv = write_scores_tsv(result, args.output)
    print("Alignment score TSV:")
    print(tsv)
    if args.alignments_out:
        from genomics_rs_tpu_torch.models.aligner import align_batch, matrix_align_batch
        from genomics_rs_tpu_torch.parallel.allpairs import bucketize_pairs

        os.makedirs(args.alignments_out, exist_ok=True)
        seqs = container.sequences
        idx = [(i, j) for j in range(len(seqs)) for i in range(len(seqs)) if i < j]
        # Length-bucketed batches (a mixed directory would pad every
        # pair to the global max otherwise).
        groups = bucketize_pairs(idx, [len(s) for s in seqs])
        alns: dict[tuple[int, int], object] = {}
        for key in sorted(groups):
            sub = [idx[k] for k in groups[key]]
            batch = [(seqs[i], seqs[j]) for i, j in sub]
            if mx is not None:
                res = matrix_align_batch(batch, mx, g=config.scores.g, h=config.scores.h,
                                         is_local=is_local, device=device)
            else:
                res = align_batch(batch, config.scores, is_local=is_local, device=device,
                                  engine=args.engine)
            alns.update(zip(sub, res))
        for i, j in idx:
            name, text = pair_alignment_fasta(i, j, seqs[i], seqs[j], alns[(i, j)], is_local)
            with open(os.path.join(args.alignments_out, name), "w") as f:
                f.write(text)
        print(f"wrote {len(alns)} pair alignments to {args.alignments_out}")
    return 0


def _msa(args, config, device, log) -> int:
    from genomics_rs_tpu_torch.comparison.driver import load_fasta_dir
    from genomics_rs_tpu_torch.models.msa import (
        center_star_msa,
        format_msa_clustal,
        write_msa_fasta,
    )
    from genomics_rs_tpu_torch.sequence import SequenceContainer

    log.info("MODE: MSA (center-star multiple alignment)")
    container = SequenceContainer()
    for path in args.fasta_path:
        if os.path.isdir(path):
            container.sequences.extend(load_fasta_dir(path).sequences)
        else:
            container.from_fasta(path)
    log.info("Number of sequences: %d", len(container.sequences))
    if len(container.sequences) < 2:
        log.error("msa needs at least two sequences")
        return 1
    msa_matrix = None
    if args.matrix:
        from genomics_rs_tpu_torch.ops.subst import get_matrix

        msa_matrix = get_matrix(args.matrix)
        log.info("Substitution matrix: %s (%d chars)", msa_matrix.name or args.matrix,
                 len(msa_matrix.alphabet))
    result = center_star_msa(container, config.scores, engine=args.engine, matrix=msa_matrix,
                             device=device)
    log.info("center: %s, alignment width %d", result.names[result.center_index], result.width)
    print(format_msa_clustal(result))
    if args.output:
        if args.format == "fasta":
            write_msa_fasta(result, args.output)
        else:
            with open(args.output, "w") as f:
                f.write(format_msa_clustal(result) + "\n")
        print(f"wrote {args.output}")
    return 0


def _load_pairs(args, log):
    """(queries, refs) of ``reads``, one reference broadcast over many
    reads; None after logging a count mismatch."""
    from genomics_rs_tpu_torch.sequence import SequenceContainer

    queries = SequenceContainer().from_reads(args.queries).sequences
    refs = SequenceContainer().from_reads(args.refs).sequences
    if len(refs) == 1 and len(queries) > 1:
        log.info("one reference for %d reads: broadcasting", len(queries))
        refs = refs * len(queries)
    if len(queries) != len(refs):
        log.error("query/ref count mismatch: %d vs %d", len(queries), len(refs))
        return None
    return queries, refs


def _reads(args, config, device, log) -> int:
    import time

    import numpy as np

    log.info("MODE: Reads (batch pair scoring)")
    loaded = _load_pairs(args, log)
    if loaded is None:
        return 1
    queries, refs = loaded
    is_local = args.alignment_type in ("local", "1")
    B = len(queries)
    if args.format == "sam" and not args.align:
        log.error("--format sam requires --align (per-read CIGARs)")
        return 1
    if args.align:
        from genomics_rs_tpu_torch.models.reads import align_reads, write_sam

        # align_reads takes scan or auto; the score-only kernels' names
        # mean auto routing.
        rd_engine = args.engine if args.engine in ("scan", "auto") else "auto"
        if rd_engine != args.engine:
            log.info("engine %s is score-only; --align uses auto routing", args.engine)
        want_sam = args.format == "sam"
        t0 = time.perf_counter()
        res = align_reads(queries, refs, config.scores, is_local=is_local, engine=rd_engine,
                          with_paths=False, with_cigars=True, both_strands=args.both_strands,
                          with_mapinfo=want_sam, device=device)
        aligned, cigars = res[0], res[1]
        strands = res[2] if args.both_strands else None
        mapinfo = res[-1] if want_sam else None
        print(f"{B} reads aligned in {time.perf_counter() - t0:.3f}s")
        if want_sam:
            write_sam(args.output, refs, aligned, cigars, mapinfo, strands)
            print(f"wrote {args.output}")
            return 0
        with open(args.output, "w") as f:
            strand_col = "\tstrand" if strands is not None else ""
            f.write("query\tref\tscore\tmatches\tmismatches\t"
                    f"gap_extensions\topening_gaps\tcigar{strand_col}\n")
            for k, (q, r, a, cg) in enumerate(zip(queries, refs, aligned, cigars)):
                tail = f"\t{strands[k]}" if strands is not None else ""
                f.write(f"{q.name}\t{r.name}\t{a.score}\t{a.matches}\t{a.mismatches}\t"
                        f"{a.gap_extensions}\t{a.opening_gaps}\t{cg}{tail}\n")
        print(f"wrote {args.output}")
        return 0

    from genomics_rs_tpu_torch.models.reads import encode_batch
    from genomics_rs_tpu_torch.parallel.batch import score_pairs
    from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, round_up

    sq = list(queries)
    if args.both_strands:
        sq = sq + [q.reverse_complement() for q in sq]  # one launch for both
    sr = refs * 2 if args.both_strands else refs
    L1 = round_up(max(max(len(s) for s in sq), 1), 128)
    L2 = round_up(max(max(len(s) for s in sr), 1), 128)
    s1b = encode_batch(sq, L1, PAD_S1)
    s2b = encode_batch(sr, L2, PAD_S2)
    ms = np.array([len(s) for s in sq], dtype=np.int32)
    ns = np.array([len(s) for s in sr], dtype=np.int32)
    t0 = time.perf_counter()
    sc, si, sj = score_pairs(s1b, s2b, ms, ns, config.scores, is_local, engine=args.engine,
                             device=device)
    dt = time.perf_counter() - t0
    cells = float(np.sum((ms + 1.0) * (ns + 1.0)))
    print(f"{len(ms)} pairs, {cells:.3g} DP cells in {dt:.3f}s ({cells / dt:.3g} cells/s)")
    if args.both_strands:
        use_rc = sc[B:] > sc[:B]  # forward wins ties
        pick = np.where(use_rc, np.arange(B) + B, np.arange(B))
        sc, si, sj = sc[pick], si[pick], sj[pick]
    with open(args.output, "w") as f:
        strand_col = "\tstrand" if args.both_strands else ""
        f.write(f"query\tref\tscore\tend_i\tend_j{strand_col}\n")
        for k in range(B):
            tail = "\t" + ("-" if use_rc[k] else "+") if args.both_strands else ""
            f.write(f"{queries[k].name}\t{refs[k].name}\t{int(sc[k])}\t"
                    f"{int(si[k])}\t{int(sj[k])}{tail}\n")
    print(f"wrote {args.output}")
    return 0


def _map(args, config, device, log) -> int:
    import time

    from genomics_rs_tpu_torch.models.mapper import KmerIndex, map_reads
    from genomics_rs_tpu_torch.models.reads import sam_records, write_sam
    from genomics_rs_tpu_torch.sequence import SequenceContainer

    log.info("MODE: Map (seed-and-extend read mapping)")
    queries = SequenceContainer().from_reads(args.queries).sequences
    refs = SequenceContainer().from_reads(args.ref).sequences
    if not queries or not refs:
        log.error("no reads or no reference loaded")
        return 1
    t0 = time.perf_counter()
    try:
        index = KmerIndex(refs, args.k)
        if args.seed_engine == "device":
            index.device_arrays(device)  # validates k and the length up front
    except ValueError as e:
        log.error("%s", e)
        return 1
    t_index = time.perf_counter() - t0
    kw = dict(index=index, stride=args.stride, band=args.band, max_hits=args.max_hits,
              min_seeds=args.min_seeds, both_strands=not args.single_strand,
              engine=args.engine, seed_engine=args.seed_engine, device=device)
    if args.queries2 is not None:
        from genomics_rs_tpu_torch.models.mapper import map_pairs, write_sam_paired

        mates = SequenceContainer().from_reads(args.queries2).sequences
        if len(mates) != len(queries):
            log.error("mate count mismatch: %d vs %d", len(queries), len(mates))
            return 1
        if args.format != "sam":
            log.error("paired-end mapping writes SAM (--format sam)")
            return 1
        t0 = time.perf_counter()
        try:
            res1, res2 = map_pairs(queries, mates, refs, config.scores, **kw)
        except ValueError as e:
            log.error("%s", e)
            return 1
        t_map = time.perf_counter() - t0
        n_mapped = sum(r.mapped for r in res1 + res2)
        proper = write_sam_paired(args.output, res1, res2, header_refs=refs,
                                  max_insert=args.max_insert)
        print(f"{n_mapped}/{2 * len(res1)} ends mapped, {proper}/{len(res1)} proper pairs "
              f"in {t_map:.3f}s (index {len(index)} {args.k}-mers in {t_index:.3f}s)")
        print(f"wrote {args.output}")
        return 0
    t0 = time.perf_counter()
    try:
        results = map_reads(queries, refs, config.scores, **kw)
    except ValueError as e:
        log.error("%s", e)
        return 1
    t_map = time.perf_counter() - t0
    n_mapped = sum(r.mapped for r in results)
    print(f"{n_mapped}/{len(results)} reads mapped in {t_map:.3f}s "
          f"(index {len(index)} {args.k}-mers in {t_index:.3f}s)")
    cols = ([r.contig for r in results], [r.aligned for r in results],
            [r.cigar for r in results], [r.mapinfo for r in results],
            [r.strand for r in results])
    if args.format == "sam":
        write_sam(args.output, *cols, header_refs=refs, mapqs=[r.mapq for r in results])
    else:
        # Edge runs fold as in the SAM writer, so both formats report
        # the same position.
        with open(args.output, "w") as f:
            f.write("query\tref\tstrand\tmapped\tpos\tscore\tmapq\tseeds\tcigar\n")
            for r, rec in zip(results, sam_records(*cols)):
                rname = r.contig.name if r.mapped else "*"
                f.write(f"{r.read.name}\t{rname}\t{r.strand}\t{int(r.mapped)}\t"
                        f"{rec['pos']}\t{r.score}\t{r.mapq}\t{r.seeds}\t{r.cigar}\n")
    print(f"wrote {args.output}")
    return 0


def _call(args, config, device, log) -> int:
    import time

    from genomics_rs_tpu_torch.models.caller import call_reads, write_vcf
    from genomics_rs_tpu_torch.sequence import SequenceContainer

    log.info("MODE: Call (map -> pileup -> consensus variants)")
    queries = SequenceContainer().from_reads(args.queries).sequences
    refs = SequenceContainer().from_reads(args.ref).sequences
    if not queries or not refs:
        log.error("no reads or no reference loaded")
        return 1
    t0 = time.perf_counter()
    try:
        calls, pileups = call_reads(
            queries, refs, config.scores, min_depth=args.min_depth, min_frac=args.min_frac,
            min_baseq=args.min_baseq, min_mapq=args.min_mapq, weighted=args.weighted,
            min_alt_conf=args.min_alt_conf, device=device, k=args.k, band=args.band,
            min_seeds=args.min_seeds, both_strands=not args.single_strand,
            engine=args.engine,
        )
    except ValueError as e:
        log.error("%s", e)
        return 1
    dt = time.perf_counter() - t0
    write_vcf(args.output, calls, refs)
    covered = sum(int((p.sum(axis=1) > 0).sum()) for p in pileups.values())
    print(f"{len(calls)} variants from {len(queries)} reads ({covered} reference positions "
          f"covered) in {dt:.3f}s")
    print(f"wrote {args.output}")
    return 0


def _search(args, config, device, log) -> int:
    import time

    from genomics_rs_tpu_torch.models.reads import _sam_token
    from genomics_rs_tpu_torch.sequence import SequenceContainer
    from genomics_rs_tpu_torch.suffixtree.fmindex import MultiFMIndex

    log.info("MODE: Search (FM-index substring queries)")
    refs = SequenceContainer().from_fasta(args.ref).sequences
    queries = SequenceContainer().from_reads(args.queries).sequences
    if not refs or not queries:
        log.error("no reference or no queries loaded")
        return 1
    t0 = time.perf_counter()
    index = MultiFMIndex.build(refs, device=device)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts, ranges = index.search_batch([q.sequence for q in queries],
                                        device=args.engine == "device")
    t_search = time.perf_counter() - t0
    multi = len(refs) > 1
    with open(args.output, "w") as f:
        pos_col = "\tpositions" if args.locate else ""
        f.write(f"query\tcount{pos_col}\n")
        for q, c, rng in zip(queries, counts, ranges):
            tail = ""
            if args.locate:
                # The batch search gave the SA range: locating is a slice
                # and an offset map.
                tail = "\t" + ",".join(f"{_sam_token(name)}:{off}" if multi else str(off)
                                       for name, off in index.locate_range(rng))
            f.write(f"{q.name}\t{int(c)}{tail}\n")
    print(f"indexed {int(index.lengths.sum())} bases ({len(refs)} contigs) in {t_build:.3f}s; "
          f"{len(queries)} queries in {t_search:.3f}s ({sum(int(c) for c in counts)} total hits)")
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
