"""Command-line interface (counterpart of ``genomics_rs_tpu/cli.py``; the
``align`` and ``align-matrix`` subcommands so far).

  align         --alignment-type {local,global,1,0} --fasta-path FILE
                [--device {cuda,cpu}]
  align-matrix  --fasta-dir DIR [--alignment-type global] [-o TSV]
                [--alignments-out DIR] [--device {cuda,cpu}]

plus the global ``--config-path`` (default ``config.toml``). The flags,
the standard output and the files written are those of the JAX
package's subcommands (``align-matrix``'s timing line aside);
``--device`` picks the CUDA kernels (default) or their plain CPU
versions. ``is_local`` is true iff the type is exactly "local" or "1".
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

NOT_PORTED = "not yet ported (ROADMAP Queue A)"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genomics-rs-tpu-torch",
        description="FASTA pairwise alignment (Smith-Waterman / "
        "Needleman-Wunsch) on PyTorch and CUDA",
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
        help="auto and pallas run the row-block fill; scan is "
        + NOT_PORTED,
    )
    a.add_argument("--matrix", default=None, help="substitution matrix: " + NOT_PORTED)
    a.add_argument("--band", type=int, default=0, help="banded fill: " + NOT_PORTED)
    _device_flag(a)

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
        help="auto and pallas run the batched fill; scan is " + NOT_PORTED,
    )
    am.add_argument("-o", "--output", default="alignment_scores.tsv")
    am.add_argument(
        "--alignments-out",
        default=None,
        help="also write every pair's full alignment (i < j) as a "
        "2-sequence gapped FASTA in this directory",
    )
    am.add_argument("--matrix", default=None, help="substitution matrix: " + NOT_PORTED)
    _device_flag(am)
    return p


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

    for flag, used in (
        ("--matrix", args.matrix),
        ("--band", getattr(args, "band", 0)),
        ("--engine scan", args.engine == "scan"),
    ):
        if used:
            print(f"{flag} is {NOT_PORTED}", file=sys.stderr)
            return 2
    from genomics_rs_tpu_torch.device import resolve_device

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

        with trace("align"):
            aligned = align_pair(container, sc, is_local=is_local, device=device)
        print_alignment_tables(aligned, sc, is_local)
        print(format_aligned_sequences(aligned))
        return 0

    if args.mode == "align-matrix":
        from genomics_rs_tpu_torch.utils.profiling import trace

        with trace("align-matrix"):
            return _align_matrix(args, config, device, log)
    return 2


def _align_matrix(args, config, device, log) -> int:
    from genomics_rs_tpu_torch.comparison.driver import load_fasta_dir
    from genomics_rs_tpu_torch.parallel.allpairs import allpairs_scores, write_scores_tsv

    log.info("MODE: Align-Matrix (all-pairs DP scores)")
    container = load_fasta_dir(args.fasta_dir)
    log.info("Number of sequences: %d", len(container.sequences))
    is_local = args.alignment_type in ("local", "1")
    result = allpairs_scores(container, config.scores, is_local=is_local, device=device)
    print(
        f"{len(result.names)} sequences, {result.cells:.3g} DP cells "
        f"in {result.elapsed_s:.2f}s ({result.cells_per_s:.3g} cells/s)"
    )
    tsv = write_scores_tsv(result, args.output)
    print("Alignment score TSV:")
    print(tsv)
    if args.alignments_out:
        from genomics_rs_tpu_torch.models.aligner import align_batch
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
            res = align_batch(
                [(seqs[i], seqs[j]) for i, j in sub], config.scores,
                is_local=is_local, device=device,
            )
            alns.update(zip(sub, res))
        for i, j in idx:
            name, text = pair_alignment_fasta(i, j, seqs[i], seqs[j], alns[(i, j)], is_local)
            with open(os.path.join(args.alignments_out, name), "w") as f:
                f.write(text)
        print(f"wrote {len(alns)} pair alignments to {args.alignments_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
