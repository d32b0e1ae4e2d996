"""Command-line interface (counterpart of ``genomics_rs_tpu/cli.py``; the
``align`` subcommand only so far).

  align  --alignment-type {local,global,1,0} --fasta-path FILE
         [--device {cuda,cpu}]

plus the global ``--config-path`` (default ``config.toml``). The flags
and the standard output are those of the JAX package's ``align``;
``--device`` picks the CUDA kernels (default) or their plain CPU
versions. ``is_local`` is true iff the type is exactly "local" or "1".
"""

from __future__ import annotations

import argparse
import logging
import os
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
    a.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="cuda runs the CUDA kernels (an error without CUDA); cpu "
        "runs their plain PyTorch versions",
    )
    return p


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

    if args.mode == "align":
        for flag, used in (
            ("--matrix", args.matrix),
            ("--band", args.band),
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
    return 2


if __name__ == "__main__":
    sys.exit(main())
