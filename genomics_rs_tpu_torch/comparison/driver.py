"""FASTA directory loading (counterpart of ``load_fasta_dir`` in the JAX
package's ``comparison`` module of the same name; the suffix-tree
comparison is not ported yet)."""

from __future__ import annotations

import os

from genomics_rs_tpu_torch.sequence import SequenceContainer


def load_fasta_dir(fasta_dir: str) -> SequenceContainer:
    """Every ``.fasta`` file of a directory, in sorted file-name order,
    into one container."""
    container = SequenceContainer()
    for fname in sorted(os.listdir(fasta_dir)):
        if not fname.endswith(".fasta"):
            continue
        container.from_fasta(os.path.join(fasta_dir, fname))
    return container
