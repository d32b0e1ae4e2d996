"""All-pairs genome comparison by recursive longest common substrings, and
FASTA directory loading (counterpart of the JAX package's
``comparison/driver.py``; host code, as there).

The Compare mode of the reference (``src/main.rs:216-379``):

* every ``.fasta`` file in a directory is loaded into one container, in
  sorted file-name order;
* for each pair (i, j) with i <= j the similarity score is the total
  length of recursively found longest common substrings: the LCS of the
  pair from a 2-string generalized suffix tree, then the same on the
  (prefix_i, prefix_j) and (suffix_i, suffix_j) remainders while the LCS
  is non-empty (``main.rs:267-308``);
* the matrix cell holds ``(score, len_i, len_j, first_lcs_len)`` and
  only the lower triangle (i <= j, stored at [j][i]) is filled;
* suffix links are always on in the per-pair tree (``main.rs:273-274``
  hardcodes true whatever the CLI flag says).

The pairs run on a thread pool: the native similarity call releases the
GIL.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
import time

import numpy as np

from genomics_rs_tpu_torch.sequence import SequenceContainer

log = logging.getLogger(__name__)

ENGINES = ("auto", "native", "python")


def recursive_lcs_similarity(s1: str, s2: str, alphabet_file: str,
                             engine: str = "auto") -> tuple[int, int]:
    """(total recursive LCS length, first LCS length) for one pair.

    ``"auto"`` and ``"native"`` run the whole recursion in C++ with a
    reused arena (``native/suffixtree.cpp::st_similarity``); ``"python"``
    runs the per-sub-pair loop below on the Python tree, the oracle. The
    two are output-identical, and neither falls back to the other."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (one of {ENGINES})")
    if engine != "python":
        from genomics_rs_tpu_torch.suffixtree.native import similarity_native

        return similarity_native(s1, s2, alphabet_file)
    from genomics_rs_tpu_torch.suffixtree.tree import SuffixTree

    def get_matches(a: str, b: str):
        st = SuffixTree(alphabet_file, len(a) + len(b))
        st.insert_string(a, True, False)
        st.insert_string(b, True, False)
        i, j, length = st.get_lcs(0, 1)
        return (length, i, j, a, b)

    stack = [get_matches(s1, s2)]
    first_lcs_length = stack[0][0]
    score = 0
    while stack:
        lcs_length, st_i, st_j, a, b = stack.pop()
        if lcs_length > 0:
            stack.append(get_matches(a[:st_i], b[:st_j]))
            stack.append(get_matches(a[st_i + lcs_length:], b[st_j + lcs_length:]))
        score += lcs_length
    return score, first_lcs_length


@dataclasses.dataclass
class CompareResult:
    names: list[str]
    lengths: list[int]
    #: [j][i] = (score, len_i, len_j, first_lcs) for i <= j; zeros above.
    matrix: np.ndarray
    elapsed_s: float


def load_fasta_dir(fasta_dir: str) -> SequenceContainer:
    """Every ``.fasta`` file of a directory, in sorted file-name order,
    into one container."""
    container = SequenceContainer()
    for fname in sorted(os.listdir(fasta_dir)):
        if not fname.endswith(".fasta"):
            continue
        container.from_fasta(os.path.join(fasta_dir, fname))
    return container


def compare_all_pairs(container: SequenceContainer, alphabet_file: str, threads: int = 1,
                      engine: str = "auto") -> CompareResult:
    """Fill the all-pairs similarity matrix (lower triangle), the pairs
    spread over ``threads`` threads."""
    seqs = [s.sequence for s in container.sequences]
    num = len(seqs)
    matrix = np.zeros((num, num, 4), dtype=np.int64)
    pairs = [(i, j) for j in range(num) for i in range(num) if i <= j]

    def pair(ij):
        i, j = ij
        return recursive_lcs_similarity(seqs[i], seqs[j], alphabet_file, engine)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        for (i, j), (score, first) in zip(pairs, ex.map(pair, pairs)):
            matrix[j, i] = (score, len(seqs[i]), len(seqs[j]), first)
    elapsed = time.perf_counter() - t0
    log.info("[Compare] Time taken to compare: %d us (%d ms)", int(elapsed * 1e6),
             int(elapsed * 1e3))
    return CompareResult(names=[s.name for s in container.sequences],
                         lengths=[len(s) for s in seqs], matrix=matrix, elapsed_s=elapsed)


def write_similarity_tsv(result: CompareResult, path: str = "similarity_matrix.tsv") -> str:
    """TSV in the reference's format (``main.rs:330-360``): a header row
    of indices, then one row of scores per sequence."""
    num = len(result.names)
    lines = ["\t" + "\t".join(str(i) for i in range(num)) + "\t"]
    for j in range(num):
        cells = "\t".join(str(int(result.matrix[j, i, 0])) for i in range(num))
        lines.append(f"{j}\t{cells}\t")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text
