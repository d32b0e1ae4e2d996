"""Substitution scoring beyond the reference's two scores (counterpart of
``genomics_rs_tpu/ops/subst.py``): Kimura transition/transversion
scoring, and full substitution matrices (:class:`SubstMatrix`: BLOSUM62
built in, any NCBI-format matrix from a file), which protein alignment
needs.

Characters are re-encoded once on the host side of a fill so the class
test in the DP loop is one XOR:

    A -> 0, G -> 2 (purines)   C -> 1, T -> 3 (pyrimidines)
    a -> 4, g -> 6, c -> 5, t -> 7   (soft-masked lowercase)
    any other byte b -> (b << 2) | 1024

``x == y`` iff the bytes were equal, and ``x ^ y == 2`` iff the pair is
a same-case DNA transition.

A matrix scores bytes outside its alphabet (lowercase letters, ``U``,
``O``: the alphabet is case-sensitive) as its wildcard ``X`` when it
has one, else at the matrix minimum.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

#: Kimura re-encoding table (int32[256]).
KIMURA_ENC = ((np.arange(256, dtype=np.int32) << 2) | 1024).astype(np.int32)
KIMURA_ENC[ord("A")] = 0
KIMURA_ENC[ord("G")] = 2
KIMURA_ENC[ord("C")] = 1
KIMURA_ENC[ord("T")] = 3
KIMURA_ENC[ord("a")] = 4
KIMURA_ENC[ord("g")] = 6
KIMURA_ENC[ord("c")] = 5
KIMURA_ENC[ord("t")] = 7


def kimura_active(scores) -> bool:
    """True when ``scores`` carries a transition score."""
    return getattr(scores, "s_transition", None) is not None


def encode_chars(arr, scores):
    """Map ASCII byte codes to kernel character codes (always int32).

    Classic scoring: identity. Kimura: the XOR-friendly class encoding
    above. Takes a numpy array or a tensor and returns the same kind,
    on the same device.
    """
    if isinstance(arr, np.ndarray):
        if not kimura_active(scores):
            return arr.astype(np.int32)
        return KIMURA_ENC[arr]
    if not kimura_active(scores):
        return arr.to(torch.int32)
    lut = torch.as_tensor(KIMURA_ENC, device=arr.device)
    return lut[arr.to(torch.long)]


def sentinel(value: int, scores) -> int:
    """Pad literal (``0xFD``/``0xFF``) under the active encoding: unequal
    to every real character's code and never a transition."""
    return int(KIMURA_ENC[value]) if kimura_active(scores) else value


def sub_score(c1, c2, sm, sx, st=None):
    """Per-cell substitution score on tensors of encoded characters
    (int32, like the characters)."""
    if st is None:
        return torch.where(c1 == c2, sm, sx).to(torch.int32)
    return torch.where(
        c1 == c2, sm, torch.where((c1 ^ c2) == 2, st, sx)
    ).to(torch.int32)


def sub_score_np(a: np.ndarray, b, sm: int, sx: int, st=None):
    """Numpy twin of :func:`sub_score` on raw ASCII bytes."""
    if st is None:
        return np.where(a == b, sm, sx)
    ea = KIMURA_ENC[np.asarray(a, dtype=np.uint8)]
    eb = KIMURA_ENC[np.asarray(b, dtype=np.uint8)]
    return np.where(ea == eb, sm, np.where((ea ^ eb) == 2, st, sx))


def kimura_byte_lut(scores) -> np.ndarray:
    """(256, 256) int32 byte-pair scores under kimura scoring (two-score
    when ``scores.s_transition`` is None): every byte pair through
    :func:`sub_score_np`. The JAX package's helper under its name; the
    port itself has no caller. Not ``dna_matrix(scores).byte_lut()``,
    which scores bytes outside ACGT at the matrix minimum where this
    table scores equal bytes as a match."""
    b = np.arange(256, dtype=np.uint8)
    return sub_score_np(b[:, None], b[None, :], scores.s_match, scores.s_mismatch,
                        scores.s_transition).astype(np.int32)


# ---------------------------------------------------------------------------
# Full substitution matrices (protein scoring)
# ---------------------------------------------------------------------------

#: Canonical BLOSUM62 (NCBI), alphabet ARNDCQEGHILKMFPSTWYVBZX*.
_BLOSUM62_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
_BLOSUM62_ROWS = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""


@dataclasses.dataclass(frozen=True, eq=False)
class SubstMatrix:
    """An integer substitution matrix over an explicit alphabet.

    ``matrix[i, j]`` scores alphabet char i (of s1) aligned against char
    j (of s2). Bytes outside the alphabet score as the wildcard row and
    column when the alphabet has one (``X``), else as the matrix minimum.
    """

    alphabet: str
    matrix: np.ndarray  # int32 (A, A)
    name: str = ""

    def __post_init__(self):
        A = len(self.alphabet)
        m = np.asarray(self.matrix, dtype=np.int32)
        if m.shape != (A, A):
            raise ValueError(
                f"matrix shape {m.shape} != ({A}, {A}) for alphabet {self.alphabet!r}"
            )
        if len(set(self.alphabet)) != A:
            raise ValueError(f"duplicate chars in alphabet {self.alphabet!r}")
        object.__setattr__(self, "matrix", m)

    @property
    def max_abs(self) -> int:
        return int(np.abs(self.matrix).max())

    def byte_lut(self) -> np.ndarray:
        """(256, 256) int32: the score of every byte pair (see the class
        doc for bytes outside the alphabet)."""
        fallback = self.alphabet.index("X") if "X" in self.alphabet else None
        idx = np.full(256, -1, dtype=np.int32)
        for i, ch in enumerate(self.alphabet):
            idx[ord(ch)] = i
        A = len(self.alphabet)
        ext = np.empty((A + 1, A + 1), dtype=np.int32)
        ext[:A, :A] = self.matrix
        if fallback is None:
            ext[A, :] = int(self.matrix.min())
            ext[:, A] = int(self.matrix.min())
        else:
            ext[A, : A + 1] = np.append(self.matrix[fallback], self.matrix[fallback, fallback])
            ext[: A + 1, A] = np.append(self.matrix[:, fallback], self.matrix[fallback, fallback])
        idx = np.where(idx < 0, A, idx)
        return ext[np.ix_(idx, idx)]

    def unknown_fraction(self, byte_arr) -> float:
        """Fraction of ``byte_arr`` outside this matrix's alphabet."""
        a = np.asarray(byte_arr, dtype=np.uint8).reshape(-1)
        if a.size == 0:
            return 0.0
        known = np.zeros(256, dtype=bool)
        known[[ord(c) for c in self.alphabet]] = True
        return float(np.count_nonzero(~known[a])) / a.size


def warn_unknown_bytes(matrix: SubstMatrix, byte_arr, where: str = "", threshold=0.02) -> float:
    """Log a warning when more than ``threshold`` of ``byte_arr`` falls
    outside ``matrix``'s alphabet (such bytes all score as the wildcard
    or minimum row, e.g. soft-masked lowercase protein). Returns the
    fraction."""
    frac = matrix.unknown_fraction(byte_arr)
    if frac > threshold:
        logging.getLogger(__name__).warning(
            "%s%.1f%% of input bytes are outside the %s alphabet "
            "(case-sensitive) and score as the wildcard/minimum row; "
            "uppercase soft-masked sequences if that is unintended",
            f"{where}: " if where else "",
            100 * frac,
            matrix.name or "substitution-matrix",
        )
    return frac


def blosum62() -> SubstMatrix:
    """The canonical NCBI BLOSUM62 matrix (24 x 24)."""
    rows = [[int(v) for v in line.split()] for line in _BLOSUM62_ROWS.strip().splitlines()]
    return SubstMatrix(_BLOSUM62_ALPHABET, np.asarray(rows, dtype=np.int32), "BLOSUM62")


def dna_matrix(scores) -> SubstMatrix:
    """An ACGT matrix equal to ``scores`` (with ``s_transition``): the
    bridge between the matrix fill and the two-score fills."""
    sm, sx = scores.s_match, scores.s_mismatch
    st = scores.s_transition if kimura_active(scores) else sx
    A = "ACGT"
    transitions = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}
    m = np.empty((4, 4), dtype=np.int32)
    for i, a in enumerate(A):
        for j, b in enumerate(A):
            m[i, j] = sm if a == b else (st if (a, b) in transitions else sx)
    return SubstMatrix(A, m, "dna")


def load_matrix_file(path: str) -> SubstMatrix:
    """Parse a matrix in the NCBI format: ``#`` lines are comments, the
    first data line lists the column alphabet (single chars), each later
    line is ``<row char> <ints...>``. Asymmetric matrices are accepted
    (scored as matrix[row = s1 char][col = s2 char])."""
    col_chars: list[str] = []
    row_chars: list[str] = []
    rows: list[list[int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if not col_chars:
                if any(len(p) != 1 for p in parts):
                    raise ValueError(f"{path}: header must list single chars, got {parts!r}")
                col_chars = parts
                continue
            if len(parts) != len(col_chars) + 1 or len(parts[0]) != 1:
                raise ValueError(
                    f"{path}: row {parts[:2]!r}... must be '<char> <{len(col_chars)} ints>'"
                )
            row_chars.append(parts[0])
            rows.append([int(v) for v in parts[1:]])
    if not col_chars or not rows:
        raise ValueError(f"{path}: no matrix data found")
    if row_chars != col_chars:
        raise ValueError(f"{path}: row alphabet {row_chars!r} != column alphabet {col_chars!r}")
    return SubstMatrix("".join(col_chars), np.asarray(rows, dtype=np.int32), path)


#: Built-in matrices by (upper-cased) name.
BUILTIN_MATRICES = {"BLOSUM62": blosum62}


def get_matrix(name_or_path: str) -> SubstMatrix:
    """A built-in matrix by name, else an NCBI-format file by path."""
    builtin = BUILTIN_MATRICES.get(name_or_path.upper())
    if builtin is not None:
        return builtin()
    return load_matrix_file(name_or_path)
