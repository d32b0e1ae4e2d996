"""Kimura transition/transversion scoring (counterpart of the kimura part
of ``genomics_rs_tpu/ops/subst.py``; substitution matrices are not
ported yet).

Characters are re-encoded once on the host side of a fill so the class
test in the DP loop is one XOR:

    A -> 0, G -> 2 (purines)   C -> 1, T -> 3 (pyrimidines)
    a -> 4, g -> 6, c -> 5, t -> 7   (soft-masked lowercase)
    any other byte b -> (b << 2) | 1024

``x == y`` iff the bytes were equal, and ``x ^ y == 2`` iff the pair is
a same-case DNA transition.
"""

from __future__ import annotations

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
