"""Input generators: every input of a run is made here from ``--seed``
and the parameters of the cell's configuration and traffic files.

The sizes of a run (lengths, counts, indel sizes) come from those files
alone and are the same for every seed; the seed picks the contents, the
positions of the edits and the order. So every seed asks for the same
work, in another order.
"""

from __future__ import annotations

import numpy as np
import torch

DNA = np.frombuffer(b"ACGT", np.uint8)


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for one purpose of one run."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *tags]))


def torch_gen(seed: int, tag: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one purpose of one run."""
    s = int(rng(seed, tag).integers(0, 1 << 63))
    return torch.Generator(device=device).manual_seed(s)


def composition(cfg: dict) -> np.ndarray:
    c = cfg["composition"]
    p = np.array([c[b] for b in "ACGT"], np.float64)
    return p / p.sum()


def dna(r: np.random.Generator, n: int, p: np.ndarray) -> np.ndarray:
    """``n`` bases drawn with probabilities ``p`` over ACGT."""
    return DNA[r.choice(4, size=int(n), p=p)]


def _substitute(r, x: np.ndarray, count: int) -> np.ndarray:
    """``count`` distinct positions set to another base."""
    x = x.copy()
    pos = r.choice(x.size, size=int(count), replace=False)
    idx = np.searchsorted(DNA, x[pos])
    x[pos] = DNA[(idx + r.integers(1, 4, size=pos.size)) % 4]
    return x


def _delete(r, x: np.ndarray, size: int) -> np.ndarray:
    at = int(r.integers(0, x.size - size + 1))
    return np.concatenate([x[:at], x[at + size:]])


def _insert(r, x: np.ndarray, size: int, p: np.ndarray) -> np.ndarray:
    at = int(r.integers(0, x.size + 1))
    return np.concatenate([x[:at], dna(r, size, p), x[at:]])


def _split(total: int, parts: int) -> list[int]:
    """``total`` as ``parts`` near-equal positive sizes."""
    parts = max(1, min(parts, total))
    return [total // parts + (k < total % parts) for k in range(parts)]


def descendant(r, anc: np.ndarray, identity: float, length: int, p: np.ndarray,
               blocks: int, small_pairs: int, small_max: int) -> np.ndarray:
    """A genome derived from ``anc``: ``(1 - identity) * len(anc)``
    substitutions, ``small_pairs`` pairs of small indels of one size each
    (1..``small_max``, a deletion and an insertion: no net change), then
    the length brought to ``length`` by ``blocks`` block insertions or
    deletions at seeded places."""
    x = _substitute(r, anc, round((1.0 - identity) * anc.size))
    for size in r.integers(1, small_max + 1, size=small_pairs):
        x = _insert(r, _delete(r, x, int(size)), int(size), p)
    delta = int(length) - x.size
    for size in _split(abs(delta), blocks) if delta else []:
        x = _delete(r, x, size) if delta < 0 else _insert(r, x, size, p)
    return x


def genome_corpus(r, cfg: dict) -> list[bytes]:
    """One corpus of the configuration's comparison genomes: an ancestor
    of ``ancestor_bp`` at the stated composition and one descendant for
    each (length, identity) of ``genomes``, in a seeded order."""
    p = composition(cfg)
    anc = dna(r, cfg["ancestor_bp"], p)
    spec = cfg["genomes"]
    out = [descendant(r, anc, g["identity"], g["bp"], p, cfg["length_blocks"],
                      round((1.0 - g["identity"]) * cfg["small_indel_pairs_per_divergence"]),
                      cfg["small_indel_max"]).tobytes() for g in spec]
    return [out[k] for k in r.permutation(len(out))]


def isolate_pair(r, cfg: dict) -> tuple[bytes, bytes]:
    """(reference genome, isolate): a seeded reference of ``ancestor_bp``
    and an isolate with ``isolate.snps`` substitutions and the stated
    small deletions and insertions at seeded places."""
    p = composition(cfg)
    ref = dna(r, cfg["ancestor_bp"], p)
    iso = cfg["isolate"]
    x = _substitute(r, ref, iso["snps"])
    for size in iso["deletions"]:
        x = _delete(r, x, int(size))
    for size in iso["insertions"]:
        x = _insert(r, x, int(size), p)
    return ref.tobytes(), x.tobytes()


def lognormal_lengths(count: int, median: float, mean: float, lo: int, hi: int) -> np.ndarray:
    """``count`` lengths at the quantiles (k + 0.5) / count of a
    log-normal with the given median and mean, clipped to [lo, hi]:
    the same lengths for every seed."""
    sigma = np.sqrt(2.0 * np.log(mean / median))
    q = (torch.arange(count, dtype=torch.float64) + 0.5) / count
    z = torch.special.ndtri(q).numpy()
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def residues(gen: torch.Generator, shape, freqs: dict, device) -> torch.Tensor:
    """uint8 residues drawn on ``device`` with the stated frequencies."""
    letters = torch.tensor(list(map(ord, freqs)), dtype=torch.uint8, device=device)
    cdf = torch.tensor(np.cumsum(list(freqs.values())), dtype=torch.float64, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device) * cdf[-1]
    return letters[torch.searchsorted(cdf, u.reshape(-1), right=True).clamp_max(len(freqs) - 1)
                   ].reshape(shape)


def bucket_key(L: int) -> int:
    """Power-of-two length class (128 floor)."""
    b = 128
    while b < L:
        b *= 2
    return b
