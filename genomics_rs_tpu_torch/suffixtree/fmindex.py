"""FM-index: BWT-backed substring counting and locating, with a batched
backward search on the device (counterpart of
``genomics_rs_tpu/suffixtree/fmindex.py``).

* **build** takes the suffix array from native SA-IS on the host
  (default) or from ``ops/bwt_device.suffix_array`` on the index's
  device (``host=False``), then makes the BWT, the C array and a full
  Occ table on the host with numpy;
* **count** is classic backward search: per pattern char c,
  ``lo, hi -> C[c] + Occ[lo][c], C[c] + Occ[hi][c]``;
* **search_batch** runs many backward searches in lockstep on the
  index's device: patterns are right-aligned into one (B, Lp) buffer so
  every search starts at the same column, and a loop over the columns
  advances all B (lo, hi) ranges with two gathers from the Occ table,
  which is uploaded once and kept there;
* **locate** reads positions out of the retained suffix array.

The terminator is the reference's ``'$'`` (0x24), below A/C/G/T, so this
index's BWT equals ``compute_stats``'s for the same text.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.ops.bwt_device import TERMINATOR, suffix_array

#: calls of the lockstep device search and of the host ``_range`` loop.
COUNTS = {"device": 0, "host_range": 0}


def _search_lockstep(occ_flat: torch.Tensor, cvec: torch.Tensor, pats: torch.Tensor,
                     n: int, A: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) of every right-aligned pattern row of ``pats`` (codes,
    -1 pad on the left), on the tensors' device.

    The gather indices are int64, so ``lo * A + c`` cannot wrap at any
    text length: the JAX version's 2-D ``wide`` gather, which it needs
    once (n + 1) * A passes int32, is this one path."""
    B, Lp = pats.shape
    lo = torch.zeros(B, dtype=torch.int64, device=pats.device)
    hi = torch.full((B,), n, dtype=torch.int64, device=pats.device)
    # Last pattern char first = rightmost column first. The -1 guards
    # fire only once a shorter pattern has fully matched: its range holds.
    for col in range(Lp - 1, -1, -1):
        c = pats[:, col]
        valid = c >= 0
        c = c.clamp_min(0)
        base = cvec[c]
        lo = torch.where(valid, base + occ_flat[lo * A + c], lo)
        hi = torch.where(valid, base + occ_flat[hi * A + c], hi)
    return lo, hi


@dataclasses.dataclass(eq=False)
class FMIndex:
    """Immutable FM-index over one text (terminator appended).

    ``eq=False``: ndarray fields make a generated ``__eq__`` raise;
    indexes are identity-compared."""

    #: text bytes including the trailing terminator.
    text: bytes
    #: suffix array of ``text`` (length n = len(text)).
    sa: np.ndarray
    #: BWT bytes (length n).
    bwt: bytes
    #: sorted distinct byte values of ``text``.
    alphabet: np.ndarray
    #: byte value -> dense code, -1 for absent bytes (256,).
    code: np.ndarray
    #: (A,) count of text chars strictly below each alphabet char.
    cvec: np.ndarray
    #: (n+1, A) ranks: occ[i][c] = #occurrences of c in bwt[:i].
    occ: np.ndarray
    #: where ``search_batch(device=True)`` runs.
    device: torch.device = dataclasses.field(default=torch.device("cpu"))
    #: (occ_flat, cvec) on ``device``, uploaded by the first device search.
    _dev: tuple | None = dataclasses.field(default=None, repr=False)

    @classmethod
    def build(cls, text: str | bytes, host: bool | None = None, device="cuda") -> "FMIndex":
        """Build the index; its searches run on ``device``.

        ``host=None`` or ``True`` takes the suffix array from native SA-IS
        (``native/sais.cpp``); ``host=False`` computes it on ``device``.
        Both orders are identical."""
        dev = resolve_device(device)
        if isinstance(text, str):
            text = text.encode("latin-1")
        if bytes([TERMINATOR]) in text:
            raise ValueError("text must not contain the terminator byte '$'")
        if host is False:
            sa = suffix_array(text, dev)
        else:
            from genomics_rs_tpu_torch.suffixtree.native import native_suffix_array

            sa = native_suffix_array(text + b"$")
        s = np.frombuffer(text + b"$", dtype=np.uint8)
        n = len(s)
        bwt = s[(sa - 1) % n]
        alphabet = np.unique(s)
        A = len(alphabet)
        code = np.full(256, -1, dtype=np.int32)
        code[alphabet] = np.arange(A, dtype=np.int32)
        counts = np.bincount(s, minlength=256)[alphabet]
        cvec = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
        onehot = code[bwt][:, None] == np.arange(A, dtype=np.int32)
        occ = np.zeros((n + 1, A), dtype=np.int32)
        np.cumsum(onehot, axis=0, out=occ[1:])
        return cls(text=bytes(s), sa=sa.astype(np.int32), bwt=bwt.tobytes(),
                   alphabet=alphabet, code=code, cvec=cvec, occ=occ, device=dev)

    @property
    def n(self) -> int:
        return len(self.text)

    def _pattern_code(self, byte: int) -> int:
        """Dense code for a PATTERN byte: the terminator is part of the
        index structure but not of the user's text, so patterns containing
        it count 0 like any absent byte."""
        if byte == TERMINATOR:
            return -1
        return int(self.code[byte])

    def _range(self, pattern: bytes) -> tuple[int, int]:
        COUNTS["host_range"] += 1
        lo, hi = 0, self.n
        for byte in reversed(pattern):
            c = self._pattern_code(byte)
            if c < 0:
                return 0, 0
            lo = int(self.cvec[c]) + int(self.occ[lo, c])
            hi = int(self.cvec[c]) + int(self.occ[hi, c])
            if lo >= hi:
                return 0, 0
        return lo, hi

    def count(self, pattern: str | bytes) -> int:
        """Occurrences of ``pattern`` in the text (overlaps counted)."""
        if isinstance(pattern, str):
            pattern = pattern.encode("latin-1")
        if not pattern:
            return self.n
        lo, hi = self._range(pattern)
        return hi - lo

    def locate(self, pattern: str | bytes) -> np.ndarray:
        """Sorted start offsets of every occurrence."""
        if isinstance(pattern, str):
            pattern = pattern.encode("latin-1")
        lo, hi = self._range(pattern) if pattern else (0, self.n)
        return np.sort(self.sa[lo:hi])

    def count_batch(self, patterns: list[str | bytes], device: bool = True) -> np.ndarray:
        """Counts for many patterns (see :meth:`search_batch`)."""
        counts, _ = self.search_batch(patterns, device=device)
        return counts

    def search_batch(self, patterns: list[str | bytes], device: bool = True
                     ) -> tuple[np.ndarray, list[tuple[int, int]]]:
        """(counts, per-pattern (lo, hi) suffix-array ranges).

        ``device=True`` runs the lockstep search on the index's device,
        ``False`` the host ``_range`` loop. Patterns holding bytes absent
        from the text (the index's own terminator included) count 0 and
        never reach the device; empty patterns count n (every position),
        as in :meth:`count`."""
        B = len(patterns)
        out = np.zeros(B, dtype=np.int64)
        ranges: list[tuple[int, int]] = [(0, 0)] * B
        pb = [p.encode("latin-1") if isinstance(p, str) else p for p in patterns]
        lens = np.array([len(p) for p in pb], dtype=np.int64)
        for k in np.flatnonzero(lens == 0):
            out[k] = self.n
            ranges[k] = (0, self.n)
        joined = np.frombuffer(b"".join(pb), dtype=np.uint8)
        if joined.size == 0:
            return out, ranges
        codes_all = self.code[joined].astype(np.int32)
        codes_all[joined == TERMINATOR] = -1
        offs = np.concatenate([[0], np.cumsum(lens)])
        nz = np.flatnonzero(lens > 0)
        # reduceat segment ends are the next listed start; empty patterns
        # add no bytes, so consecutive nz starts are exact.
        bad = np.add.reduceat((codes_all < 0).astype(np.int64), offs[nz]) > 0
        keep = nz[~bad]  # searchable patterns (absent bytes count 0)
        if keep.size == 0:
            return out, ranges
        if not device:
            for k in keep:
                lo, hi = self._range(pb[int(k)])
                out[k] = hi - lo
                ranges[k] = (lo, hi)
            return out, ranges
        klens = lens[keep]
        Lp = int(klens.max())
        pats = np.full((len(keep), Lp), -1, dtype=np.int64)
        within = (np.arange(int(klens.sum()), dtype=np.int64)
                  - np.repeat(np.cumsum(klens) - klens, klens))
        rowidx = np.repeat(np.arange(len(keep)), klens)
        pats[rowidx, within + np.repeat(Lp - klens, klens)] = codes_all[
            np.repeat(offs[keep], klens) + within]
        if self._dev is None:
            self._dev = (torch.from_numpy(self.occ.reshape(-1)).to(self.device),
                         torch.from_numpy(self.cvec.astype(np.int64)).to(self.device))
        COUNTS["device"] += 1
        lo, hi = _search_lockstep(*self._dev, torch.from_numpy(pats).to(self.device),
                                  self.n, len(self.alphabet))
        lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
        out[keep] = np.maximum(hi - lo, 0)
        for row, k in enumerate(keep):
            l, h = int(lo[row]), int(hi[row])
            ranges[k] = (l, h) if h > l else (0, 0)
        return out, ranges

    def locate_range(self, rng: tuple[int, int]) -> np.ndarray:
        """Sorted text offsets for a (lo, hi) range from :meth:`search_batch`."""
        lo, hi = rng
        return np.sort(self.sa[lo:hi])


#: joins contigs in a multi-reference index. 0x23 ('#') is below every
#: DNA/protein letter and distinct from the terminator; patterns never
#: contain it, so no match can span a contig boundary.
SEPARATOR = 0x23


@dataclasses.dataclass(eq=False)
class MultiFMIndex:
    """FM-index over a multi-contig reference (one joined text).

    Contigs are joined with :data:`SEPARATOR` bytes; a match would have to
    contain the separator to cross a boundary, so every hit lies inside
    exactly one contig and locating is coordinate arithmetic over the
    contig offset table."""

    index: FMIndex
    names: list[str]
    #: (K,) start offset of each contig in the joined text.
    offsets: np.ndarray
    lengths: np.ndarray

    @classmethod
    def build(cls, refs, host: bool | None = None, device="cuda") -> "MultiFMIndex":
        """``refs``: Sequence-likes with ``.name`` and ``.sequence``.
        ``host`` and ``device`` as in :meth:`FMIndex.build`."""
        if not refs:
            raise ValueError("empty reference list")
        names, parts = [], []
        for r in refs:
            if chr(SEPARATOR) in r.sequence:
                raise ValueError(f"contig {r.name!r} contains the separator byte")
            names.append(r.name)
            parts.append(r.sequence)
        joined = chr(SEPARATOR).join(parts)
        lengths = np.array([len(p) for p in parts], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths[:-1] + 1)])
        return cls(index=FMIndex.build(joined, host=host, device=device), names=names,
                   offsets=offsets, lengths=lengths)

    @staticmethod
    def _sanitize(patterns) -> list:
        """A pattern holding a separator byte matches nothing in any
        contig: it is replaced by an unsearchable stand-in (the terminator
        byte), which the single-text index counts 0."""
        sep = chr(SEPARATOR)
        out = []
        for p in patterns:
            has_sep = SEPARATOR in p if isinstance(p, bytes) else sep in p
            out.append(b"$" if has_sep else p)
        return out

    def count_batch(self, patterns, device: bool = True) -> np.ndarray:
        return self.search_batch(patterns, device=device)[0]

    def search_batch(self, patterns, device: bool = True):
        counts, ranges = self.index.search_batch(self._sanitize(patterns), device=device)
        # Empty patterns: report the real contig positions, so that
        # count == len(locate_range(rng)) holds for every pattern.
        real = int(self.lengths.sum())
        for k, p in enumerate(patterns):
            if len(p) == 0:
                counts[k] = real
        return counts, ranges

    def locate_range(self, rng: tuple[int, int]) -> list[tuple[str, int]]:
        """Sorted (contig name, 0-based offset) for every hit."""
        hits = self.index.locate_range(rng).astype(np.int64)
        if hits.size == 0:
            return []
        k = np.searchsorted(self.offsets, hits, side="right") - 1
        local = hits - self.offsets[k]
        # Separator/terminator positions surface only for empty patterns.
        keep = local < self.lengths[k]
        return [(self.names[int(ki)], int(li)) for ki, li in zip(k[keep], local[keep])]
