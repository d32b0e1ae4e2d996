"""Seed-and-extend read mapping against long (multi-contig) references
(counterpart of ``genomics_rs_tpu/models/mapper.py``).

* **host**: an exact k-mer index of the reference (2-bit Horner-packed
  keys, sorted array + binary search) and per-read candidate windows by
  diagonal voting, vectorized over the whole read batch;
* **device**: every candidate window is extended in batched rounds
  through :func:`~genomics_rs_tpu_torch.models.reads.align_reads` in
  local mode (K6 with ``walk_rows16`` for windows up to 256 bytes, K3
  with K4 beyond), so unaligned read ends become soft clips.

Strand handling mirrors ``align_reads(both_strands=True)``: the
reverse-complemented reads ride the same seeding pass, the orientation
with more votes wins (forward wins ties), and a ``"-"`` result's
coordinates and CIGAR are those of the oriented read.

``seed_engine="device"`` votes on the device instead
(:func:`_vote_windows_device`, the JAX package's jitted twin as torch
ops): every sampled seed owns ``max_hits`` hit slots, each read's bins
are sorted, and a bin pair's vote is counted by two batched binary
searches of the row into itself. It needs ``k <= 15`` (int32 keys,
:meth:`KmerIndex.device_arrays`) and gives the host vote's results bit
for bit.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os

import numpy as np
import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.models.reads import (
    _sam_header,
    _sam_line,
    align_reads,
    encode_batch,
    sam_records,
)
from genomics_rs_tpu_torch.ops.traceback import AlignedSequences
from genomics_rs_tpu_torch.sequence import Sequence

#: Row-chunk size for thread-parallel seeding (reads per chunk).
_PAR_CHUNK = 16384

#: ASCII byte -> 2-bit base code; 0xFF marks non-ACGT (either case).
_BASE = np.full(256, 0xFF, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE[_c] = _i
for _i, _c in enumerate(b"acgt"):
    _BASE[_c] = _i


def _pack_rows(enc4: np.ndarray, k: int):
    """Horner-pack every k-window of each row of a (B, L) 2-bit-code
    matrix: returns ``(keys, valid)`` of shape (B, L-k+1). ``valid`` is
    False where the window holds a non-ACGT byte (code >= 4; padding
    uses 0xFF, so padded tails are invalid)."""
    B, L = enc4.shape
    n = L - k + 1
    if n <= 0:
        return np.zeros((B, 0), np.uint64), np.zeros((B, 0), bool)
    keys = np.zeros((B, n), np.uint64)
    for i in range(k):
        keys = (keys << np.uint64(2)) | (enc4[:, i : i + n].astype(np.uint64) & np.uint64(3))
    bad = (enc4 >= 4).astype(np.int32)
    c = np.concatenate([np.zeros((B, 1), np.int32), np.cumsum(bad, axis=1)], axis=1)
    valid = (c[:, k:] - c[:, :-k]) == 0
    return keys, valid


class KmerIndex:
    """Sorted exact k-mer index of one or more reference contigs.

    Positions are 0-based window starts in the global concatenated
    coordinate space (``starts[c]`` maps them back), ascending within one
    key. Windows never cross a contig boundary and never hold a non-ACGT
    byte.
    """

    def __init__(self, ref: Sequence | list[Sequence], k: int = 21):
        if not 4 <= k <= 31:
            raise ValueError(f"k={k} outside [4, 31] (2-bit uint64 pack)")
        self.refs: list[Sequence] = [ref] if isinstance(ref, Sequence) else list(ref)
        if not self.refs:
            raise ValueError("empty reference list")
        self.k = k
        self.starts = np.concatenate([[0], np.cumsum([len(r) for r in self.refs])]).astype(np.int64)
        all_keys, all_pos = [], []
        for c, r in enumerate(self.refs):
            keys, valid = _pack_rows(_BASE[r.encoded()][None, :], k)
            pos = np.flatnonzero(valid[0])
            all_keys.append(keys[0][pos])
            all_pos.append(pos.astype(np.int64) + self.starts[c])
        keys = np.concatenate(all_keys)
        pos = np.concatenate(all_pos)
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._pos = pos[order]
        self._dev: dict = {}

    @property
    def ref(self) -> Sequence:
        """The first (or only) reference contig."""
        return self.refs[0]

    def contig_of(self, gpos: int) -> int:
        """Contig id owning global position ``gpos``."""
        return int(np.searchsorted(self.starts, gpos, "right") - 1)

    def __len__(self) -> int:
        return int(self._keys.size)

    def device_arrays(self, device="cuda"):
        """The index as int32 tensors ``(keys, positions)`` on ``device``,
        made once a device. Device seeding needs ``k <= 15``, so packed
        keys fit 30 bits, and a total length below 2^31."""
        if self.k > 15:
            raise ValueError(
                f"device seeding requires k <= 15 (int32 keys); index has k={self.k}"
            )
        if int(self.starts[-1]) > np.iinfo(np.int32).max:
            raise ValueError(
                "device seeding requires total reference length "
                f"< 2^31 (got {int(self.starts[-1])}); use the host seed engine"
            )
        dev = resolve_device(device)
        if dev not in self._dev:
            self._dev[dev] = (
                torch.from_numpy(self._keys.astype(np.int64).astype(np.int32)).to(dev),
                torch.from_numpy(self._pos.astype(np.int32)).to(dev),
            )
        return self._dev[dev]

    def lookup(self, key: int) -> np.ndarray:
        lo = np.searchsorted(self._keys, np.uint64(key), "left")
        hi = np.searchsorted(self._keys, np.uint64(key), "right")
        return self._pos[lo:hi]


@dataclasses.dataclass
class MappedRead:
    """One read's mapping result (input order is preserved).

    ``read`` is the oriented read (reverse-complemented when ``strand ==
    "-"``); ``contig`` the reference sequence it mapped to (the first
    contig for unmapped reads); ``mapinfo = (i0, j0, end_i, end_j)``
    spans query rows ``(i0, end_i]`` and contig-relative reference
    columns ``(j0, end_j]``; ``seeds`` is the winning window's vote
    count; ``mapq`` is ``min(60, 6 * (seeds - runner_up_seeds))``, 0 for
    unmapped reads."""

    read: Sequence
    contig: Sequence
    strand: str
    mapped: bool
    score: int
    mapinfo: tuple[int, int, int, int]
    cigar: str
    aligned: AlignedSequences
    seeds: int
    mapq: int = 255


def _vote_windows(index: KmerIndex, enc4: np.ndarray, stride: int, max_hits: int,
                  band: int):
    """Best candidate window per row of a (R, L) read matrix.

    Returns ``(votes, wlo, whi, anchor, votes2)`` per row: the winning
    diagonal bin pair's vote count, its diagonal span ``[wlo, whi)``,
    ``anchor`` (the smallest reference hit position among the winning
    bins' hits, a real global coordinate that names the contig) and
    ``votes2`` (the second-best non-overlapping bin pair's count, the
    margin behind MAPQ). Rows with no in-cap seed hit get votes 0 and
    anchor -1.
    """
    R, L = enc4.shape
    k = index.k
    n = L - k + 1
    votes = np.zeros(R, np.int64)
    votes2 = np.zeros(R, np.int64)
    wlo = np.zeros(R, np.int64)
    anchor = np.full(R, -1, np.int64)
    if n <= 0:
        return votes, wlo, wlo, anchor, votes2
    # Big batches: independent row chunks across threads (the hot numpy
    # ops release the GIL), bit-identical to one pass.
    if R >= 2 * _PAR_CHUNK:
        chunks = [(s, min(s + _PAR_CHUNK, R)) for s in range(0, R, _PAR_CHUNK)]
        with cf.ThreadPoolExecutor(min(os.cpu_count() or 1, len(chunks))) as pool:
            parts = list(pool.map(
                lambda se: _vote_windows(index, enc4[se[0] : se[1]], stride, max_hits, band),
                chunks))
        return tuple(np.concatenate(xs) for xs in zip(*parts))
    offs = np.arange(0, n, stride)
    # Pack only the sampled offsets (k gathers of (R, S) columns).
    skeys = np.zeros((R, offs.size), np.uint64)
    sbad = np.zeros((R, offs.size), bool)
    for i in range(k):
        col = enc4[:, offs + i]
        skeys = (skeys << np.uint64(2)) | (col & 3).astype(np.uint64)
        sbad |= col >= 4
    lo = np.searchsorted(index._keys, skeys.ravel(), "left")
    hi = np.searchsorted(index._keys, skeys.ravel(), "right")
    cnt = hi - lo
    use = ~sbad.ravel() & (cnt > 0) & (cnt <= max_hits)
    lo, cnt = lo[use], cnt[use]
    if lo.size == 0:
        return votes, wlo, wlo, anchor, votes2
    rid = np.repeat(np.arange(R), offs.size)[use]
    off = np.tile(offs, R)[use]
    # Ragged expansion of the [lo, lo + cnt) hit runs into flat arrays.
    total = int(cnt.sum())
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    hit_idx = np.repeat(lo, cnt) + (np.arange(total, dtype=np.int64) - np.repeat(starts, cnt))
    pos = index._pos[hit_idx]
    rid_f = np.repeat(rid, cnt)
    diag = pos - np.repeat(off, cnt)
    # Vote per (read, diagonal band); windows cover bin pairs (b, b+1),
    # so hits straddling a bin edge still count together.
    bins = diag // band
    binmin = bins.min()
    combo = rid_f * np.int64(1 << 40) + (bins - binmin)
    order0 = np.argsort(combo, kind="stable")
    combo_s = combo[order0]
    pos_s = pos[order0]
    ub, first0 = np.unique(combo_s, return_index=True)
    uc = np.diff(np.concatenate([first0, [combo_s.size]]))
    uminpos = np.minimum.reduceat(pos_s, first0)
    nxt = np.searchsorted(ub, ub + 1)
    has_nxt = (nxt < ub.size) & (ub[np.minimum(nxt, ub.size - 1)] == ub + 1)
    nxt_cl = np.minimum(nxt, ub.size - 1)
    pair = uc + np.where(has_nxt, uc[nxt_cl], 0)
    pairpos = np.minimum(uminpos, np.where(has_nxt, uminpos[nxt_cl], np.iinfo(np.int64).max))
    urid = (ub >> np.int64(40)).astype(np.int64)
    ubin = (ub & np.int64((1 << 40) - 1)) + binmin
    # Per-read argmax over bin pairs (ties -> smallest diagonal bin).
    order = np.lexsort((ubin, -pair, urid))
    urid_s = urid[order]
    first = np.unique(urid_s, return_index=True)[1]
    rows = order[first]
    votes[urid_s[first]] = pair[rows]
    wlo[urid_s[first]] = ubin[rows] * band
    anchor[urid_s[first]] = pairpos[rows]
    # Second-best non-overlapping bin pair (|bin - winner| > 1).
    winbin = np.full(R, np.int64(1) << 60)
    winbin[urid_s[first]] = ubin[rows]
    pair2 = np.where(np.abs(ubin - winbin[urid]) <= 1, -1, pair)
    order2 = np.lexsort((ubin, -pair2, urid))
    urid_s2 = urid[order2]
    first2 = np.unique(urid_s2, return_index=True)[1]
    votes2[urid_s2[first2]] = np.maximum(pair2[order2[first2]], 0)
    return votes, wlo, wlo + 2 * band, anchor, votes2


def _device_vote(enc4c: torch.Tensor, keys: torch.Tensor, pos: torch.Tensor,
                 offs: torch.Tensor, k: int, H: int, band: int):
    """The fixed-shape vote of one chunk of reads, as torch ops on the
    device of ``enc4c`` (the JAX package's ``_device_vote_fn``): ``(votes,
    wlo, anchor, votes2)`` int32 (C,).

    Every sampled seed owns ``H`` hit slots (masked past its true count; a
    seed over the cap gives none, like the host filter). Each read's bins
    are sorted, and the bin-pair vote at every hit is its bin's count plus
    bin+1's, by two batched binary searches of the row into itself. The
    winner is the first maximum of the sorted row, the smallest bin
    holding it (the host tie-break), found by a masked min over positions
    rather than ``argmax``.
    """
    C = enc4c.shape[0]
    S = offs.numel()
    skeys = torch.zeros((C, S), dtype=torch.int32, device=enc4c.device)
    bad = torch.zeros((C, S), dtype=torch.bool, device=enc4c.device)
    for i in range(k):
        col = enc4c[:, offs + i].to(torch.int32)
        skeys = (skeys << 2) | (col & 3)
        bad = bad | (col >= 4)
    flat = skeys.reshape(-1)
    lo = torch.searchsorted(keys, flat).reshape(C, S)
    cnt = torch.searchsorted(keys, flat, right=True).reshape(C, S) - lo
    seed_ok = ~bad & (cnt > 0) & (cnt <= H)
    slot = torch.arange(H, device=enc4c.device)
    idx = (lo[:, :, None] + slot).clamp(0, pos.numel() - 1)
    hitmask = seed_ok[:, :, None] & (slot < cnt[:, :, None])
    hitpos = pos[idx]
    bins = torch.div(hitpos - offs[None, :, None].to(torch.int32), band, rounding_mode="floor")
    big = 1 << 28  # above any real bin; +1 never wraps
    rows = torch.where(hitmask, bins, big).reshape(C, S * H).sort(dim=1).values

    def count(v):
        return (torch.searchsorted(rows, v, right=True) - torch.searchsorted(rows, v))

    pair = torch.where(rows < big, count(rows) + count(rows + 1), -1)
    vmax = pair.amax(1)
    at = torch.arange(S * H, device=enc4c.device)
    best = torch.where(pair == vmax[:, None], at, S * H).amin(1)
    bw = rows.gather(1, best[:, None])[:, 0]
    v = vmax.clamp_min(0).to(torch.int32)
    # Contig anchor: the smallest hit position inside the winning bin pair.
    inwin = hitmask & ((bins == bw[:, None, None]) | (bins == bw[:, None, None] + 1))
    amin = torch.where(inwin, hitpos, np.iinfo(np.int32).max).reshape(C, S * H).amin(1)
    anchor = torch.where(v > 0, amin, -1)
    # Second-best non-overlapping bin pair (|bin - winner| > 1): the MAPQ
    # margin.
    v2 = torch.where((rows - bw[:, None]).abs() <= 1, -1, pair).amax(1).clamp_min(0)
    return v, torch.where(v > 0, bw * band, 0), anchor, v2


def _vote_windows_device(index: KmerIndex, enc4: np.ndarray, stride: int, max_hits: int,
                         band: int, chunk: int = 16384, device="cuda"):
    """Device twin of :func:`_vote_windows` on ``device``: the same results,
    computed with fixed shapes chunk by chunk of ``chunk`` reads (the last
    chunk padded with invalid rows when there are several, so every chunk
    has one shape)."""
    R, L = enc4.shape
    k = index.k
    n = L - k + 1
    votes = np.zeros(R, np.int64)
    votes2 = np.zeros(R, np.int64)
    wlo = np.zeros(R, np.int64)
    anchor = np.full(R, -1, np.int64)
    if n <= 0:
        return votes, wlo, wlo, anchor, votes2
    dev = resolve_device(device)
    keys, pos = index.device_arrays(dev)
    offs = torch.arange(0, n, stride, device=dev)
    outs = []
    for s in range(0, R, chunk):
        part = enc4[s : s + chunk]
        if part.shape[0] < chunk and R > chunk:
            part = np.concatenate([part, np.full((chunk - part.shape[0], L), 0xFE, enc4.dtype)])
        part = torch.from_numpy(np.ascontiguousarray(part)).to(dev)
        outs.append(torch.stack(_device_vote(part, keys, pos, offs, k, max_hits, band)))
    got = torch.cat(outs, 1)[:, :R].cpu().numpy().astype(np.int64)
    votes[:], wlo[:], anchor[:], votes2[:] = got
    return votes, wlo, wlo + 2 * band, anchor, votes2


def map_reads(queries, ref, scores: Scores, *, index: KmerIndex | None = None, k: int = 21,
              stride: int | None = None, band: int = 32, max_hits: int = 64,
              min_seeds: int = 2, both_strands: bool = True, engine: str = "auto",
              seed_engine: str = "host", with_paths: bool = False, batch: int = 4096,
              device="cuda") -> list[MappedRead]:
    """Map ``queries`` against ``ref`` (one contig or a list); results
    keep input order.

    ``stride`` samples every stride-th read k-mer as a seed (default
    ``max(1, k // 2)``); ``min_seeds`` is the vote threshold below which
    a read is unmapped without an extension. A prebuilt ``index`` is
    reused (its ``k`` wins). Extension windows are ``read_len + 4*band``
    wide: up to 256 bytes they extend on K6, wider on K3. ``engine`` and
    ``device`` go to :func:`align_reads`. ``seed_engine="device"`` votes
    on ``device`` (the first, given a list) by :func:`_vote_windows_device`
    (``k <= 15``), bit-identical to the host vote.
    """
    if band < 1:
        raise ValueError(f"band={band} must be >= 1 (diagonal bin width)")
    if max_hits < 1:
        raise ValueError(f"max_hits={max_hits} must be >= 1")
    if seed_engine not in ("host", "device"):
        raise ValueError(f"unknown seed_engine {seed_engine!r}")
    refs = [ref] if isinstance(ref, Sequence) else list(ref)
    if index is None:
        index = KmerIndex(refs, k)
    if len(index.refs) != len(refs) or any(
        a.sequence is not b.sequence and a.sequence != b.sequence
        for a, b in zip(index.refs, refs)
    ):
        raise ValueError("index was built for a different reference")
    k = index.k
    stride = max(1, k // 2) if stride is None else max(1, stride)
    B = len(queries)
    if B == 0:
        return []

    # Case-normalize for seeding and extension: the index case-folds and
    # the DP compares raw bytes.
    def _upper(q: Sequence) -> Sequence:
        return q if q.sequence.isupper() else Sequence(q.name, q.sequence.upper(), q.quality)

    oriented = [_upper(q) for q in queries]
    if both_strands:
        oriented = oriented + [q.reverse_complement() for q in oriented[:B]]
    L = max(max(len(q) for q in oriented), 1)
    enc4 = _BASE[encode_batch(oriented, L, 0xFE)]
    lens = np.array([len(q) for q in oriented], np.int64)
    if seed_engine == "device":
        vote_dev = device[0] if isinstance(device, (list, tuple)) else device
        votes, wlo, whi, anchor, votes2 = _vote_windows_device(
            index, enc4, stride, max_hits, band, device=vote_dev)
    else:
        votes, wlo, whi, anchor, votes2 = _vote_windows(index, enc4, stride, max_hits, band)
    if both_strands:
        use_rc = votes[B:] > votes[:B]  # forward wins ties
        pick = np.where(use_rc, np.arange(B) + B, np.arange(B))
        # The losing orientation's best window joins the runner-up margin.
        other = np.where(use_rc, votes[:B], votes[B:])
        votes2 = np.maximum(votes2[pick], other)
        votes, wlo, whi, anchor = votes[pick], wlo[pick], whi[pick], anchor[pick]
        chosen = [oriented[int(p)] for p in pick]
        strands = ["-" if rc else "+" for rc in use_rc]
    else:
        chosen = oriented
        strands = ["+"] * B

    # Whole-batch window math: the anchor names the supporting contig and
    # the widened window is clipped to it.
    total = int(index.starts[-1])
    starts_a = np.asarray(index.starts, np.int64)
    cids = np.searchsorted(starts_a, np.clip(anchor, 0, None), "right").astype(np.int64) - 1
    cids = np.clip(cids, 0, max(len(starts_a) - 2, 0))
    c0s = starts_a[cids]
    c1s = starts_a[np.minimum(cids + 1, len(starts_a) - 1)]
    ws_a = np.maximum(np.maximum(wlo - band, 0), c0s)
    we_a = np.minimum(np.minimum(whi + lens[: len(whi)] + band, total), c1s)
    keep = (votes >= min_seeds) & (anchor >= 0) & (we_a > ws_a)
    mapped_ix, win_seqs, win_starts, win_contig = [], [], [], []
    for i in np.flatnonzero(keep):
        cid = int(cids[i])
        c0 = int(c0s[i])
        ws, we = int(ws_a[i]), int(we_a[i])
        contig = index.refs[cid]
        win_seqs.append(Sequence(contig.name, contig.sequence[ws - c0 : we - c0].upper()))
        win_starts.append(ws - c0)
        win_contig.append(contig)
        mapped_ix.append(int(i))

    ext: dict[int, tuple] = {}
    if mapped_ix:
        aligned, cigars, mapinfo = align_reads(
            [chosen[i] for i in mapped_ix], win_seqs, scores, is_local=True, engine=engine,
            with_paths=with_paths, with_cigars=True, with_mapinfo=True, batch=batch,
            device=device,
        )
        for j, i in enumerate(mapped_ix):
            i0, j0, ei, ej = mapinfo[j]
            ws = win_starts[j]
            ext[i] = (aligned[j], cigars[j], (i0, j0 + ws, ei, ej + ws), win_contig[j])

    out: list[MappedRead] = []
    for i in range(B):
        q = chosen[i]
        if i in ext and "M" in ext[i][1]:
            a, cg, info, contig = ext[i]
            out.append(MappedRead(
                read=q, contig=contig, strand=strands[i], mapped=True, score=a.score,
                mapinfo=info, cigar=cg, aligned=a, seeds=int(votes[i]),
                mapq=min(60, 6 * int(votes[i] - votes2[i])),
            ))
        else:
            # Unmapped (no window, or a pure D/I zero-plateau walk): the
            # original read on the forward strand.
            empty = AlignedSequences(
                s1=queries[i], s2=Sequence(refs[0].name, ""), alignment=[], score=0,
                matches=0, mismatches=0, gap_extensions=0, opening_gaps=0,
            )
            out.append(MappedRead(
                read=queries[i], contig=refs[0], strand="+", mapped=False, score=0,
                mapinfo=(0, 0, 0, 0), cigar="", aligned=empty, seeds=int(votes[i]), mapq=0,
            ))
    return out


def map_pairs(reads1, reads2, ref, scores: Scores, **kwargs):
    """Map both ends of a paired-end library (``reads1[i]`` and
    ``reads2[i]`` are mates) over one prebuilt index; pairing is SAM
    bookkeeping, done in :func:`write_sam_paired`."""
    if len(reads1) != len(reads2):
        raise ValueError(f"mate count mismatch: {len(reads1)} vs {len(reads2)}")
    refs = [ref] if isinstance(ref, Sequence) else list(ref)
    if kwargs.get("index") is None:
        kwargs["index"] = KmerIndex(refs, kwargs.pop("k", 21))
    else:
        kwargs.pop("k", None)
    return map_reads(reads1, refs, scores, **kwargs), map_reads(reads2, refs, scores, **kwargs)


def write_sam_paired(path, res1, res2, header_refs=None, max_insert: int = 1000) -> int:
    """Write mate-annotated SAM records for paired mapping results.

    Flags follow SAM 1.6: 0x1 on every record, 0x40/0x80 first/second of
    pair, 0x8/0x20 mirror the mate's unmapped/strand state, 0x2 (proper
    pair) when both ends map to one contig on opposite strands in FR
    orientation with an outer distance <= ``max_insert``. RNEXT is ``=``
    for same-contig mates, PNEXT the mate's POS, TLEN the signed outer
    distance. Records interleave (R1, R2). Returns the proper pairs.
    """

    def records(res):
        return sam_records([r.contig for r in res], [r.aligned for r in res],
                           [r.cigar for r in res], [r.mapinfo for r in res],
                           [r.strand for r in res], [r.mapq for r in res])

    if len(res1) != len(res2):
        raise ValueError(f"mate count mismatch: {len(res1)} vs {len(res2)}")
    rec1, rec2 = records(res1), records(res2)
    proper = 0
    with open(path, "w") as f:
        f.write(_sam_header([r.contig for r in res1 + res2], header_refs))
        for a, b in zip(rec1, rec2):
            a["flag"] |= 0x1 | 0x40
            b["flag"] |= 0x1 | 0x80
            for me, mate in ((a, b), (b, a)):
                if not mate["mapped"]:
                    me["flag"] |= 0x8
                if mate["flag"] & 0x10:
                    me["flag"] |= 0x20
            is_proper = False
            tlen_a = tlen_b = 0
            if a["mapped"] and b["mapped"] and a["rname"] == b["rname"]:
                fwd, rev = (a, b) if not a["flag"] & 0x10 else (b, a)
                lo = min(a["pos"], b["pos"])
                hi = max(a["ref_end"], b["ref_end"])
                outer = hi - lo + 1
                is_proper = ((a["flag"] & 0x10) != (b["flag"] & 0x10)
                             and fwd["pos"] <= rev["pos"] and outer <= max_insert)
                # Signed TLEN on any same-contig pair, proper or not.
                if a["pos"] < b["pos"] or (a["pos"] == b["pos"] and a["ref_end"] <= b["ref_end"]):
                    tlen_a, tlen_b = outer, -outer
                else:
                    tlen_a, tlen_b = -outer, outer
            if is_proper:
                a["flag"] |= 0x2
                b["flag"] |= 0x2
                proper += 1
            for me, mate, tl in ((a, b, tlen_a), (b, a, tlen_b)):
                if mate["mapped"]:
                    rnext = "=" if mate["rname"] == me["rname"] and me["mapped"] else mate["rname"]
                    pnext = mate["pos"]
                else:
                    rnext, pnext = "*", 0
                f.write(_sam_line(me, rnext, pnext, tl))
    return proper
