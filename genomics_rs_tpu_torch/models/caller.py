"""Pileup and consensus variant calling over mapped reads (counterpart of
``genomics_rs_tpu/models/caller.py``): map -> pileup -> call.

The pileup is built from SAM-normalized records (``reads.sam_records``,
the same POS/CIGAR edge folding as the SAM writer): each record's CIGAR
expands run by run into (position, base-code) arrays with numpy slices,
and the whole read set lands in one scatter per contig on the device.
Codes: A/C/G/T = 0..3, deletion = 4. Insertions are events (anchor
position, inserted string) in a side map. Non-ACGT read bases are
skipped; an I run at the leading edge of an alignment is dropped.

Counts are ``index_add_`` of ones into an int32 (ref_len + 1, 5) table
(row ``ref_len`` catches out-of-range positions, which raise). The
quality-weighted pileup (:func:`pileup_q`) also sums float32 weights;
atomics on the card would add them in a run-dependent order, so the
updates are sorted by (position, code), stably, and each bin is summed
in update order, one rank per step: the order ``np.add.at`` and the JAX
package's CPU scatter use, so the sums are the same bits on the card and
on the host.

Calling is per-position consensus: at depth >= ``min_depth`` the
most-voted non-reference code with fraction >= ``min_frac`` is a call,
a SNP (codes 0..3) or a deletion (code 4, adjacent calls merged into
one VCF record); insertions are called per anchor under the same gates.
With weights the alt choice and the fraction gate use the weighted
evidence, the depth gate integer coverage.
"""

from __future__ import annotations

import dataclasses
import logging
import re

import numpy as np
import torch

from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.models.reads import _sam_token, sam_records

log = logging.getLogger(__name__)

_BASES = "ACGT"
_CODE = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(_BASES):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i
DEL_CODE = 4


@dataclasses.dataclass
class VariantCall:
    contig: str
    #: 1-based position of the variant base itself (VCF POS differs for
    #: deletions: anchor base, pos - 1).
    pos: int
    ref: str  # reference base(s): one base for SNPs, run for dels
    alt: str  # alt base for SNPs, "" for deletions
    depth: int
    alt_count: int

    @property
    def frac(self) -> float:
        return self.alt_count / self.depth if self.depth else 0.0

    @property
    def is_deletion(self) -> bool:
        return self.alt == ""

    @property
    def is_insertion(self) -> bool:
        return len(self.alt) > 1


def _phred_probs(qual: str) -> np.ndarray:
    """Phred+33 string -> per-base correctness probability
    ``1 - 10^(-q/10)`` (float32)."""
    q = np.frombuffer(qual.encode("latin-1"), dtype=np.uint8).astype(np.float32) - 33.0
    return 1.0 - np.power(10.0, -q / 10.0, dtype=np.float32)


def _mapq_factor(mapq: int) -> float:
    """MAPQ -> probability the mapping is correct (255 = unavailable =
    certain), floored at 0.5: a zero seed margin is at worst a coin flip
    between candidate loci."""
    if mapq >= 255:
        return 1.0
    return float(max(1.0 - 10.0 ** (-mapq / 10.0), 0.5))


def _expand_records(records: list[dict], min_baseq: int = 0, min_mapq: int = 0,
                    collect_weights: bool = False):
    """(positions, codes, weights, insertions, ins_w): pileup inputs.

    ``insertions`` maps a 0-based anchor (the reference base the
    inserted run follows) to a count of inserted strings. With
    ``collect_weights`` each vote also gets its correctness weight
    (base probability x MAPQ factor; a deletion mark the MAPQ factor
    only); ``min_baseq`` drops single M/X/= bases, ``min_mapq`` whole
    reads. ``weights``/``ins_w`` are None without ``collect_weights``.
    """
    pos_chunks: list[np.ndarray] = []
    code_chunks: list[np.ndarray] = []
    w_chunks: list[np.ndarray] = []
    insertions: dict = {}
    ins_w: dict | None = {} if collect_weights else None
    for rec in records:
        if not rec["mapped"]:
            continue
        mapq = int(rec.get("mapq", 255))
        if mapq < min_mapq:
            continue
        wm = np.float32(_mapq_factor(mapq)) if collect_weights else None
        seq_codes = _CODE[np.frombuffer(rec["seq"].encode("latin-1"), dtype=np.uint8)]
        qual = rec.get("qual") or "*"
        probs = None
        if qual != "*" and (min_baseq > 0 or collect_weights):
            probs = _phred_probs(qual)
            if len(probs) != len(seq_codes):
                raise ValueError(f"quality length {len(probs)} != read length {len(seq_codes)}")
        q = 0  # read cursor
        r = rec["pos"] - 1  # 0-based reference cursor
        covered = False  # any reference-consuming op seen yet?
        runs = re.findall(r"(\d+)([A-Z=])", rec["cigar"])
        if "".join(n + op for n, op in runs) != rec["cigar"]:
            raise ValueError(f"malformed CIGAR {rec['cigar']!r}")
        for n_str, op in runs:
            n = int(n_str)
            if op in ("M", "=", "X"):
                codes = seq_codes[q : q + n].astype(np.int32)
                keep = codes >= 0  # skip non-ACGT read bases
                if probs is not None and min_baseq > 0:
                    qv = np.frombuffer(qual[q : q + n].encode("latin-1"),
                                       dtype=np.uint8).astype(np.int32) - 33
                    keep = keep & (qv >= min_baseq)
                pos_chunks.append((r + np.arange(n, dtype=np.int64))[keep])
                code_chunks.append(codes[keep])
                if collect_weights:
                    wb = (probs[q : q + n][keep] if probs is not None
                          else np.ones(int(keep.sum()), dtype=np.float32))
                    w_chunks.append(wb * wm)
                q += n
                r += n
                covered = True
            elif op == "D":
                pos_chunks.append(r + np.arange(n, dtype=np.int64))
                code_chunks.append(np.full(n, DEL_CODE, dtype=np.int32))
                if collect_weights:
                    w_chunks.append(np.full(n, wm, dtype=np.float32))
                r += n
                covered = True
            elif op == "N":
                # Skipped reference region (splice): not deletion evidence.
                r += n
                covered = True
            elif op == "I":
                anchor = r - 1
                ins = rec["seq"][q : q + n].upper()
                # Pure-ACGT inserts only (N/IUPAC would reach VCF ALT).
                if covered and anchor >= 0 and all(_CODE[ord(ch)] >= 0 for ch in ins):
                    bucket = insertions.setdefault(anchor, {})
                    bucket[ins] = bucket.get(ins, 0) + 1
                    if collect_weights:
                        # Weighted like the per-base votes it competes with.
                        wi = wm
                        if probs is not None and n:
                            wi = wm * float(np.mean(probs[q : q + n]))
                        wbucket = ins_w.setdefault(anchor, {})
                        wbucket[ins] = wbucket.get(ins, 0.0) + float(wi)
                q += n
            elif op == "S":  # read-only
                q += n
            elif op in ("H", "P"):
                pass  # consume neither cursor
            else:
                raise ValueError(f"unsupported CIGAR op {op!r} in {rec['cigar']!r}")
    if not pos_chunks:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32),
                np.zeros(0, dtype=np.float32) if collect_weights else None, insertions, ins_w)
    return (np.concatenate(pos_chunks), np.concatenate(code_chunks),
            np.concatenate(w_chunks) if collect_weights else None, insertions, ins_w)


def _bins(positions: np.ndarray, codes: np.ndarray, ref_len: int, dev) -> torch.Tensor:
    """Flat (position, code) bin of every update on ``dev``; positions
    outside the reference go to the spill row ``ref_len``."""
    p = torch.from_numpy(np.asarray(positions, np.int64)).to(dev)
    c = torch.from_numpy(np.asarray(codes, np.int64)).to(dev)
    p = torch.where((p >= 0) & (p < ref_len), p, ref_len)
    return p * 5 + c


def _counts(bins: torch.Tensor, ref_len: int) -> np.ndarray:
    counts = torch.zeros((ref_len + 1) * 5, dtype=torch.int32, device=bins.device)
    counts.index_add_(0, bins, torch.ones_like(bins, dtype=torch.int32))
    counts = counts.view(ref_len + 1, 5).cpu().numpy()
    if counts[ref_len].any():
        raise AssertionError(
            f"pileup positions outside the reference ({int(counts[ref_len].sum())} bases)")
    return counts[:ref_len]


def _ordered_sums(bins: torch.Tensor, w: torch.Tensor, size: int) -> torch.Tensor:
    """Per-bin float32 sums of ``w``, each bin summed in update order:
    a stable sort groups the updates by bin, then step ``r`` adds every
    bin's ``r``-th update. Same bits on every device, and the same as a
    sequential float32 sum (``np.add.at``)."""
    out = torch.zeros(size, dtype=torch.float32, device=bins.device)
    if bins.numel() == 0:
        return out
    order = torch.sort(bins, stable=True).indices
    sbins, sw = bins[order], w[order]
    uniq, cnt = torch.unique_consecutive(sbins, return_counts=True)
    first = torch.cumsum(cnt, 0) - cnt
    acc = sw[first].clone()
    live = torch.nonzero(cnt > 1)[:, 0]
    r = 1
    while live.numel():
        acc[live] = acc[live] + sw[first[live] + r]
        r += 1
        live = live[cnt[live] > r]
    out[uniq] = acc
    return out


def pileup(records: list[dict], ref_len: int, device="cuda") -> np.ndarray:
    """(ref_len, 5) base/deletion counts from SAM-normalized records of
    one contig (:func:`call_reads` groups by ``rname``)."""
    return pileup_full(records, ref_len, device=device)[0]


def pileup_full(records: list[dict], ref_len: int, device="cuda"):
    """(counts, insertions): see :func:`pileup` and ``_expand_records``."""
    positions, codes, _, insertions, _ = _expand_records(records)
    dev = resolve_device(device)
    return _counts(_bins(positions, codes, ref_len, dev), ref_len), insertions


def pileup_q(records: list[dict], ref_len: int, device="cuda", min_baseq: int = 0,
             min_mapq: int = 0):
    """Quality-aware pileup: (counts, weights, insertions, ins_w).
    ``counts`` is the integer coverage surviving the gates, ``weights``
    each bin's sum of correctness probabilities (float32, summed in
    update order), ``ins_w`` the insertions' weighted support."""
    positions, codes, w, insertions, ins_w = _expand_records(
        records, min_baseq=min_baseq, min_mapq=min_mapq, collect_weights=True)
    dev = resolve_device(device)
    bins = _bins(positions, codes, ref_len, dev)
    counts = _counts(bins, ref_len)
    wsum = _ordered_sums(bins, torch.from_numpy(np.asarray(w, np.float32)).to(dev),
                         (ref_len + 1) * 5)
    return counts, wsum.view(ref_len + 1, 5)[:ref_len].cpu().numpy(), insertions, ins_w


def call_pileup(counts: np.ndarray, ref_seq: str, contig: str, min_depth: int = 8,
                min_frac: float = 0.7, weights: np.ndarray | None = None,
                min_alt_conf: float = 0.0) -> list[VariantCall]:
    """Consensus calls from a pileup (vectorized scan, then merge).

    With ``weights`` the alt choice and the ``min_frac`` gate use the
    weighted evidence; ``min_depth`` and the reported DP/AC stay integer
    coverage. ``min_alt_conf`` (weighted mode) is the minimum mean weight
    of the alt-supporting bases.
    """
    L = len(ref_seq)
    ref_codes = _CODE[np.frombuffer(ref_seq.encode("latin-1"), dtype=np.uint8)].astype(np.int32)
    depth = counts.sum(axis=1)
    evidence = counts if weights is None else weights
    masked = evidence.copy()
    rows = np.arange(L)
    valid_ref = ref_codes >= 0
    masked[rows[valid_ref], ref_codes[valid_ref]] = -1
    alt_code = masked.argmax(axis=1)
    alt_evidence = masked[rows, alt_code]
    alt_count = counts[rows, alt_code]
    ev_depth = evidence.sum(axis=1)
    callable_ = ((depth >= min_depth) & (alt_evidence.astype(np.float64) >= min_frac * ev_depth)
                 & (alt_count > 0) & valid_ref)
    if weights is not None and min_alt_conf > 0:
        callable_ &= alt_evidence >= min_alt_conf * np.maximum(alt_count, 1)
    calls: list[VariantCall] = []
    for p in np.flatnonzero(callable_):
        code = int(alt_code[p])
        if code == DEL_CODE:
            if calls and calls[-1].is_deletion and calls[-1].pos + len(calls[-1].ref) - 1 == p:
                prev = calls[-1]
                # A merged run reports its weakest position's DP/AC.
                calls[-1] = VariantCall(contig, prev.pos, prev.ref + ref_seq[p], "",
                                        min(prev.depth, int(depth[p])),
                                        min(prev.alt_count, int(alt_count[p])))
            else:
                calls.append(VariantCall(contig, int(p) + 1, ref_seq[p], "", int(depth[p]),
                                         int(alt_count[p])))
        else:
            calls.append(VariantCall(contig, int(p) + 1, ref_seq[p], _BASES[code],
                                     int(depth[p]), int(alt_count[p])))
    return calls


def call_insertions(insertions: dict, counts: np.ndarray, ref_seq: str, contig: str,
                    min_depth: int = 8, min_frac: float = 0.7, ins_w: dict | None = None,
                    weights: np.ndarray | None = None) -> list[VariantCall]:
    """Consensus insertion calls from the pileup's insertion map: the
    majority inserted string at an anchor is called when it clears the
    depth and fraction gates against the anchor's depth. ``ref`` is the
    anchor base and ``alt`` the anchor plus the inserted run."""
    if (ins_w is None) != (weights is None):
        raise ValueError(
            "call_insertions needs ins_w and weights together (both from pileup_q) or neither")
    calls: list[VariantCall] = []
    for anchor in sorted(insertions):
        bucket = insertions[anchor]
        wbucket = ins_w.get(anchor, {}) if ins_w is not None else None
        if wbucket:
            ins, ev_support = max(wbucket.items(), key=lambda kv: (kv[1], kv[0]))
            ev_depth = float(weights[anchor].sum())
        else:
            ins, ev_support = max(bucket.items(), key=lambda kv: (kv[1], kv[0]))
            ev_depth = float(counts[anchor].sum())
        support = bucket[ins]
        depth = int(counts[anchor].sum())
        if depth < min_depth or ev_support < min_frac * ev_depth:
            continue
        calls.append(VariantCall(contig, anchor + 1, ref_seq[anchor],
                                 ref_seq[anchor] + ins, depth, int(support)))
    return calls


def call_reads(queries, refs, scores, min_depth: int = 8, min_frac: float = 0.7,
               min_baseq: int = 0, min_mapq: int = 0, weighted: bool = False,
               min_alt_conf: float = 0.0, device="cuda", **map_kw):
    """map -> pileup -> call. Returns (calls, per-contig pileups).

    ``map_kw`` flows to ``models.mapper.map_reads`` (band, min_seeds,
    engine, ...); ``device`` runs the mapping's extension and the
    pileup. ``weighted`` (or a nonzero ``min_baseq``/``min_mapq``/
    ``min_alt_conf``) switches to the quality-aware pileup.
    """
    from genomics_rs_tpu_torch.models.mapper import map_reads

    results = map_reads(queries, refs, scores, device=device, **map_kw)
    records = sam_records([r.contig for r in results], [r.aligned for r in results],
                          [r.cigar for r in results], [r.mapinfo for r in results],
                          [r.strand for r in results], mapqs=[r.mapq for r in results])
    by_contig: dict[str, list[dict]] = {}
    contig_seq = {_sam_token(r.name): r.sequence for r in refs}
    for rec in records:
        if rec["mapped"]:
            by_contig.setdefault(rec["rname"], []).append(rec)
    calls: list[VariantCall] = []
    pileups: dict[str, np.ndarray] = {}
    use_q = weighted or min_baseq > 0 or min_mapq > 0 or min_alt_conf > 0
    for rname in sorted(by_contig):
        seq = contig_seq[rname]
        if use_q:
            counts, wsum, insertions, ins_w = pileup_q(
                by_contig[rname], len(seq), device=device, min_baseq=min_baseq,
                min_mapq=min_mapq)
        else:
            counts, insertions = pileup_full(by_contig[rname], len(seq), device=device)
            wsum = ins_w = None
        pileups[rname] = counts
        contig_calls = call_pileup(
            counts, seq, rname, min_depth=min_depth, min_frac=min_frac, weights=wsum,
            min_alt_conf=min_alt_conf,
        ) + call_insertions(insertions, counts, seq, rname, min_depth=min_depth,
                            min_frac=min_frac, ins_w=ins_w, weights=wsum)
        contig_calls.sort(key=lambda c: c.pos)
        calls.extend(contig_calls)
    log.info("called %d variants from %d mapped reads", len(calls),
             sum(len(v) for v in by_contig.values()))
    return calls, pileups


def write_vcf(path: str, calls: list[VariantCall], refs) -> None:
    """Minimal VCF 4.2: SNPs as REF/ALT bases, deletions anchored on the
    base before the event (or, for a deletion at position 1, on the base
    after the run)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Pileup depth">\n')
        f.write('##INFO=<ID=AC,Number=1,Type=Integer,Description="Alt-supporting bases">\n')
        for r in refs:
            f.write(f"##contig=<ID={_sam_token(r.name)},length={len(r)}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        contig_seq = {_sam_token(r.name): r.sequence for r in refs}
        for c in calls:
            if c.is_deletion:
                seq = contig_seq[c.contig]
                if c.pos >= 2:
                    anchor = seq[c.pos - 2]
                    pos, ref, alt = c.pos - 1, anchor + c.ref, anchor
                elif c.pos + len(c.ref) - 1 < len(seq):
                    anchor = seq[c.pos + len(c.ref) - 1]
                    pos, ref, alt = c.pos, c.ref + anchor, anchor
                else:
                    log.warning("deletion of the entire contig %s is not representable in "
                                "VCF; skipped", c.contig)
                    continue
            else:
                pos, ref, alt = c.pos, c.ref, c.alt
            f.write(f"{c.contig}\t{pos}\t.\t{ref}\t{alt}\t.\tPASS\tDP={c.depth};AC={c.alt_count}\n")
