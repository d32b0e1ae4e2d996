"""Batched short-read alignment with full per-read tracebacks
(counterpart of ``genomics_rs_tpu/models/reads.py``).

Every read gets its full alignment (path, stats, CIGAR), with the
O(m*n) fill and the O(m+n) walks batched on the device, round by round:

* reads whose padded lengths fit K6 (``max(L1, L2) <= 256``, no empty
  sequence) take the short-read fill with rows16 direction words
  (``ops/gotoh_shortread``) and the ``walk_rows16`` walk;
* wider rounds take K3's dirs mode and K4 through
  ``models/aligner.stream_walk_group`` (``align_batch``'s group step,
  and its byte budget sizes the round): the contract of the JAX scan
  fill's ``"diag"`` route, with the same paths;
* ``engine="scan"`` takes the scan fill (``ops/gotoh_scan``), one uint8
  code a cell, and the ``"diag"`` walk (``ops/traceback_batch``), both
  torch ops on the device: the JAX package's oracle route;
* classification (the reference's ``is_match`` off-by-one and
  open-vs-extend quirks) is whole-batch numpy
  (``ops/traceback_batch.classify_batch``); per-read results equal
  ``PairwiseAligner.align`` on that pair.

CIGAR convention (query = s1 vs reference = s2): ``M`` consumes both,
``I`` only the query (the DP's DELETE move, a gap in s2), ``D`` only the
reference (the DP's INSERT move, a gap in s1).

Given a list of devices, a round of at least two reads a device is cut
into equal slices, one a device (the JAX package's split over its local
devices). Rounds run in the JAX package's one-deep pipeline: the next
round is launched before this one is read and classified.
"""

from __future__ import annotations

import logging
import re

import numpy as np
import torch

from genomics_rs_tpu_torch.config import Scores
from genomics_rs_tpu_torch.device import resolve_device
from genomics_rs_tpu_torch.models.aligner import _stream_group_pairs, stream_walk_group
from genomics_rs_tpu_torch.ops.gotoh_shortread import gotoh_scores_shortread
from genomics_rs_tpu_torch.ops.traceback import AlignedSequences, AlignmentChoice
from genomics_rs_tpu_torch.ops.gotoh_scan import gotoh_fill_scan_batch
from genomics_rs_tpu_torch.ops.traceback_batch import classify_batch, walk_batch_launch
from genomics_rs_tpu_torch.parallel.batch import pad_batch, shortread_fits
from genomics_rs_tpu_torch.sequence import PAD_S1, PAD_S2, Sequence, round_up

log = logging.getLogger(__name__)

#: Resident direction-table bytes a scan-engine round may hold (the JAX
#: package's bound): the scan fill keeps (L1 + L2 + 1) * (L1 + 1) bytes of
#: uint8 codes a read.
_SCAN_DIRS_BUDGET = 2 << 30


def cigar(aligned: AlignedSequences) -> str:
    """Run-length CIGAR string (query = s1) from the move path."""
    ops = []
    for choice, _, _ in reversed(aligned.alignment):
        if choice in (AlignmentChoice.MATCH, AlignmentChoice.MISMATCH):
            op = "M"
        elif choice in (AlignmentChoice.DELETE, AlignmentChoice.OPEN_DELETE):
            op = "I"  # consumes only the query (gap in s2)
        else:
            op = "D"  # consumes only the reference (gap in s1)
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])
    return "".join(f"{count}{op}" for op, count in ops)


def _sam_token(name: str) -> str:
    """SAM QNAME/RNAME cannot contain whitespace; a bare ``>``/``@``
    header yields ``name == ""`` and split() then has no tokens."""
    parts = name.split()
    return parts[0] if parts else "*"


def sam_records(refs, aligned, cigars, mapinfo, strands=None, mapqs=None) -> list[dict]:
    """Per-read SAM record fields (before mate annotation / writing).

    Each dict carries ``qname, flag, rname, pos, cigar, seq, qual,
    score, mapped, ref_end, mapq``: ``pos`` is 1-based after edge
    folding, ``ref_end`` the 1-based inclusive last reference column the
    CIGAR consumes (0 when unmapped). ``flag`` holds only 0x4/0x10 here;
    pairing layers OR in their bits before writing.

    The reference's local termination quirk (a zero cell still takes a
    move when an arm matches) can walk through zero-score plateaus, so
    paths may begin or end with D or I runs. SAM forbids clip-adjacent
    D, so edge D runs fold into POS and edge I runs into the soft clips;
    the TSV and path outputs keep the raw walk.
    """
    out = []
    for k, a in enumerate(aligned):
        qname = _sam_token(a.s1.name)
        seq = a.s1.sequence or "*"
        qual = a.s1.quality or "*"
        i0, j0, end_i, _ = mapinfo[k]
        runs = [[int(n), op] for n, op in re.findall(r"(\d+)([MID])", cigars[k])]
        pos = j0 + 1
        head_clip = i0
        tail_clip = len(a.s1) - end_i
        while runs and runs[0][1] != "M":
            n, op = runs.pop(0)
            if op == "D":
                pos += n
            else:
                head_clip += n
        while runs and runs[-1][1] != "M":
            n, op = runs.pop()
            if op == "I":
                tail_clip += n
        if not runs:
            out.append(dict(qname=qname, flag=4, rname="*", pos=0, cigar="*", seq=seq,
                            qual=qual, score=a.score, mapped=False, ref_end=0, mapq=0))
            continue
        flag = 16 if strands is not None and strands[k] == "-" else 0
        head = f"{head_clip}S" if head_clip else ""
        tail = f"{tail_clip}S" if tail_clip > 0 else ""
        cig = head + "".join(f"{n}{op}" for n, op in runs) + tail
        ref_len = sum(n for n, op in runs if op in ("M", "D"))
        out.append(dict(
            qname=qname, flag=flag, rname=_sam_token(refs[k].name), pos=pos, cigar=cig,
            seq=seq, qual=qual, score=a.score, mapped=True, ref_end=pos + ref_len - 1,
            # 255 = "MAPQ unavailable" unless the caller supplies one.
            mapq=255 if mapqs is None else int(mapqs[k]),
        ))
    return out


def _sam_header(refs, header_refs) -> str:
    sq: dict[str, int] = {}
    # header_refs (when given) lists the full reference set, so @SQ
    # covers contigs no read mapped to; per-read refs follow so every
    # record's RNAME is declared.
    for r in (header_refs or []) + list(refs):
        name = _sam_token(r.name)
        if sq.setdefault(name, len(r)) != len(r):
            raise ValueError(
                f"distinct references share SAM RNAME {name!r} with different "
                "lengths — rename them (RNAME is the header's first whitespace token)"
            )
    lines = ["@HD\tVN:1.6\tSO:unknown"]
    lines += [f"@SQ\tSN:{n}\tLN:{ln}" for n, ln in sq.items()]
    lines.append("@PG\tID:genomics_rs_tpu\tPN:genomics_rs_tpu")
    return "\n".join(lines) + "\n"


def _sam_line(r: dict, rnext="*", pnext=0, tlen=0) -> str:
    return (
        f"{r['qname']}\t{r['flag']}\t{r['rname']}\t{r['pos']}\t"
        f"{r['mapq']}\t{r['cigar']}\t{rnext}\t{pnext}\t"
        f"{tlen}\t{r['seq']}\t{r['qual']}\tAS:i:{r['score']}\n"
    )


def write_sam(path, refs, aligned, cigars, mapinfo, strands=None, header_refs=None,
              mapqs=None) -> None:
    """Write read alignments as SAM 1.6: FLAG 16 marks a reverse-strand
    mapping (SEQ/QUAL are then the reverse-complemented read), unaligned
    query ends of a local alignment become soft clips, POS is the
    1-based reference column after the walk end, an empty alignment is
    unmapped (FLAG 4), AS:i carries the DP score. @SQ lines are deduped
    by name in first-appearance order."""
    with open(path, "w") as f:
        f.write(_sam_header(refs, header_refs))
        for r in sam_records(refs, aligned, cigars, mapinfo, strands, mapqs):
            f.write(_sam_line(r))


def encode_batch(seqs: list[Sequence], pad_to: int, pad_value: int) -> np.ndarray:
    """Stack per-sequence encodings. When every row is one object (one
    reference for many reads) the result is a read-only broadcast view;
    otherwise one pass over the joined bytes."""
    if not seqs:
        return np.zeros((0, pad_to), np.uint8)
    first = seqs[0]
    if all(s is first for s in seqs) and len(seqs) > 1:
        return np.broadcast_to(
            first.encoded(pad_to=pad_to, pad_value=pad_value), (len(seqs), pad_to))
    joined = np.frombuffer("".join(s.sequence for s in seqs).encode("ascii"), np.uint8)
    lens = np.array([len(s.sequence) for s in seqs], np.int64)
    if lens.max(initial=0) > pad_to:
        raise ValueError(f"pad_to={pad_to} < longest sequence")
    out = np.full((len(seqs), pad_to), pad_value, np.uint8)
    L0 = int(lens[0])
    if (lens == L0).all():
        out[:, :L0] = joined.reshape(len(seqs), L0)
        return out
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(offs, lens)
    rowidx = np.repeat(np.arange(len(seqs), dtype=np.int64), lens)
    out[rowidx, within] = joined
    return out


def _fill_batch(s1b: torch.Tensor, s2b: torch.Tensor, ms, ns, scores: Scores, is_local: bool):
    """The scan fill over a batch (the JAX package's ``vmap`` of
    ``gotoh_fill_scan``), on the tensors' device: ``(dirs (B, K, Mp)
    uint8, score, start_i, start_j)``."""
    f = gotoh_fill_scan_batch(s1b, s2b, ms, ns, scores, is_local)
    return f.dirs, f.score, f.start_i, f.start_j


def _launch_round(s1b, s2b, ms, ns, scores, is_local, route, max_steps, devs):
    """Issue one round on ``devs`` and return its reader, which gives the
    numpy (moves, counts, i_f, j_f, done, score, si, sj) of the round's
    reads. Equal slices go to the devices when there are several and at
    least two reads a device (padding rows replicate read 0 and are cut
    off), else the whole round goes to ``devs[0]``."""
    Bq = len(ms)
    if len(devs) < 2 or Bq < 2 * len(devs):
        return _launch_part(s1b, s2b, ms, ns, scores, is_local, route, max_steps, devs[0])
    (s1p, s2p, mp, np_), Bp = pad_batch((s1b, s2b, ms, ns), Bq, len(devs))
    per = Bp // len(devs)
    parts = [_launch_part(s1p[k * per : (k + 1) * per], s2p[k * per : (k + 1) * per],
                          mp[k * per : (k + 1) * per], np_[k * per : (k + 1) * per],
                          scores, is_local, route, max_steps, d)
             for k, d in enumerate(devs)]

    def read():
        got = [r() for r in parts]
        return tuple(np.concatenate([g[f] for g in got])[:Bq] for f in range(8))

    return read


def _launch_part(s1b, s2b, ms, ns, scores, is_local, route, max_steps, dev):
    """One device's fill with direction codes and every walk, issued;
    returns the reader. ``route``: ``"k6"`` (K6 and ``walk_rows16``) and
    ``"scan"`` (the scan fill and the ``"diag"`` walk) issue their work
    without reading anything back; ``"k3"`` (K3 and K4 through
    ``models/aligner.stream_walk_group``) reads its fill's error word and
    starts inside."""
    if route == "k3":
        out = stream_walk_group(s1b, s2b, ms, ns, scores, is_local, max_steps, dev)
        return lambda: out
    s1 = torch.from_numpy(np.ascontiguousarray(s1b)).to(dev)
    s2 = torch.from_numpy(np.ascontiguousarray(s2b)).to(dev)
    if route == "k6":
        sc, si, sj, codes = gotoh_scores_shortread(s1, s2, ms, ns, scores, is_local,
                                                   emit_dirs=True)
        layout = "rows16"
    else:
        codes, sc, si, sj = _fill_batch(s1, s2, ms, ns, scores, is_local)
        layout = "diag"
    read_walk = walk_batch_launch(codes, si, sj, scores, is_local, layout, max_steps)

    def read():
        walked = read_walk()
        return walked + tuple(x.cpu().numpy().astype(np.int64) for x in (sc, si, sj))

    return read


def align_reads(queries, refs, scores: Scores, is_local: bool = True, batch: int = 4096,
                engine: str = "auto", with_paths: bool = True, with_cigars: bool = False,
                both_strands: bool = False, with_mapinfo: bool = False, device="cuda"):
    """Full alignments for query[i] vs ref[i], batched on ``device``.

    Reads go in rounds of ``batch`` (each round one fill and one walk
    launch). ``engine`` picks the fill: ``"auto"`` takes K6 when the
    round's padded lengths fit it (``parallel/batch.shortread_fits``)
    and K3 otherwise, ``"pallas"`` always K6, ``"scan"`` the scan fill
    with the ``"diag"`` walk, its rounds sized by the JAX package's
    ``_SCAN_DIRS_BUDGET``. ``with_paths=False`` skips each result's
    per-move ``alignment`` list; pair it with ``with_cigars=True``, which
    returns ``(aligned, cigars)`` with the batch-vectorized CIGARs.
    Output order matches input.

    Rounds run one deep in a pipeline, as in the JAX package: round k+1's
    fill and walk are launched before round k's results are copied home
    and classified, so the host classifies one round while the device
    runs the next (on the scan route the round is halved then, so two
    rounds' direction tables fit the budget).

    ``device`` is one device or a list of them: with more than one, each
    round of at least two reads a device is split into equal slices
    (padded by replicating read 0), one fill and walk a device.

    ``both_strands=True`` also aligns each query's reverse complement in
    the same launches (the round size is halved) and keeps the better
    orientation, forward winning ties; a ``strands`` list of ``"+"`` /
    ``"-"`` joins the return value. ``with_mapinfo=True`` appends the
    walk endpoints ``(i0, j0, end_i, end_j)`` per read in oriented-query
    coordinates: the aligned block spans query rows ``(i0, end_i]`` and
    reference columns ``(j0, end_j]``. Optional returns stack in the
    order ``aligned[, cigars][, strands][, mapinfo]``.
    """
    if len(refs) == 1 and len(queries) > 1:
        refs = refs * len(queries)  # mapper convention: one reference
    if len(queries) != len(refs):
        raise ValueError(f"query/ref count mismatch: {len(queries)} vs {len(refs)}")
    if engine not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    devs = [resolve_device(d) for d in (device if isinstance(device, (list, tuple))
                                        else [device])]
    L1 = max(round_up(max((len(s) for s in queries), default=1), 128), 128)
    L2 = max(round_up(max((len(s) for s in refs), default=1), 128), 128)
    max_steps = L1 + L2 + 1
    ms_all = [len(s) for s in queries]
    ns_all = [len(s) for s in refs]
    if engine == "scan":
        route = "scan"
    elif engine == "pallas" or shortread_fits(L1, L2, ms_all, ns_all):
        route = "k6"
    else:
        route = "k3"
    if route == "scan":
        # Bound the resident per-round direction tables.
        batch = max(16, min(batch, _SCAN_DIRS_BUDGET // ((L1 + L2 + 1) * (L1 + 1))))
    if both_strands:
        batch = max(8, batch // 2)  # the device batch doubles
    if route == "k3":
        per_round = _stream_group_pairs(L1, L2, max_steps) // (2 if both_strands else 1)
        batch = max(1, min(batch, per_round))
    if route == "scan" and len(queries) > batch:
        batch = max(16, batch // 2)  # two rounds' tables are resident at once

    out: list[AlignedSequences] = []
    all_cigars: list[str] = []
    all_strands: list[str] = []
    all_mapinfo: list[tuple[int, int, int, int]] = []

    def launch(k0: int):
        qs = queries[k0 : k0 + batch]
        rs = refs[k0 : k0 + batch]
        b = len(qs)
        if both_strands:
            qs = qs + [q.reverse_complement() for q in qs]
            rs = rs + rs
        s1b = encode_batch(qs, L1, PAD_S1)
        s2b = encode_batch(rs, L2, PAD_S2)
        ms = np.array([len(s) for s in qs], dtype=np.int32)
        ns = np.array([len(s) for s in rs], dtype=np.int32)
        read = _launch_round(s1b, s2b, ms, ns, scores, is_local, route, max_steps, devs)
        return k0, b, qs, rs, s1b, s2b, ms, ns, read

    def harvest(state) -> None:
        k0, b, qs, rs, s1b, s2b, ms, ns, read = state
        moves, counts, i_f, j_f, done, sc_h, si_h, sj_h = read()
        # A global retrace is complete only at (0, 0): a mid-table stop
        # there means a corrupt fill.
        complete = done if is_local else done & (i_f == 0) & (j_f == 0)
        if not bool(np.all(complete)):
            bad = int(np.flatnonzero(~np.asarray(complete))[0])
            which = f"read {k0 + bad % b}" + (
                " (revcomp row)" if both_strands and bad >= b else "")
            raise RuntimeError(
                f"{which} retrace did not terminate at ({int(i_f[bad])}, {int(j_f[bad])})")
        aligned, cigars = classify_batch(moves, counts, si_h, sj_h, sc_h, qs, rs,
                                         with_paths=with_paths, encoded=(s1b, s2b, ms, ns))
        # The aligned block spans query rows (i_f, si] and reference
        # columns (j_f, sj]: zeros and (m, n) for a global retrace.
        info = np.stack([np.asarray(x, dtype=np.int64) for x in (i_f, j_f, si_h, sj_h)], axis=1)
        if both_strands:
            use_rc = sc_h[b:] > sc_h[:b]  # forward wins ties
            aligned = [aligned[b + i] if rc else aligned[i] for i, rc in enumerate(use_rc)]
            cigars = [cigars[b + i] if rc else cigars[i] for i, rc in enumerate(use_rc)]
            info = np.where(use_rc[:, None], info[b:], info[:b])
            all_strands.extend("-" if rc else "+" for rc in use_rc)
        out.extend(aligned)
        all_cigars.extend(cigars)
        if with_mapinfo:
            all_mapinfo.extend((int(r[0]), int(r[1]), int(r[2]), int(r[3])) for r in info)

    # One round deep: round k is read and classified only after round
    # k+1 is launched; rounds are harvested in order, so the output keeps
    # the input order.
    pending = None
    for k0 in range(0, len(queries), batch):
        current = launch(k0)
        if pending is not None:
            harvest(pending)
        pending = current
    if pending is not None:
        harvest(pending)
    ret = [out]
    if with_cigars:
        ret.append(all_cigars)
    if both_strands:
        ret.append(all_strands)
    if with_mapinfo:
        ret.append(all_mapinfo)
    return out if len(ret) == 1 else tuple(ret)
