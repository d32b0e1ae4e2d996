"""The plain reference: the affine-gap DP of the genomics-rs reference
project, written again in plain PyTorch and NumPy.

It imports nothing of the program under test and takes nothing the
program made: it fills its own tables from the raw sequence bytes the
benchmark generated, walks them on the host and classifies the moves.

The recurrence (the reference project's, quirks included; ``g`` is the
gap extension, ``h`` the gap open, both negative; ``hg = h + g``)::

    I(i, j) = max(I(i, j-1) + g, max(S(i, j-1), D(i, j-1)) + hg)
    D(i, j) = max(max(I(i-1, j), S(i-1, j)) + hg, D(i-1, j) + g)
    S(i, j) = sub(s1[i-1], s2[j-1]) + C(i-1, j-1)
    C(i, j) = max(I, S, D)

Local mode floors I and D at 0 and S reads max(C, 0); the local score is
the largest max(C, 0) over the whole (m+1) x (n+1) table, at the last
such cell in row-major order. Boundaries: the origin is 0 in every arm,
row 0 has I = h + j*g, column 0 has D = h + i*g, the other arms there
are ``NEG_INF``. The direction of a cell is the first arm equal to C in
the order S, I, D (3 = none: a local zero cell).

The fill runs one row at a time over a batch of pairs, the row's I chain
by one running maximum (``I(i, j) = hg + (j-1) g + max_{k<j} (X(k) -
k g)`` with ``X = max(S, D)``), on the device of the inputs. A band
(``band=V``) keeps row i's columns ``off(i)+1 .. off(i)+V`` and sets the
rest to ``NEG_INF``, as the banded model does.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -(1 << 30)
#: rows of a fill on a CUDA device that run as one replayed CUDA graph.
GRAPH_ROWS = 32
SUB, INS, DEL, STOP = 0, 1, 2, 3

#: choice codes of a classified move.
MATCH, MISMATCH, INSERT, OPEN_INSERT, DELETE, OPEN_DELETE = range(6)
CHOICE_NAMES = ("Match", "Mismatch", "Insert", "OpenInsert", "Delete", "OpenDelete")

#: NCBI BLOSUM62, alphabet ARNDCQEGHILKMFPSTWYVBZX*.
BLOSUM62_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
BLOSUM62_ROWS = """
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

#: tie orders of the direction codes: the reference's, and the reversed
#: order that the DNA cells' control takes.
TIE_ORDERS = {"SID": (SUB, INS, DEL), "DIS": (DEL, INS, SUB)}


def dna_table(s_match: int, s_mismatch: int) -> np.ndarray:
    """(256, 256) int32 byte-pair scores: equal bytes match."""
    t = np.full((256, 256), s_mismatch, np.int32)
    np.fill_diagonal(t, s_match)
    return t


def blosum62_table() -> np.ndarray:
    """(256, 256) int32 byte-pair scores of BLOSUM62 over its letters;
    any other byte scores as ``X``."""
    rows = np.array([[int(v) for v in line.split()]
                     for line in BLOSUM62_ROWS.strip().splitlines()], np.int32)
    code = np.full(256, BLOSUM62_ALPHABET.index("X"), np.int64)
    for k, ch in enumerate(BLOSUM62_ALPHABET):
        code[ord(ch)] = k
    return np.ascontiguousarray(rows[code[:, None], code[None, :]])


def band_offset(i, m: int, n: int, V: int) -> np.ndarray:
    """Row i's band starts after column ``off(i)``: the length-
    proportional diagonal less half the band, kept inside the table."""
    lo = (np.asarray(i, np.int64) * n) // m - V // 2
    return np.clip(lo, 0, max(0, n - V))


def fill(s1: torch.Tensor, s2: torch.Tensor, ms, ns, table, g: int, h: int, local: bool,
         *, band: int | None = None, dirs: bool = False, tie: str = "SID",
         keep: str = "last"):
    """Fill B tables, one row of s1 at a time.

    ``s1`` (B, Lm) and ``s2`` (B, Ln) are uint8 byte batches (padding past
    ``ms``/``ns`` is never read by a true cell), ``table`` a (256, 256)
    int32 byte-pair score table. Returns a dict of numpy arrays:
    ``score`` (B,), ``start_i``, ``start_j`` (the end cell for global, the
    best cell for local) and, with ``dirs``, ``dirs`` as a (B, M+1, Ln+1)
    uint8 tensor on the inputs' device.

    ``keep`` picks the local best among equal values, ranked by (value,
    row, column): ``"last"`` takes the largest position, ``"first"`` the
    smallest. A band applies to global fills with ``m >= n`` (each pair's
    own off).

    The row step updates its state in place and reads its row from a
    device counter, so on a CUDA device :data:`GRAPH_ROWS` rows at a time
    run as one replayed CUDA graph; the arithmetic is the same as the
    eager rows of a CPU fill.
    """
    dev = s1.device
    B, Lm = s1.shape
    Ln = s2.shape[1]
    ms = np.asarray(ms, np.int64).reshape(B)
    ns = np.asarray(ns, np.int64).reshape(B)
    M = int(ms.max()) if B else 0
    N1 = Ln + 1
    use_graph = dev.type == "cuda" and M > 2 * GRAPH_ROWS
    R = GRAPH_ROWS if use_graph else 1
    warm = 2 if use_graph else 0  # rows run eagerly before the capture
    rows = warm + -(-(M - warm) // R) * R if use_graph else M  # rows run, >= M
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    hg = h + g
    tab = torch.as_tensor(np.asarray(table, np.int32)).to(dev)
    s2l = s2.long()
    # s1's byte of row i at column i - 1, padded for the rows past M.
    s1l = torch.zeros((B, max(rows, 1)), **i64)
    s1l[:, :Lm] = s1.long()[:, :rows]
    k = torch.arange(N1, **i32)[None, :]
    kg = k * g
    # I(i, j) = hg + (j-1) g + running max of X - k g, shifted by one.
    ibase = (hg + (k[:, 1:] - 1) * g).expand(B, Ln)
    # Row 0.
    I = torch.cat([torch.zeros((B, 1), **i32), h + kg[:, 1:].expand(B, Ln)], 1)
    S = torch.full((B, N1), NEG_INF, **i32)
    S[:, 0] = 0
    D = S.clone()
    C = I.clone()
    if band is not None:
        offs = np.zeros((B, rows + 1), np.int64)
        for b, (m, n) in enumerate(zip(ms, ns)):
            offs[b, : M + 1] = band_offset(np.arange(M + 1), int(m), int(n), band)
        offs = torch.as_tensor(offs, device=dev)
    out_dirs = torch.empty((B, rows + 1, N1), dtype=torch.uint8, device=dev) if dirs else None
    a0, a1, a2 = TIE_ORDERS[tie]

    def codes(I, S, D, Cc):
        arm = {SUB: S, INS: I, DEL: D}
        return torch.where(Cc == arm[a0], a0, torch.where(
            Cc == arm[a1], a1, torch.where(Cc == arm[a2], a2, STOP))).to(torch.uint8)

    if dirs:
        out_dirs[:, 0] = codes(I, S, D, C.clamp_min(0) if local else C)
    mcol = torch.as_tensor(ms, device=dev)
    ncol = torch.as_tensor(ns, device=dev)[:, None]
    true_col = k <= ncol  # (B, N1)
    at_end = torch.zeros(B, **i64)
    best_v = torch.zeros(B, **i64)
    best_r = torch.zeros(B, **i64)
    best_c = ncol[:, 0].clone() if keep == "last" else torch.zeros(B, **i64)
    big = (1 << 20) - 1
    if N1 >= big:
        raise ValueError(f"rows of {N1} columns: the local key holds 20 bits of column")
    kl = k.long()
    it = torch.ones(1, **i64)  # the row the next step fills

    def step():
        sub = torch.gather(tab.index_select(0, s1l.index_select(1, it - 1)[:, 0]), 1, s2l)
        Dn = torch.maximum(torch.maximum(I, S) + hg, D + g)
        Sn = torch.empty_like(S)
        Sn[:, 1:] = sub + (C[:, :-1].clamp_min(0) if local else C[:, :-1])
        if local:
            Dn = Dn.clamp_min(0)
        Dn[:, :1] = (h + it * g).to(torch.int32)
        Sn[:, 0] = NEG_INF
        X = torch.maximum(Sn, Dn)
        if band is not None:
            off = offs.index_select(1, it)  # (B, 1)
            inband = (k > off) & (k <= off + band)
            inband[:, :1] = off == 0
            X = torch.where(inband, X, NEG_INF)
        run = torch.cummax(X - kg, 1).values
        In = torch.empty_like(I)
        In[:, 0] = NEG_INF
        In[:, 1:] = ibase + run[:, :-1]
        if local:
            In[:, 1:] = In[:, 1:].clamp_min(0)
        if band is not None:
            In = torch.where(inband, In, NEG_INF)
            Sn = torch.where(inband, Sn, NEG_INF)
            Dn = torch.where(inband, Dn, NEG_INF)
        I.copy_(In)
        S.copy_(Sn)
        D.copy_(Dn)
        torch.maximum(torch.maximum(I, S), D, out=C)
        Cc = C.clamp_min(0) if local else C
        if dirs:
            out_dirs.index_copy_(1, it, codes(I, S, D, Cc)[:, None, :])
        if local:
            # The row's best (value, then the last or first column) as one
            # key: value << 20 | column (or its complement).
            col = kl if keep == "last" else big - kl
            key = torch.where(true_col, (Cc.long() << 20) | col, -1).amax(1)
            vmax = key >> 20
            cmax = key & 0xFFFFF if keep == "last" else big - (key & 0xFFFFF)
            better = (vmax > best_v if keep == "first" else vmax >= best_v) & (it <= mcol)
            best_v.copy_(torch.where(better, vmax, best_v))
            best_r.copy_(torch.where(better, it, best_r))
            best_c.copy_(torch.where(better, cmax, best_c))
        else:
            at_end.copy_(torch.where(it == mcol, C.gather(1, ncol)[:, 0].long(), at_end))
        it.add_(1)

    for _ in range(warm if use_graph else M):
        step()
    if use_graph:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
            for _ in range(R):
                step()
        torch.cuda.current_stream(dev).wait_stream(side)
        for _ in range((rows - warm) // R):
            graph.replay()
        del graph
    if local:
        res = {"score": best_v, "start_i": best_r, "start_j": best_c}
    else:
        res = {"score": at_end, "start_i": mcol, "start_j": ncol[:, 0]}
    res = {key: v.cpu().numpy().astype(np.int64) for key, v in res.items()}
    if dirs:
        res["dirs"] = out_dirs[:, : M + 1]
    return res


def walk(d: np.ndarray, i: int, j: int, local: bool) -> np.ndarray:
    """The reference retrace over a (M+1, N+1) code table from ``(i, j)``:
    per-axis saturation at 0, stop once (0, 0) is reached after a move or
    both axes would pass 0, a stop code ends a local walk. Returns the
    codes in walk order."""
    out = []
    while True:
        code = int(d[i, j])
        if code == STOP:
            if local:
                break
            raise RuntimeError(f"stop code on a global path at ({i}, {j})")
        out.append(code)
        ni = i - 1 if code != INS else i
        nj = j - 1 if code != DEL else j
        if ni < 0 and nj < 0:
            break
        i, j = max(ni, 0), max(nj, 0)
        if i == 0 and j == 0:
            break
    return np.asarray(out, np.uint8)


def classify(codes: np.ndarray, i: int, j: int, s1: bytes, s2: bytes) -> dict:
    """Classify a walked path as the reference does: a move is taken AT
    (i, j); a diagonal move matches when ``s1[i] == s2[j]`` (indexes one
    past the cell, both past their ends count as equal); a gap opens
    unless the previous move was a gap of the same kind. Returns the
    choice codes and positions (numpy) and the four counts."""
    T = len(codes)
    choice = np.empty(T, np.uint8)
    pi = np.empty(T, np.int64)
    pj = np.empty(T, np.int64)
    stats = {"matches": 0, "mismatches": 0, "gap_extensions": 0, "opening_gaps": 0}
    last = MATCH
    for t, code in enumerate(codes.tolist()):
        pi[t], pj[t] = i, j
        if code == SUB:
            c1 = s1[i] if i < len(s1) else None
            c2 = s2[j] if j < len(s2) else None
            if c1 == c2:
                choice[t] = last = MATCH
                stats["matches"] += 1
            else:
                choice[t] = last = MISMATCH
                stats["mismatches"] += 1
            i, j = max(i - 1, 0), max(j - 1, 0)
        elif code == INS:
            if last == INSERT:
                choice[t] = INSERT
                stats["gap_extensions"] += 1
            else:
                choice[t] = OPEN_INSERT
                stats["opening_gaps"] += 1
            last = INSERT
            j = max(j - 1, 0)
        elif code == DEL:
            if last == DELETE:
                choice[t] = DELETE
                stats["gap_extensions"] += 1
            else:
                choice[t] = OPEN_DELETE
                stats["opening_gaps"] += 1
            last = DELETE
            i = max(i - 1, 0)
        else:
            raise ValueError(f"unexpected move code {code}")
    return {"choice": choice, "i": pi, "j": pj, **stats}


def align(pairs, table, g: int, h: int, local: bool = False, band: int | None = None,
          tie: str = "SID", device="cpu", batch: int = 2) -> list[dict]:
    """Full alignments of ``pairs`` (byte strings ``(s1, s2)``): score,
    start cell, the classified path and its counts, ``batch`` pairs a
    fill."""
    out = []
    for b0 in range(0, len(pairs), batch):
        chunk = pairs[b0 : b0 + batch]
        s1, s2, ms, ns = pad_batch(chunk, device)
        res = fill(s1, s2, ms, ns, table, g, h, local, band=band, dirs=True, tie=tie)
        for b, (a, s) in enumerate(chunk):
            d = res["dirs"][b, : ms[b] + 1, : ns[b] + 1].cpu().numpy()
            i, j = int(res["start_i"][b]), int(res["start_j"][b])
            rec = classify(walk(d, i, j, local), i, j, a, s)
            rec.update(score=int(res["score"][b]), start=(i, j))
            out.append(rec)
        del res
    return out


def pad_batch(pairs, device, pad1: int = 0xFE, pad2: int = 0xFF):
    """Byte-string pairs as padded uint8 tensors on ``device`` and their
    lengths."""
    ms = np.array([len(a) for a, _ in pairs], np.int64)
    ns = np.array([len(b) for _, b in pairs], np.int64)
    s1 = np.full((len(pairs), max(int(ms.max()), 1)), pad1, np.uint8)
    s2 = np.full((len(pairs), max(int(ns.max()), 1)), pad2, np.uint8)
    for b, (a, s) in enumerate(pairs):
        s1[b, : len(a)] = np.frombuffer(a, np.uint8)
        s2[b, : len(s)] = np.frombuffer(s, np.uint8)
    return torch.from_numpy(s1).to(device), torch.from_numpy(s2).to(device), ms, ns


def scores(pairs, table, g: int, h: int, local: bool = False, band: int | None = None,
           device="cpu", batch: int = 64) -> dict:
    """Scores and start cells of ``pairs`` (byte strings), ``batch`` a
    fill: numpy arrays ``score``, ``start_i``, ``start_j``."""
    parts = []
    for b0 in range(0, len(pairs), batch):
        s1, s2, ms, ns = pad_batch(pairs[b0 : b0 + batch], device)
        parts.append(fill(s1, s2, ms, ns, table, g, h, local, band=band))
    return {key: np.concatenate([p[key] for p in parts]) for key in ("score", "start_i",
                                                                        "start_j")}
