"""Banded Gotoh fill (kernel K10) and the banded walker (kernel K11);
counterpart of ``genomics_rs_tpu/ops/gotoh_banded.py``.

The fill covers a width-``V`` band around the length-proportional
diagonal. Lane ``v`` of row ``i`` holds column ``j = off(i) + v + 1``::

    off(i) = clamp((i * n) // m - V // 2, 0, max(0, n - V))

so with ``n <= m`` the window slides by ``delta(i) = off(i) - off(i-1)``
in {0, 1} per row. Per row, the previous row's carries are aligned by
``delta``: the D carry ``A = max(max(I, S) + h + g, D + g)`` shifts up
by ``delta`` (same column), the cell max ``M`` shifts down by ``1 -
delta`` (previous column) with the column-0 boundary entering while the
window still touches it; the horizontal chain I is a (max,+) prefix
along the row. Out-of-band predecessors are ``NEG_INF``, and int32 adds
wrap as JAX's do. Codes use the tie order S > I > D, packed 16 rows to
an int32 word at each lane: ``dirs[(i-1)//16, v]``, ``(ceil(m/16), V)``.

* :func:`plan_streams` is the host planning (int64 geometry) shared by
  the single-pair and batched fills; :func:`band_offset` is JAX's.
* :func:`gotoh_banded` launches ``csrc/gotoh_banded.cu`` on a CUDA
  tensor (the warp-strip pipeline of ``csrc/gotoh_warp_pipe.cuh``: the
  band as the full table with its out-of-band cells at -inf, strips of
  128 rows on many SMs, each visiting only its rows' band columns,
  :func:`band_strip_columns`) and runs :func:`gotoh_banded_plain` on a
  CPU tensor: ``_kernel_banded``'s step restated for a flat ``(B, V)``
  state, one loop step per row.
* :func:`walk_banded` chases the codes from ``(m, n)`` to the origin,
  tracking ``off`` by the per-row deltas (``(i*n)//m`` overflows int32
  at chromosome scale). A CUDA bitmap launches ``walk_banded_kernel``
  (``csrc/traceback_walk.cu``: a staged chase, one warp a walk reading
  its codes from a ring of boxes in shared memory, ``ops/walk_stage``;
  all walks of a batch in one launch, whole walks unless ``max_steps``
  caps it), a CPU bitmap runs :func:`walk_banded_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops import gotoh_pallas as gp
from genomics_rs_tpu_torch.ops.gotoh_scan import (
    DIR_DEL,
    DIR_INS,
    DIR_STOP,
    DIR_SUB,
    INT_MIN,
    NEG_INF,
)
from genomics_rs_tpu_torch.ops.subst import encode_chars, kimura_active, sentinel, sub_score
from genomics_rs_tpu_torch.ops.traceback_walker import MAX_STEPS_CAP, MPW, unpack_moves
from genomics_rs_tpu_torch.ops.walk_stage import slide_words
from genomics_rs_tpu_torch.utils.profiling import annotate

#: 2-bit codes per packed word (rows per int32).
PACK = 16
#: rows of a strip (one warp) of the kernel's sweep: 4 rows a lane, so a
#: code word's 16 rows fill 4 lanes (``BAND_RT`` in the source).
BAND_STRIP_ROWS = 32 * 4

#: launches of the fill kernel from :func:`gotoh_banded` (K10) and of the
#: walker (K11); calls of their plain versions.
COUNTS = {"kernel": 0, "plain": 0, "walk_kernel": 0, "walk_plain": 0}


def band_offset(i, m: int, n: int, V: int):
    """Window start of row ``i``: columns ``off+1 .. off+V`` are in band.
    Host int64 math."""
    lo = (np.asarray(i, np.int64) * n) // m - V // 2
    return np.clip(lo, 0, max(0, n - V))


def plan_streams(M: int, N: int, V: int):
    """Per-row geometry of a fill over rows ``1..M`` of the window planned
    from ``(M, N)``: ``(off, delta, at0)`` int64 numpy arrays indexed by
    row - 1. ``at0`` marks rows whose window still touches column 0 (the
    boundary fills enter there)."""
    rows = np.arange(1, M + 1, dtype=np.int64)
    off = band_offset(rows, M, N, V).astype(np.int64)
    delta = off - band_offset(rows - 1, M, N, V).astype(np.int64)
    if delta.max(initial=0) > 1 or delta.min(initial=0) < 0:
        raise ValueError(
            f"band window slides by more than one column per row "
            f"(M={M}, N={N}): banded alignment needs N <= M"
        )
    return off, delta, off == 0


def row_streams(enc1: torch.Tensor, enc2: torch.Tensor, M: int, N: int, V: int):
    """The fill's per-row inputs for ``B`` pairs of encoded characters
    ``enc1`` (B, L1) and ``enc2`` (B, L2): ``s1c`` (B, M) the row's s1
    char and ``s2in`` (B, M) the s2 char entering the window on the right
    (``s2[off(i) + V - 1]``), both clamped to the padded width as JAX
    clamps them, on the tensors' device; and the numpy ``delta`` and
    ``at0`` of :func:`plan_streams`."""
    dev = enc1.device
    off, delta, at0 = plan_streams(M, N, V)
    s1_idx = np.minimum(np.arange(M), enc1.shape[1] - 1)
    in_idx = np.minimum(off + V - 1, enc2.shape[1] - 1)
    s1c = enc1[:, torch.from_numpy(s1_idx).to(dev)]
    s2in = enc2[:, torch.from_numpy(in_idx).to(dev)]
    return s1c.contiguous(), s2in.contiguous(), delta, at0


def window_init(enc2: torch.Tensor, V: int, scores) -> torch.Tensor:
    """(B, V) s2 chars of the row-0 window, padded with ``sentinel(0xFF)``."""
    B, L2 = enc2.shape
    out = torch.full((B, V), sentinel(0xFF, scores), dtype=torch.int32, device=enc2.device)
    take = min(V, L2)
    out[:, :take] = enc2[:, :take]
    return out


def _check_fill(s1e, s2e, m: int, n: int, V: int):
    if V < 1024 or V % 1024:
        raise ValueError(f"band width V={V} must be a multiple of 1024")
    if not 1 <= n <= m:
        raise ValueError(
            f"banded alignment needs 1 <= n ({n}) <= m ({m}); swap "
            "the pair (the band tracks the length-proportional "
            "diagonal, which must slide at most one column per row)"
        )
    if s1e.dim() != 1 or s2e.dim() != 1 or s1e.device != s2e.device:
        raise ValueError("s1e and s2e must be 1-D tensors on one device")


def gotoh_banded(s1e: torch.Tensor, s2e: torch.Tensor, m: int, n: int, scores, V: int):
    """Banded global fill of one pair. Returns ``(score, dirs)``: the int
    score at ``(m, n)`` and ``dirs`` (ceil(m/16), V) int32 on the
    sequences' device. ``s1e``/``s2e`` are uint8 byte codes (padding
    past ``m``/``n`` allowed). Requires ``1 <= n <= m`` and ``V`` a
    multiple of 1024. A CUDA tensor launches K10, a CPU tensor runs
    :func:`gotoh_banded_plain`."""
    _check_fill(s1e, s2e, m, n, V)
    s1b, s2b = s1e[None, :], s2e[None, :]
    ms, ns = np.array([m]), np.array([n])
    if _build.uses_kernel(s1e):
        score, dirs = fill_cuda(s1b, s2b, ms, ns, scores, V, COUNTS)
    else:
        score, dirs = gotoh_banded_plain(s1b, s2b, ms, ns, scores, V)
    return int(score[0]), dirs[0]


def probe_lanes(ms: np.ndarray, ns: np.ndarray, M: int, N: int, V: int) -> np.ndarray:
    """Band lane of each pair's end cell ``(m_p, n_p)`` in the window
    planned from ``(M, N)``."""
    return np.asarray(ns, np.int64) - band_offset(np.asarray(ms, np.int64), M, N, V) - 1


def band_strip_columns(off: np.ndarray, m: int, n: int, V: int) -> tuple[np.ndarray, np.ndarray]:
    """The columns each strip (:data:`BAND_STRIP_ROWS` rows) of one pair
    visits in the kernel's sweep, over its rows ``1..m`` in the window whose row offsets
    are ``off`` (:func:`plan_streams`; row i at ``off[i - 1]``): ``(lo,
    hi)`` int64 arrays, one entry a strip, ``lo = off(first)`` (the column
    left of the first row's band) and ``hi = min(off(last) + V, n)``."""
    first = np.arange(1, int(m) + 1, BAND_STRIP_ROWS, dtype=np.int64)
    last = np.minimum(first + BAND_STRIP_ROWS - 1, int(m))
    off = np.asarray(off, np.int64)
    return off[first - 1], np.minimum(off[last - 1] + V, int(n))


def band_slot_width(off: np.ndarray, ms, ns, V: int) -> int:
    """Columns a ring slot of the kernel holds: the widest strip of the
    batch (``hi - lo + 1`` of :func:`band_strip_columns`, at most ``V +
    BAND_STRIP_ROWS``)."""
    return max(int((hi - lo).max()) + 1
               for lo, hi in (band_strip_columns(off, m, n, V) for m, n in zip(ms, ns)))


def band_strips_in_flight(off: np.ndarray, ms, ns, V: int) -> np.ndarray:
    """Each pair's strips that can sweep at once
    (``gotoh_pallas.strips_in_flight`` of its widest strip and its median
    shift between strips: the band moves right as it goes down, so a
    strip waits for the one above to pass its first column)."""
    out = []
    for m, n in zip(ms, ns):
        lo, hi = band_strip_columns(off, m, n, V)
        shift = int(np.median(np.diff(lo))) if lo.size > 1 else 0
        out.append(int(gp.strips_in_flight(int((hi - lo).max()) + 1, shift)))
    return np.asarray(out, np.int64)


def fill_cuda(s1b, s2b, ms, ns, scores, V: int, counts: dict, max_blocks=None,
              spin_ns=gp.SPIN_NS):
    """Launch the banded fill over a batch of ``B`` pairs that share the
    window of ``(M, N) = (max ms, max ns)``: each pair's strips of
    :data:`BAND_STRIP_ROWS` rows are tickets of one warp-strip pipeline.
    Returns ``(score (B,) int32, dirs (B, ceil(M/16), V) int32)`` on the
    card (the codes of every true in-band cell; the rest zero) and adds
    one to ``counts["kernel"]``. ``max_blocks`` caps the persistent grid,
    ``spin_ns`` bounds a wait that sees nothing of the launch move; reads
    the launch's error word (one synchronisation) and raises if it is
    set. The callers check the geometry."""
    dev = s1b.device
    if dev.type != "cuda":
        raise ValueError(f"the banded fill kernel takes CUDA tensors, not {dev}")
    _build.require(s1b, "s1b", torch.uint8, dev)
    _build.require(s2b, "s2b", torch.uint8, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        resident = gp.resident_blocks(lib.gotoh_banded_blocks_per_sm(),
                                      torch.cuda.get_device_properties(dev).multi_processor_count,
                                      max_blocks)
        return run_band(lib, s1b, s2b, ms, ns, scores, V, resident, counts, spin_ns,
                        _build.stream_handle(dev))


def run_band(lib, s1b, s2b, ms, ns, scores, V: int, resident: int, counts: dict, spin_ns,
             stream):
    """Plan and launch the banded fill over the batch's tensors (on the
    card): ``(score, dirs)`` after reading the launch's error word."""
    dev = s1b.device
    B, Lm = s1b.shape
    Ln = s2b.shape[1]
    with annotate("genomics/gotoh_banded.plan"):
        ms = np.asarray(ms, np.int64)
        ns = np.asarray(ns, np.int64)
        M, N = int(ms.max()), int(ns.max())
        KW = -(-M // PACK)
        off, _, _ = plan_streams(M, N, V)
        slotw = band_slot_width(off, ms, ns, V)
        plan_h, nlevels, total, blocks, nslots = gp.pipeline_plan(
            ms, ns, slotw - 1, BAND_STRIP_ROWS, resident, row0=1,
            inflight=band_strips_in_flight(off, ms, ns, V))
        i32 = dict(dtype=torch.int32, device=dev)
        plan = torch.from_numpy(plan_h).to(dev)
        offs = torch.from_numpy(off.astype(np.int32)).to(dev)
        s1c = encode_chars(s1b, scores).contiguous()
        s2c = encode_chars(s2b, scores).contiguous()
        dirs = torch.zeros((B, KW, V), **i32)
        score = torch.full((B,), INT_MIN, **i32)
        work = torch.zeros(gp.WORK_HEAD + 5 * total + B, **i32)
        ring = torch.empty(max(nslots, 1) * 2 * slotw, **i32)
        kim = kimura_active(scores)
    with annotate("genomics/gotoh_banded.launch"):
        err = lib.gotoh_banded_launch(
            _build.ptr(s1c), _build.ptr(s2c), _build.ptr(offs), _build.ptr(plan),
            _build.ptr(work), _build.ptr(ring), _build.ptr(dirs), _build.ptr(score), B, Lm, Ln,
            V, KW, nlevels, total, slotw, scores.s_match, scores.s_mismatch,
            scores.s_transition if kim else 0, int(kim), scores.g, scores.h, blocks,
            int(spin_ns), stream,
        )
    _build.check(err, "gotoh_banded")
    counts["kernel"] += 1
    with annotate("genomics/gotoh_banded.wait"):
        err = int(work[1])  # the launch's error word (synchronises)
    if err != 0:
        raise RuntimeError("gotoh_banded: a strip pipeline wait passed its bound")
    return score, dirs


def gotoh_banded_plain(s1b, s2b, ms, ns, scores, V: int, counts: dict | None = None,
                       rows: int | None = None):
    """The plain PyTorch version of the banded fill over ``B`` pairs that
    share the window of ``(M, N) = (max ms, max ns)``: state (B, V), one
    step per row ``1..M``, on the tensors' device. Returns ``(score (B,),
    dirs (B, ceil(M/16), V))`` as :func:`fill_cuda` does; every lane is
    computed. ``rows`` stops after that many rows of the same window (dirs
    then has ``ceil(rows/16)`` words a lane; a probe below is not read)."""
    (COUNTS if counts is None else counts)["plain"] += 1
    dev = s1b.device
    B = s1b.shape[0]
    ms = np.asarray(ms, np.int64)
    ns = np.asarray(ns, np.int64)
    M, N = int(ms.max()), int(ns.max())
    i32 = dict(dtype=torch.int32, device=dev)
    g, h = scores.g, scores.h
    hg = h + g
    st = scores.s_transition if kimura_active(scores) else None
    enc1, enc2 = encode_chars(s1b, scores), encode_chars(s2b, scores)
    s1c, s2in, delta, at0 = row_streams(enc1, enc2, M, N, V)
    vpr = torch.from_numpy(probe_lanes(ms, ns, M, N, V)).to(dev)[:, None]
    mpr = torch.from_numpy(ms).to(dev)[:, None]

    lanes = torch.arange(V, **i32)[None, :]
    lanes_g = lanes * g
    neg_col = torch.full((B, 1), NEG_INF, **i32)
    M_prev = (h + (lanes + 1) * g).expand(B, V).clone()
    A_prev = M_prev + hg
    s2w = window_init(enc2, V, scores)
    fin = torch.full((B, V), INT_MIN, **i32)
    R = M if rows is None else min(int(rows), M)
    dirs = torch.zeros((B, -(-R // PACK), V), **i32)
    acc = torch.zeros((B, V), **i32)
    ends = set(ms.tolist())

    for i in range(1, R + 1):
        r = i - 1
        if at0[r]:
            fillM = 0 if i == 1 else h + (i - 1) * g
            fillN = h + i * g + hg
        else:
            fillM = fillN = NEG_INF
        if delta[r]:
            Dn = torch.cat([A_prev[:, 1:], neg_col], 1)
            M_al = M_prev
            s2w = torch.cat([s2w[:, 1:], s2in[:, r : r + 1]], 1)
        else:
            Dn = A_prev
            M_al = torch.cat([torch.full((B, 1), fillM, **i32), M_prev[:, :-1]], 1)
        Sn = sub_score(s1c[:, r : r + 1], s2w, scores.s_match, scores.s_mismatch, st) + M_al
        P = torch.maximum(Sn, Dn)
        # I[v] = max_{u <= v} seed[u] + (v - u) g, exact in int32 (no sum
        # here comes near the wrap)
        seed = torch.cat([torch.full((B, 1), fillN, **i32), P[:, :-1] + hg], 1)
        In = torch.cummax(seed - lanes_g, 1).values + lanes_g
        cm = torch.maximum(In, P)
        code = torch.where(cm == Sn, DIR_SUB, torch.where(
            cm == In, DIR_INS, torch.where(cm == Dn, DIR_DEL, DIR_STOP))).to(torch.int32)
        sp = r % PACK
        acc = (code if sp == 0 else acc) | (code << (2 * sp))
        if sp == PACK - 1 or i == R:
            dirs[:, r // PACK] = acc
        if i in ends:
            fin = torch.where((i == mpr) & (lanes == vpr), cm, fin)
        A_prev = torch.maximum(torch.maximum(In, Sn) + hg, Dn + g)
        M_prev = cm
    return fin.max(1).values, dirs


def walk_banded(dirs, m: int, n: int, V: int, geom: tuple[int, int] | None = None,
                max_steps: int | None = None) -> np.ndarray:
    """Chase one pair's banded codes from ``(m, n)`` to the origin; returns
    the move codes in walk order (uint8). ``geom`` overrides the window
    geometry ``(M, N)`` (a batched fill plans one window for the batch;
    the walk of a shorter pair starts at its own ``(m, n)``).
    ``max_steps`` caps one kernel launch (a longer walk resumes). Raises
    ``RuntimeError`` on a path that leaves the band or meets a stop
    code."""
    return walk_banded_batch(dirs[None], [m], [n], V, geom, max_steps)[0]


def walk_banded_batch(dirs, ms, ns, V: int, geom: tuple[int, int] | None = None,
                      max_steps: int | None = None) -> list[np.ndarray]:
    """:func:`walk_banded` for ``B`` pairs' bitmaps ``dirs`` (B, KW, V)
    under one window geometry (default: pair 0's own ``(m, n)``). A CUDA
    bitmap launches K11 once for all walks, each carried whole (its
    buffer sized by :func:`whole_walk_steps`), or, given ``max_steps``
    (1..``MAX_STEPS_CAP``), again for the walks that filled it; a CPU
    bitmap runs :func:`walk_banded_plain` per walk."""
    ms = np.asarray(ms, np.int64).reshape(-1)
    ns = np.asarray(ns, np.int64).reshape(-1)
    if dirs.dim() != 3 or dirs.shape[0] != ms.size or ns.shape != ms.shape:
        raise ValueError("dirs must be (B, KW, V) with one (m, n) per pair")
    if dirs.shape[2] != V:
        raise ValueError(f"dirs have {dirs.shape[2]} lanes, not V={V}")
    gM, gN = geom if geom is not None else (int(ms[0]), int(ns[0]))
    if ms.max() > gM or ms.min() < 1:
        raise ValueError(f"walks start in rows {ms.min()}..{ms.max()}, outside the "
                         f"window's rows 1..{gM}")
    if not _build.uses_kernel(dirs):
        return [walk_banded_plain(dirs[b], int(ms[b]), int(ns[b]), V, (gM, gN))
                for b in range(ms.size)]
    with annotate("genomics/gotoh_banded.walk"):
        return _walk_banded_cuda(dirs, ms, ns, V, gM, gN, max_steps)


def whole_walk_steps(ms, ns) -> int:
    """Moves that cover every walk from its ``(m, n)``: a path makes at
    most ``m + n`` moves."""
    return int(np.max(np.asarray(ms, np.int64) + np.asarray(ns, np.int64))) + 1


def _oob(i: int, j: int) -> RuntimeError:
    return RuntimeError(
        f"banded traceback left the band or hit a stop code at ({i}, {j}) "
        "— corrupt direction data"
    )


def _walk_banded_cuda(dirs, ms, ns, V, gM: int, gN: int,
                      cap: int | None) -> list[np.ndarray]:
    dev = dirs.device
    _build.require(dirs, "dirs", torch.int32, dev)
    if cap is not None and not 1 <= cap <= MAX_STEPS_CAP:
        raise ValueError(f"max_steps must be in 1..{MAX_STEPS_CAP}")
    B, KW, _ = dirs.shape
    cap = whole_walk_steps(ms, ns) if cap is None else cap
    nw = -(-cap // MPW)
    lib = _build.library()
    off, deltas, _ = plan_streams(gM, gN, V)
    slides_d = torch.from_numpy(slide_words(deltas, gM)).to(dev)
    # walk state: (i, j, off, koff) of every walk still running
    state = np.stack([ms, ns, off[ms - 1], np.arange(B) * KW], 1)
    live = np.arange(B)
    chunks: list[list[np.ndarray]] = [[] for _ in range(B)]
    while live.size:
        W = live.size
        starts = torch.from_numpy(state[live].astype(np.int32)).to(dev)
        words = torch.empty((W, nw), dtype=torch.int32, device=dev)
        meta = torch.empty((W, 6), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = lib.walk_banded_launch(
                _build.ptr(dirs), _build.ptr(slides_d), _build.ptr(starts), _build.ptr(words),
                _build.ptr(meta), W, KW, V, B * KW, int(deltas.size), nw, cap,
                _build.stream_handle(dev),
            )
        _build.check(err, "walk_banded")
        COUNTS["walk_kernel"] += 1
        meta_h = meta.cpu().numpy().astype(np.int64)
        bad = np.nonzero(meta_h[:, 5])[0]
        if bad.size:
            raise _oob(int(meta_h[bad[0], 1]), int(meta_h[bad[0], 2]))
        # Every launch moves each live walk at least once, or flags it.
        used = -(-int(meta_h[:, 0].max()) // MPW)
        words_h = words[:, :used].cpu().numpy()
        for k, b in enumerate(live):
            chunks[b].append(unpack_moves(words_h[k], int(meta_h[k, 0])))
        state[live, :3] = meta_h[:, 1:4]
        live = live[meta_h[:, 4] == 0]
    return [np.concatenate(c) for c in chunks]


def walk_banded_plain(dirs, m: int, n: int, V: int,
                      geom: tuple[int, int] | None = None) -> np.ndarray:
    """The plain version of the banded walker: a host loop over one
    pair's bitmap ``dirs`` (KW, V) from ``(m, n)``, in the window planned
    from ``geom`` (default ``(m, n)``), tracking ``off`` by the rows'
    deltas."""
    COUNTS["walk_plain"] += 1
    gM, gN = geom or (m, n)
    offs, deltas, _ = plan_streams(gM, gN, V)
    words = dirs.detach().to("cpu").numpy()
    KW = words.shape[0]
    i, j, off = int(m), int(n), int(offs[m - 1])
    moves = []
    while i > 0 or j > 0:
        v = j - off - 1
        if i == 0:
            code = DIR_INS
        elif j == 0:
            code = DIR_DEL
        else:
            if not (0 <= v < V and ((i - 1) >> 4) < KW):
                raise _oob(i, j)
            code = (int(words[(i - 1) >> 4, v]) >> (2 * ((i - 1) & 15))) & 3
            if code == DIR_STOP:
                raise _oob(i, j)
        moves.append(code)
        if code != DIR_INS:
            off -= int(deltas[i - 1])
            i -= 1
        if code != DIR_DEL:
            j -= 1
    return np.asarray(moves, np.uint8)
