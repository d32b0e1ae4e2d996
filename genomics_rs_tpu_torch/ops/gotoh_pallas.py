"""Batch scores by a strip pipeline (kernel K9), the tile fill (K5) and
the row-blocked batch scores (K16): counterpart of
``genomics_rs_tpu/ops/gotoh_pallas.py``'s ``gotoh_scores_pallas_batch``,
``gotoh_tile_pallas``, ``gotoh_fill_pallas``, ``gotoh_scores_blocked``
and ``unpack_dirs``, and of the helpers its sibling modules import from
it: ``ROWS``, ``drift_rate_or_none``, ``concrete_lengths_or_none``.

:func:`gotoh_scores_pallas_batch` keeps its JAX namesake's contract: for a
padded batch ``s1eb`` (B, Lm), ``s2eb`` (B, Ln) of uint8 byte codes with
true lengths ``ms``/``ns``, each pair's global score at ``(m, n)`` or its
local keep-last row-major argmax ``(v, i, j)``, as ``(score, start_i,
start_j)`` int32 tensors of shape (B,).

On a CUDA tensor it launches ``csrc/gotoh_pallas.cu``: every row strip of
``32 * RT`` rows is one warp's work in the warp-strip pipeline of
``csrc/gotoh_warp_pipe.cuh`` (lane l holding RT rows in registers, the
lanes one column apart), the strips of a pair running on many SMs at once,
each fed the bottom row of the strip above through a ring of boundary rows
(see the sources' notes). On a CPU tensor it runs
:func:`gotoh_strips_plain`, the same decomposition: strips one after
another, each strip's bottom A/M row carried to the next, the local bests
merged across strips by (larger v, larger i, larger j).

The kernel computes only true cells, so it needs none of the JAX
wrappers' int32 drift guard (``drift_rate_or_none``).

:func:`gotoh_tile_pallas` (K5) fills one tile of the table from a
streamed top row and left column at global offsets ``(i0, j0)``: on a
CUDA tensor it launches K1's kernel (``csrc/gotoh_rowblock.cu``) with the
column offset and the right-column output, on a CPU tensor it runs
``ops/gotoh_tile.tile_fill``. :func:`gotoh_scores_blocked` (K16) is the
strip pipeline above at a strip height taken from its block height.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops import _build
from genomics_rs_tpu_torch.ops import gotoh_rowblock as rb
from genomics_rs_tpu_torch.ops.gotoh_scan import INT_MIN, FillResult
from genomics_rs_tpu_torch.ops import gotoh_stream as gs  # imports this module too
from genomics_rs_tpu_torch.ops.subst import encode_chars, kimura_active, sentinel, sub_score
from genomics_rs_tpu_torch.utils.profiling import annotate

#: sublane count of the JAX flat layout (kept for the modules that import
#: it there; the port's kernels have no panes).
ROWS = 8
#: rows a lane of the warp-strip pipeline holds, one compiled kernel each
#: (RT; a strip is ``32 * RT`` rows).
LANE_ROWS = (1, 2, 4, 8, 16)
#: rows of a pipeline strip (32 x RT): ``tools/time_fills.py`` times K9 at
#: RT = 4, 8 and 16.
PIPE_ROWS = 256
#: bytes K1's ring of boundary rows may take on the card
#: (``gotoh_rowblock.block_plan`` passes it to :func:`ring_budget`).
RING_BYTES = 2 << 30
#: bytes the warp-strip pipeline's ring may take (K9, K16, K10, K12), and
#: the default budget of :func:`ring_budget`, :func:`pipeline_groups` and
#: :func:`pipeline_plan`: a strip is one warp, so a long pair needs about a
#: thousand strips in flight, each holding a slot of its bottom row (8.6 MB
#: at 1 Mb columns).
PIPE_RING_BYTES = 8 << 30
#: ns a pipeline wait may see nothing of the launch move before it sets the
#: error word.
SPIN_NS = rb.SPIN_NS
#: ints of the pipeline's workspace before its per-strip arrays: ticket,
#: error word, heartbeat (``PIPE_WORK_HEAD`` in the source).
WORK_HEAD = 3

#: launches of the CUDA kernel / calls of the plain version.
COUNTS = {"kernel": 0, "plain": 0}
#: the same for the tile entry (K5) and the row-blocked entry (K16).
TILE_COUNTS = {"kernel": 0, "plain": 0}
BLOCKED_COUNTS = {"kernel": 0, "plain": 0}
#: the tallest strip (16 rows a lane).
PIPE_MAX_ROWS = 32 * LANE_ROWS[-1]
#: codes per packed int32 word.
PACK = rb.PACK


def drift_rate_or_none(scores) -> int | None:
    """The JAX kernels' worst-case per-diagonal drift of an unclamped
    padded lane (their int32 headroom guard raises past ``2**30``), or
    None when the scores cannot be read as integers. The port's kernels
    compute only true cells and do not need it."""
    try:
        st = getattr(scores, "s_transition", None)
        return (abs(int(scores.g)) + abs(int(scores.h)) + abs(int(scores.s_mismatch))
                + abs(int(scores.s_match)) + (abs(int(st)) if st is not None else 0) + 1)
    except (AttributeError, TypeError, ValueError):
        return None


def concrete_lengths_or_none(ms, ns):
    """``(ms, ns)`` as int64 numpy, or None when they cannot be read
    (a meta tensor, say)."""
    try:
        return tuple(np.asarray(x.cpu() if torch.is_tensor(x) else x, np.int64).reshape(-1)
                     for x in (ms, ns))
    except (TypeError, ValueError, NotImplementedError, RuntimeError):
        return None


def strip_height(rows: int) -> int:
    """The least compiled strip height (32 x RT, RT in :data:`LANE_ROWS`)
    that holds ``rows`` rows, or the tallest."""
    return 32 * next((r for r in LANE_ROWS if 32 * r >= rows), LANE_ROWS[-1])


def pipe_rows(Lm: int, rows_per_strip: int = PIPE_ROWS) -> int:
    """The strip height for a bucket of padded ``Lm`` rows:
    ``rows_per_strip`` (a compiled height), or the least compiled height
    that holds the bucket's ``Lm + 1`` rows if that is lower."""
    return min(int(rows_per_strip), strip_height(Lm + 1))


def gotoh_scores_pallas_batch(s1eb, s2eb, ms, ns, scores, is_local: bool = False):
    """``(score, start_i, start_j)``, int32 tensors of shape (B,) on the
    batch's device. The device of ``s1eb`` picks the route: CUDA launches
    the strip pipeline, CPU runs :func:`gotoh_strips_plain` at the same
    strip height."""
    if _build.uses_kernel(s1eb):
        return _pallas_cuda(s1eb, s2eb, ms, ns, scores, is_local)
    COUNTS["plain"] += 1
    return gotoh_strips_plain(s1eb, s2eb, ms, ns, scores, is_local, pipe_rows(s1eb.shape[1]))


def gotoh_strips_plain(s1eb, s2eb, ms, ns, scores, is_local: bool = False,
                       rows_per_strip: int = PIPE_ROWS):
    """The plain PyTorch version of the strip kernels (K9's pipeline, and
    K7's warp strips at ``32 * R`` rows): each pair is filled in strips
    of ``rows_per_strip`` rows, one after another, by the batched
    anti-diagonal step of :func:`wavefront_plain` over the strip's rows;
    the strip's bottom A/M row is carried to the next strip (lane 0 there
    replays it), and the local bests are merged across strips by larger v,
    then larger i, then larger j. Runs on the tensors' device; returns
    ``(score, start_i, start_j)`` int32 tensors of shape (B,)."""
    H = int(rows_per_strip)
    if H < 1:
        raise ValueError(f"rows_per_strip = {H}: at least one row a strip")
    dev = s1eb.device
    B, Lm = s1eb.shape
    Ln = s2eb.shape[1]
    ms_h, ns_h = gs._lengths(ms, ns, B, Lm, Ln)
    i32 = dict(dtype=torch.int32, device=dev)
    st = scores.s_transition if kimura_active(scores) else None
    s1c = encode_chars(s1eb, scores)
    s2c = encode_chars(s2eb, scores)
    s2pad = torch.full((B, 1), sentinel(0xFF, scores), **i32)

    best = [torch.full((B,), INT_MIN, **i32), torch.full((B,), -1, **i32),
            torch.zeros((B,), **i32)]
    fin = torch.full((B,), INT_MIN, **i32)
    top = None
    nstrips = (int(ms_h.max(initial=0)) + H) // H if B else 0
    for s in range(nstrips):
        # Lane 0 is row 0 in the first strip, the carried row s*H - 1 after.
        i0 = 0 if s == 0 else s * H - 1
        V = H if s == 0 else H + 1
        rows = torch.arange(i0, i0 + V, device=dev)
        s1m = torch.full((B, V), sentinel(0xFD, scores), **i32)
        real = (rows >= 1) & (rows <= Lm)
        s1m[:, real] = s1c[:, rows[real] - 1]
        s2j = torch.full((B, V), 0xFF, **i32)

        def sub_at(k: int) -> torch.Tensor:
            # The s2 character of lane iv's column j = k - iv shifts in at lane 0.
            nonlocal s2j
            inj = s2c[:, max(k - 1, 0) : max(k - 1, 0) + 1] if k - 1 < Ln else s2pad
            s2j = torch.cat([inj, s2j[:, :-1]], 1)
            return sub_score(s1m, s2j, scores.s_match, scores.s_mismatch, st)

        last = s == nstrips - 1
        out = gs.wavefront_plain(sub_at, B, Lm, Ln, ms_h, ns_h, scores.g, scores.h, is_local,
                              False, dev, i0=i0, V=V, top=top, emit_bottom=not last)
        fill, top = (out, None) if last else out
        if is_local:
            v, i, j = fill.score, fill.start_i, fill.start_j
            take = (v > best[0]) | ((v == best[0]) & ((i > best[1]) | ((i == best[1]) & (j > best[2]))))
            best = [torch.where(take, x, y) for x, y in zip((v, i, j), best)]
        else:
            fin = torch.where(fill.score != INT_MIN, fill.score, fin)
    if is_local:
        return tuple(best)
    return (fin, torch.as_tensor(ms_h, dtype=torch.int32).to(dev),
            torch.as_tensor(ns_h, dtype=torch.int32).to(dev))


def ring_budget(Ln: int, ring_bytes: int | None = None) -> int:
    """Ring slots (2 x (Ln + 1) int32 each) that ``ring_bytes`` (default
    ``PIPE_RING_BYTES``) holds."""
    return (PIPE_RING_BYTES if ring_bytes is None else ring_bytes) // (8 * (Ln + 1))


def strip_counts(ms_h, rows: int, row0: int = 0) -> np.ndarray:
    """Strips of ``rows`` rows each pair's rows ``row0..m`` take (int64)."""
    return (np.asarray(ms_h, np.int64) - row0 + rows) // rows


def pipeline_groups(ms_h, Ln: int, rows: int, ring_bytes: int | None = None
                    ) -> list[tuple[int, int]]:
    """Split a bucket into launches whose rings fit ``ring_bytes``
    (default ``PIPE_RING_BYTES``): contiguous pair ranges ``[lo, hi)``. A pair
    of s strips needs ``min(s - 1, 2)`` slots (strip s - 1 writes the slot
    strip s - 2 read), so a launch takes pairs while their needs fit the
    budget."""
    need = np.minimum(strip_counts(ms_h, rows) - 1, 2)
    budget = ring_budget(Ln, ring_bytes)
    if budget < int(need.max(initial=0)):
        raise ValueError(f"gotoh_pallas: two ring slots of {Ln + 1} columns pass PIPE_RING_BYTES")
    if int(need.sum()) <= budget:  # the common case: one launch
        return [(0, len(need))]
    groups, lo, used = [], 0, 0
    for p, k in enumerate(need.tolist()):
        if used + k > budget:
            groups.append((lo, p))
            lo, used = p, 0
        used += k
    groups.append((lo, len(need)))
    return groups


def strips_in_flight(width, shift) -> np.ndarray:
    """Strips of each pair that can sweep at once in the warp-strip
    pipeline: a strip sweeps ``width`` columns (and 31 steps of lane skew)
    while the next one starts ``shift`` columns further right plus about
    64 steps of lookahead and skew behind it; two more for slack. A warp
    beyond these only spins on its predecessor's progress, and spinning
    warps slow the sweeping ones (PERF.md)."""
    return -(-(np.asarray(width, np.int64) + 32) // (np.asarray(shift, np.int64) + 64)) + 2


def pipeline_plan(ms_h, ns_h, Ln: int, rows: int, resident: int, row0: int = 0,
                  ring_bytes: int | None = None, inflight=None):
    """The host's plan of one pipelined launch over each pair's rows
    ``row0..m`` (0 for K9, 1 for the band fill): ``(plan int32 array,
    nlevels, total strips, persistent blocks, ring slots)``. Tickets go
    level by level (strip s of every pair that has one), pairs ordered by
    strip count; each pair gets ``min(strips - 1, k)`` ring slots of 2 x
    (``Ln`` + 1) int32, ``k`` from 2 (a strip never writes the slot it
    reads) up to ``ceil(blocks / B) + 1``, as large as ``ring_bytes``
    (default ``PIPE_RING_BYTES``) allows. The pairs must fit at ``k = 2``
    (:func:`pipeline_groups`). The grid is then cut to the strips that can
    run at once: ``min(strips, slots + 1)`` a pair, and at most
    ``inflight`` (one entry a pair, :func:`strips_in_flight`) when
    given."""
    B = len(ms_h)
    strips = strip_counts(ms_h, rows, row0)
    strip0 = np.concatenate([[0], np.cumsum(strips)])
    total = int(strip0[-1])
    nlevels = int(strips.max())
    by_strips = np.argsort(-strips, kind="stable")
    level_start = np.concatenate([[0], np.cumsum([(strips > s).sum() for s in range(nlevels)])])
    blocks = max(1, min(total, resident))
    budget = ring_budget(Ln, ring_bytes)
    lo, hi = 2, max(2, -(-blocks // B) + 1)  # the most slots a pair that fit the budget
    if np.minimum(strips - 1, lo).sum() > budget:
        raise ValueError("gotoh_pallas: the pairs' two ring slots each pass PIPE_RING_BYTES")
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if np.minimum(strips - 1, mid).sum() <= budget else (lo, mid - 1)
    slots = np.minimum(strips - 1, lo)
    cap = np.minimum(strips, slots + 1)
    if inflight is not None:
        cap = np.minimum(cap, inflight)
    blocks = max(1, min(blocks, int(cap.sum())))
    slot0 = np.concatenate([[0], np.cumsum(slots)[:-1]])
    plan = np.concatenate([ms_h, ns_h, strip0, level_start, by_strips, slot0, slots])
    return plan.astype(np.int32), nlevels, total, blocks, int(slots.sum())


def _pallas_cuda(s1eb, s2eb, ms, ns, scores, is_local, rows_per_strip=PIPE_ROWS,
                 max_blocks=None, counts=COUNTS, spin_ns=SPIN_NS):
    """Launch the pipeline at strips of ``pipe_rows(Lm, rows_per_strip)``
    rows (a compiled height), once for each of :func:`pipeline_groups`'
    pair ranges (one launch unless the bucket's ring passes
    ``PIPE_RING_BYTES``), adding one to ``counts["kernel"]`` a launch (K9's
    count, or K16's); ``max_blocks`` caps the persistent grid below what
    the card holds (the card tests cycle tickets and ring slots with it);
    ``spin_ns`` bounds a wait that sees nothing of the launch move. Reads
    the launches' error words (one synchronisation) and raises if one is
    set."""
    dev = s1eb.device
    if dev.type != "cuda":
        raise ValueError(f"the K9 kernel takes CUDA tensors, not {dev}")
    B, Lm = s1eb.shape
    Ln = s2eb.shape[1]
    _build.require(s1eb, "s1eb", torch.uint8, dev, (B, Lm))
    _build.require(s2eb, "s2eb", torch.uint8, dev, (B, Ln))
    ms_h, ns_h = gs._lengths(ms, ns, B, Lm, Ln)
    if B == 0:
        return tuple(torch.empty((0,), dtype=torch.int32, device=dev) for _ in range(3))
    lib = _build.library()
    rows = pipe_rows(Lm, rows_per_strip)
    check_rows(rows, "gotoh_pallas")
    with torch.cuda.device(dev):
        per_sm = blocks_per_sm(lib.gotoh_pallas_blocks_per_sm, rows // 32, int(is_local))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        res = run_pipeline(lib, s1eb, s2eb, ms_h, ns_h, scores, is_local, rows,
                           resident_blocks(per_sm, sms, max_blocks), counts, spin_ns,
                           _build.stream_handle(dev))
    return res


def check_rows(rows: int, what: str) -> None:
    """Raise unless ``rows`` is a compiled strip height (32 x RT)."""
    if rows % 32 or rows // 32 not in LANE_ROWS:
        raise ValueError(f"{what}: {rows} rows a strip is not 32 x {LANE_ROWS}")


_PER_SM: dict = {}


def blocks_per_sm(query, *args) -> int:
    """``query(*args)``, a library's occupancy query for one compiled
    kernel, asked once a process (the answer does not change)."""
    key = (query.__name__, *args)
    if key not in _PER_SM:
        _PER_SM[key] = query(*args)
    return _PER_SM[key]


def resident_blocks(per_sm: int, sms: int, max_blocks=None) -> int:
    """Persistent one-warp blocks of a launch: what ``sms`` SMs hold at
    ``per_sm`` each (the occupancy query's answer), capped by
    ``max_blocks``. Raises if none fits."""
    if per_sm < 1:
        raise RuntimeError(f"gotoh_pallas: no warp of the pipeline fits an SM ({per_sm})")
    resident = per_sm * sms
    return resident if max_blocks is None else min(resident, int(max_blocks))


def run_pipeline(lib, s1eb, s2eb, ms_h, ns_h, scores, is_local, rows, resident, counts,
                 spin_ns, stream):
    """Plan and launch the warp-strip pipeline over the batch's tensors
    (on the card), one launch for each of :func:`pipeline_groups`' pair
    ranges; returns ``(score, start_i, start_j)`` after reading the
    launches' error words."""
    B, Lm = s1eb.shape
    Ln = s2eb.shape[1]
    kim = kimura_active(scores)
    s1c = encode_chars(s1eb, scores).contiguous()
    s2c = encode_chars(s2eb, scores).contiguous()
    res = torch.empty((B, 3), dtype=torch.int32, device=s1eb.device)

    def launch(lo, hi, plan, work, ring, nlevels, total, blocks):
        return lib.gotoh_pallas_launch(
            _build.ptr(s1c[lo:hi]), _build.ptr(s2c[lo:hi]), _build.ptr(plan),
            _build.ptr(work), _build.ptr(ring), _build.ptr(res[lo:hi]), hi - lo, Lm, Ln,
            nlevels, total, scores.s_match, scores.s_mismatch,
            scores.s_transition if kim else 0, int(kim), scores.g, scores.h,
            int(is_local), rows // 32, blocks, int(spin_ns), stream,
        )

    raise_on_err(launch_groups(launch, ms_h, ns_h, Ln, rows, resident, s1eb.device, counts,
                               "gotoh_pallas"))
    return res[:, 0], res[:, 1], res[:, 2]


def launch_groups(launch, ms_h, ns_h, Ln: int, rows: int, resident: int, dev, counts,
                  what: str) -> torch.Tensor:
    """Plan each of :func:`pipeline_groups`' pair ranges ``[lo, hi)`` and
    launch it by ``launch(lo, hi, plan, work, ring, nlevels, total,
    blocks)`` (a CUDA launch that returns its cudaError; ``work`` is the
    zeroed workspace, ``ring`` the range's slots), adding one to
    ``counts["kernel"]`` a launch. Returns the launches' largest error
    word as a 0-d int32 tensor on ``dev``, not read: the caller reads it
    where it reads the results (:func:`raise_on_err`)."""
    i32 = dict(dtype=torch.int32, device=dev)
    errs = []
    for lo, hi in pipeline_groups(ms_h, Ln, rows):
        with annotate("genomics/gotoh_pallas.plan"):
            plan_h, nlevels, total, blocks, nslots = pipeline_plan(
                ms_h[lo:hi], ns_h[lo:hi], Ln, rows, resident,
                inflight=strips_in_flight(np.asarray(ns_h[lo:hi]) + 1, 0))
            plan = torch.from_numpy(plan_h)
            if dev.type == "cuda":  # a pinned copy does not wait for the stream's earlier work
                plan = plan.pin_memory().to(dev, non_blocking=True)
            work = torch.zeros(WORK_HEAD + 5 * total + (hi - lo), **i32)
            ring = torch.empty(max(nslots, 1) * 2 * (Ln + 1), **i32)
        with annotate("genomics/gotoh_pallas.launch"):
            err = launch(lo, hi, plan, work, ring, nlevels, total, blocks)
        _build.check(err, what)
        counts["kernel"] += 1
        errs.append(work[1])
    return errs[0] if len(errs) == 1 else torch.stack(errs).max()


def raise_on_err(err, what: str = "gotoh_pallas") -> None:
    """Raise if a warp-strip pipeline's error word (a tensor or an int;
    reading a card tensor synchronises) is set."""
    with annotate("genomics/gotoh_pallas.wait"):
        err = int(err)
    if err != 0:
        raise RuntimeError(f"{what}: a strip pipeline wait passed its bound")


def blocked_rows(R: int, Lm: int | None = None) -> int:
    """The pipeline's strip height for K16's block height ``R``: the least
    compiled height (32 x RT) that holds ``R`` rows, at most
    :data:`PIPE_MAX_ROWS` (16 rows a lane). A bucket of padded ``Lm``
    rows that one such strip would hold runs at :data:`PIPE_ROWS` at most:
    its pairs' strips then sweep at once, and a 300-row block took 45.5
    ms at 256 rows a strip against 53.4 ms in one strip of 16-row lanes
    (PERF.md, ``tools/time_fills.py``)."""
    rows = strip_height(max(int(R), 1))
    return min(rows, PIPE_ROWS) if Lm is not None and Lm + 1 <= rows else rows


def gotoh_scores_blocked(s1eb, s2eb, ms, ns, scores, is_local: bool = False, R: int = 4096):
    """Batch scores filled in row blocks of ``R`` rows, each block's
    bottom row carried to the next and the local argmax merged across
    blocks (K16's contract): ``(score, ms, ns)`` in global mode, the
    keep-last row-major ``(v, i, j)`` in local mode, int32 tensors of
    shape (B,) on the batch's device.

    A CUDA batch runs K9's strip pipeline at strips of
    :func:`blocked_rows` ``(R, Lm)`` rows, a CPU batch
    ``gotoh_strips_plain`` at strips of ``R`` rows. The answer does not
    depend on ``R``: every block height fills the same table.
    """
    if _build.uses_kernel(s1eb):
        return _pallas_cuda(s1eb, s2eb, ms, ns, scores, is_local,
                            rows_per_strip=blocked_rows(R, s1eb.shape[1]),
                            counts=BLOCKED_COUNTS)
    BLOCKED_COUNTS["plain"] += 1
    return gotoh_strips_plain(s1eb, s2eb, ms, ns, scores, is_local, R)


def gotoh_tile_pallas(s1_block, s2e, top, left, m, n, i0, j0, scores, is_local: bool,
                      emit_dirs: bool = True, emit_bottom: bool = False,
                      emit_right: bool = False) -> rb.TileFillResult:
    """Fill tile rows ``i0+1..i0+R`` x columns ``j0+1..j0+B`` (K5).

    ``s1_block`` uint8 (R,), ``s2e`` uint8 (B,), ``top`` int32 (3, B+1)
    (I/S/D at row ``i0``, columns ``j0..j0+B``), ``left`` int32 (3, R) (at
    column ``j0``, rows ``i0+1..i0+R``), ``m``/``n`` the table's true
    lengths. Returns ``gotoh_rowblock.TileFillResult`` in the JAX
    layouts: packed ``dirs`` (Kp/16, V) (the code at tile cell (li, j) is
    ``(dirs[(li+j)//16, li] >> 2*((li+j)%16)) & 3``), ``score_at_mn``,
    ``best`` (v, i, j) in global coordinates, ``bottom`` (3, B+1) and
    ``right`` (3, R). ``best`` is ``tile_fill``'s argmax in both modes
    (the JAX tile kernel tracks it in local mode only). ``err`` is the
    launch's error word, read by the caller (``gotoh_rowblock.raise_on_err``).

    A CUDA tile launches K5 (K1's pipeline kernel at column offset ``j0``,
    without waiting for it); a CPU tile runs ``ops/gotoh_tile.tile_fill``
    (and, for ``dirs``, the row-block fill's plain version, whose codes do
    not depend on ``j0``).
    """
    if _build.uses_kernel(s1_block):
        return rb.launch(s1_block, s2e, top, left, m, n, i0, j0, scores, is_local,
                         emit_dirs, emit_bottom, False, emit_right, True, TILE_COUNTS)
    from genomics_rs_tpu_torch.ops.gotoh_tile import tile_fill

    TILE_COUNTS["plain"] += 1
    res = tile_fill(s1_block, s2e, top, left, scores, is_local, i0, j0, m, n)
    dirs = None
    if emit_dirs:
        dirs = rb.gotoh_rowblock_plain(s1_block, s2e, top, m, int(n) - int(j0), i0, scores,
                                       is_local, emit_dirs=True, emit_bottom=False,
                                       left=left).dirs
    return rb.TileFillResult(
        dirs=dirs, score_at_mn=res.at_mn, best=res.best,
        bottom=res.bottom if emit_bottom else None, cols=None,
        right=res.right if emit_right else None,
        err=torch.zeros((), dtype=torch.int32, device=s1_block.device))


def unpack_dirs(packed: torch.Tensor, Kp: int) -> torch.Tensor:
    """(Kp/16, V) packed words -> (Kp, V) uint8 per-cell codes."""
    shifts = 2 * torch.arange(PACK, dtype=torch.int32, device=packed.device)[None, :, None]
    codes = (packed[:, None, :] >> shifts) & 3
    return codes.reshape(Kp, packed.shape[1]).to(torch.uint8)


def gotoh_fill_pallas(s1e, s2e, m, n, scores, is_local: bool, emit_dirs: bool = True,
                      packed_dirs: bool = False) -> FillResult:
    """The whole (m+1) x (n+1) table as one tile, with the reference's
    boundary (``gotoh_fill_pallas``'s contract): score-only, K5 with the
    global boundary streams; with dirs, the row-block fill K1 and, unless
    ``packed_dirs``, the unpack to per-cell codes ``dirs[i + j, i]``.
    Returns ``FillResult`` with 0-d int32 tensors: the score at (m, n)
    and (m, n) in global mode, the keep-last argmax in local mode. Reads
    the fill's error word (one synchronisation) and raises if it is set."""
    from genomics_rs_tpu_torch.ops.gotoh_tile import global_boundary_left, global_boundary_top

    dev = s1e.device
    Lm, Ln = s1e.shape[0], s2e.shape[0]
    top = global_boundary_top(0, Ln, scores, device=dev)
    if emit_dirs:
        res = rb.gotoh_rowblock(s1e, s2e, top, m, n, 0, scores, is_local,
                                emit_dirs=True, emit_bottom=False)
        dirs = res.dirs if packed_dirs else unpack_dirs(res.dirs, res.dirs.shape[0] * PACK)
    else:
        res = gotoh_tile_pallas(s1e, s2e, top, global_boundary_left(0, Lm, scores, device=dev),
                                m, n, 0, 0, scores, is_local, emit_dirs=False)
        dirs = torch.zeros((0, 0), dtype=torch.uint8, device=dev)
    rb.raise_on_err(res.err)
    if is_local:
        v, bi, bj = res.best
        return FillResult(dirs=dirs, score=v, start_i=bi, start_j=bj)
    i32 = dict(dtype=torch.int32, device=dev)
    return FillResult(dirs=dirs, score=res.score_at_mn, start_i=torch.tensor(int(m), **i32),
                      start_j=torch.tensor(int(n), **i32))
