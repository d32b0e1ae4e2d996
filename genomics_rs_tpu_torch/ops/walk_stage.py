"""The staged chase of K2, K4 and K11 (``csrc/traceback_walk.cu``),
replayed on the host.

A staged chase runs one walk on one warp and reads its codes only from a
ring of *boxes* of the bitmap in shared memory: box ``c`` holds the word
rows ``[c R, (c+1) R)`` at a window of lanes, and the warp, on entering
box ``c``, prefetches the box ``RING - 1`` below it, placed from the
walk's cell at that moment. The constants below are the kernel's
(``DIAG_*``, ``BAND_*`` in the source; ``tests/test_torch_walk_stage.py``
holds them equal).

:func:`staged_walk` (K2), :func:`staged_walk_many` (K4) and
:func:`staged_walk_banded` (K11) replay the kernels step for step with
numpy copies of the boxes: the same box geometry, ring depth, window
placement, reloads and register-cached words; K2 and K4 one loop, as in
the source, with its runs of SUB and INS codes under the same caps (which
end a run on K2's exiting move at the latest), K11 its runs of SUB codes
decoded from one word. A word outside the current box reads as
``POISON`` (all STOP codes), so a placement or a run that reaches past
the box shows as a wrong walk, and entering a box that the ring did not
hold raises. They take ``walk_kernel``, ``walk_many`` and
``walk_banded_batch``'s arguments and return what those return, so the
tests hold them equal to the plain walkers and to JAX's.
:func:`slide_words` builds K11's ``slides`` operand.
"""

from __future__ import annotations

import numpy as np
import torch

from genomics_rs_tpu_torch.ops.gotoh_scan import DIR_DEL, DIR_INS, DIR_STOP, DIR_SUB
from genomics_rs_tpu_torch.ops.traceback_walker import (
    MAX_STEPS_CAP,
    MPW,
    _walk_args,
    pack_moves,
)

#: A window's first lane is a multiple of 4 (a TMA tile's must be 16-byte
#: aligned). K2 and K4: boxes of DIAG_ROWS word rows (64 anti-diagonals),
#: a ring of DIAG_RING; a box placed from a cell at most DIAG_RING boxes
#: above it spans at most 16 DIAG_ROWS DIAG_RING lanes, +3 for that
#: alignment.
DIAG_ROWS, DIAG_RING = 4, 3
DIAG_LANES = 16 * DIAG_ROWS * DIAG_RING + 4
#: K11: boxes of BAND_ROWS word rows (128 matrix rows) by BAND_LANES lanes,
#: a ring of BAND_RING, the window's top BAND_ABOVE lanes above the
#: extrapolated diagonal, BAND_BITS slide-bit words a box.
BAND_ROWS, BAND_LANES, BAND_RING, BAND_ABOVE = 8, 256, 4, 64
BAND_BITS = BAND_ROWS // 2
#: what a word outside every staged box reads as: sixteen STOP codes.
POISON = 0xFFFFFFFF


def slide_bits(deltas: np.ndarray) -> np.ndarray:
    """Per-row slides in {0, 1} -> int32 words, row q at bit q % 32 of
    word q // 32 (K11's ``slides`` operand)."""
    d = np.asarray(deltas).astype(bool)
    nw = -(-d.size // 32)
    packed = np.packbits(np.concatenate([d, np.zeros(nw * 32 - d.size, bool)]),
                         bitorder="little")
    return packed.view("<u4").astype(np.uint32).view(np.int32)


def slide_words(deltas: np.ndarray, m: int) -> np.ndarray:
    """K11's ``slides`` operand for a window of ``m`` rows:
    :func:`slide_bits` with zero words up to the last box's, since a box's
    BAND_BITS slide words are copied whole."""
    bits = slide_bits(deltas)
    boxes = ((int(m) - 1) >> 4) // BAND_ROWS + 1
    return np.concatenate([bits, np.zeros(max(0, boxes * BAND_BITS - bits.size), np.int32)])


def _clz32(x: int) -> int:
    return 32 - (x & 0xFFFFFFFF).bit_length()


class _Ring:
    """The kernel's ``Stage``: numpy copies of the boxes it stages."""

    def __init__(self, words, nrows, rows, lanes, ring, side, bits, stats):
        self.words, self.nrows = words, nrows
        self.rows, self.lanes, self.ring = rows, lanes, ring
        self.side, self.bits = side, bits
        self.V = words.shape[1]
        self.slots = [None] * ring
        self.cb = -1
        self.stats = stats

    def issue(self, c: int, lo: int) -> None:
        box = np.full((self.rows, self.lanes), POISON, np.uint32)
        r0, r1 = c * self.rows, min((c + 1) * self.rows, self.nrows)
        hi = min(lo + self.lanes, self.V)
        if r1 > r0 and hi > lo:
            box[: r1 - r0, : hi - lo] = self.words[r0:r1, lo:hi]
        side = [int(self.side[g]) if g < self.side.size else 0
                for g in range(c * self.bits, (c + 1) * self.bits)]
        self.slots[c % self.ring] = (c, lo, box, side)
        self.stats["boxes"] += 1

    def make_current(self, c: int) -> None:
        slot = self.slots[c % self.ring]
        if slot is None or slot[0] != c:
            raise AssertionError(f"box {c} was not staged (slot holds "
                                 f"{None if slot is None else slot[0]})")
        self.cb, self.cur_lo, self.cur, self.cur_bits = c, slot[1], slot[2], slot[3]

    def to_row(self, r: int, place) -> None:
        c = r // self.rows
        if c == self.cb:
            return
        if self.cb >= 0 and c == self.cb - 1:
            self.make_current(c)
            if c - (self.ring - 1) >= 0:
                self.issue(c - (self.ring - 1), place(c - (self.ring - 1)))
            return
        self.stats["restarts"] += 1
        self.issue(c, place(c))
        self.make_current(c)
        for q in range(1, self.ring):
            if c - q >= 0:
                self.issue(c - q, place(c - q))

    def holds(self, x: int) -> bool:
        return self.cur_lo <= x < self.cur_lo + self.lanes

    def reload(self, lo: int) -> None:
        self.stats["reloads"] += 1
        self.issue(self.cb, lo)
        self.make_current(self.cb)

    def word(self, r: int, x: int) -> int:
        """The word at (word row r, lane x) of the current box; POISON
        outside it."""
        rr, xx = r - self.cb * self.rows, x - self.cur_lo
        if not (0 <= rr < self.rows and 0 <= xx < self.lanes):
            return POISON
        return int(self.cur[rr, xx])


def _new_stats() -> dict:
    return {"boxes": 0, "restarts": 0, "reloads": 0, "steps": 0}


def _diag_one(words, KW, li, j, koff, loff, max_steps, stats, i0=0, j0=0):
    """The source's ``diag_chase``: one walk of K2 (block origin ``i0``,
    ``j0``) or K4 (``i0 = j0 = 0``), step for step. Returns ``(moves, li,
    j, done, exited, oob)``."""
    KWT, V = words.shape
    nrows = min(KW, KWT - koff)
    ring = _Ring(words[koff:] if koff < KWT else words[:0], nrows, DIAG_ROWS, DIAG_LANES,
                 DIAG_RING, np.zeros(0, np.uint32), 0, stats)
    moves, done, exited, oob = [], 0, 0, 0
    while not done and not exited and len(moves) < max_steps:
        k = li + j
        r, lane = k >> 4, loff + li
        if li < 0 or lane >= V or k < 0 or r >= KW or koff + r >= KWT:
            oob = 1
            break

        def place(c, li=li, k=k):
            return (loff + max(0, li - (k - 16 * DIAG_ROWS * c))) & ~3

        ring.to_row(r, place)
        if not ring.holds(lane):
            ring.reload(place(ring.cb))
        kmin, once = 16 * DIAG_ROWS * ring.cb, j < 0
        while True:
            kk = li + j
            p, rr, x = kk & 15, kk >> 4, loff + li
            tmax = min(p >> 1, li)
            w0 = ring.word(rr, x)
            c0 = (w0 >> (2 * p)) & 3
            subs = int(c0 == DIR_SUB)
            for t in range(1, 8):
                wt = ring.word(rr, x - min(t, tmax))
                subs |= int(((wt >> ((2 * p - 4 * t) & 31)) & 3) == DIR_SUB) << t
            ones = subs & ((2 << tmax) - 1)
            sub_run = min((~ones & (ones + 1)).bit_length() - 1, j)  # trailing ones
            ins_run = 0
            if c0 == DIR_INS:
                lead = _clz32(((w0 ^ 0x55555555) << (2 * (15 - p))) & 0xFFFFFFFF) >> 1
                ins_run = min(lead, p + 1, j)
            code = DIR_SUB if sub_run > 0 else c0
            n = min(max(sub_run, ins_run, 1), max_steps - len(moves))
            stats["steps"] += 1
            ig = max(i0 + li - (0 if code == DIR_INS else n), 0)
            jn = max(j - (0 if code == DIR_DEL else n), 0)
            if code != DIR_STOP:
                moves.extend([code] * n)
            if code == DIR_STOP or (ig == 0 and jn == 0 and j0 == 0):
                done = 1
            elif ig < i0:
                exited = 1
            elif jn == 0 and j0 > 0:
                exited = 2
            li, j = max(ig - i0, 0), jn
            if done or exited or len(moves) >= max_steps or li + j < kmin or once:
                break
    return moves, li, j, done, exited, oob


def staged_walk(dirs: torch.Tensor, start_li: int, start_j: int, i0: int, max_steps: int,
                j0: int = 0, stats: dict | None = None):
    """K2 replayed over a CPU bitmap (KW, V): ``walk_kernel``'s arguments
    and return value, ``(words int32[ceil(count/16)], count, i_final,
    j_final, done)``; a walk off the bitmap raises ``IndexError``.
    ``stats`` gathers box loads, ring restarts, reloads and steps."""
    if max_steps > MAX_STEPS_CAP:
        raise ValueError(f"max_steps {max_steps} > {MAX_STEPS_CAP}; loop walk_full")
    words = dirs.detach().cpu().numpy().view(np.uint32)
    stats = _new_stats() if stats is None else stats
    KW = words.shape[0]
    moves, li, j, done, exited, oob = _diag_one(words, KW, int(start_li), int(start_j), 0, 0,
                                                int(max_steps), stats, int(i0), int(j0))
    if oob:
        raise IndexError(f"walk left the bitmap at (li={li}, j={j})")
    i_final = int(i0) - 1 if exited == 1 else int(i0) + li
    packed = pack_moves(np.asarray(moves, np.uint32), -(-len(moves) // MPW))
    return packed, len(moves), i_final, j, bool(done)


def staged_walk_many(dirs: torch.Tensor, start_li, start_j, koffs, KW: int,
                     max_steps: int, loffs=None, stats: dict | None = None):
    """K4 replayed over a CPU bitmap: ``walk_many``'s arguments and return
    value (an out-of-bitmap walk raises ``IndexError``); ``stats`` gathers
    box loads, ring restarts, reloads and steps."""
    W, (li, sj, ko, lo) = _walk_args(dirs, start_li, start_j, koffs, max_steps, loffs)
    words = dirs.detach().cpu().numpy().view(np.uint32)
    stats = _new_stats() if stats is None else stats
    nw = -(-max_steps // MPW)
    out_w = np.zeros((W, nw), np.int32)
    out = np.zeros((4, W), np.int64)
    for w in range(W):
        moves, li_f, j_f, done, _, oob = _diag_one(
            words, int(KW), int(li[w]), int(sj[w]), int(ko[w]), int(lo[w]), max_steps, stats)
        if oob:
            raise IndexError(f"walk {w} left its bitmap at (li={li_f}, j={j_f})")
        out_w[w] = pack_moves(np.asarray(moves, np.uint32), nw)
        out[:, w] = len(moves), li_f, j_f, done
    return out_w, out[0], out[1], out[2], out[3] != 0


def _banded_one(words, KW, koff, slides, ND, i, j, off, max_steps, stats):
    KWT, V = words.shape
    nrows = min(KW, KWT - koff)
    ring = _Ring(words[koff:] if koff < KWT else words[:0], nrows, BAND_ROWS, BAND_LANES,
                 BAND_RING, slides, BAND_BITS, stats)
    moves, pos, done, oob = [], 0, int(i == 0 and j == 0), 0
    cr = cv = cg = -1
    cw = cs = 0
    rows16 = 16 * BAND_ROWS
    while not done and pos < max_steps:
        n = 1
        if i == 0:
            code = DIR_INS
        else:
            r, v = (i - 1) >> 4, j - off - 1

            def place(c, i=i, v=v):
                d = max(0, i - rows16 * (c + 1))
                slope = sum(bin(b).count("1") for b in ring.cur_bits) if d > 0 else 0
                top = min(v - d + d * slope // rows16 + BAND_ABOVE + 1, V)
                return max(0, top - (BAND_LANES - 4)) & ~3

            ring.to_row(r, place)
            g = (i - 1) >> 5
            if g != cg:
                cs, cg = ring.cur_bits[g - ring.cb * BAND_BITS], g
            if j == 0:
                code = DIR_DEL
            else:
                if v < 0 or v >= V or r >= KW or koff + r >= KWT or i > ND:
                    oob = 1
                    break
                if r != cr or v != cv:
                    if not ring.holds(v):
                        ring.reload(place(ring.cb))
                    cw, cr, cv = ring.word(r, v), r, v
                p = (i - 1) & 15
                code = (cw >> (2 * p)) & 3
                if code == DIR_STOP:
                    oob = 1
                    break
                if code == DIR_SUB:
                    subs = min(_clz32(cw << (2 * (15 - p))) >> 1, p + 1)
                    slid = _clz32(~(cs << (31 - ((i - 1) & 31))))
                    n = min(subs, slid + 1, j, max_steps - pos)
        stats["steps"] += 1
        if code != DIR_INS:
            off -= (n - 1) + ((cs >> ((i - n) & 31)) & 1)
            i -= n
        if code != DIR_DEL:
            j -= n
        moves.extend([code] * n)
        pos += n
        done = int(i == 0 and j == 0)
    return moves, i, j, off, done, oob


def staged_walk_banded(dirs: torch.Tensor, ms, ns, V: int, geom: tuple[int, int] | None = None,
                       max_steps: int | None = None,
                       stats: dict | None = None) -> list[np.ndarray]:
    """K11 replayed over CPU bitmaps ``dirs`` (B, KW, V): ``walk_banded_
    batch``'s arguments and return value, launch for launch (one launch
    carries whole walks unless ``max_steps`` caps it; a capped walk
    resumes from its meta). Raises ``RuntimeError`` where the kernel
    flags ``oob``."""
    from genomics_rs_tpu_torch.ops import gotoh_banded as gb

    ms = np.asarray(ms, np.int64).reshape(-1)
    ns = np.asarray(ns, np.int64).reshape(-1)
    gM, gN = geom if geom is not None else (int(ms[0]), int(ns[0]))
    B, KW, _ = dirs.shape
    words = dirs.detach().cpu().numpy().reshape(B * KW, V).view(np.uint32)
    stats = _new_stats() if stats is None else stats
    off, deltas, _ = gb.plan_streams(gM, gN, V)
    slides = slide_words(deltas, gM).view(np.uint32)
    cap = gb.whole_walk_steps(ms, ns) if max_steps is None else int(max_steps)
    state = [[int(ms[b]), int(ns[b]), int(off[ms[b] - 1])] for b in range(B)]
    chunks: list[list] = [[] for _ in range(B)]
    live = list(range(B))
    while live:
        still = []
        for b in live:
            i, j, o = state[b]
            moves, i, j, o, done, oob = _banded_one(words, KW, b * KW, slides, deltas.size,
                                                    i, j, o, cap, stats)
            if oob:
                raise gb._oob(i, j)
            chunks[b].extend(moves)
            state[b] = [i, j, o]
            if not done:
                still.append(b)
        live = still
    return [np.asarray(c, np.uint8) for c in chunks]
