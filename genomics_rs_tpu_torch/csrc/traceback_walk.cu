// Traceback walkers for Hopper (sm_90a), bound by ctypes.
//
// walk_kernel (K2) replaces genomics_rs_tpu/ops/traceback_pallas.py's
// walk_pallas (body _kernel_walk over _run_chase). It chases packed 2-bit
// direction codes (code(li, j) = (dirs[(li+j)/16 * V + li] >> 2*((li+j)%16))
// & 3) from a start cell with the reference retrace rules: per-axis
// saturation at 0; done on a STOP code or on reaching (0, 0) when j0 == 0;
// exit up when the row falls below i0 (exited = 1) or left onto local
// column 0 of a windowed bitmap when j0 > 0 (exited = 2); the position moves
// on a STOP too. Moves (STOP excluded) are packed 16 per int32 into
// `words`; a partial last word still lands. meta = (pos, li, j, done,
// exited, out_of_bounds). It is K4's staged chase (below) on one warp over
// the whole (KW, V) bitmap, with the exits: only a move off lane 0 (when
// i0 > 0) or onto column 0 (when j0 > 0) can exit, and K4's runs of SUB or
// INS codes end on such a move at the latest (their caps at lane 0 and
// column 0), so the one-move rules applied to a run's last move decide
// every exit. It takes any KW >= 1, V >= 1 and any 4-byte-aligned view.
//
// walk_many_kernel (K4) replaces traceback_pallas.py:397, walk_many (body
// _kernel_walk_many): W independent chases over one packed diag16 array
// (KWT, V), walk w reading the word rows [koff_w, koff_w + KW) and the
// lanes from loff_w on, from its own start cell to the origin (i0 = j0 = 0:
// full-width bitmaps, so no exits). A staged chase (below), a warp a walk.
// A box is DIAG_ROWS word rows of anti-diagonals (k = li + j) by the lanes
// from the lowest one the path can reach in it up to the walk's lane; li
// and k only fall, and li falls no faster than k, so a box placed from the
// walk's cell always holds its path: the walk never waits for a box it has
// not prefetched. It takes any KW >= 1, V >= 1.
//
// walk_rows16_kernel is the card form of genomics_rs_tpu/ops/
// traceback_batch.py's walk_batch (layout "rows16"), which is XLA code (a
// lax.scan over max_steps lockstep steps), not a Pallas kernel: B walks over
// K6's per-read words codes[b, i-1, (j-1)/16] (interior cells only). The
// boundary codes are synthesized as walk_batch does: row 0 is INS and
// column 0 is DEL, except in local mode where a negative boundary score
// (h + j*g, h + i*g) is a STOP. A stop ends the walk where it stands
// (walk_batch's final cell is the stop cell, unlike K4's). One thread per
// walk: the B chains of dependent loads hide each other's latency.
//
// walk_banded_kernel (K11) replaces genomics_rs_tpu/ops/gotoh_banded.py:624,
// _walk_banded_pallas (body _kernel_walk_banded): the chase of the banded
// fill's row-packed codes, dirs[(i-1)/16, v] at band lane v = j - off - 1,
// from (m, n) to the origin. Row 0 is INS and column 0 is DEL (synthesized);
// an interior lane outside [0, V) or a STOP code is corrupt data (oob). off
// is tracked by the per-row slides delta(i-1) = off(i) - off(i-1) in {0, 1},
// never by (i*n)/m, which overflows int32 at chromosome scale. A staged
// chase, a warp a walk, all walks of a banded batch in one launch under one
// window geometry. A box is BAND_ROWS word rows (16 BAND_ROWS matrix rows)
// by BAND_LANES lanes, with its rows' slide bits (32 rows a word): the
// window's top sits BAND_ABOVE lanes above the lane where the diagonal
// enters the box, extrapolated from the walk's cell at the current box's
// slope (its slide bits' popcount), so gaps of up to ~BAND_ABOVE deletions
// and ~BAND_LANES - BAND_ABOVE - 16 BAND_ROWS insertions stay inside. A path
// that leaves the window anyway reloads the box around its cell and waits.
// On a diagonal run where the band slides with the path (slide bits 1) the
// lane stays put, so the run's SUB codes are consecutive fields of the
// cached word: they are decoded together (a count of leading zero bits) and
// applied as one step of up to 16 moves.
//
// The staged chase (K2, K4 and K11). What bounds a walk on one thread is the
// chain: each move's address depends on the previous move's
// code, so every move was one dependent global load, a DRAM miss whenever
// the path enters a new word row (one 29.9 kb pair's bitmap is ~450 MB, the
// 1 Mb band's ~550 MB, past the 50 MB L2), and one to sixteen walks leave
// the card idle under it. The design takes the DRAM latency off the chain:
// - One warp a walk. Every lane runs the same chase (uniform control flow,
//   so each shared-memory read is a broadcast) and lane 0 stores the moves.
// - A ring of RING boxes of the bitmap in shared memory. The walk's row only
//   falls, so each box is left once; on entering box c the warp issues the
//   box RING - 1 below it, placed from the walk's current cell, and waits
//   only for box c's own copy. Where the rows are 16-byte multiples and at
//   least a box wide, lane 0 issues the box as one TMA tile of a tensor map
//   over the bitmap (rows and lanes past its end read as 0), counted in on
//   the slot's mbarrier; else the 32 lanes issue it as one group of 4-byte
//   cp.async copies. DRAM latency overlaps RING - 1 boxes of walking.
//   K2 and K4 share one loop (diag_chase); K2 adds its exits to it.
// - The current word stays in a register: a move that keeps (word row,
//   lane) decodes from it with no memory access at all.
// What bounds the staged chase is the chain of one shared-memory load (or
// a register decode) and ~10 dependent integer operations a move, against a
// byte bound of the words the path reads.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned DIR_SUB = 0, DIR_INS = 1, DIR_DEL = 2, DIR_STOP = 3;

// A window's first lane is a multiple of 4 (16 bytes): a TMA tile whose
// first lane is not faults (an illegal instruction on the card).
// K2 and K4: boxes of 4 word rows (64 anti-diagonals), a ring of 3; a box placed
// from a cell at most RING boxes above it spans at most 16 DIAG_ROWS
// DIAG_RING lanes, +3 for its first lane's alignment.
constexpr int DIAG_ROWS = 4, DIAG_RING = 3;
constexpr int DIAG_LANES = 16 * DIAG_ROWS * DIAG_RING + 4;
// K2's output: META_SLOTS int32 of meta (6 and 2 pad), then its moves.
constexpr int META_SLOTS = 8;
// K11: boxes of 8 word rows (128 matrix rows) by 256 lanes, a ring of 4;
// 4 slide-bit words a box.
constexpr int BAND_ROWS = 8, BAND_LANES = 256, BAND_RING = 4, BAND_ABOVE = 64;
constexpr int BAND_BITS = BAND_ROWS / 2;

// starts[2b .. 2b+1] = (start_i, start_j) of walk b over the (L1, W) words
// of read b; its moves go to words[b*NW ..], its meta to meta[5b ..] =
// (count, i, j, done, oob).
__global__ void walk_rows16_kernel(const unsigned* __restrict__ codes,
                                   const int* __restrict__ starts,
                                   unsigned* __restrict__ words,
                                   int* __restrict__ meta, int B, int L1,
                                   int W, int NW, int max_steps, int h, int g,
                                   int is_local) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = starts[2 * b];
  int j = starts[2 * b + 1];
  const unsigned* c = codes + (size_t)b * L1 * W;
  unsigned* out = words + (size_t)b * NW;
  int pos = 0, done = 0, oob = 0;
  unsigned acc = 0;
  for (int step = 0; step < max_steps && !done; ++step) {
    unsigned code;
    if (i == 0) {
      code = (!is_local || h + j * g >= 0) ? DIR_INS : DIR_STOP;
    } else if (j == 0) {
      code = (!is_local || h + i * g >= 0) ? DIR_DEL : DIR_STOP;
    } else {
      if (i > L1 || j < 0 || ((j - 1) >> 4) >= W) {
        oob = 1;
        break;
      }
      code = (c[(size_t)(i - 1) * W + ((j - 1) >> 4)] >> (2 * ((j - 1) & 15))) & 3u;
    }
    if (code == DIR_STOP) {
      done = 1;
      break;
    }
    const int sp = pos & 15;
    if (sp == 0) acc = 0;
    acc |= code << (2 * sp);
    if (sp == 15) out[pos >> 4] = acc;
    ++pos;
    i = max(i - (code == DIR_INS ? 0 : 1), 0);
    j = max(j - (code == DIR_DEL ? 0 : 1), 0);
    if (i == 0 && j == 0) done = 1;
  }
  if (pos & 15) out[pos >> 4] = acc;
  int* mt = meta + 5 * b;
  mt[0] = pos;
  mt[1] = i;
  mt[2] = j;
  mt[3] = done;
  mt[4] = oob;
}

// ---- the staged chase: a ring of bitmap boxes in shared memory ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy4_async(unsigned* dst, const unsigned* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this lane's copy groups are in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// The TMA route: one lane copies a whole box (a tile of a 2-D tensor map
// over the bitmap, rows past its end read as 0) and its slide words (a bulk
// copy) into a slot whose mbarrier counts their bytes in.
__device__ __forceinline__ void init_barrier(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void copy_tile(unsigned* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)), "l"(map), "r"(x), "r"(y), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void copy_bulk(unsigned* dst, const unsigned* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ bool barrier_passed(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return ok;
}

// RING boxes of a (rows, V) int32 bitmap, each ROWS word rows by LANES
// lanes, and BITS words of a side array a box (the band's slide bits).
template <int ROWS, int LANES, int RING, int BITS>
struct BoxRing {
  // a slot 128-byte aligned, as TMA writes it
  static constexpr int SLOT = (ROWS * LANES + 31) / 32 * 32;
  unsigned code[RING][SLOT];
  unsigned bits[RING][BITS > 0 ? (BITS + 3) / 4 * 4 : 4];
  uint64_t bar[RING];  // the TMA route's barrier of each slot
  int lo[RING];        // first lane of each slot's window
};

// The ring as one warp runs it. Box c holds the word rows [c ROWS, (c+1)
// ROWS) at the lanes [lo, lo + LANES) (rows and lanes past the bitmap are
// not the walk's to read) and the side words [c BITS, (c+1) BITS) (0 past
// the array); it lives in slot c % RING. Two routes fill a slot: with a
// tensor map, lane 0 issues one TMA tile (and one bulk copy of the side
// words) on the slot's mbarrier, which every lane then waits on; without
// one (rows not 16-byte multiples, or narrower than a box), every lane
// issues its share of 4-byte cp.async copies as one group and waits on its
// own groups, and a __syncwarp shows the box to every lane.
template <int ROWS, int LANES, int RING, int BITS>
struct Stage {
  using Ring = BoxRing<ROWS, LANES, RING, BITS>;
  Ring& ring;
  const CUtensorMap* map;  // over the whole bitmap, or null: cp.async
  const unsigned* base;    // word row 0 of the walk's bitmap
  const unsigned* side;
  int row0, nrows, V, nside, lane;
  int cb = -1;  // the current box (-1: none staged)
  const unsigned* cur = nullptr;
  const unsigned* cur_bits = nullptr;
  int cur_lo = 0;
  unsigned parity = 0, pending = 0;  // TMA: each slot's barrier phase, fills in flight

  __device__ Stage(Ring& r, const CUtensorMap* m, const unsigned* dirs, const unsigned* s,
                   int r0, int nr, int v, int ns, int ln)
      : ring(r), map(m), base(dirs + (size_t)r0 * v), side(s), row0(r0), nrows(nr), V(v),
        nside(ns), lane(ln) {
    if (map && lane == 0) {
      for (int q = 0; q < RING; ++q) init_barrier(&ring.bar[q]);
      fence_barrier_init();
    }
    __syncwarp();
  }

  __device__ void issue(int c, int lo) {
    const int s = c % RING;
    ring.lo[s] = lo;
    if (map) {
      if (lane == 0) {
        fence_async_proxy();  // the warp's reads of the slot before the copy's writes
        expect_bytes(&ring.bar[s], (ROWS * LANES + BITS) * 4);
        copy_tile(ring.code[s], map, lo, row0 + c * ROWS, &ring.bar[s]);
        if (BITS > 0) copy_bulk(ring.bits[s], side + c * BITS, BITS * 4, &ring.bar[s]);
      }
      pending |= 1u << s;
      return;
    }
    const int rows = min(ROWS, nrows - c * ROWS);
    const int width = min(LANES, V - lo);
    const unsigned* src = base + (size_t)c * ROWS * V + lo;
    unsigned* dst = ring.code[s];
    for (int rr = 0; rr < rows; ++rr) {
      for (int x = lane; x < width; x += 32) copy4_async(dst + rr * LANES + x, src + (size_t)rr * V + x);
    }
    if (BITS > 0 && lane < BITS) {
      const int g = c * BITS + lane;
      if (g < nside) {
        copy4_async(&ring.bits[s][lane], side + g);
      } else {
        ring.bits[s][lane] = 0;
      }
    }
    commit_copies();
  }

  // TMA: waits until slot s's fill has landed.
  __device__ void land(int s) {
    if (!(pending >> s & 1u)) return;
    while (!barrier_passed(&ring.bar[s], parity >> s & 1u)) {
    }
    parity ^= 1u << s;
    pending &= ~(1u << s);
  }

  // Waits for every fill in flight.
  __device__ void drain() {
    if (map) {
      for (int q = 0; q < RING; ++q) land(q);
    } else {
      wait_copies<0>();
    }
    __syncwarp();
  }

  __device__ void make_current(int c) {
    cb = c;
    cur = ring.code[c % RING];
    cur_bits = ring.bits[c % RING];
    cur_lo = ring.lo[c % RING];
  }

  // Stages the box of word row r. The next box down was prefetched: wait
  // for it and prefetch the box RING - 1 below it into the slot just left.
  // Any other box (the first, or a jump) drains the ring and starts it
  // again there. place(c) gives box c's first lane from the walk's state; it
  // runs after make_current for every box but the current one.
  template <class Place>
  __device__ void to_row(int r, Place place) {
    const int c = r / ROWS;
    if (c == cb) return;
    if (cb >= 0 && c == cb - 1) {
      if (map) {
        land(c % RING);
      } else {
        wait_copies<RING - 2>();
      }
      __syncwarp();
      make_current(c);
      const int nc = c - (RING - 1);
      if (nc >= 0) {
        issue(nc, place(nc));
      } else if (!map) {
        commit_copies();
      }
      return;
    }
    drain();
    issue(c, place(c));
    drain();
    make_current(c);
    for (int q = 1; q < RING; ++q) {
      if (c - q >= 0) {
        issue(c - q, place(c - q));
      } else if (!map) {
        commit_copies();
      }
    }
  }

  __device__ bool holds(int x) const { return x >= cur_lo && x < cur_lo + LANES; }

  // The walk left the current box's lanes: load the box again at `lo`.
  __device__ void reload(int lo) {
    __syncwarp();
    issue(cb, lo);
    if (map) {
      land(cb % RING);
    } else {
      wait_copies<0>();
    }
    __syncwarp();
    make_current(cb);
  }

  __device__ unsigned word(int r, int x) const {
    return cur[(r - cb * ROWS) * LANES + (x - cur_lo)];
  }
};

// Packs n codes `code` (n <= 16) after the pos moves already packed and
// stores each word as it fills. Every lane holds the same word and stores
// it (one transaction): a store by lane 0 alone splits the warp each time.
__device__ __forceinline__ void append_moves(unsigned code, int n, int& pos, unsigned& acc,
                                             unsigned* out) {
  const int sp = pos & 15;
  const unsigned rep = (code * 0x55555555u) & (n >= 16 ? ~0u : (1u << (2 * n)) - 1u);
  acc |= rep << (2 * sp);
  if (sp + n >= 16) {
    out[pos >> 4] = acc;
    acc = sp ? rep >> (2 * (16 - sp)) : 0u;
  }
  pos += n;
}

// The diag16 chase of one walk on one warp (K2 and K4), through the staged
// ring: from the walk-local cell (li, j) over the word rows [koff, koff +
// KW) of the (KWT, V) bitmap at the lanes from loff on, its moves to out.
// EXITS adds K2's block exits at the block origin (i0, j0); without them
// (K4: full-width bitmaps) i0 = j0 = 0 and the code is K4's as it was.
// Returns (pos, li, j, done, exited, oob) in w.
struct Walk {
  int pos, li, j, done, exited, oob;
};

using DiagStage = Stage<DIAG_ROWS, DIAG_LANES, DIAG_RING, 0>;

template <bool EXITS>
__device__ __forceinline__ void diag_chase(DiagStage::Ring& ring, const CUtensorMap* map,
                                           const unsigned* dirs, unsigned* out, int KW, int KWT,
                                           int V, int koff, int loff, int i0, int j0,
                                           int max_steps, Walk& w) {
  DiagStage st(ring, map, dirs, nullptr, koff, min(KW, KWT - koff), V, 0, (int)threadIdx.x);
  int li = w.li, j = w.j, pos = 0, done = 0, exited = 0, oob = 0;
  unsigned acc = 0;
  while (!done && !exited && pos < max_steps) {
    const int k = li + j;
    const int r = k >> 4;
    const int lane = loff + li;
    if (li < 0 || lane >= V || k < 0 || r >= KW || koff + r >= KWT) {
      oob = 1;
      break;
    }
    // Box c's lanes: from the lowest the path can reach in it (li falls at
    // most as fast as k) up to this one.
    auto place = [&](int c) { return (loff + max(0, li - (k - 16 * DIAG_ROWS * c))) & ~3; };
    st.to_row(r, place);
    if (!st.holds(lane)) st.reload(place(st.cb));
    // The chase through box cb: from a cell with li, j >= 0 the walk's li
    // and k only fall, so the window holds every lane it reaches in the box
    // and only leaving the box's rows is tested. (From j < 0 a move can
    // raise k: one move at a time.)
    const unsigned* box = st.cur;
    const int base = loff - st.cur_lo - st.cb * DIAG_ROWS * DIAG_LANES;
    const int kmin = 16 * DIAG_ROWS * st.cb;
    const bool once = j < 0;
    for (;;) {
      // A run of SUB codes reads the lanes li, li-1, ..., li-7 of this word
      // row at the fields p, p-2, ..., p-14: the eight loads go out together
      // and up to eight moves are taken at once. A run of INS codes keeps
      // the lane and the word: it decodes from the register copy.
      const int kk = li + j;
      const int p = kk & 15;
      const int at = (kk >> 4) * DIAG_LANES + li + base;
      const int tmax = min(p >> 1, li);  // SUB moves the word row and lanes allow (<= 7)
      const unsigned w0 = box[at];
      const unsigned c0 = (w0 >> (2 * p)) & 3u;
      unsigned subs = c0 == DIR_SUB;
#pragma unroll
      for (int t = 1; t < 8; ++t) {
        const unsigned wt = box[at - min(t, tmax)];
        subs |= (unsigned)(((wt >> ((2 * p - 4 * t) & 31)) & 3u) == DIR_SUB) << t;
      }
      const int sub_run = min(__ffs(~(subs & ((2u << tmax) - 1u))) - 1, j);
      const int ins_run = c0 == DIR_INS
          ? min(__clz((w0 ^ 0x55555555u) << (2 * (15 - p))) >> 1, min(p + 1, j)) : 0;
      const unsigned code = sub_run > 0 ? DIR_SUB : c0;
      const int n = min(max(max(sub_run, ins_run), 1), max_steps - pos);
      if (EXITS) {
        // K2's one-move rules on the step's last move. Only a move off lane
        // 0 (i0 > 0) or onto column 0 (j0 > 0) exits, and a run ends on
        // such a move at the latest (its caps li + 1 and j), so no exit
        // falls inside a run.
        const int ig = max(i0 + li - (code == DIR_INS ? 0 : n), 0);
        const int jn = max(j - (code == DIR_DEL ? 0 : n), 0);
        if (code != DIR_STOP) append_moves(code, n, pos, acc, out);
        if (code == DIR_STOP || (ig == 0 && jn == 0 && j0 == 0)) {
          done = 1;
        } else if (ig < i0) {
          exited = 1;
        } else if (jn == 0 && j0 > 0) {
          exited = 2;
        }
        li = max(ig - i0, 0);
        j = jn;
        if (done || exited) break;
      } else {
        li = max(li - (code == DIR_INS ? 0 : n), 0);
        j = max(j - (code == DIR_DEL ? 0 : n), 0);
        if (code != DIR_STOP) append_moves(code, n, pos, acc, out);
        if (code == DIR_STOP || (li == 0 && j == 0)) {
          done = 1;
          break;
        }
      }
      if (pos >= max_steps || li + j < kmin || once) break;
    }
  }
  st.drain();
  if (threadIdx.x == 0 && (pos & 15)) out[pos >> 4] = acc;
  w = Walk{pos, li, j, done, exited, oob};
}

// K2: one walk, one warp, over the (KW, V) bitmap `dirs` (block origin i0,
// j0). out[0 .. 5] = meta, its moves from out[META_SLOTS] on (the wrapper
// reads both in one copy). tma = the boxes come by TMA over `map` (else by 4-byte
// cp.async copies).
__global__ void __launch_bounds__(32)
    walk_kernel(const unsigned* __restrict__ dirs, int* __restrict__ out, int KW, int V, int li,
                int j, int i0, int j0, int max_steps, int tma,
                const __grid_constant__ CUtensorMap map) {
  __shared__ __align__(128) DiagStage::Ring ring;
  Walk w{0, li, j, 0, 0, 0};
  diag_chase<true>(ring, tma ? &map : nullptr, dirs,
                   reinterpret_cast<unsigned*>(out + META_SLOTS), KW, KW, V, 0, 0, i0, j0,
                   max_steps, w);
  if (threadIdx.x != 0) return;
  out[0] = w.pos;
  out[1] = w.li;
  out[2] = w.j;
  out[3] = w.done;
  out[4] = w.exited;
  out[5] = w.oob;
}

// K4: walk w = blockIdx.x, one warp. starts[4w .. 4w+3] = (start_li,
// start_j, koff, loff) of walk w; its moves go to words[w*NW ..], its meta
// to meta[5w ..] = (pos, li, j, done, oob). tma as K2's.
__global__ void __launch_bounds__(32)
    walk_many_kernel(const unsigned* __restrict__ dirs, const int* __restrict__ starts,
                     unsigned* __restrict__ words, int* __restrict__ meta, int KW, int KWT,
                     int V, int NW, int max_steps, int tma,
                     const __grid_constant__ CUtensorMap map) {
  __shared__ __align__(128) DiagStage::Ring ring;
  const int b = blockIdx.x;
  Walk w{0, starts[4 * b], starts[4 * b + 1], 0, 0, 0};
  diag_chase<false>(ring, tma ? &map : nullptr, dirs, words + (size_t)b * NW, KW, KWT, V,
                    starts[4 * b + 2], starts[4 * b + 3], 0, 0, max_steps, w);
  if (threadIdx.x != 0) return;
  int* mt = meta + 5 * b;
  mt[0] = w.pos;
  mt[1] = w.li;
  mt[2] = w.j;
  mt[3] = w.done;
  mt[4] = w.oob;
}

// K11: walk w = blockIdx.x, one warp. starts[4w .. 4w+3] = (i, j, off, koff)
// of walk w over the (KWT, V) words, its bitmap the rows [koff, koff + KW);
// slides holds delta(0 .. ND-1) as bits, delta(q) at bit q % 32 of word q /
// 32, 16-byte aligned and zero past ND up to the last box's words. Its moves
// go to words[w*NW ..], its meta to meta[6w ..] = (pos, i, j, off, done,
// oob). tma and map as K4's.
__global__ void __launch_bounds__(32)
    walk_banded_kernel(const unsigned* __restrict__ dirs, const unsigned* __restrict__ slides,
                       const int* __restrict__ starts, unsigned* __restrict__ words,
                       int* __restrict__ meta, int KW, int V, int KWT, int ND, int NW,
                       int max_steps, int tma, const __grid_constant__ CUtensorMap map) {
  using St = Stage<BAND_ROWS, BAND_LANES, BAND_RING, BAND_BITS>;
  __shared__ __align__(128) St::Ring ring;
  const int w = blockIdx.x;
  const bool writer = threadIdx.x == 0;
  int i = starts[4 * w];
  int j = starts[4 * w + 1];
  int off = starts[4 * w + 2];
  const int koff = starts[4 * w + 3];
  St st(ring, tma ? &map : nullptr, dirs, slides, koff, min(KW, KWT - koff), V, (ND + 31) >> 5,
        (int)threadIdx.x);
  unsigned* out = words + (size_t)w * NW;
  int pos = 0, done = i == 0 && j == 0, oob = 0;
  unsigned acc = 0;
  while (!done && pos < max_steps) {
    if (i == 0) {  // row 0: INS to the origin, 16 a step
      const int n = min(min(j, 16), max_steps - pos);
      append_moves(DIR_INS, n, pos, acc, out);
      j -= n;
      done = j == 0;
      continue;
    }
    const int r = (i - 1) >> 4;
    const int v = j - off - 1;
    // Box c's window: its top BAND_ABOVE lanes above the lane where the
    // diagonal from (i, v) enters it, at the current box's slope.
    auto place = [&](int c) {
      const int d = max(0, i - 16 * BAND_ROWS * (c + 1));
      int slope = 0;
      if (d > 0) {
        for (int q = 0; q < BAND_BITS; ++q) slope += __popc(st.cur_bits[q]);
      }
      const int top = min(v - d + d * slope / (16 * BAND_ROWS) + BAND_ABOVE + 1, V);
      return max(0, top - (BAND_LANES - 4)) & ~3;
    };
    st.to_row(r, place);
    const unsigned* bits = st.cur_bits - st.cb * BAND_BITS;  // slide words by row / 32
    if (j == 0) {  // column 0: DEL, undoing the row's slide
      off -= (int)((bits[(i - 1) >> 5] >> ((i - 1) & 31)) & 1u);
      --i;
      append_moves(DIR_DEL, 1, pos, acc, out);
      done = i == 0;
      continue;
    }
    if (v < 0 || v >= V || r >= KW || koff + r >= KWT || i > ND) {
      oob = 1;
      break;
    }
    if (!st.holds(v)) st.reload(place(st.cb));
    // The chase through box cb while the walk stays in its rows and lanes
    // (and in the band); anything else goes back to the tests above.
    const unsigned* box = st.cur;
    const int base = -st.cb * BAND_ROWS * BAND_LANES - st.cur_lo;
    const int rmin = st.cb * BAND_ROWS;
    const unsigned span = (unsigned)min(BAND_LANES, V - st.cur_lo);
    int rr = r, vv = v;
    for (;;) {
      const int p = (i - 1) & 15;
      const unsigned cw = box[rr * BAND_LANES + vv + base];  // the word, kept for its run
      const unsigned cs = bits[(i - 1) >> 5];
      const unsigned code = (cw >> (2 * p)) & 3u;
      if (code == DIR_STOP) {
        oob = 1;
        break;
      }
      // SUB codes at rows i, i-1, ... are the fields p, p-1, ... of this
      // word while the slides delta(i-1), delta(i-2), ... are 1.
      const int subs = min(__clz(cw << (2 * (15 - p))) >> 1, p + 1);
      const int slid = __clz(~(cs << (31 - ((i - 1) & 31))));
      const int n = code == DIR_SUB ? min(min(subs, slid + 1), min(j, max_steps - pos)) : 1;
      if (code != DIR_INS) {
        // entering rows i-1 .. i-n undoes their slides: the first n-1 are 1
        off -= (n - 1) + (int)((cs >> ((i - n) & 31)) & 1u);
        i -= n;
      }
      if (code != DIR_DEL) j -= n;
      append_moves(code, n, pos, acc, out);
      if (i == 0 || j == 0 || pos >= max_steps) break;
      rr = (i - 1) >> 4;
      vv = j - off - 1;
      if (rr < rmin || (unsigned)(vv - st.cur_lo) >= span) break;
    }
    if (oob) break;
    done = i == 0 && j == 0;
  }
  st.drain();
  if (!writer) return;
  if (pos & 15) out[pos >> 4] = acc;
  int* mt = meta + 6 * w;
  mt[0] = pos;
  mt[1] = i;
  mt[2] = j;
  mt[3] = off;
  mt[4] = done;
  mt[5] = oob;
}

}  // namespace

// A TMA tensor map over the (rows, V) int32 bitmap with (lanes, box_rows)
// tiles, for rows of 16-byte multiples (V % 4 == 0, a 16-byte aligned
// bitmap) at least one tile wide. Returns false where it cannot be made;
// the kernels then copy the boxes with 4-byte cp.async.
static bool bitmap_map(CUtensorMap* map, const void* dirs, int rows, int V, int lanes,
                       int box_rows) {
  if (V % 4 || reinterpret_cast<uintptr_t>(dirs) % 16 || V < lanes) return false;
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess) {
      fn = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)V, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)V * 4};
  const cuuint32_t box[2] = {(cuuint32_t)lanes, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(dirs), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

extern "C" int walk_banded_launch(const void* dirs, const void* slides,
                                  const void* starts, void* words, void* meta,
                                  int W, int KW, int V, int KWT, int ND, int NW,
                                  int max_steps, void* stream) {
  if (W < 1 || KW < 1 || V < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap map{};
  const int tma = bitmap_map(&map, dirs, KWT, V, BAND_LANES, BAND_ROWS);
  walk_banded_kernel<<<W, 32, 0, (cudaStream_t)stream>>>(
      (const unsigned*)dirs, (const unsigned*)slides, (const int*)starts,
      (unsigned*)words, (int*)meta, KW, V, KWT, ND, NW, max_steps, tma, map);
  return (int)cudaGetLastError();
}

// K2: out = int32[META_SLOTS + ceil(max_steps / 16)], meta then the moves.
extern "C" int traceback_walk_launch(const void* dirs, void* out, int KW, int V, int start_li,
                                     int start_j, int i0, int j0, int max_steps,
                                     void* stream) {
  if (KW < 1 || V < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap map{};
  const int tma = bitmap_map(&map, dirs, KW, V, DIAG_LANES, DIAG_ROWS);
  walk_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const unsigned*)dirs, (int*)out, KW, V,
                                                  start_li, start_j, i0, j0, max_steps, tma, map);
  return (int)cudaGetLastError();
}

extern "C" int walk_many_launch(const void* dirs, const void* starts,
                                void* words, void* meta, int W, int KW,
                                int KWT, int V, int NW, int max_steps,
                                void* stream) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap map{};
  const int tma = bitmap_map(&map, dirs, KWT, V, DIAG_LANES, DIAG_ROWS);
  walk_many_kernel<<<W, 32, 0, (cudaStream_t)stream>>>(
      (const unsigned*)dirs, (const int*)starts, (unsigned*)words, (int*)meta,
      KW, KWT, V, NW, max_steps, tma, map);
  return (int)cudaGetLastError();
}

extern "C" int walk_rows16_launch(const void* codes, const void* starts,
                                  void* words, void* meta, int B, int L1,
                                  int W, int NW, int max_steps, int h, int g,
                                  int is_local, void* stream) {
  if (B < 1 || L1 < 1 || W < 1) return (int)cudaErrorInvalidValue;
  constexpr int threads = 128;
  walk_rows16_kernel<<<(B + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const unsigned*)codes, (const int*)starts, (unsigned*)words,
      (int*)meta, B, L1, W, NW, max_steps, h, g, is_local);
  return (int)cudaGetLastError();
}
