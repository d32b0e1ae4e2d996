// Row-block Gotoh fill for Hopper (sm_90a) as a multi-SM strip pipeline,
// bound by ctypes.
//
// Replaces: genomics_rs_tpu/ops/gotoh_rowblock.py, gotoh_rowblock_pallas
// (body _kernel_rows; K1), and genomics_rs_tpu/ops/gotoh_pallas.py,
// gotoh_tile_pallas (body _kernel_tile at :157, pallas_call at :599; K5).
// Same contract: fill rows i0+1..i0+R of an affine-gap (Gotoh) table over
// block columns 0..B, given the row-i0 boundary `top` (3, B+1) and either
// the computed col-0 boundary or a streamed `left` (3, R); global or local
// (reference zero floor inside every predecessor max), classic or kimura
// scoring. K5 is the same fill at a global column offset j0 (block column
// j is table column j0 + j): the (m, n) probe and the argmax are taken at
// j0 + j, the argmax over columns up to n, and the argmax is tracked in
// both modes, as the tile oracle (ops/gotoh_tile.tile_fill) does. K5 is
// the TILE instantiation; K1's (tile = 0 at launch) compiles without it,
// so K1 pays nothing for K5. Outputs:
//   res[0]      score at (m, n) when that cell is in the block, else INT_MIN
//   res[1..3]   keep-last row-major argmax (v, i, j), global coords: local
//               mode, or both modes for K5; with no true cell (m < i0) it is
//               (INT_MIN, i0+V-1, max(-1, Kp-V)) for K1, Kp = round_up(R+B+1,
//               256) the diagonals of dirs, as the TPU row-block kernel's
//               lane merge gives, and (INT_MIN, i0+R, j0+B) for K5, as
//               tile_fill's does; (INT_MIN, 0, 0) in K1's global mode
//   dirs        2-bit codes packed 16 per int32 along the anti-diagonal:
//               code(li, j) = (dirs[(li+j)/16 * V + li] >> 2*((li+j)%16)) & 3
//   bottom      I/S/D of row i0+R over columns 0..B, as (3, B+1)
//   right       I/S/D of column B over rows i0+1..i0+R, as (3, R) (K5)
//   cols        I/S/D at (i0+v, c*V) in cols[(c*3 + x) * V + v]
//   err         the launch's error word (work[5]): set when a pipeline wait
//               saw nothing of the launch move for its bound (spin_ns;
//               a hang), and then no other output holds
//
// Design. The block's rows are cut into strips of T rows, and each strip
// is one thread block's work, so one fill runs on many SMs at once. The
// strip itself is the skewed wavefront of gotoh_stream_body.cuh's
// strip_sweep: thread t owns row li = s*T + t, steps one column a barrier,
// takes A and M of the row above from thread t-1 through shared memory,
// and keeps its own row's I and max(S, D) in registers. Around it:
//   - Order: persistent blocks, as many as the SMs hold (the host sizes the
//     grid from the occupancy), take strips from a ticket counter in strip
//     order, so a block only ever waits on a strip that holds an earlier
//     ticket and is running: no deadlock at any residency, also with other
//     launches (K5's tiles on other streams) beside it on the card.
//   - Hand-off: the strip's last thread stores its row's A and M in a ring
//     slot and publishes the column count with release semantics every
//     PIPE_CHUNK columns; the next strip's warp 0 polls with acquire
//     semantics once a chunk and stages the chunk through L2 (__ldcg).
//     A slot is written again once the strip that read it has released it.
//   - Boundaries and outputs are policies of the shared sweep (BlockEdge,
//     BlockOut below): row 0 is `top`, column 0 is `left` or D = h +
//     (i0+li)*g, and every output is written by the thread that owns the
//     cell. A thread visits k = li + j in increasing order, so it packs 16
//     consecutive diagonals of its own row into exactly the word
//     dirs[k/16][li] and no other thread writes that word; all threads of
//     a step share k, so the flushes of one step are coalesced.
//   - The argmax: each strip merges its threads' bests, and the block's
//     last strip to finish (an atomic count) merges the strips' bests by
//     (v, i, j), keep-last, and writes res[1..3] (and res[0] when the
//     probe is outside the block).
//   - No hang and no host synchronisation: a strip bumps a heartbeat with
//     each chunk it publishes, and a wait that sees neither its flag nor
//     the heartbeat move for spin_ns ns (10 s by default) sets the error
//     word, and every block leaves. A long wait behind strips that still
//     sweep (a slot waits for its reader, which may first wait for its own
//     slot: about a sweep of B columns a link) is no fault: a wait only
//     ever waits on a strip with a successor, which publishes, and the
//     strip at the head of a chain is sweeping. The wrapper returns the
//     word with the result, and the callers raise where they read it.
//
// What bounds it: integer issue (12 ops a cell global, 19 local, 9 more
// with dirs) against, per strip, a dependent step of a few integer ops, a
// shared-memory hand-off and one barrier over T threads; the pipeline adds
// one L2 poll and one chunk copy every PIPE_CHUNK columns and a lag of
// T + PIPE_CHUNK columns a strip, so a block of R rows and B columns takes
// about B + (R+1)(1 + PIPE_CHUNK/T) steps when every strip has an SM.
// Device memory traffic is 2 bits of dirs a cell, one character a cell
// and 8 bytes a boundary cell.

#include "gotoh_stream_body.cuh"

namespace {

// K1's boundaries: row 0 is the given `top`; column 0 the streamed `left`,
// or the table's own (D = h + (i0 + li)*g, I = S = -inf).
struct BlockEdge {
  const int* top_row;   // (3, W)
  const int* left_col;  // (3, R) or null
  int W, R, i0;

  __device__ __forceinline__ void top(int j, int, int, int& I, int& S, int& D) const {
    I = __ldg(top_row + j);
    S = __ldg(top_row + W + j);
    D = __ldg(top_row + 2 * W + j);
  }
  __device__ __forceinline__ void left(int li, int g, int h, int& I, int& S, int& D) const {
    if (left_col != nullptr) {
      I = __ldg(left_col + li - 1);
      S = __ldg(left_col + R + li - 1);
      D = __ldg(left_col + 2 * R + li - 1);
    } else {
      I = NEG_INF;
      S = NEG_INF;
      D = h + (i0 + li) * g;
    }
  }
};

// K1's outputs at one cell (li, j) of the block, and this thread's
// keep-last best over the true cells of its row (li <= m - i0, j0 + j <= n).
template <bool LOCAL, bool TILE>
struct BlockOut {
  int* bottom;
  int* cols;
  int* right;
  int* res;
  int R, B, V, mi0, nj0, i0, j0;
  int next_col = 0;  // this row's next checkpointed column (a multiple of V)
  int bv = INT_MIN_V, bi = -1, bj = 0;

  __device__ __forceinline__ void cell(int li, int j, int I, int S, int D, int M) {
    const int W = B + 1;
    if (bottom != nullptr && li == R) {
      bottom[j] = I;
      bottom[W + j] = S;
      bottom[2 * W + j] = D;
    }
    if (TILE && right != nullptr && j == B && li >= 1) {
      right[li - 1] = I;
      right[R + li - 1] = S;
      right[2 * R + li - 1] = D;
    }
    if (cols != nullptr && j == next_col) {
      int* cp = cols + (size_t)(j / V) * 3 * V + li;
      cp[0] = I;
      cp[V] = S;
      cp[2 * V] = D;
      next_col += V;
    }
    if (li == mi0 && j == nj0) res[0] = M;
    if ((LOCAL || TILE) && li <= mi0 && j <= nj0 && M >= bv) {
      bv = M;
      bi = i0 + li;
      bj = TILE ? j0 + j : j;
    }
  }
};

struct BlockArgs {
  unsigned* dirs;
  int* bottom;
  int* cols;
  int* right;
  int R, B, V, m, n, i0, j0, g, h;
  int nstrips, nslots;
  unsigned long long spin_ns;  // the pipeline waits' bound (wait_geq)
};

//: ints of the workspace before its per-strip arrays: res[4], ticket, err,
//: finished, beat.
constexpr int WORK_HEAD = 8;

// The workspace (zeroed by the host): res[0..3], ticket, err, finished,
// beat, progress[nstrips], released[nstrips], best[3 * nstrips]. Strip s reads
// its top row from ring slot (s-1) % nslots and writes its bottom row to
// slot s % nslots once strip s - nslots + 1, the last to read that slot,
// has released it.
template <bool LOCAL, bool TILE>
__global__ void __launch_bounds__(MAX_T)
rowblock_kernel(CharSub sub, BlockEdge edge, BlockArgs a, int* __restrict__ work,
                int* __restrict__ ring) {
  __shared__ int sA[2][MAX_T];
  __shared__ int sM[2][MAX_T];
  __shared__ int rv[MAX_T], ri[MAX_T], rj[MAX_T];
  __shared__ int sUpA[PIPE_CHUNK], sUpM[PIPE_CHUNK];
  __shared__ int s_s, s_abort;
  constexpr bool track = LOCAL || TILE;

  const int t = threadIdx.x;
  const int T = blockDim.x;
  int* res = work;
  int* ticket = work + 4;
  int* err = work + 5;
  int* finished = work + 6;
  int* beat = work + 7;
  int* progress = work + WORK_HEAD;
  int* released = progress + a.nstrips;
  int* best = released + a.nstrips;
  const size_t slot_ints = 2 * (size_t)(a.B + 1);
  const int mi0 = a.m - a.i0;  // block-local row of the probe (may be outside)
  const int nj0 = TILE ? a.n - a.j0 : a.n;  // block-local column of the probe
  int cur = 0;
  for (;;) {
    if (t == 0) {
      const int tk = *(volatile int*)err ? a.nstrips : atomicAdd(ticket, 1);
      s_s = tk < a.nstrips ? tk : -1;
      s_abort = 0;
    }
    __syncthreads();
    const int s = s_s;
    if (s < 0) return;
    const int* up = s > 0 ? ring + (size_t)((s - 1) % a.nslots) * slot_ints : nullptr;
    int* down = s + 1 < a.nstrips ? ring + (size_t)(s % a.nslots) * slot_ints : nullptr;
    if (t == 0 && down != nullptr && s >= a.nslots &&
        !wait_geq(released + s - a.nslots + 1, 1, err, beat, a.spin_ns))
      s_abort = 1;
    __syncthreads();
    if (s_abort) return;

    const StripLinks ln{s > 0 ? progress + s - 1 : nullptr, progress + s, released + s, err,
                        &s_abort, sUpA, sUpM, beat, a.spin_ns};
    BlockOut<LOCAL, TILE> out{a.bottom, a.cols, a.right, res, a.R, a.B, a.V,
                              mi0,      nj0,    a.i0,    a.j0};
    if (!strip_sweep<LOCAL, true>(sub, edge, out, 0, s, a.R, a.B, a.g, a.h, sA, sM, cur, up,
                                  down, down != nullptr && t == T - 1, a.dirs, a.V, ln))
      return;

    int v = INT_MIN_V, ii = -1, jj = 0;
    if (track) block_best(rv, ri, rj, out.bv, out.bi, out.bj, v, ii, jj);
    if (t == 0) {
      if (track) {
        best[3 * s] = v;
        best[3 * s + 1] = ii;
        best[3 * s + 2] = jj;
      }
      __threadfence();
      if (atomicAdd(finished, 1) == a.nstrips - 1) {
        // The block's last strip: merge the strips' bests (a strip with no
        // true cell holds (INT_MIN, -1, 0) and never wins).
        __threadfence();
        int bv = INT_MIN_V;
        int bi = TILE ? a.i0 + a.R : (track ? a.i0 + a.V - 1 : 0);
        int bj = TILE ? a.j0 + a.B : (track ? max(-1, (a.R + a.B + 256) / 256 * 256 - a.V) : 0);
        for (int u = 0; track && u < a.nstrips; ++u) {
          const int uv = __ldcg(best + 3 * u), ui = __ldcg(best + 3 * u + 1),
                    uj = __ldcg(best + 3 * u + 2);
          if (better(uv, ui, uj, bv, bi, bj)) {
            bv = uv;
            bi = ui;
            bj = uj;
          }
        }
        res[1] = bv;
        res[2] = bi;
        res[3] = bj;
        if (mi0 < 0 || mi0 > a.R || nj0 < 0 || nj0 > a.B) res[0] = INT_MIN_V;
      }
    }
    __syncthreads();  // rv/ri/rj and s_s are rewritten by the next strip
  }
}

using Kernel = void (*)(CharSub, BlockEdge, BlockArgs, int*, int*);

Kernel pick(int is_local, int tile) {
  return is_local ? (tile ? &rowblock_kernel<true, true> : &rowblock_kernel<true, false>)
                  : (tile ? &rowblock_kernel<false, true> : &rowblock_kernel<false, false>);
}

}  // namespace

// Blocks of `threads` one SM holds for this instantiation (the host sizes
// the persistent grid and the ring from it); negative on a CUDA error.
extern "C" int gotoh_rowblock_blocks_per_sm(int threads, int is_local, int tile) {
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pick(is_local, tile), threads, 0);
  return e == cudaSuccess ? n : -(int)e;
}

// work: zeroed int32 [WORK_HEAD + 5 * nstrips]; ring: nslots slots of
// 2 * (B + 1) int32. nstrips = ceil((R + 1) / threads); nslots >= 1 when
// nstrips > 1; spin_ns > 0 bounds a wait that sees nothing move.
extern "C" int gotoh_rowblock_launch(
    const void* s1c, const void* s2c, const void* top, const void* left, void* dirs,
    void* bottom, void* cols, void* right, void* work, void* ring, int R, int B, int V, int m,
    int n, int i0, int j0, int tile, int sm, int sx, int st, int kimura, int g, int h,
    int is_local, int threads, int blocks, int nstrips, int nslots, long long spin_ns,
    void* stream) {
  if (threads < 32 || threads > MAX_T || (threads & 31) || blocks < 1 || R < 0 || B < 0 ||
      nstrips != (R + threads) / threads || (nstrips > 1 && nslots < 1) || spin_ns < 1)
    return (int)cudaErrorInvalidValue;
  const CharSub sub{(const int*)s1c, (const int*)s2c, R, B, sm, sx, st, kimura};
  const BlockEdge edge{(const int*)top, (const int*)left, B + 1, R, i0};
  const BlockArgs a{(unsigned*)dirs, (int*)bottom, (int*)cols, (int*)right, R, B, V, m, n,
                    i0, j0, g, h, nstrips, nslots, (unsigned long long)spin_ns};
  pick(is_local, tile)<<<blocks, threads, 0, (cudaStream_t)stream>>>(sub, edge, a, (int*)work,
                                                                      (int*)ring);
  return (int)cudaGetLastError();
}
