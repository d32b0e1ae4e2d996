// Row-block Gotoh fill for Hopper (sm_90a), bound by ctypes.
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
// the TILE instantiation; K1's (tile = 0 at launch) compiles to the
// row-block fill alone, so K1 pays nothing for K5. Outputs:
//   res[0]      score at (m, n) when that cell is in the block, else left
//               as the caller set it (the wrapper sets INT_MIN)
//   res[1..3]   keep-last row-major argmax (v, i, j), global coords: local
//               mode, or both modes for K5
//   dirs        2-bit codes packed 16 per int32 along the anti-diagonal:
//               code(li, j) = (dirs[(li+j)/16 * V + li] >> 2*((li+j)%16)) & 3
//   bottom      I/S/D of row i0+R over columns 0..B, as (3, B+1)
//   right       I/S/D of column B over rows i0+1..i0+R, as (3, R) (K5)
//   cols        I/S/D at (i0+v, c*V) in cols[(c*3 + x) * V + v]
//
// Design. One thread block runs the whole fill. Thread t owns row
// li = s*T + t of strip s; each strip is a skewed wavefront: at step q
// thread t computes (li, j = q - t). It keeps its left neighbour (I and
// max(S, D) of j-1) in registers and takes the cell above (A = the
// open/extend predecessor of D) and the cell up-left (M = the floored
// cell max) from thread t-1 through double-buffered shared memory, one
// __syncthreads() per step. The strip's last row goes to a global
// scratch row that the next strip's thread 0 reads. A thread visits
// k = li + j in increasing order, so it packs 16 consecutive diagonals
// of its own row into exactly the word dirs[k/16][li] and no other
// thread writes that word; all threads of a step share k, so the
// flushes of one step are coalesced.
//
// What bounds it: the recurrence is a dependency chain along both axes,
// so one fill is latency-bound on one SM: (R+1)/T strips, each
// B + T steps long, each step a handful of integer max/add ops plus one
// block barrier. Device memory traffic is small (2 bits per cell of dirs
// plus one char load per cell, prefetched a step ahead). This design
// uses 1 of the 132 SMs; spreading a fill over several SMs (a diagonal
// band of tiles per block, boundaries handed over through global
// memory) is the first performance lead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 30);
constexpr int INT_MIN_V = -2147483647 - 1;
constexpr int MAX_T = 1024;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

template <bool LOCAL, bool TILE>
__global__ void __launch_bounds__(MAX_T, 1)
rowblock_kernel(const int* __restrict__ s1c, const int* __restrict__ s2c,
                const int* __restrict__ top, const int* __restrict__ left,
                unsigned* __restrict__ dirs, int* __restrict__ bottom,
                int* __restrict__ cols, int* __restrict__ right,
                int* __restrict__ res, int* __restrict__ scratch, int R,
                int B, int V, int m, int n, int i0, int j0, int sm,
                int sx, int st, int kimura, int g, int h) {
  __shared__ int sA[2][MAX_T];
  __shared__ int sM[2][MAX_T];
  __shared__ int rv[MAX_T], ri[MAX_T], rj[MAX_T];

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int hg = h + g;
  const int mi0 = m - i0;  // block-local row of the probe (may be outside)
  const int nj0 = TILE ? n - j0 : n;  // block-local column of the probe
  constexpr bool track = LOCAL || TILE;
  const int rows = R + 1;
  const int nstrips = (rows + T - 1) / T;
  const int W = B + 1;  // boundary row width

  int bv = INT_MIN_V, bi = -1, bj = 0;  // this thread's keep-last best
  int cur = 0;

  for (int s = 0; s < nstrips; ++s) {
    const int li = s * T + t;
    const bool has_row = li <= R;
    const int in_strip = min(T, rows - s * T);
    const int nsteps = B + in_strip;
    const int* up = scratch + ((s + 1) & 1) * 2 * W;  // written by strip s-1
    int* down = scratch + (s & 1) * 2 * W;
    const bool writes_down = (t == T - 1) && (s + 1 < nstrips);
    const bool probe_row = has_row && li == mi0;
    const bool best_row = track && has_row && li <= mi0;

    const int c1 = (has_row && li >= 1) ? s1c[li - 1] : 0;
    int c2 = B > 0 ? s2c[0] : 0;  // char of column j+1, prefetched
    int Il = 0, Pl = 0, diagM = 0;
    unsigned acc = 0;

    for (int q = 0; q < nsteps; ++q) {
      const int j = q - t;
      if (has_row && j >= 0 && j <= B) {
        int I, S, D;
        if (li == 0) {
          I = top[j];
          S = top[W + j];
          D = top[2 * W + j];
        } else {
          int upA, upM;
          if (t == 0) {
            upA = up[j];
            upM = up[W + j];
          } else {
            upA = sA[cur ^ 1][t - 1];
            upM = sM[cur ^ 1][t - 1];
          }
          if (j == 0) {
            if (left != nullptr) {
              I = left[li - 1];
              S = left[R + li - 1];
              D = left[2 * R + li - 1];
            } else {
              I = NEG_INF;
              S = NEG_INF;
              D = h + (i0 + li) * g;
            }
          } else {
            I = imax(Il + g, Pl + hg);
            if (LOCAL) I = imax(I, 0);
            D = upA;
            int sub;
            if (c1 == c2) sub = sm;
            else if (kimura && (c1 ^ c2) == 2) sub = st;
            else sub = sx;
            S = sub + diagM;
            c2 = j < B ? s2c[j] : 0;
          }
          diagM = upM;
        }
        const int Q = imax(I, S);
        const int M0 = imax(Q, D);  // the cell max before the local floor
        int M = M0;
        int A = imax(Q + hg, D + g);
        if (LOCAL) {
          M = imax(M, 0);
          A = imax(A, 0);
        }
        Il = I;
        Pl = imax(S, D);
        sA[cur][t] = A;
        sM[cur][t] = M;
        if (writes_down) {
          down[j] = A;
          down[W + j] = M;
        }
        if (dirs != nullptr) {
          // SUB if M == S, else INS if M == I, else DEL if M == D, else
          // STOP. Written against the pre-floor max M0 (equal to M unless
          // the floor lifted M0 < 0 to 0, where no test holds): with the
          // plain `M == D` chain, ptxas (CUDA 12.9, -O1 and up) derives the
          // DEL test from the predicate of the fused max-with-zero
          // (VIMNMX.RELU) and gives STOP where D == M (found on the card
          // against the plain version).
          const unsigned code = (LOCAL && M0 < 0) ? 3u
                                : (M0 == S)         ? 0u
                                : (M0 == I)         ? 1u
                                : (M0 == D)         ? 2u
                                                    : 3u;
          const int k = li + j;
          const int sp = k & 15;
          if (j == 0 || sp == 0) acc = 0;
          acc |= code << (2 * sp);
          if (sp == 15 || j == B) dirs[(size_t)(k >> 4) * V + li] = acc;
        }
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
        if (cols != nullptr && j % V == 0) {
          int* cp = cols + (size_t)(j / V) * 3 * V + li;
          cp[0] = I;
          cp[V] = S;
          cp[2 * V] = D;
        }
        if (probe_row && j == nj0) res[0] = M;
        if (best_row && j <= nj0 && M >= bv) {
          bv = M;
          bi = i0 + li;
          bj = TILE ? j0 + j : j;
        }
      }
      __syncthreads();
      cur ^= 1;
    }
  }

  // Merge the per-thread bests: max v, then max i (then that row's j).
  // Rows with no true cell keep INT_MIN; if every row is empty the result
  // is (INT_MIN, i0+V-1, 0), as the TPU row-block kernel's lane merge
  // gives, or for K5 (INT_MIN, i0+R, j0+B), as tile_fill's does.
  rv[t] = bv;
  ri[t] = bi;
  rj[t] = bj;
  __syncthreads();
  if (t == 0) {
    if (track) {
      int v = INT_MIN_V, i = TILE ? i0 + R : i0 + V - 1, jj = TILE ? j0 + B : 0;
      for (int u = 0; u < T; ++u) {
        if (rv[u] > v || (rv[u] == v && ri[u] > i)) {
          v = rv[u];
          i = ri[u];
          jj = rj[u];
        }
      }
      res[1] = v;
      res[2] = i;
      res[3] = jj;
    } else {
      res[1] = INT_MIN_V;
      res[2] = 0;
      res[3] = 0;
    }
  }
}

}  // namespace

extern "C" int gotoh_rowblock_launch(
    const void* s1c, const void* s2c, const void* top, const void* left,
    void* dirs, void* bottom, void* cols, void* right, void* res,
    void* scratch, int R, int B, int V, int m, int n, int i0, int j0,
    int tile, int sm, int sx, int st, int kimura, int g, int h, int is_local,
    int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (threads < 1 || threads > MAX_T) return (int)cudaErrorInvalidValue;
  auto kernel = is_local
                    ? (tile ? &rowblock_kernel<true, true> : &rowblock_kernel<true, false>)
                    : (tile ? &rowblock_kernel<false, true> : &rowblock_kernel<false, false>);
  kernel<<<1, threads, 0, s>>>(
      (const int*)s1c, (const int*)s2c, (const int*)top, (const int*)left,
      (unsigned*)dirs, (int*)bottom, (int*)cols, (int*)right, (int*)res,
      (int*)scratch, R, B, V, m, n, i0, j0, sm, sx, st, kimura, g, h);
  return (int)cudaGetLastError();
}
