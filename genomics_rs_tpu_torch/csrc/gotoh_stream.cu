// Batched Gotoh fill for Hopper (sm_90a), one thread block per pair, bound
// by ctypes.
//
// Replaces: genomics_rs_tpu/ops/gotoh_stream.py, _stream_call (body
// _kernel_stream), behind gotoh_scores_stream and gotoh_stream_fill_dirs.
// Same contract for every pair p of a padded batch (s1 rows of Lm chars,
// s2 rows of Ln chars, true lengths m_p <= Lm and n_p <= Ln): the affine-gap
// (Gotoh) table over rows 0..m_p and columns 0..n_p with the global
// boundary (corner 0, I(0, j) = h + j*g, D(i, 0) = h + i*g, the rest -inf),
// global or local (reference zero floor inside every predecessor max),
// classic or kimura scoring. Outputs:
//   res[3p .. 3p+2]  global: (score at (m_p, n_p), m_p, n_p);
//                    local: the keep-last row-major argmax (v, i, j) over
//                    the pair's true cells (larger v, then larger i, then
//                    that row's larger j)
//   dirs (optional)  the pair's 2-bit codes packed like K1's (S > I > D >
//                    STOP), in its own slice of a (B, KW, V) array:
//                    code(i, j) = (dirs[(p*KW + (i+j)/16) * V + i]
//                                  >> 2*((i+j)%16)) & 3
//
// Design. The TPU kernel lays every pair end to end along one V-lane
// vector and re-injects column 0 at each seam, so its lanes do not idle
// through each pair's diagonal ramp. That answers a TPU constraint (one
// core, one wide vector). Hopper has 132 SMs and K1 (gotoh_rowblock.cu)
// already fills one table per SM, so here grid = B: block p runs K1's
// skewed row-strip wavefront over pair p alone, rows 0..m_p and columns
// 0..n_p, with its own global scratch rows. No padded cell is computed, so
// the local argmax needs no padding mask and every pair needs no seam, probe
// chunk or drift guard: the wrapper has no fallback.
//
// What bounds it: as K1, one block is a dependency chain along both axes,
// latency-bound on its SM: ceil((m+1)/T) strips of n + T steps, each step a
// handful of integer max/add ops plus one block barrier. A batch runs
// min(B, 132) blocks at once, so a bucket of up to 132 equal pairs takes
// about one pair's time. Device memory traffic is small (one char load per
// cell, 2 bits of dirs per cell).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 30);
constexpr int INT_MIN_V = -2147483647 - 1;
constexpr int MAX_T = 1024;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

template <bool LOCAL>
__global__ void __launch_bounds__(MAX_T, 1)
stream_kernel(const int* __restrict__ s1c, const int* __restrict__ s2c,
              const int* __restrict__ ms, const int* __restrict__ ns,
              unsigned* __restrict__ dirs, int* __restrict__ res,
              int* __restrict__ scratch, int Lm, int Ln, int V, int KW,
              int sm, int sx, int st, int kimura, int g, int h) {
  __shared__ int sA[2][MAX_T];
  __shared__ int sM[2][MAX_T];
  __shared__ int rv[MAX_T], ri[MAX_T], rj[MAX_T];

  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int m = ms[p];
  const int n = ns[p];
  const int hg = h + g;
  const int W = n + 1;  // scratch row width
  const int* a = s1c + (size_t)p * Lm;
  const int* b = s2c + (size_t)p * Ln;
  unsigned* dp = dirs == nullptr ? nullptr : dirs + (size_t)p * KW * V;
  int* scr = scratch + (size_t)p * 4 * (Ln + 1);
  const int rows = m + 1;
  const int nstrips = (rows + T - 1) / T;

  int bv = INT_MIN_V, bi = -1, bj = 0;  // this thread's keep-last best
  int cur = 0;

  for (int s = 0; s < nstrips; ++s) {
    const int i = s * T + t;
    const bool has_row = i <= m;
    const int in_strip = min(T, rows - s * T);
    const int nsteps = n + in_strip;
    const int* up = scr + ((s + 1) & 1) * 2 * W;  // written by strip s-1
    int* down = scr + (s & 1) * 2 * W;
    const bool writes_down = (t == T - 1) && (s + 1 < nstrips);

    const int c1 = (has_row && i >= 1) ? a[i - 1] : 0;
    int c2 = n > 0 ? b[0] : 0;  // char of column j+1, prefetched
    int Il = 0, Pl = 0, diagM = 0;
    unsigned acc = 0;

    for (int q = 0; q < nsteps; ++q) {
      const int j = q - t;
      if (has_row && j >= 0 && j <= n) {
        int I, S, D;
        if (i == 0) {
          I = j == 0 ? 0 : h + j * g;
          S = j == 0 ? 0 : NEG_INF;
          D = S;
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
            I = NEG_INF;
            S = NEG_INF;
            D = h + i * g;
          } else {
            I = imax(Il + g, Pl + hg);
            if (LOCAL) I = imax(I, 0);
            D = upA;
            int sub;
            if (c1 == c2) sub = sm;
            else if (kimura && (c1 ^ c2) == 2) sub = st;
            else sub = sx;
            S = sub + diagM;
            c2 = j < n ? b[j] : 0;
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
        if (dp != nullptr) {
          // Tested against the pre-floor max M0, as in K1: ptxas (CUDA
          // 12.9, -O1 and up) miscompiles `M == D` after the fused
          // max-with-zero in local mode (see gotoh_rowblock.cu).
          const unsigned code = (LOCAL && M0 < 0) ? 3u
                                : (M0 == S)         ? 0u
                                : (M0 == I)         ? 1u
                                : (M0 == D)         ? 2u
                                                    : 3u;
          const int k = i + j;
          const int sp = k & 15;
          if (j == 0 || sp == 0) acc = 0;
          acc |= code << (2 * sp);
          if (sp == 15 || j == n) dp[(size_t)(k >> 4) * V + i] = acc;
        }
        if (LOCAL) {
          if (M >= bv) {
            bv = M;
            bi = i;
            bj = j;
          }
        } else if (i == m && j == n) {
          res[3 * p] = M;
        }
      }
      __syncthreads();
      cur ^= 1;
    }
  }

  // Merge the per-thread bests: max v, then max i (then that row's j).
  // Thread 0 owns row 0, whose cells are all >= 0, so the merge always
  // finds a true cell.
  if (LOCAL) {
    rv[t] = bv;
    ri[t] = bi;
    rj[t] = bj;
  }
  __syncthreads();
  if (t == 0) {
    if (LOCAL) {
      int v = INT_MIN_V, ii = -1, jj = 0;
      for (int u = 0; u < T; ++u) {
        if (rv[u] > v || (rv[u] == v && ri[u] > ii)) {
          v = rv[u];
          ii = ri[u];
          jj = rj[u];
        }
      }
      res[3 * p] = v;
      res[3 * p + 1] = ii;
      res[3 * p + 2] = jj;
    } else {
      res[3 * p + 1] = m;
      res[3 * p + 2] = n;
    }
  }
}

}  // namespace

extern "C" int gotoh_stream_launch(
    const void* s1c, const void* s2c, const void* ms, const void* ns,
    void* dirs, void* res, void* scratch, int B, int Lm, int Ln, int V,
    int KW, int sm, int sx, int st, int kimura, int g, int h, int is_local,
    int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (threads < 1 || threads > MAX_T || B < 1) return (int)cudaErrorInvalidValue;
  if (is_local) {
    stream_kernel<true><<<B, threads, 0, s>>>(
        (const int*)s1c, (const int*)s2c, (const int*)ms, (const int*)ns,
        (unsigned*)dirs, (int*)res, (int*)scratch, Lm, Ln, V, KW, sm, sx, st,
        kimura, g, h);
  } else {
    stream_kernel<false><<<B, threads, 0, s>>>(
        (const int*)s1c, (const int*)s2c, (const int*)ms, (const int*)ns,
        (unsigned*)dirs, (int*)res, (int*)scratch, Lm, Ln, V, KW, sm, sx, st,
        kimura, g, h);
  }
  return (int)cudaGetLastError();
}
