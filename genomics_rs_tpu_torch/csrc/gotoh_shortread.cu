// Short-read batched Gotoh fill for Hopper (sm_90a), one warp per pair,
// bound by ctypes.
//
// Replaces: genomics_rs_tpu/ops/gotoh_shortread.py, gotoh_scores_shortread
// (body _rowscan_body, pallas_call at :316). Same contract for every pair p
// of a padded batch (s1 rows of L1 chars, s2 rows of L2 <= 256 chars, L2 a
// multiple of 16, true lengths 1 <= m_p <= L1 and 1 <= n_p <= L2): the
// affine-gap (Gotoh) table with the global boundary (row 0: I = h + j*g,
// column 0: D = h + i*g, corner 0 at i = 1), global or local (the zero
// floor inside each predecessor max, placed as the TPU kernel places it),
// classic or kimura scoring. Outputs:
//   res[3p .. 3p+2]   global: (score at (m_p, n_p), m_p, n_p);
//                     local: the keep-last-over-rows best per column,
//                     merged by larger value, then larger i, then larger j;
//                     a best <= 0 gives (0, m_p, n_p) (empty alignment)
//   codes (optional)  the rows16 layout: word codes[p, i-1, (j-1)/16] holds
//                     the 2-bit codes (S > I > D > STOP) of the interior
//                     cells (i, 16w+1 .. 16w+16), bits 2*((j-1)%16); rows
//                     1..m_p are written, every column 1..L2 of them
//
// Design. The TPU kernel puts 1024 pairs on the lanes of an (8, 128) pane
// and computes a whole DP row per step, the horizontal gap chain by a
// log2(L2)-round (max,+) prefix over pane rolls. Here one warp owns one
// pair and the row: lane l holds columns 8l+1 .. 8l+8 of I, S and D in
// registers (256 columns per warp), so no DP state lives in shared or
// global memory. Per row: M(i-1, j-1) crosses a lane edge by one
// __shfl_up_sync; the vertical (D) and diagonal (S) terms are per-column
// register math; the horizontal chain I(i, j) = max(I(i, j-1) + g,
// max(S, D)(i, j-1) + h + g) is a serial (max,+) pass over the lane's 8
// columns, then a 5-round warp scan of the lane carries (offset d adds
// d*8*g), then a fix-up pass: the TPU's roll rounds, on the warp. Codes pack
// 8 per lane and two lanes join them into one 16-code word, so a row's
// words are one coalesced store. Each lane keeps its columns' keep-last
// bests; one warp reduction merges them at the end. A block holds 4 warps
// (4 pairs), so ~8k pairs fill the 132 SMs.
//
// What bounds it: one warp's row is a dependency chain of ~8 shuffles and
// the in-lane passes; with enough warps resident the SM issue rate bounds
// it (~12 integer ops per cell, 19 local, +9 with codes). Device memory
// traffic is one char per cell read and 2 bits per cell written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 30);
constexpr int INT_MIN_V = -2147483647 - 1;
constexpr int CPL = 8;     // columns per lane
constexpr int WARPS = 4;   // pairs per block
constexpr int MAX_L2 = 32 * CPL;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

template <bool LOCAL, bool DIRS>
__global__ void __launch_bounds__(WARPS * 32)
shortread_kernel(const int* __restrict__ s1c, const int* __restrict__ s2c,
                 const int* __restrict__ ms, const int* __restrict__ ns,
                 unsigned* __restrict__ codes, int* __restrict__ res, int B,
                 int L1, int L2, int sm, int sx, int st, int kimura, int g,
                 int h) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= B) return;  // p is uniform over the warp: the whole warp leaves
  const int m = ms[p];
  const int n = ns[p];
  const int hg = h + g;
  const int zero = LOCAL ? 0 : NEG_INF;
  const int* a = s1c + (size_t)p * L1;
  const int* b = s2c + (size_t)p * L2;
  const int W = L2 >> 4;
  unsigned* cp = DIRS ? codes + (size_t)p * L1 * W : nullptr;
  const int j0 = lane * CPL + 1;  // column of slot 0

  int c2[CPL], I[CPL], S[CPL], D[CPL], bv[CPL], bi[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int j = j0 + t;
    c2[t] = j <= L2 ? b[j - 1] : -1;  // past L2: never read back
    I[t] = h + j * g;                  // row 0
    S[t] = NEG_INF;
    D[t] = NEG_INF;
    bv[t] = INT_MIN_V;
    bi[t] = 0;
  }
  int fin = INT_MIN_V;

  int c1 = a[0];
  for (int i = 1; i <= m; ++i) {
    const int c1_next = i < m ? a[i] : 0;

    // M(i-1, j) per column, and M(i-1, j-1) from the lane to the left;
    // lane 0's left neighbour is column 0 (corner 0 at i = 1).
    int Mp[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) Mp[t] = imax(imax(I[t], S[t]), D[t]);
    int left = __shfl_up_sync(FULL, Mp[CPL - 1], 1);
    if (lane == 0) left = i == 1 ? 0 : h + (i - 1) * g;

    int Sn[CPL], Dn[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int diag = t == 0 ? left : Mp[t - 1];
      Dn[t] = imax(imax(imax(I[t], S[t]) + hg, D[t] + g), zero);
      int sub;
      if (c1 == c2[t]) sub = sm;
      else if (kimura && (c1 ^ c2[t]) == 2) sub = st;
      else sub = sx;
      Sn[t] = sub + imax(diag, zero);
    }

    // Horizontal chain: x[j] = max(S, D)(i, j-1) + h + g (floored), with
    // column 0's D = h + i*g feeding column 1; In[j] = max over k <= j of
    // x[k] + (j - k) * g.
    int carry_in = __shfl_up_sync(FULL, imax(imax(Sn[CPL - 1], Dn[CPL - 1]) + hg, zero), 1);
    if (lane == 0) carry_in = imax(h + i * g + hg, zero);
    int y[CPL];
    y[0] = carry_in;
#pragma unroll
    for (int t = 1; t < CPL; ++t)
      y[t] = imax(imax(imax(Sn[t - 1], Dn[t - 1]) + hg, zero), y[t - 1] + g);
    int C = y[CPL - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, C, d);
      if (lane >= d) C = imax(C, o + d * CPL * g);
    }
    const int P = __shfl_up_sync(FULL, C, 1);  // best ending at the lane to the left

    unsigned half = 0;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int In = lane == 0 ? y[t] : imax(y[t], P + (t + 1) * g);
      // The cell max before the local floor. Local: In, Dn >= 0 already,
      // so the floor never changes it; codes test this value, as K1 and
      // K3 do (ptxas once miscompiled an equality after a fused
      // max-with-zero, see gotoh_rowblock.cu).
      const int cm = imax(imax(In, Sn[t]), Dn[t]);
      if (DIRS) {
        const unsigned code = cm == Sn[t] ? 0u : cm == In ? 1u : cm == Dn[t] ? 2u : 3u;
        half |= code << (2 * t);
      }
      const int j = j0 + t;
      if (LOCAL) {
        if (j <= n && cm >= bv[t]) {
          bv[t] = cm;
          bi[t] = i;
        }
      } else if (i == m && j == n) {
        fin = cm;
      }
      I[t] = In;
      S[t] = Sn[t];
      D[t] = Dn[t];
    }
    if (DIRS) {
      const unsigned hi = __shfl_down_sync(FULL, half, 1);
      if ((lane & 1) == 0 && (lane >> 1) < W)
        cp[(size_t)(i - 1) * W + (lane >> 1)] = half | (hi << 16);
    }
    c1 = c1_next;
  }

  if (LOCAL) {
    // Lexicographic max of (v, i, j): larger value, then larger i, then
    // larger j (the JAX wrapper's tie-break over the per-column bests).
    int v = INT_MIN_V, vi = -1, vj = -1;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int j = j0 + t;
      if (bv[t] > v || (bv[t] == v && (bi[t] > vi || (bi[t] == vi && j > vj)))) {
        v = bv[t];
        vi = bi[t];
        vj = j;
      }
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      const int ov = __shfl_xor_sync(FULL, v, d);
      const int oi = __shfl_xor_sync(FULL, vi, d);
      const int oj = __shfl_xor_sync(FULL, vj, d);
      if (ov > v || (ov == v && (oi > vi || (oi == vi && oj > vj)))) {
        v = ov;
        vi = oi;
        vj = oj;
      }
    }
    if (lane == 0) {
      const bool empty = v <= 0;
      res[3 * p] = empty ? 0 : v;
      res[3 * p + 1] = empty ? m : vi;
      res[3 * p + 2] = empty ? n : vj;
    }
  } else if (lane == (n - 1) / CPL) {
    res[3 * p] = fin;
    res[3 * p + 1] = m;
    res[3 * p + 2] = n;
  }
}

template <bool LOCAL, bool DIRS>
void launch(const void* s1c, const void* s2c, const void* ms, const void* ns,
            void* codes, void* res, int B, int L1, int L2, int sm, int sx,
            int st, int kimura, int g, int h, cudaStream_t s) {
  const int blocks = (B + WARPS - 1) / WARPS;
  shortread_kernel<LOCAL, DIRS><<<blocks, WARPS * 32, 0, s>>>(
      (const int*)s1c, (const int*)s2c, (const int*)ms, (const int*)ns,
      (unsigned*)codes, (int*)res, B, L1, L2, sm, sx, st, kimura, g, h);
}

}  // namespace

extern "C" int gotoh_shortread_launch(
    const void* s1c, const void* s2c, const void* ms, const void* ns,
    void* codes, void* res, int B, int L1, int L2, int sm, int sx, int st,
    int kimura, int g, int h, int is_local, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || L1 < 1 || L2 < 16 || L2 > MAX_L2 || (L2 & 15))
    return (int)cudaErrorInvalidValue;
  const bool dirs = codes != nullptr;
  if (is_local) {
    if (dirs) launch<true, true>(s1c, s2c, ms, ns, codes, res, B, L1, L2, sm, sx, st, kimura, g, h, s);
    else launch<true, false>(s1c, s2c, ms, ns, codes, res, B, L1, L2, sm, sx, st, kimura, g, h, s);
  } else {
    if (dirs) launch<false, true>(s1c, s2c, ms, ns, codes, res, B, L1, L2, sm, sx, st, kimura, g, h, s);
    else launch<false, false>(s1c, s2c, ms, ns, codes, res, B, L1, L2, sm, sx, st, kimura, g, h, s);
  }
  return (int)cudaGetLastError();
}
