// Short-read batched Gotoh fill for Hopper (sm_90a), a group of G lanes per
// pair, bound by ctypes.
//
// Replaces: genomics_rs_tpu/ops/gotoh_shortread.py, gotoh_scores_shortread
// (body _rowscan_body, pallas_call at :316). Same contract for every pair p
// of a padded batch (s1 rows of L1 chars, s2 rows of L2 <= 256 chars, L2 a
// multiple of 16, true lengths 1 <= m_p <= L1 and 1 <= n_p <= L2): the
// affine-gap (Gotoh) table with the global boundary (row 0: I = h + j*g,
// column 0: D = h + i*g, corner 0), global or local (the zero floor inside
// each predecessor max), classic or kimura scoring. Outputs:
//   res[3p .. 3p+2]   global: (score at (m_p, n_p), m_p, n_p);
//                     local: the largest (v, i, j) over the true cells
//                     (larger value, then larger i, then larger j: the
//                     keep-last-over-rows best of each column merged the
//                     same way); a best <= 0 gives (0, m_p, n_p) (empty
//                     alignment)
//   codes (optional)  the rows16 layout: word codes[p, i-1, (j-1)/16] holds
//                     the 2-bit codes (S > I > D > STOP) of the interior
//                     cells (i, 16w+1 .. 16w+16), bits 2*((j-1)%16); the
//                     words of rows 1..m_p up to column n_p's are written
//                     (bits past n_p zero), the rest stay as the wrapper
//                     zeroed them
//
// Design. The TPU kernel puts 1024 pairs on the lanes of an (8, 128) pane
// and computes a whole DP row per step, the horizontal gap chain by a
// log2(L2)-round (max,+) prefix over pane rolls. On a warp that prefix is a
// shuffle scan on every row. Here the lanes run over rows instead, so no
// chain crosses lanes within a step: a group of G lanes (G = 8, 16 or 32,
// chosen from the batch's longest s1 by ops/gotoh_shortread.group_size)
// owns one pair, and lane l of the group holds the RT consecutive rows
// l*RT+1 .. l*RT+RT in registers. The lanes run one column apart: at step t
// lane l fills column t - l + 1 of its RT rows top down, row k reading row
// k-1's A and M of the same column from registers, and its first row
// reading lane l-1's last row, filled one step earlier, by one
// __shfl_up_sync within the group (with s2's character, which travels down
// the lanes the same way from lane 0's load). This is the step of
// gotoh_warp_pipe.cuh without its ring, tickets or host plan: a short pair
// fits in one group. A pair takes n + G - 1 steps of RT cells a lane; a
// warp holds 32/G pairs and steps to its longest one (RT, with G x RT >= m,
// from the host: ops/gotoh_shortread.lane_rows).
//
// The cell is gotoh_cell's interior step (gotoh_stream_body.cuh) written
// for this sweep: a row keeps the next column's I (not I and max(S, D)),
// and in local mode I >= 0, so the cell max M needs no floor and is the
// pre-floor max K1 and K3 test their codes against (S > I > D; never STOP
// here). Each row builds its code word in a register over 16 columns and
// stores it when the lane's column ends the word (or reaches n). Local:
// each row keeps its keep-last best and its column (one compare a cell), the
// lane merges its rows once (top down, so a tie goes to the lower row) and
// the group by (v, i, j) with xor shuffles. Global: after the sweep the
// lane holding row m has M(m, n) in its state (a lane stops past n).
//
// What bounds it: integer issue, about 12 ops a cell global and 15 local
// (+5 with codes), once enough warps are resident; three shuffles a lane a
// step, shared by RT cells. RT, the mode and codes are compile-time (the
// seven row heights of gotoh_shortread_launch's switch x 4 kernels; a copy
// specialised for classic scoring measured no faster, PERF.md). Registers
// grow with RT (about 3 a row global, 6 local with codes), so G trades skew
// for occupancy. Device memory traffic is one character a cell row and
// column, 2 bits of codes a cell (a word a row every 16 columns, 4-byte
// stores).

#include "gotoh_stream_body.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SR_BLOCK = 128;  // threads a block (four warps)
constexpr int MAX_L2 = 256;

__device__ __forceinline__ int floor0(int x, bool local) { return local ? imax(x, 0) : x; }

// One pair a group of G lanes; lane l fills rows l*RT+1 .. l*RT+RT. Row state
// (registers): c1 (s1's character), In (I of the row's next column: max(I +
// g, max(S, D) + h + g) of the current one, floored in local mode), dM (M of
// the row above at the current column: the next column's diagonal), acc (the
// row's code word), and in local mode bv/bj (the row's keep-last best and its
// column).
template <int RT, bool LOCAL, bool DIRS>
__global__ void __launch_bounds__(SR_BLOCK)
shortread_wave(CharSub sub, const int* __restrict__ ms, const int* __restrict__ ns,
               unsigned* __restrict__ codes, int* __restrict__ res, int B, int G, int g,
               int h) {
  const int tid = blockIdx.x * SR_BLOCK + threadIdx.x;
  if ((tid & ~31) / G >= B) return;  // the warp's first pair: uniform over the warp
  const int l = threadIdx.x & (G - 1);
  const int p = tid / G;
  const bool has = p < B;
  const int m = has ? ms[p] : 0;
  const int n = has ? ns[p] : 0;
  int steps = n + G - 1;  // the warp steps to its longest pair
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) steps = imax(steps, __shfl_xor_sync(FULL, steps, d));
  const int hg = h + g;
  const int i0 = l * RT + 1;   // the lane's first row
  const int rows = m - i0 + 1; // its true rows (RT or more: all; <= 0: none)
  const int* a = sub.s1c + (size_t)p * sub.Lm;
  const int* b = sub.s2c + (size_t)p * sub.Ln;
  const int W = sub.Ln >> 4;

  // Column 0: I = -inf and max(S, D) = D(i, 0) = h + i*g, so the next I is
  // h + i*g + h + g; the row above's M at column 0 (the corner 0 above row 1).
  int c1[RT], In[RT], dM[RT], bv[RT], bj[RT];
  unsigned acc[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int i = i0 + k;
    c1[k] = k < rows ? __ldg(a + i - 1) : -1;  // past m: never a true cell
    In[k] = floor0(h + i * g + hg, LOCAL);
    dM[k] = i == 1 ? 0 : floor0(h + (i - 1) * g, LOCAL);
    acc[k] = 0;
    bv[k] = INT_MIN_V;
    bj[k] = 0;
  }
  // What lane l+1 reads of this lane's last row (A and M) at its latest
  // column; the initial values are never read (lane l+1 starts a step later).
  int outA = 0, outM = 0;
  int c2 = 0;

  for (int t = 0; t < steps; ++t) {
    const int j = t - l + 1;
    int upA = __shfl_up_sync(FULL, outA, 1, G);
    int upM = __shfl_up_sync(FULL, outM, 1, G);
    const int c2up = __shfl_up_sync(FULL, c2, 1, G);
    if (l == 0) {  // row 0 of the table above the group's first row
      upA = floor0(h + j * g + hg, LOCAL);
      upM = floor0(h + j * g, LOCAL);
      c2 = j <= n ? __ldg(b + j - 1) : 0;
    } else {
      c2 = c2up;
    }
    if (j < 1 || j > n) continue;
    const int sh = 2 * ((j - 1) & 15);
    const unsigned pw1 = 1u << sh, pw2 = 2u << sh;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      // gotoh_cell's interior step (gotoh_stream_body.cuh). In local mode I
      // >= 0, so the cell max M needs no floor and equals the pre-floor max
      // that K1 and K3 test their codes against.
      const int I = In[k];
      const int S = sub.score(c1[k], c2) + dM[k];
      const int D = upA;
      const int Q = imax(I, S);
      const int M = imax(Q, D);
      const int P = imax(S, D);
      In[k] = floor0(imax(I + g, P + hg), LOCAL);
      dM[k] = upM;
      upA = floor0(imax(Q + hg, D + g), LOCAL);
      upM = M;
      if (DIRS) acc[k] += M == S ? 0u : M == I ? pw1 : pw2;  // S > I > D
      if (LOCAL && M >= bv[k]) {  // keep-last over the row's columns
        bv[k] = M;
        bj[k] = j;
      }
    }
    outA = upA;
    outM = upM;
    if (DIRS && (sh == 30 || j == n)) {
      unsigned* wp = codes + ((size_t)p * sub.Lm + i0 - 1) * W + ((j - 1) >> 4);
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (k < rows) *wp = acc[k];
        wp += W;
        acc[k] = 0;
      }
    }
  }

  if (LOCAL) {
    // The lane's largest (v, i, j) (rows top down: a tie goes to the lower
    // row), then the group's by xor shuffles; lane 0 of the group writes it.
    int v = INT_MIN_V, vi = -1, vj = 0;
#pragma unroll
    for (int k = 0; k < RT; ++k)
      if (k < rows && bv[k] >= v) {
        v = bv[k];
        vi = i0 + k;
        vj = bj[k];
      }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      if (d >= G) continue;
      const int ov = __shfl_xor_sync(FULL, v, d, G);
      const int oi = __shfl_xor_sync(FULL, vi, d, G);
      const int oj = __shfl_xor_sync(FULL, vj, d, G);
      if (better(ov, oi, oj, v, vi, vj)) {
        v = ov;
        vi = oi;
        vj = oj;
      }
    }
    if (has && l == 0) {
      const bool empty = v <= 0;
      res[3 * p] = empty ? 0 : v;
      res[3 * p + 1] = empty ? m : vi;
      res[3 * p + 2] = empty ? n : vj;
    }
  } else if (has && (m - 1) / RT == l) {
    // After column n, dM of row k holds M(row k-1, n) and outM the lane's
    // last row's M(., n) (a lane stops past n): M(m, n) is one of them.
    int fin = outM;
#pragma unroll
    for (int k = 1; k < RT; ++k)
      if (i0 + k - 1 == m) fin = dM[k];
    res[3 * p] = fin;
    res[3 * p + 1] = m;
    res[3 * p + 2] = n;
  }
}

template <int RT>
int launch_rt(const CharSub& sub, const void* ms, const void* ns, void* codes, void* res,
              int B, int G, int g, int h, bool local, cudaStream_t s) {
  const int blocks = (int)(((long long)B * G + SR_BLOCK - 1) / SR_BLOCK);
  const int* m = (const int*)ms;
  const int* n = (const int*)ns;
  unsigned* c = (unsigned*)codes;
  int* r = (int*)res;
  if (local) {
    if (c) shortread_wave<RT, true, true><<<blocks, SR_BLOCK, 0, s>>>(sub, m, n, c, r, B, G, g, h);
    else shortread_wave<RT, true, false><<<blocks, SR_BLOCK, 0, s>>>(sub, m, n, c, r, B, G, g, h);
  } else {
    if (c) shortread_wave<RT, false, true><<<blocks, SR_BLOCK, 0, s>>>(sub, m, n, c, r, B, G, g, h);
    else shortread_wave<RT, false, false><<<blocks, SR_BLOCK, 0, s>>>(sub, m, n, c, r, B, G, g, h);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows_per_lane: one of the switch's (ops/gotoh_shortread.LANE_ROWS); group: 8, 16
// or 32 lanes a pair, with group * rows_per_lane >= every m_p (the wrapper
// checks). codes: zeroed (B, L1, L2/16) or null.
extern "C" int gotoh_shortread_launch(
    const void* s1c, const void* s2c, const void* ms, const void* ns, void* codes, void* res,
    int B, int L1, int L2, int group, int rows_per_lane, int sm, int sx, int st, int kimura,
    int g, int h, int is_local, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || L1 < 1 || L2 < 16 || L2 > MAX_L2 || (L2 & 15) ||
      (group != 8 && group != 16 && group != 32))
    return (int)cudaErrorInvalidValue;
  const CharSub sub{(const int*)s1c, (const int*)s2c, L1, L2, sm, sx, st, kimura};
  const bool local = is_local != 0;
#define SR_CASE(RT) \
  case RT:          \
    return launch_rt<RT>(sub, ms, ns, codes, res, B, group, g, h, local, s);
  switch (rows_per_lane) {
    SR_CASE(4)
    SR_CASE(5)
    SR_CASE(8)
    SR_CASE(10)
    SR_CASE(16)
    SR_CASE(20)
    SR_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SR_CASE
}
