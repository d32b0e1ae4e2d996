// The Gotoh fill's shared body: the cell recurrence (gotoh_cell), the
// character substitution (CharSub), the global boundary (GlobalEdge), the
// strip sweep of K1's row-block pipeline and its tile form K5
// (strip_sweep, block_best: gotoh_rowblock.cu), and the pipelines' hand-off
// (wait_geq and the acquire/release stores). The warp-strip kernel K7
// (gotoh_segmented.cu) and the short-read wavefront K6 (gotoh_shortread.cu)
// take the cell and CharSub; the warp-strip pipeline of K9, K16, K3, K8,
// the matrix fill (K13/K14), K10 and K12 (gotoh_warp_pipe.cuh) takes the
// cell, a substitution policy (CharSub, or the matrix fill's ProfileSub in
// gotoh_matrix.cu), GlobalEdge and the waits.
//
// The table, for every pair p of a padded batch (true lengths m_p, n_p):
// the affine-gap (Gotoh) recurrence over rows 0..m_p and columns 0..n_p
// with the global boundary (corner 0, I(0, j) = h + j*g, D(i, 0) = h + i*g,
// the rest -inf), global or local (reference zero floor inside every
// predecessor max). Its 2-bit direction codes (S > I > D > STOP) are
// packed diagonal-major by K1, K3 and the matrix fill (diag16):
//   code(i, j) = (dirs[(p*KW + (i+j)/16) * V + i] >> 2*((i+j)%16)) & 3
//
// strip_sweep: a strip of T rows is swept by T threads, thread t owning row
// s*T + t and stepping one column a barrier (a skewed wavefront); the
// strip's last thread hands its row's A and M to the next strip. K1's
// pipeline runs it with a strip a block.
//
// A substitution policy gives s(i, j) two ways:
//   strip_sweep's row form (K1):
//     Row row(int p, int i, int m, int n) const    state for row i of pair p
//                                                   (i may be 0 or past m:
//                                                   then nothing is read)
//     int next(Row& r, int j, int n) const          s(i, j) for the row's next
//                                                   column j (1 <= j <= n),
//                                                   then prefetch column j+1
//   the warp strip's lane form (gotoh_warp_pipe.cuh), lane state for the
//   RT rows i0 .. i0+RT-1 of one lane:
//     COLS                                          true when a value travels
//                                                   down the lanes with each
//                                                   column (s2's character)
//     void lane(Lane<RT>& L, int p, int i0, int kreal) const
//     int col(const Lane<RT>& L, int c) const       column c's travelling value
//     int at(const Lane<RT>& L, int k, int c2) const   s(i0+k, j), the lane's
//                                                   column j, c2 its value
//     void next(Lane<RT>& L, int p, int j, int n) const   after the lane's
//                                                   column j: prefetch j+1
// The sweep takes two more policies. An edge (GlobalEdge here; K1's given
// top row and streamed left column in gotoh_rowblock.cu) gives I/S/D on
// row 0 and column 0. An output (K1's in gotoh_rowblock.cu) sees every true
// cell once, after its codes, as cell(i, j, I, S, D, M).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 30);
constexpr int INT_MIN_V = -2147483647 - 1;
constexpr int MAX_T = 1024;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// The character substitution of K1, K3, K6, K7, K8, K9 and K10: equal codes score sm;
// kimura (codes classed so that a transition differs by XOR 2) scores st
// for a transition; anything else sx.
struct CharSub {
  const int* s1c;
  const int* s2c;
  int Lm, Ln, sm, sx, st, kimura;

  struct Row {
    int c1;        // s1[i-1]
    const int* b;  // the pair's s2 characters
    int c2;        // s2[j-1] of the next column, prefetched
  };

  __device__ __forceinline__ int score(int c1, int c2) const {
    if (c1 == c2) return sm;
    if (kimura && (c1 ^ c2) == 2) return st;
    return sx;
  }

  __device__ __forceinline__ Row row(int p, int i, int m, int n) const {
    Row r;
    r.c1 = (i <= m && i >= 1) ? s1c[(size_t)p * Lm + i - 1] : 0;
    r.b = s2c + (size_t)p * Ln;
    r.c2 = n > 0 ? r.b[0] : 0;
    return r;
  }

  __device__ __forceinline__ int next(Row& r, int j, int n) const {
    const int v = score(r.c1, r.c2);
    r.c2 = j < n ? r.b[j] : 0;
    return v;
  }

  // The lane form: each lane holds its rows' s1 characters; s2's travel
  // down the lanes with the columns.
  static constexpr bool COLS = true;
  template <int RT>
  struct Lane {
    int c1[RT];
    const int* s2p;  // the pair's s2 characters
  };
  template <int RT>
  __device__ __forceinline__ void lane(Lane<RT>& L, int p, int i0, int kreal) const {
    const int* s1p = s1c + (size_t)p * Lm;
#pragma unroll
    for (int k = 0; k < RT; ++k) L.c1[k] = (k < kreal && i0 + k >= 1) ? __ldg(s1p + i0 + k - 1) : 0;
    L.s2p = s2c + (size_t)p * Ln;
  }
  template <int RT>
  __device__ __forceinline__ int col(const Lane<RT>& L, int c) const {
    return c >= 1 ? __ldg(L.s2p + c - 1) : 0;
  }
  template <int RT>
  __device__ __forceinline__ int at(const Lane<RT>& L, int k, int c2) const {
    return score(L.c1[k], c2);
  }
  template <int RT>
  __device__ __forceinline__ void next(Lane<RT>&, int, int, int) const {}
};

// The table's global boundary (K7 and the warp-strip pipeline's FullRows): corner 0,
// I(0, j) = h + j*g, D(i, 0) = h + i*g, the rest -inf.
struct GlobalEdge {
  __device__ __forceinline__ void top(int j, int g, int h, int& I, int& S, int& D) const {
    I = j == 0 ? 0 : h + j * g;
    S = j == 0 ? 0 : NEG_INF;
    D = S;
  }
  __device__ __forceinline__ void left(int i, int g, int h, int& I, int& S, int& D) const {
    I = NEG_INF;
    S = NEG_INF;
    D = h + i * g;
  }
};

// The recurrence at one true cell (i, j). The row's state: Il = I and
// Pl = max(S, D) of (i, j-1), diagM = M of (i-1, j-1); `up(a, m)` gives A
// and M of the cell above, (i-1, j), and is called only off row 0 (the
// fetch stays inside the cell's one branch on i). Row 0 and column 0 come
// from `edge`. `sub()` gives s(i, j) and is called only for i, j >= 1,
// once a column. Sets I, S, D, M (floored in local mode) and A, moves the
// row state on, and returns M0, the cell max before the local floor.
// INTERIOR: the caller knows i, j >= 1, and the boundary branches go (the
// warp-strip kernel's straight-line steps).
template <bool LOCAL, bool INTERIOR = false, class UpF, class SubF, class Edge = GlobalEdge>
__device__ __forceinline__ int gotoh_cell(int i, int j, int g, int h, UpF up, SubF sub,
                                          int& Il, int& Pl, int& diagM, int& I,
                                          int& S, int& D, int& M, int& A,
                                          const Edge& edge = Edge{}) {
  const int hg = h + g;
  if (!INTERIOR && i == 0) {
    edge.top(j, g, h, I, S, D);
  } else {
    int upA, upM;
    up(upA, upM);
    if (!INTERIOR && j == 0) {
      edge.left(i, g, h, I, S, D);
    } else {
      I = imax(Il + g, Pl + hg);
      if (LOCAL) I = imax(I, 0);
      D = upA;
      S = sub() + diagM;
    }
    diagM = upM;
  }
  const int Q = imax(I, S);
  const int M0 = imax(Q, D);  // the cell max before the local floor
  M = M0;
  A = imax(Q + hg, D + g);
  if (LOCAL) {
    M = imax(M, 0);
    A = imax(A, 0);
  }
  Il = I;
  Pl = imax(S, D);
  return M0;
}

// Keep-last order of local bests: larger v, then larger i, then larger j.
__device__ __forceinline__ bool better(int v, int i, int j, int bv, int bi, int bj) {
  return v > bv || (v == bv && (i > bi || (i == bi && j > bj)));
}

// Merge the block's per-thread bests into (v, i, j) on thread 0 (every
// thread calls it; the result is thread 0's).
__device__ __forceinline__ void block_best(int* rv, int* ri, int* rj, int bv,
                                           int bi, int bj, int& v, int& ii,
                                           int& jj) {
  const int t = threadIdx.x;
  rv[t] = bv;
  ri[t] = bi;
  rj[t] = bj;
  __syncthreads();
  v = INT_MIN_V;
  ii = -1;
  jj = 0;
  if (t == 0) {
    for (int u = 0; u < (int)blockDim.x; ++u)
      if (better(rv[u], ri[u], rj[u], v, ii, jj)) {
        v = rv[u];
        ii = ri[u];
        jj = rj[u];
      }
  }
}

// ---- the pipelines' hand-off (K1's strips, the warp strips of K9 and K10) ----

//: columns a producer publishes at once (a consumer waits once a chunk).
constexpr int PIPE_CHUNK = 64;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;\n" : : "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *flag >= target (acquire). False when the launch's error
// word is set, or when the wait sees nothing move for `bound` ns (it then
// sets the word): each time the bound passes the wait looks at the
// launch's heartbeat *beat and starts its clock again if it changed, so a
// wait behind strips that are still sweeping is no fault however long,
// and a hang (no strip of the launch moves for a whole bound) is. The beat
// is read once a bound, not once a spin, so the waits add no loads to the
// line every strip adds to.
__device__ __noinline__ bool wait_geq(const int* flag, int target, int* err, const int* beat,
                                      unsigned long long bound) {
  if (ld_acquire(flag) >= target) return true;
  unsigned long long t0 = globaltimer();
  int seen = *(const volatile int*)beat;
  for (;;) {
    __nanosleep(64);
    if (ld_acquire(flag) >= target) return true;
    if (*(volatile int*)err) return false;
    const unsigned long long now = globaltimer();
    if (now - t0 > bound) {
      const int b = *(const volatile int*)beat;
      if (b == seen) {
        atomicExch(err, 1);
        return false;
      }
      seen = b;
      t0 = now;
    }
  }
}

// One pipelined strip's links to its neighbours (K1's pipeline).
struct StripLinks {
  const int* progress_in;  // columns of the top row published by strip s-1
  int* progress_out;       // this strip's published bottom-row columns
  int* released;           // set once this strip has read its whole top row
  int* err;                // the launch's error word
  int* abort;              // shared: set by warp 0 when a wait failed
  int* upA;                // shared: the staged chunk of the top row
  int* upM;
  int* beat;               // the launch's heartbeat: a strip adds one with
                           // each chunk it publishes, see wait_geq
  unsigned long long bound;  // wait_geq's bound (ns)
};

// Sweep strip s of pair p: rows s*T .. s*T + T - 1 (those <= m), columns
// 0..n. Thread 0 reads the row above from `up` (A at [j], M at [W + j]);
// the last thread writes its row to `down` when `writes_down`. PIPE: the
// top row arrives in published chunks (warp 0 stages each chunk in
// shared memory) and the bottom row is published chunk by chunk. Row 0
// and column 0 come from `edge`; `out` sees every true cell. Returns
// false when a pipeline wait failed (every thread of the block returns).
template <bool LOCAL, bool PIPE, class Sub, class Edge, class Out>
__device__ __forceinline__ bool strip_sweep(
    const Sub& sub, const Edge& edge, Out& out, int p, int s, int m, int n, int g, int h,
    int (*sA)[MAX_T], int (*sM)[MAX_T], int& cur, const int* up, int* down,
    bool writes_down, unsigned* dp, int V, const StripLinks& ln) {
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int W = n + 1;
  const int i = s * T + t;
  const bool has_row = i <= m;
  const int in_strip = min(T, m + 1 - s * T);
  const int nsteps = n + in_strip;

  typename Sub::Row row = sub.row(p, i, m, n);
  int Il = 0, Pl = 0, diagM = 0;
  unsigned acc = 0;

  for (int q = 0; q < nsteps; ++q) {
    if (PIPE && t < 32 && s > 0 && q <= n && (q % PIPE_CHUNK) == 0) {
      // Warp 0 stages top-row columns q .. q + PIPE_CHUNK - 1 once strip
      // s-1 has published them (L2 loads: L1 is not coherent across SMs).
      const int hi = min(q + PIPE_CHUNK, W);
      if (t == 0 && !wait_geq(ln.progress_in, hi, ln.err, ln.beat, ln.bound)) *ln.abort = 1;
      __syncwarp();
      for (int c = q + t; c < hi; c += 32) {
        ln.upA[c - q] = __ldcg(up + c);
        ln.upM[c - q] = __ldcg(up + W + c);
      }
      __syncwarp();
      if (t == 0 && hi == W) {  // the whole top row is read: its slot is free
        __threadfence();
        st_release(ln.released, 1);
      }
    }
    const int j = q - t;
    if (has_row && j >= 0 && j <= n) {
      int I, S, D, M, A;
      const int M0 = gotoh_cell<LOCAL>(
          i, j, g, h,
          [&](int& upA, int& upM) {
            if (t == 0) {
              if (PIPE) {
                upA = ln.upA[j % PIPE_CHUNK];
                upM = ln.upM[j % PIPE_CHUNK];
              } else {
                upA = up[j];
                upM = up[W + j];
              }
            } else {
              upA = sA[cur ^ 1][t - 1];
              upM = sM[cur ^ 1][t - 1];
            }
          },
          [&] { return sub.next(row, j, n); }, Il, Pl, diagM, I, S, D, M, A, edge);
      sA[cur][t] = A;
      sM[cur][t] = M;
      if (writes_down) {
        down[j] = A;
        down[W + j] = M;
        if (PIPE && ((j + 1) % PIPE_CHUNK == 0 || j == n)) {
          st_release(ln.progress_out, j + 1);  // orders this thread's row stores
          atomicAdd(ln.beat, 1);
        }
      }
      if (dp != nullptr) {
        // Tested against the pre-floor max M0: ptxas (CUDA 12.9, -O1 and
        // up) miscompiled K1's `M == D` after the fused max-with-zero in
        // local mode, found only on the card.
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
      out.cell(i, j, I, S, D, M);
    }
    __syncthreads();
    cur ^= 1;
    if (PIPE && (q % PIPE_CHUNK) == 0 && *(volatile int*)ln.abort) return false;
  }
  return true;
}

}  // namespace
