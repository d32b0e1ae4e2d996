// The batched Gotoh fill's body, one thread block per pair, shared by K3
// (gotoh_stream.cu: the substitution compares two characters, classic or
// kimura) and the matrix fill (gotoh_matrix.cu: the substitution is read
// from a query profile). A substitution policy `Sub` supplies s(i, j); the
// recurrence, the boundaries, the direction codes and the local argmax are
// this file's, once.
//
// Contract, for every pair p of a padded batch (true lengths m_p, n_p): the
// affine-gap (Gotoh) table over rows 0..m_p and columns 0..n_p with the
// global boundary (corner 0, I(0, j) = h + j*g, D(i, 0) = h + i*g, the rest
// -inf), global or local (reference zero floor inside every predecessor
// max). Outputs:
//   res[3p .. 3p+2]  global: (score at (m_p, n_p), m_p, n_p);
//                    local: the keep-last row-major argmax (v, i, j) over
//                    the pair's true cells (larger v, then larger i, then
//                    that row's larger j)
//   dirs (optional)  the pair's 2-bit codes packed like K1's (S > I > D >
//                    STOP), in its own slice of a (B, KW, V) array:
//                    code(i, j) = (dirs[(p*KW + (i+j)/16) * V + i]
//                                  >> 2*((i+j)%16)) & 3
//
// Design: block p runs K1's skewed row-strip wavefront (gotoh_rowblock.cu)
// over pair p alone: thread t owns row s*T + t of strip s and steps one
// column a barrier; the last thread of a strip hands its row's A and M to
// the next strip through the pair's global scratch rows. No padded cell is
// computed, so the local argmax needs no padding mask and no pair needs a
// seam, probe or drift guard.
//
// A policy is a struct with a nested `Row` and two device methods:
//   Row row(int p, int i, int m, int n) const    state for row i of pair p
//                                                 (i may be 0 or past m:
//                                                 then nothing is read)
//   int next(Row& r, int j, int n) const          s(i, j) for the row's next
//                                                 column j (1 <= j <= n),
//                                                 then prefetch column j+1

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 30);
constexpr int INT_MIN_V = -2147483647 - 1;
constexpr int MAX_T = 1024;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

template <bool LOCAL, class Sub>
__global__ void __launch_bounds__(MAX_T, 1)
stream_kernel(Sub sub, const int* __restrict__ ms, const int* __restrict__ ns,
              unsigned* __restrict__ dirs, int* __restrict__ res,
              int* __restrict__ scratch, int Ln, int V, int KW, int g, int h) {
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

    typename Sub::Row row = sub.row(p, i, m, n);
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
            S = sub.next(row, j, n) + diagM;
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

// Launch the body over B pairs; returns cudaGetLastError().
template <class Sub>
int launch_stream(const Sub& sub, const int* ms, const int* ns, unsigned* dirs,
                  int* res, int* scratch, int B, int Ln, int V, int KW, int g,
                  int h, int is_local, int threads, cudaStream_t s) {
  if (threads < 1 || threads > MAX_T || B < 1) return (int)cudaErrorInvalidValue;
  if (is_local) {
    stream_kernel<true, Sub><<<B, threads, 0, s>>>(sub, ms, ns, dirs, res, scratch,
                                                   Ln, V, KW, g, h);
  } else {
    stream_kernel<false, Sub><<<B, threads, 0, s>>>(sub, ms, ns, dirs, res, scratch,
                                                    Ln, V, KW, g, h);
  }
  return (int)cudaGetLastError();
}

}  // namespace
