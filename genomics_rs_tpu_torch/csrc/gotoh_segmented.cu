// Batched Gotoh scores for Hopper (sm_90a), one warp per pair, no block
// barrier. Bound by ctypes.
//
// Replaces: genomics_rs_tpu/ops/gotoh_segmented.py, gotoh_scores_segmented
// (body _kernel_seg, pallas_call at :349; K7): 8 pairs per (8, C) register
// pane, an answer to the TPU's one wide vector; on Hopper a pair is a warp.
// (K8, the stream8 tier, runs on K3's warp-strip pipeline instead,
// gotoh_stream.cu; this kernel serves K7's route and the stream8 route's
// single pairs.) The contract is K3's (gotoh_stream_body.cuh) without dirs: for every pair
// p of a padded batch, the global score at (m_p, n_p) or the local keep-last
// row-major argmax (v, i, j), classic or kimura scoring, empty sequences
// allowed. Only true cells are computed, so no drift guard is needed.
//
// Design. K6's idea (gotoh_shortread.cu: a warp owns a pair, state in
// registers) carried past 256 bp as a skewed anti-diagonal strip. The warp
// sweeps its pair in strips of 32*R rows; lane l owns R consecutive rows of
// the strip in registers. Row r = l*R + k of the strip takes column q - r at
// step q, so a lane's R cells of one step are independent: row k reads the
// A, M and s2 character that row k-1 left at step q-1 (the lane walks its
// rows bottom up, so row k-1's are still last step's), and row 0 reads lane
// l-1's last row by __shfl_up_sync. Lane 0 reads the strip's top row from
// the pair's global scratch and s2 from the batch, both loaded by the warp
// 32 columns a chunk ahead and handed to it by shuffle (a load a column
// would stall the warp on L2 every step); lane 31 writes the strip's bottom
// row to scratch (double-buffered by strip parity). A strip takes n + 32*R
// steps at most; there is no
// __syncthreads anywhere. A block is one warp, so Hopper keeps up to 32
// pairs resident on an SM and a bucket of B pairs spreads over min(B, 132)
// SMs. The cell recurrence is the body's (gotoh_cell; its INTERIOR form on
// steps whose R cells all lie off row 0 and column 0 and inside the pair,
// so those steps are straight-line code), the substitution its CharSub.
// The cells of a step carry no branch and no chain between them: local,
// each row keeps its own keep-last best (its cells come in column order),
// merged into the lane's by (v, i, j) once a strip and across lanes by one
// warp reduction; global, row m's M at column n is read after its strip.
//
// What bounds it: integer issue, 12 ops a cell global and 19 local
// (PERF.md), plus six shuffles a lane a step, shared by R cells. With one
// warp a pair nothing waits on a barrier; a lone warp's R independent cells
// a step keep its SM sub-partition issuing, and more resident warps fill
// the rest.

#include <type_traits>

#include "gotoh_stream_body.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
//: rows a lane holds (8 beat 4 on the card: PERF.md §6).
constexpr int R = 8;
//: rows a strip.
constexpr int H = 32 * R;

template <bool LOCAL>
__global__ void __launch_bounds__(32)
warp_strip_kernel(CharSub sub, const int* __restrict__ ms, const int* __restrict__ ns,
                  int* __restrict__ res, int* __restrict__ scratch, int g, int h) {
  const int p = blockIdx.x;
  const int l = threadIdx.x;
  const int m = ms[p];
  const int n = ns[p];
  const int W = n + 1;  // scratch row width
  const int nstrips = (m + H) / H;
  int* scr = scratch + (size_t)p * 4 * (sub.Ln + 1);
  const int* b = sub.s2c + (size_t)p * sub.Ln;
  const int* a = sub.s1c + (size_t)p * sub.Lm;

  int bv = INT_MIN_V, bi = -1, bj = 0;  // this lane's best
  int fin = 0;
  for (int s = 0; s < nstrips; ++s) {
    const int* up = scr + ((s + 1) & 1) * 2 * W;  // written by strip s-1
    int* down = scr + (s & 1) * 2 * W;
    const bool writes_down = l == 31 && s + 1 < nstrips;
    const int i0 = s * H + l * R;  // this lane's first row
    // Row state (left cell's I and max(S, D), up-left M) and what each row
    // left at the last step: A, M and the s2 character of its column.
    int c1[R], Il[R], Pl[R], dM[R], oA[R], oM[R], ch[R];
    int rv[R], rj[R];  // local: each row's keep-last best (v, j)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = i0 + k;
      c1[k] = (i >= 1 && i <= m) ? a[i - 1] : 0;
      Il[k] = Pl[k] = dM[k] = oA[k] = oM[k] = ch[k] = 0;
      rv[k] = INT_MIN_V;
      rj[k] = 0;
    }
    // Lane 0's inputs by column: the top row's A and M and s2's character.
    // The warp loads them 32 columns at a time, a chunk ahead (lane t holds
    // column base + t), so no step waits on a load; lane 0 takes column q
    // from lane q & 31.
    auto load = [&](int c, int& A, int& M, int& C) {
      A = (s > 0 && c <= n) ? up[c] : 0;
      M = (s > 0 && c <= n) ? up[W + c] : 0;
      C = (c >= 1 && c <= n) ? b[c - 1] : 0;
    };
    int curA, curM, curC, nxtA, nxtM, nxtC;
    load(l, curA, curM, curC);
    load(32 + l, nxtA, nxtM, nxtC);
    const bool interior_rows = i0 >= 1 && i0 + R - 1 <= m;
    // The strip's last row, min(H, m + 1 - s*H) - 1, reaches column n last.
    const int nsteps = n + min(H, m + 1 - s * H);
    for (int q = 0; q < nsteps; ++q) {
      if (q > 0 && (q & 31) == 0) {
        curA = nxtA;
        curM = nxtM;
        curC = nxtC;
        load(q + 32 + l, nxtA, nxtM, nxtC);
      }
      const int tA = __shfl_sync(FULL, curA, q & 31);
      const int tM = __shfl_sync(FULL, curM, q & 31);
      const int tC = __shfl_sync(FULL, curC, q & 31);
      // Lane l-1's last row as it stood after step q-1: column q - l*R.
      const int inA = __shfl_up_sync(FULL, oA[R - 1], 1);
      const int inM = __shfl_up_sync(FULL, oM[R - 1], 1);
      const int inC = __shfl_up_sync(FULL, ch[R - 1], 1);
      const int j0 = q - l * R;  // row k's column is j0 - k
      auto step = [&](auto interior) {
        constexpr bool IN = decltype(interior)::value;
#pragma unroll
        for (int k = R - 1; k >= 0; --k) {
          const int i = i0 + k;
          const int j = j0 - k;
          const int uA = k > 0 ? oA[k - 1] : (l == 0 ? tA : inA);
          const int uM = k > 0 ? oM[k - 1] : (l == 0 ? tM : inM);
          const int c = k > 0 ? ch[k - 1] : (l == 0 ? tC : inC);
          ch[k] = c;
          if (IN || (j >= 0 && j <= n && i <= m)) {
            int I, S, D, Mk, Ak;
            gotoh_cell<LOCAL, IN>(i, j, g, h,
                                  [&](int& upA, int& upM) {
                                    upA = uA;
                                    upM = uM;
                                  },
                                  [&] { return sub.score(c1[k], c); }, Il[k], Pl[k], dM[k],
                                  I, S, D, Mk, Ak);
            oA[k] = Ak;
            oM[k] = Mk;
            if (LOCAL && Mk >= rv[k]) {  // a row's visits come in column order
              rv[k] = Mk;
              rj[k] = j;
            }
            if (k == R - 1 && writes_down) {
              down[j] = Ak;
              down[W + j] = Mk;
            }
          }
        }
      };
      if (interior_rows && j0 - (R - 1) >= 1 && j0 <= n) {
        step(std::true_type{});
      } else {
        step(std::false_type{});
      }
    }
    // A row's last cell is column n, so oM holds M(i, n) once the strip
    // ends: row m's is the global score.
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = i0 + k;
      if (LOCAL) {
        if (i <= m && better(rv[k], i, rj[k], bv, bi, bj)) {
          bv = rv[k];
          bi = i;
          bj = rj[k];
        }
      } else if (i == m) {
        fin = oM[k];
      }
    }
    __syncwarp();  // lane 31's row is visible to lane 0 of the next strip
  }

  if (LOCAL) {
    // Lane 0 owns row 0, whose cells are all >= 0: the merge finds a true cell.
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      const int ov = __shfl_xor_sync(FULL, bv, d);
      const int oi = __shfl_xor_sync(FULL, bi, d);
      const int oj = __shfl_xor_sync(FULL, bj, d);
      if (better(ov, oi, oj, bv, bi, bj)) {
        bv = ov;
        bi = oi;
        bj = oj;
      }
    }
    if (l == 0) {
      res[3 * p] = bv;
      res[3 * p + 1] = bi;
      res[3 * p + 2] = bj;
    }
  } else {
    // Row m is lane ((m % H) / R)'s in the last strip.
    if (l == (m % H) / R) {
      res[3 * p] = fin;
      res[3 * p + 1] = m;
      res[3 * p + 2] = n;
    }
  }
}

}  // namespace

// scratch: int32 (B, 4 * (Ln + 1)).
extern "C" int gotoh_segmented_launch(
    const void* s1c, const void* s2c, const void* ms, const void* ns, void* res,
    void* scratch, int B, int Lm, int Ln, int sm, int sx, int st, int kimura, int g,
    int h, int is_local, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const CharSub sub{(const int*)s1c, (const int*)s2c, Lm, Ln, sm, sx, st, kimura};
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_local) {
    warp_strip_kernel<true><<<B, 32, 0, s>>>(sub, (const int*)ms, (const int*)ns, (int*)res,
                                             (int*)scratch, g, h);
  } else {
    warp_strip_kernel<false><<<B, 32, 0, s>>>(sub, (const int*)ms, (const int*)ns, (int*)res,
                                              (int*)scratch, g, h);
  }
  return (int)cudaGetLastError();
}
