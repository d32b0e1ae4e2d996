// Banded Gotoh fill for Hopper (sm_90a), one thread block per pair, bound by
// ctypes.
//
// Replaces two TPU kernels with one:
//   K10  genomics_rs_tpu/ops/gotoh_banded.py, _banded_call (body
//        _kernel_banded, pallas_call at :373): one pair, its own window;
//   K12  genomics_rs_tpu/ops/gotoh_banded_batch.py, _banded_batch_call (body
//        _kernel_banded8, pallas_call at :303): B pairs under one window
//        planned from the batch's (max m, max n).
// K10 is this kernel at B = 1. Contract, per pair p (global mode only): lane
// v of row i holds column off(i) + v + 1; the host plans off (int64) and
// passes per row flags = delta | at0 << 1 (delta = off(i) - off(i-1) in
// {0, 1}, at0 = off(i) == 0), the row's s1 char s1c[p, i-1] and the s2 char
// entering on the right s2in[p, i-1], plus the row-0 window s2init[p, :V].
// Per row: the D carry A = max(max(I, S) + h + g, D + g) of the previous row
// shifts up by delta (NEG_INF enters at lane V-1), the cell max M shifts
// down by 1 - delta (the column-0 value enters at lane 0 while at0), the s2
// window shifts up by delta; S = sub + M, P = max(S, D), and I is the (max,+)
// prefix I[v] = max_{u <= v} seed[u] + (v - u) g of seed[v] = P[v-1] + h + g,
// seed[0] = the column-0 value (at0) or NEG_INF. Codes (S > I > D > STOP) pack
// 16 rows to a word: dirs[p, (i-1)/16, v], bits 2*((i-1)%16); the last row's
// partial word is stored too. score[p] = the cell max at (m_p, v_p) (probe).
// int32 adds wrap as the JAX kernel's do.
//
// Design. The TPU kernel keeps the band on an (8, C) pane and scans the I
// chain by pane rolls. Here a block owns one pair's row: thread t holds LPT
// consecutive lanes (8 up to 4,096 lanes, 16 up to 8,192, 32 up to 32,768)
// of A, M, the s2 window and the 16-row code words in registers, so no DP
// state lives in memory. The lanes shift across threads by one warp shuffle;
// the I chain is a serial (max,+) pass over the thread's lanes (each thread
// owns the seeds of its lanes 1..LPT, so the pass needs no neighbour), a
// 5-round warp scan of the thread totals and a scan of the warp totals in
// shared memory, then a fix-up pass. The values that cross a warp edge for
// the next row (A and the s2 char at the next warp's first lane, M at the
// previous warp's last lane) are recomputed by the edge lanes from what
// each warp publishes before the row's one barrier, in a buffer kept per row
// parity, so a row costs one __syncthreads. Row streams are staged through
// shared memory 256 rows at a time. Code words are stored every 16 rows, 32
// bytes a thread, coalesced along v.
//
// What bounds it: a row is a dependent chain (shuffles, the warp scan, the
// barrier, the serial passes) on one SM per pair; the card's integer rate
// bounds it only in aggregate. Device memory traffic is 2 bits a band cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG_INF = -(1 << 30);
constexpr int CHUNK = 256;  // rows of streams staged per refill
constexpr int MAX_WARPS = 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// What a warp publishes each row for its neighbours.
struct Edge {
  int total;   // lane 31: scan of the warp's thread totals (through its last lane + 1)
  int z_last;  // lane 31: its own-seed prefix at its last lane
  int xe;      // lane 31: the in-warp exclusive scan value
  int p_last;  // lane 31: P at its last lane
  int sn0;     // lane 0: S at its first lane
  int dn0;     // lane 0: D at its first lane
  int s20;     // lane 0: the s2 char at its first lane, after this row's shift
};

template <int LPT>
__global__ void __launch_bounds__(LPT == 32 ? 1024 : 512)
banded_kernel(const int* __restrict__ s1c, const int* __restrict__ s2in,
              const int* __restrict__ flags, const int* __restrict__ s2init,
              const int* __restrict__ probe, unsigned* __restrict__ dirs,
              int* __restrict__ score, int R, int V, int Vc, int KW, int sm,
              int sx, int st, int kimura, int g, int h) {
  __shared__ int sh_s1[CHUNK], sh_in[CHUNK], sh_fl[CHUNK];
  __shared__ Edge edge[2][MAX_WARPS];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nreal = Vc / LPT;  // threads holding computed lanes
  const bool real = t < nreal;
  const bool last_real = t == nreal - 1;
  const int v0 = t * LPT;
  const int hg = h + g;
  const int span = 32 * LPT * g;  // g times the lanes of one warp
  const int m_p = probe[2 * p];
  const int v_p = probe[2 * p + 1];
  const int* s1p = s1c + (size_t)p * R;
  const int* inp = s2in + (size_t)p * R;
  unsigned* dp = dirs + (size_t)p * KW * V;

  // Row 0 (off = 0, column v + 1): M = I = h + j g, A = M + h + g.
  int A[LPT], Mx[LPT], s2w[LPT];
  unsigned acc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    Mx[k] = h + (v0 + k + 1) * g;
    A[k] = Mx[k] + hg;
    s2w[k] = real ? s2init[(size_t)p * V + v0 + k] : 0;
    acc[k] = 0;
  }
  // The previous row's values across this thread's warp edges.
  int edgeA = h + (v0 + LPT + 1) * g + hg;                             // lane 31
  int edgeS2 = v0 + LPT < Vc ? s2init[(size_t)p * V + v0 + LPT] : 0;  // lane 31
  int edgeM = h + v0 * g;                                              // lane 0

  for (int i = 1; i <= R; ++i) {
    const int r = (i - 1) % CHUNK;
    if (r == 0) {
      // Every thread has read the previous chunk: it passed the last row's barrier.
      for (int q = t; q < CHUNK && i + q <= R; q += blockDim.x) {
        sh_s1[q] = s1p[i - 1 + q];
        sh_in[q] = inp[i - 1 + q];
        sh_fl[q] = flags[i - 1 + q];
      }
      __syncthreads();
    }
    const int fl = sh_fl[r];
    const int c1 = sh_s1[r];
    const int cin = sh_in[r];
    const bool dlt = fl & 1;
    const bool at0 = (fl >> 1) & 1;
    const int fillM = at0 ? (i == 1 ? 0 : h + (i - 1) * g) : NEG_INF;
    const int fillN = at0 ? h + i * g + hg : NEG_INF;

    int upA = __shfl_down_sync(FULL, A[0], 1);
    int upS = __shfl_down_sync(FULL, s2w[0], 1);
    int dnM = __shfl_up_sync(FULL, Mx[LPT - 1], 1);
    if (lane == 31) {
      upA = edgeA;
      upS = edgeS2;
    }
    if (lane == 0) dnM = edgeM;
    if (last_real) {
      upA = NEG_INF;
      upS = cin;
    }
    if (t == 0) dnM = fillM;

    int Dn[LPT], Sn[LPT], P[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      Dn[k] = dlt ? (k + 1 < LPT ? A[k + 1] : upA) : A[k];
      const int m_al = dlt ? Mx[k] : (k > 0 ? Mx[k - 1] : dnM);
      if (dlt) s2w[k] = k + 1 < LPT ? s2w[k + 1] : upS;
      const int c2 = s2w[k];
      int sub;
      if (c1 == c2) sub = sm;
      else if (kimura && (c1 ^ c2) == 2) sub = st;
      else sub = sx;
      Sn[k] = sub + m_al;
      P[k] = imax(Sn[k], Dn[k]);
    }

    // I chain. The thread owns the seeds of its lanes 1..LPT (seed[v0 + k]
    // = P[k - 1] + h + g); z[k] is their prefix at lane k, T the total at
    // lane LPT (the next thread's first lane).
    int z[LPT];
    z[0] = 0;  // unused: lane 0's seed belongs to the thread before
    z[1] = P[0] + hg;
#pragma unroll
    for (int k = 2; k < LPT; ++k) z[k] = imax(P[k - 1] + hg, z[k - 1] + g);
    int X = imax(P[LPT - 1] + hg, z[LPT - 1] + g);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, X, d);
      if (lane >= d) X = imax(X, o + d * LPT * g);
    }
    const int Xe = __shfl_up_sync(FULL, X, 1);
    Edge* eb = edge[i & 1];
    if (lane == 31) {
      eb[w].total = X;
      eb[w].z_last = z[LPT - 1];
      eb[w].xe = Xe;
      eb[w].p_last = P[LPT - 1];
    }
    if (lane == 0) {
      eb[w].sn0 = Sn[0];
      eb[w].dn0 = Dn[0];
      eb[w].s20 = s2w[0];
    }
    __syncthreads();

    // I at the warp's first lane (C), and at the warp before's (Cprev).
    int C = fillN, Cprev = NEG_INF;
    for (int q = 0; q < w; ++q) {
      Cprev = C;
      C = imax(C + span, eb[q].total);
    }
    const int E = lane == 0 ? C : imax(Xe, C + lane * LPT * g);  // I at lane v0

    const int sp = (i - 1) & 15;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int In = k == 0 ? E : imax(z[k], E + k * g);
      const int cm = imax(In, P[k]);
      const unsigned code = cm == Sn[k] ? 0u : cm == In ? 1u : cm == Dn[k] ? 2u : 3u;
      acc[k] = (sp == 0 ? 0u : acc[k]) | (code << (2 * sp));
      if (i == m_p && v0 + k == v_p) score[p] = cm;
      A[k] = imax(imax(In, Sn[k]) + hg, Dn[k] + g);
      Mx[k] = cm;
    }
    if (real && (sp == 15 || i == R)) {
      uint4* out = reinterpret_cast<uint4*>(dp + (size_t)((i - 1) >> 4) * V + v0);
#pragma unroll
      for (int k = 0; k < LPT; k += 4)
        out[k >> 2] = make_uint4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
    }

    // Next row's values across the warp edges, from what the neighbours
    // published: A and the s2 char at the next warp's first lane, M at the
    // previous warp's last lane.
    if (lane == 31 && w + 1 < nwarps) {
      const int Cn = imax(C + span, eb[w].total);
      edgeA = imax(imax(Cn, eb[w + 1].sn0) + hg, eb[w + 1].dn0 + g);
      edgeS2 = eb[w + 1].s20;
    }
    if (lane == 0 && w > 0) {
      const int Ep = imax(eb[w - 1].xe, Cprev + 31 * LPT * g);
      edgeM = imax(imax(eb[w - 1].z_last, Ep + (LPT - 1) * g), eb[w - 1].p_last);
    }
  }
}

// The wide form, for more than 32,768 computed lanes: the same row step with
// the row state in device memory. Thread t owns the L = ceil(Vc / 1024)
// consecutive lanes t*L .. (the last thread with lanes may own fewer); lane
// v's slot is (v % L) * 1024 + v / L, so a step over k is coalesced across
// threads. A, M and the s2 window are double-buffered by row parity
// (scratch[p] = [parity][A, M, s2][slots]), so the neighbour lanes of the
// previous row are read straight from its buffer. The I chain is the same
// serial pass, warp scan and scan of the warp totals; the second pass
// recomputes S, D and P rather than storing them. Two barriers a row.
constexpr int WIDE_THREADS = 1024;

__global__ void __launch_bounds__(WIDE_THREADS)
banded_wide_kernel(const int* __restrict__ s1c, const int* __restrict__ s2in,
                   const int* __restrict__ flags, const int* __restrict__ s2init,
                   const int* __restrict__ probe, unsigned* __restrict__ dirs,
                   int* __restrict__ score, int* __restrict__ scratch, int R,
                   int V, int Vc, int KW, int sm, int sx, int st, int kimura,
                   int g, int h) {
  __shared__ int wtot[MAX_WARPS];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int L = (Vc + WIDE_THREADS - 1) / WIDE_THREADS;
  const int v0 = t * L;
  const int cnt = Vc - v0 < L ? (Vc - v0 > 0 ? Vc - v0 : 0) : L;
  const int hg = h + g;
  const size_t plane = (size_t)L * WIDE_THREADS;
  int* sp_ = scratch + (size_t)p * 6 * plane;
  const int m_p = probe[2 * p];
  const int v_p = probe[2 * p + 1];
  unsigned* dp = dirs + (size_t)p * KW * V;
  auto slot = [L](int v) { return (size_t)(v % L) * WIDE_THREADS + v / L; };

  for (int k = 0; k < cnt; ++k) {  // row 0 into parity 0
    const int v = v0 + k;
    const int m0 = h + (v + 1) * g;
    sp_[slot(v)] = m0 + hg;
    sp_[plane + slot(v)] = m0;
    sp_[2 * plane + slot(v)] = s2init[(size_t)p * V + v];
  }
  __syncthreads();

  for (int i = 1; i <= R; ++i) {
    const int* Ap = sp_ + ((i - 1) & 1) * 3 * plane;
    const int* Mp = Ap + plane;
    const int* Sp = Ap + 2 * plane;
    int* An = sp_ + (i & 1) * 3 * plane;
    int* Mn = An + plane;
    int* Sw = An + 2 * plane;
    const int fl = flags[i - 1];
    const int c1 = s1c[(size_t)p * R + i - 1];
    const int cin = s2in[(size_t)p * R + i - 1];
    const bool dlt = fl & 1;
    const bool at0 = (fl >> 1) & 1;
    const int fillM = at0 ? (i == 1 ? 0 : h + (i - 1) * g) : NEG_INF;
    const int fillN = at0 ? h + i * g + hg : NEG_INF;
    // The previous row aligned to lane v: D, S, P and the s2 char there.
    auto cell = [&](int v, int& dn, int& sn, int& pp) {
      const bool last = v + 1 >= Vc;
      dn = dlt ? (last ? NEG_INF : Ap[slot(v + 1)]) : Ap[slot(v)];
      const int m_al = dlt ? Mp[slot(v)] : (v > 0 ? Mp[slot(v - 1)] : fillM);
      const int c2 = dlt ? (last ? cin : Sp[slot(v + 1)]) : Sp[slot(v)];
      int sub;
      if (c1 == c2) sub = sm;
      else if (kimura && (c1 ^ c2) == 2) sub = st;
      else sub = sx;
      sn = sub + m_al;
      pp = imax(sn, dn);
      return c2;
    };

    // Pass 1: the prefix of the thread's own seeds (lanes v0+1 .. v0+cnt).
    int X = NEG_INF;
    for (int k = 0; k < cnt; ++k) {
      int dn, sn, pp;
      cell(v0 + k, dn, sn, pp);
      X = k == 0 ? pp + hg : imax(pp + hg, X + g);
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(FULL, X, d);
      if (lane >= d) X = imax(X, o + d * L * g);
    }
    const int Xe = __shfl_up_sync(FULL, X, 1);
    if (lane == 31) wtot[w] = X;
    __syncthreads();
    int C = fillN;  // I at the warp's first lane
    for (int q = 0; q < w; ++q) C = imax(C + 32 * L * g, wtot[q]);
    const int E = lane == 0 ? C : imax(Xe, C + lane * L * g);  // I at lane v0

    // Pass 2: I, the cell max, the code and the new state of each lane.
    const int sp = (i - 1) & 15;
    int z = NEG_INF, prevP = NEG_INF;
    for (int k = 0; k < cnt; ++k) {
      const int v = v0 + k;
      int dn, sn, pp;
      const int c2 = cell(v, dn, sn, pp);
      if (k > 0) z = k == 1 ? prevP + hg : imax(prevP + hg, z + g);
      const int In = k == 0 ? E : imax(z, E + k * g);
      const int cm = imax(In, pp);
      const unsigned code = cm == sn ? 0u : cm == In ? 1u : cm == dn ? 2u : 3u;
      unsigned* word = dp + (size_t)((i - 1) >> 4) * V + v;
      *word = (sp == 0 ? 0u : *word) | (code << (2 * sp));
      if (i == m_p && v == v_p) score[p] = cm;
      An[slot(v)] = imax(imax(In, sn) + hg, dn + g);
      Mn[slot(v)] = cm;
      Sw[slot(v)] = c2;
      prevP = pp;
    }
    __syncthreads();
  }
}

template <int LPT>
void launch(const void* s1c, const void* s2in, const void* flags,
            const void* s2init, const void* probe, void* dirs, void* score,
            int B, int R, int V, int Vc, int KW, int sm, int sx, int st,
            int kimura, int g, int h, cudaStream_t s) {
  const int threads = ((Vc / LPT + 31) / 32) * 32;
  banded_kernel<LPT><<<B, threads, 0, s>>>(
      (const int*)s1c, (const int*)s2in, (const int*)flags, (const int*)s2init,
      (const int*)probe, (unsigned*)dirs, (int*)score, R, V, Vc, KW, sm, sx, st,
      kimura, g, h);
}

}  // namespace

// Vc: the lanes computed and stored (a multiple of 32, <= V); V: the row
// stride of dirs and s2init. scratch: for Vc > 32,768 (the wide form), B x 6
// x 1,024 x ceil(Vc / 1,024) ints; else unused.
extern "C" int gotoh_banded_launch(const void* s1c, const void* s2in,
                                   const void* flags, const void* s2init,
                                   const void* probe, void* dirs, void* score,
                                   void* scratch, int B, int R, int V, int Vc,
                                   int KW, int sm, int sx, int st, int kimura,
                                   int g, int h, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || R < 1 || Vc < 32 || (Vc & 31) || Vc > V || (V & 3) || KW < (R + 15) / 16)
    return (int)cudaErrorInvalidValue;
  if (Vc <= 512 * 8) {
    launch<8>(s1c, s2in, flags, s2init, probe, dirs, score, B, R, V, Vc, KW, sm, sx, st, kimura, g, h, s);
  } else if (Vc <= 512 * 16) {
    launch<16>(s1c, s2in, flags, s2init, probe, dirs, score, B, R, V, Vc, KW, sm, sx, st, kimura, g, h, s);
  } else if (Vc <= 1024 * 32) {
    launch<32>(s1c, s2in, flags, s2init, probe, dirs, score, B, R, V, Vc, KW, sm, sx, st, kimura, g, h, s);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    banded_wide_kernel<<<B, WIDE_THREADS, 0, s>>>(
        (const int*)s1c, (const int*)s2in, (const int*)flags, (const int*)s2init,
        (const int*)probe, (unsigned*)dirs, (int*)score, (int*)scratch, R, V, Vc,
        KW, sm, sx, st, kimura, g, h);
  }
  return (int)cudaGetLastError();
}
