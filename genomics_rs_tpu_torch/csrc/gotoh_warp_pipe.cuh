// The warp-strip pipeline sweep, shared by K9 and K16 (gotoh_pallas.cu),
// K3 (gotoh_stream.cu) and the matrix fill K13/K14 (gotoh_matrix.cu): every
// column of every row; and by K10 and K12 (gotoh_banded.cu: a band of V
// columns a row). Cell recurrence, the substitution policies' contract
// (CharSub; the matrix fill's ProfileSub), global boundary (GlobalEdge) and
// the pipeline's waits (wait_geq) are gotoh_stream_body.cuh's.
//
// Contract, per pair p of a batch (true lengths m_p, n_p), over the cells the
// geometry policy gives:
//   FullRows  rows 0..m_p x columns 0..n_p (K9, K16, K3, the matrix fill):
//             res[3p .. 3p+2] is the global (score at (m_p, n_p), m_p, n_p),
//             or the local keep-last row-major argmax (v, i, j) (larger v,
//             then larger i, then that row's larger j); with DIAG16 (K3 and
//             the matrix fill with dirs) also the diag16 codes of every true
//             cell, dirs[(p*KW + (i+j)/16) * DV + i] bits 2*((i+j)%16)
//             (S > I > D > STOP; STOP where the local cell max is below 0,
//             and at row 0 off the corner in local mode); words with no true
//             cell stay as the caller left them (zero);
//   BandRows  rows 1..m_p, row i's band columns off(i)+1 .. off(i)+V (off
//             planned by the host, int32, rising by 0 or 1 a row), every
//             other cell -inf, column 0 and row 0 the global boundary (K10,
//             K12; global only): the codes (S > I > D > STOP) of every true
//             in-band cell, dirs[(p*KW + (i-1)/16) * V + v] bits 2*((i-1)%16)
//             with v = j - off(i) - 1, and score[p] = M at (m_p, n_p). Cells
//             past n_p or m_p are not computed; their code bits stay as the
//             caller left them (zero).
//
// Design. A strip is one warp of H = 32*RT rows: lane l holds rows
// first + l*RT .. first + l*RT + RT - 1 in registers (their s1 characters,
// I and max(S, D) of the left cell, M of the up-left cell). Each step, lane l
// takes one column, j = lo + q - l: it computes its RT cells top-down, row k
// reading A and M of row k-1 in the same column from registers, and row 0
// reading lane l-1's last row, which that lane computed the step before, by
// __shfl_up_sync. So the lanes run one column apart and a strip takes its
// width + 31 steps; there is no block barrier anywhere. The s2 character
// travels down the lanes with the row values; the warp loads the top row
// (the strip above's bottom row, from the ring) and the characters 32
// columns at a time, a chunk ahead, and lane 0 takes its column by shuffle.
//   - Hand-off between strips is K9's: persistent one-warp blocks take
//     (pair, strip) tickets level by level (strip 0 of every pair, then
//     strip 1, ...), so a strip waits only on an earlier ticket, which is
//     running or done; lane 31 stores the strip's bottom row (A and M) in a
//     ring slot of the pair and publishes its column count with release
//     semantics every WARP_CHUNK columns; lane 0 of the strip below waits
//     with acquire semantics before each chunk load; a slot is written again
//     once the strip that read it has released it. A slot holds a producer's
//     columns lo .. hi at [column - lo]; a column past the producer's hi is
//     -inf (a band strip reaches up to H columns further right).
//   - No hang: every producer bumps the launch's heartbeat each BEAT_COLS
//     published columns and at its last, and a wait fails only when neither
//     its flag nor the heartbeat moved for a whole bound; then the launch's
//     error word is set, every warp leaves and the wrapper raises.
//   - Blocks of one warp. Each warp takes its own ticket, so no warp waits
//     for another at a barrier, and the kernels need more than 64 registers
//     a thread, so an SM holds fewer than 32 of their warps: one-warp blocks
//     reach the same occupancy as larger ones without a shared ticket. The
//     host cuts the grid to the strips that can sweep at once (a warp past
//     them only spins on its predecessor, and spinning warps slow the
//     sweeping ones).
//   - One step form: off column 0 and before the strip's last column a
//     lane's step is straight-line code (band edges by selects, rows past m
//     computed and never read, row 0 computed from -inf fed from above), so
//     a warp rarely runs both forms of the step at once.
//   - Diag16 codes (FullRows): a code word holds 16 consecutive columns of
//     one row, and a row is one lane's for the whole sweep, so each lane
//     fills one word a row in a register, a funnel shift a cell (the code
//     enters at the top, so 16 cells later the word is whole and older
//     codes are gone: no reset), and stores it where (i+j) % 16 == 15, at
//     most one row of a lane a step (a predicated store in the one step
//     form, no staging), or at j = n_p shifted down; rows past m_p never.
//   - Local mode: a row's cells come in column order, so each row keeps its
//     own keep-last best (>=); once a strip, the rows are merged into the
//     lane's best by (v, i, j) (`better`), the lanes by a warp reduction,
//     and the pair's last strip to finish (an atomic count) merges the
//     strips' bests.
//   - Band: the strip visits columns off(first)..min(off(last) + V, n_p);
//     a cell outside its row's band is -inf (A = M = I = max(S, D) = -inf,
//     its up-left M carried on), as the band fill's out-of-band lanes are.
//     RT = 4, so a code word's 16 rows fill G = 4 lanes. A row's code for
//     band lane v arrives at column off(i) + v + 1, so word v fills over up
//     to 16 columns: the G lanes stage the words in flight in shared
//     memory by atomic OR (32 slots a group, v mod 32), and the lane with
//     the group's last row stores word v once that row has passed column
//     off(last) + v + 1 (the other lanes passed it in earlier steps), the
//     rest at the strip's end.
//
// What bounds it: integer issue (12 ops a cell global, 19 local, +9 with
// codes; the profile substitution one L1/L2 load a cell) in aggregate; for
// one pair, a warp that is nearly alone on its SM issuing one step of RT
// chained cells (A and M pass down the rows), six shuffles and the lane-31
// hand-off: ~0.3 us a step at RT = 8 on the H100
// (PERF.md). A pair's strips start about 31 + 2*WARP_CHUNK steps apart (the
// lane skew and the lookahead), and a band strip another H*n/m steps (the
// band moves right as it goes down).

#pragma once

#include <type_traits>

#include "gotoh_stream_body.cuh"

namespace {

constexpr unsigned WFULL = 0xffffffffu;
//: columns a warp strip publishes at once; also its lookahead unit.
constexpr int WARP_CHUNK = 32;
//: a producer bumps the heartbeat once every this many published columns.
constexpr int BEAT_COLS = 256;

// Every column 0..n of every row 0..m (K9, K16).
struct FullRows {
  static constexpr int ROW0 = 0;
  static constexpr bool BAND = false;
  __device__ __forceinline__ int off(int) const { return 0; }
  __device__ __forceinline__ int lo(int) const { return 0; }
  __device__ __forceinline__ int hi(int, int n) const { return n; }
};

// Row i's band, columns off(i)+1 .. off(i)+V, rows 1..m (K10, K12). A strip
// of rows first..last visits columns off(first) .. min(off(last) + V, n).
struct BandRows {
  static constexpr int ROW0 = 1;
  static constexpr bool BAND = true;
  const int* offs;  // off(i) at offs[i - 1]
  int V;
  __device__ __forceinline__ int off(int i) const { return __ldg(offs + i - 1); }
  __device__ __forceinline__ int lo(int first) const { return off(first); }
  __device__ __forceinline__ int hi(int last, int n) const { return min(off(last) + V, n); }
};

// The host's plan of one launch (int32 arrays on the device).
struct PipePlan {
  const int* ms;           // [B] true lengths
  const int* ns;           // [B]
  const int* strip0;       // [B+1] pair p's strips are ids strip0[p] .. strip0[p+1]-1
  const int* level_start;  // [nlevels+1] first ticket of strip level s
  const int* by_strips;    // [B] pairs by strip count, descending
  const int* slot0;        // [B] pair p's first ring slot
  const int* slots;        // [B] its ring slots (0 for a one-strip pair)
  int B, nlevels, total;
};

//: ints before the per-strip arrays of the workspace: ticket, error word,
//: heartbeat.
constexpr int PIPE_WORK_HEAD = 3;

// The launch's zeroed workspace, in this order: ticket, error word,
// heartbeat, progress[total], released[total], finished[B], best[3 * total].
struct PipeWork {
  int* ticket;
  int* err;
  int* beat;
  int* progress;
  int* released;
  int* finished;
  int* best;

  __device__ __host__ static PipeWork of(int* w, int total, int B) {
    PipeWork pw;
    pw.ticket = w;
    pw.err = w + 1;
    pw.beat = w + 2;
    pw.progress = w + PIPE_WORK_HEAD;
    pw.released = pw.progress + total;
    pw.finished = pw.released + total;
    pw.best = pw.finished + B;
    return pw;
  }
};

template <class Geom, class Sub = CharSub>
struct WarpPipe {
  Sub sub;          // the substitution: encoded characters and scores, or a profile
  Geom geom;
  PipePlan plan;
  PipeWork work;
  int* ring;        // slots of 2 * slotw ints: A at [0, slotw), M at [slotw, 2 slotw)
  int slotw;
  int g, h;
  unsigned long long bound;  // wait_geq's bound (ns)
  int* res;         // FullRows: (score, i, j) a pair
  unsigned* dirs;   // code words: BandRows (B, KW, V); FullRows with DIAG16 (B, KW, DV)
  int* score;       // BandRows: M at (m_p, n_p)
  int KW;
  int DV;           // FullRows: a code word row's lanes
};

// Sweep strip s of pair p. False when a wait failed (every lane returns).
template <bool LOCAL, int RT, bool DIAG16, class Geom, class Sub>
__device__ __forceinline__ bool warp_strip(const WarpPipe<Geom, Sub>& a, int p, int s,
                                           unsigned* stage) {
  constexpr int H = 32 * RT;
  constexpr bool BAND = Geom::BAND;
  static_assert(!BAND || RT == 4, "the band sweep holds 4 rows a lane (BAND_RT)");
  static_assert(!(BAND && DIAG16), "the band's codes have their own layout");
  constexpr int G = BAND ? 16 / RT : 1;  // lanes that share a code word
  static_assert(!(BAND && LOCAL), "the band fill is global");
  const int l = threadIdx.x & 31;
  const PipePlan& plan = a.plan;
  const int m = __ldg(plan.ms + p), n = __ldg(plan.ns + p);
  const int gid = __ldg(plan.strip0 + p) + s;
  const int nst = __ldg(plan.strip0 + p + 1) - __ldg(plan.strip0 + p);
  const int nslots = __ldg(plan.slots + p);
  const size_t slot_ints = 2 * (size_t)a.slotw;
  int* ring_p = a.ring + (size_t)__ldg(plan.slot0 + p) * slot_ints;
  const int* up = s > 0 ? ring_p + (size_t)((s - 1) % nslots) * slot_ints : nullptr;
  int* down = s + 1 < nst ? ring_p + (size_t)(s % nslots) * slot_ints : nullptr;
  // The slot this strip writes was last read by strip s - nslots + 1.
  int ok = 1;
  if (l == 0 && down != nullptr && s >= nslots)
    ok = wait_geq(a.work.released + gid - nslots + 1, 1, a.work.err, a.work.beat, a.bound);
  if (!__shfl_sync(WFULL, ok, 0)) return false;

  const int g = a.g, h = a.h, hg = g + h;
  const int first = Geom::ROW0 + s * H;
  const int last = min(first + H - 1, m);
  const int lo = a.geom.lo(first), hi = a.geom.hi(last, n);
  // The strip above: its columns plo..phi, and the last of them read here.
  const int plo = s > 0 ? a.geom.lo(first - H) : 0;
  const int phi = s > 0 ? a.geom.hi(first - 1, n) : -1;
  const int need_hi = min(hi, phi);
  const int i0 = first + l * RT;           // this lane's first row
  const int kreal = min(RT, m - i0 + 1);   // its rows in the pair (<= 0: none)

  typename Sub::template Lane<RT> sl;      // the rows' substitution state
  a.sub.lane(sl, p, i0, kreal);
  int Il[RT], Pl[RT], dM[RT], rv[RT], rj[RT], off[RT];
  unsigned acc[RT];  // DIAG16: each row's code word in flight
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    const int i = i0 + k;
    const bool real = k < kreal;
    Il[k] = Pl[k] = dM[k] = NEG_INF;
    rv[k] = INT_MIN_V;
    rj[k] = 0;
    acc[k] = 0;
    off[k] = (BAND && real) ? a.geom.off(i) : 0;
  }
  unsigned* const dq = DIAG16 ? a.dirs + (size_t)p * a.KW * a.DV : nullptr;
  const int off_last = (BAND && kreal > 0) ? a.geom.off(i0 + kreal - 1) : 0;
  // BAND: this lane's code words (its group of G lanes shares them), the
  // group's staging column, the rows' bit base in a word, and whether this
  // lane holds the group's last row (it stores the words).
  unsigned* dp = nullptr;
  const int gl = l & ~(G - 1);
  const int bit0 = 2 * ((l * RT) & 15);
  const bool completer = kreal > 0 && ((l & (G - 1)) == G - 1 || i0 + RT > m);
  if constexpr (BAND) {
    dp = a.dirs + ((size_t)p * a.KW + (i0 - 1) / 16) * a.geom.V;
#pragma unroll 4
    for (int u = 0; u < 32; ++u) stage[u * 32 + l] = 0;
    __syncwarp();
  }

  // Top-row columns c0 .. c0 + 31 (lane t: column c0 + t) and their s2
  // characters; releases the slot above once its last needed column is in.
  auto load = [&](int c0, int& A, int& M, int& C) -> bool {
    if (c0 > hi) return true;
    const bool reads_up = s > 0 && c0 <= need_hi;
    if (reads_up) {
      int got = 1;
      if (l == 0)
        got = wait_geq(a.work.progress + gid - 1, min(c0 + WARP_CHUNK, phi + 1), a.work.err,
                       a.work.beat, a.bound);
      if (!__shfl_sync(WFULL, got, 0)) return false;
      __syncwarp();  // lane 0's acquire orders the warp's loads below
    }
    const int c = c0 + l;
    if (c <= hi) {
      if (s > 0) {
        A = c <= phi ? __ldcg(up + c - plo) : NEG_INF;  // L2: L1 is not coherent
        M = c <= phi ? __ldcg(up + a.slotw + c - plo) : NEG_INF;
      } else if (Geom::ROW0 == 1) {  // row 0 of the global boundary
        int I, S, D;
        GlobalEdge{}.top(c, g, h, I, S, D);
        M = imax(imax(I, S), D);
        A = imax(imax(I, S) + hg, D + g);
      } else {  // above row 0: -inf, so the interior step gives row 0 itself
        A = M = NEG_INF;
      }
      if constexpr (Sub::COLS) C = a.sub.col(sl, c);
    }
    if (reads_up && c0 + WARP_CHUNK > need_hi) {  // the slot above is read: free it
      __syncwarp();
      if (l == 0) {
        __threadfence();
        st_release(a.work.released + gid, 1);
      }
    }
    return true;
  };

  const bool writes_down = l == 31 && down != nullptr;
  int curA = 0, curM = 0, curC = 0, nxtA = 0, nxtM = 0, nxtC = 0;
  if (!load(lo, curA, curM, curC) || !load(lo + WARP_CHUNK, nxtA, nxtM, nxtC)) return false;
  int lastA = 0, lastM = 0, myC = 0;  // this lane's last row and character, last step
  const int nsteps = hi - lo + 32;
  for (int q = 0; q < nsteps; ++q) {
    if (q > 0 && (q & 31) == 0) {
      curA = nxtA;
      curM = nxtM;
      curC = nxtC;
      if (!load(lo + q + WARP_CHUNK, nxtA, nxtM, nxtC)) return false;
    }
    // The column's travelling value (s2's character) shuffles beside A and
    // M, in this order: the first row's S waits on it.
    int tC = 0, inC = 0;
    const int tA = __shfl_sync(WFULL, curA, q & 31);
    const int tM = __shfl_sync(WFULL, curM, q & 31);
    if constexpr (Sub::COLS) tC = __shfl_sync(WFULL, curC, q & 31);
    const int inA = __shfl_up_sync(WFULL, lastA, 1);
    const int inM = __shfl_up_sync(WFULL, lastM, 1);
    if constexpr (Sub::COLS) inC = __shfl_up_sync(WFULL, myC, 1);
    const int j = lo + q - l;
    int uA = l == 0 ? tA : inA;
    int uM = l == 0 ? tM : inM;
    const int c2 = l == 0 ? tC : inC;
    myC = c2;
    // DIAG16: the lane's row that completes a word this step, the one with
    // (i+j) % 16 == 15 (at most one of RT <= 16 consecutive rows; -1 if none
    // or past m), and that word row's first word, for the straight-line step.
    int kst = -1;
    unsigned* wrow = nullptr;
    if constexpr (DIAG16) {
      kst = 15 - ((i0 + j) & 15);
      if (kst >= kreal) kst = -1;
      wrow = dq + (size_t)((i0 + j) >> 4) * a.DV + i0;
    }
    auto rows = [&](auto interior) {
      constexpr bool IN = decltype(interior)::value;
#pragma unroll
      for (int k = 0; k < RT; ++k) {
        if (!IN && k >= kreal) break;
        const int i = i0 + k;
        if constexpr (BAND) {
          if (!IN && j != 0 && (j <= off[k] || j > off[k] + a.geom.V)) {
            dM[k] = uM;  // outside row i's band: -inf
            Il[k] = Pl[k] = uA = uM = NEG_INF;
            continue;
          }
        }
        const int upA = uA, upM = uM;
        int I, S, D, M, A;
        const int M0 = gotoh_cell<LOCAL, IN>(
            i, j, g, h,
            [&](int& x, int& y) {
              x = upA;
              y = upM;
            },
            [&] { return a.sub.at(sl, k, c2); }, Il[k], Pl[k], dM[k], I, S, D, M, A);
        // The corner's I must not extend along row 0 (I(0, j) = h + j*g):
        // then the interior step, fed -inf from above, computes row 0.
        if (!IN && i == 0 && j == 0) Il[k] = NEG_INF;
        bool inb = true;  // a true row's cell in its band (BAND)
        if constexpr (BAND) {
          if (IN) {  // outside the band: -inf, as the slow path makes it
            inb = j > off[k] && j <= off[k] + a.geom.V;
            if (!inb) A = M = Il[k] = Pl[k] = NEG_INF;
            inb = inb && k < kreal;  // a row past m stages no code
          }
        }
        uA = A;
        uM = M;
        if constexpr (DIAG16) {
          // Tested against the pre-floor max M0: ptxas (CUDA 12.9, -O1 and
          // up) miscompiled K1's `M == D` after the fused max-with-zero in
          // local mode, found only on the card. In the straight-line step
          // M0 is one of S, I, D (and >= I >= 0 in local mode), so only
          // row 0 can stop there: it comes from -inf fed from above, where
          // the local floor makes I = 0, and its code is the boundary's
          // STOP (I(0, j) = h + j*g < 0), as the corner's is S.
          unsigned code;
          if (IN) {
            code = M0 == S ? 0u : M0 == I ? 1u : 2u;
            if (LOCAL && k == 0 && i0 == 0) code = 3u;
          } else {
            code = (LOCAL && (M0 < 0 || (i == 0 && j != 0))) ? 3u
                   : (M0 == S)                                 ? 0u
                   : (M0 == I)                                 ? 1u
                   : (M0 == D)                                 ? 2u
                                                               : 3u;
          }
          // The word fills from the top: after the cell with (i+j) % 16 ==
          // 15 the last 16 codes sit at bits 2*((i+j)%16), older ones
          // shifted out (a row's first word fills from the zeroed start).
          acc[k] = __funnelshift_r(acc[k], code, 2);
          if (IN) {
            if (k == kst) wrow[k] = acc[k];  // rows past m never match kst
          } else {
            const int d = i + j, sp = d & 15;
            if (sp == 15 || j == n)  // the row's last word may end early
              dq[(size_t)(d >> 4) * a.DV + i] = acc[k] >> (2 * (15 - sp));
          }
        }
        if constexpr (LOCAL) {
          if (M >= rv[k]) {  // a row's cells come in column order: keep-last
            rv[k] = M;
            rj[k] = j;
          }
        } else if constexpr (BAND) {
          if (IN ? inb : j != 0) {
            const unsigned code = M0 == S ? 0u : M0 == I ? 1u : M0 == D ? 2u : 3u;
            const int v = j - off[k] - 1;
            // An atomic OR: the rows' words may alias (and the group's
            // lanes share them), and a plain read-modify-write would
            // chain them one after another.
            atomicOr(stage + (v & 31) * 32 + gl, code << (bit0 + 2 * k));
          }
          if (!IN && i == m && j == n) a.score[p] = M0;
        } else {
          if (!IN && i == m && j == n) {
            a.res[3 * p] = M;
            a.res[3 * p + 1] = m;
            a.res[3 * p + 2] = n;
          }
        }
      }
    };
    // Off column 0 and before the last column, a lane's step is
    // straight-line code (band edges by selects; rows past m compute what
    // nothing reads), so the warp does not run both forms at once.
    const bool act = kreal > 0 && j >= lo && j <= hi;
    if (act) {
      if (j >= 1 && j < hi)
        rows(std::true_type{});
      else
        rows(std::false_type{});
      lastA = uA;
      lastM = uM;
      a.sub.next(sl, p, j, n);  // the next column's substitution, ahead
    }
    if (writes_down && act) {  // lane 31 of a strip with a successor (a full one)
      down[j - lo] = uA;
      down[a.slotw + j - lo] = uM;
      const int done = j - lo + 1;
      if (done % WARP_CHUNK == 0 || j == hi) {
        st_release(a.work.progress + gid, j + 1);  // orders this lane's row stores
        if (done % BEAT_COLS == 0 || j == hi) atomicAdd(a.work.beat, 1);
      }
    }
    if constexpr (BAND) {  // word j - off(last) - 1 has its last row's code
      __syncwarp();  // the group's earlier lanes' codes are in
      const int vd = j - off_last - 1;
      if (act && completer && vd >= 0 && vd < a.geom.V) {
        unsigned* w = stage + (vd & 31) * 32 + gl;
        dp[vd] = *w;
        *w = 0;
      }
    }
  }

  if constexpr (BAND) {  // the words still in flight: cells past hi stay zero
    const int off_first = __shfl_sync(WFULL, off[0], gl);  // the group's first row
    __syncwarp();
    if (completer) {
      const int vmax = min(hi - off_first - 1, a.geom.V - 1);
      for (int v = max(hi - off_last, 0); v <= vmax; ++v) {
        unsigned* w = stage + (v & 31) * 32 + gl;
        dp[v] = *w;
        *w = 0;
      }
    }
  }
  if constexpr (LOCAL) {
    // Rows into the lane's best, lanes by a reduction; lane 0 owns the
    // strip's first row, a true row, so the strip has a cell >= 0.
    int bv = INT_MIN_V, bi = -1, bj = 0;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      if (k < kreal && better(rv[k], i0 + k, rj[k], bv, bi, bj)) {
        bv = rv[k];
        bi = i0 + k;
        bj = rj[k];
      }
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      const int ov = __shfl_xor_sync(WFULL, bv, d);
      const int oi = __shfl_xor_sync(WFULL, bi, d);
      const int oj = __shfl_xor_sync(WFULL, bj, d);
      if (better(ov, oi, oj, bv, bi, bj)) {
        bv = ov;
        bi = oi;
        bj = oj;
      }
    }
    if (l == 0) {
      PipeWork w = a.work;
      w.best[3 * gid] = bv;
      w.best[3 * gid + 1] = bi;
      w.best[3 * gid + 2] = bj;
      __threadfence();
      if (atomicAdd(w.finished + p, 1) == nst - 1) {  // the pair's last strip: merge
        __threadfence();
        int V = INT_MIN_V, I = -1, J = 0;
        for (int u = __ldg(plan.strip0 + p); u < __ldg(plan.strip0 + p + 1); ++u) {
          const int uv = __ldcg(w.best + 3 * u), ui = __ldcg(w.best + 3 * u + 1),
                    uj = __ldcg(w.best + 3 * u + 2);
          if (better(uv, ui, uj, V, I, J)) {
            V = uv;
            I = ui;
            J = uj;
          }
        }
        a.res[3 * p] = V;
        a.res[3 * p + 1] = I;
        a.res[3 * p + 2] = J;
      }
    }
  }
  return true;
}

// Persistent one-warp blocks: each takes a ticket, sweeps that strip and
// takes the next, until the tickets run out or the error word is set.
template <bool LOCAL, int RT, bool DIAG16, class Geom, class Sub>
__global__ void __launch_bounds__(32) warp_pipe_kernel(const WarpPipe<Geom, Sub> a) {
  __shared__ unsigned stage[Geom::BAND ? 32 * 32 : 1];  // [v mod 32][lane]
  const int l = threadIdx.x;
  for (;;) {
    int tk = 0;
    if (l == 0) tk = *(volatile int*)a.work.err ? a.plan.total : atomicAdd(a.work.ticket, 1);
    tk = __shfl_sync(WFULL, tk, 0);
    if (tk >= a.plan.total) return;
    int lv = 0, top = a.plan.nlevels;  // the level holding ticket tk
    while (top - lv > 1) {
      const int mid = (lv + top) >> 1;
      if (__ldg(a.plan.level_start + mid) <= tk) lv = mid;
      else top = mid;
    }
    const int p = __ldg(a.plan.by_strips + tk - __ldg(a.plan.level_start + lv));
    if (!warp_strip<LOCAL, RT, DIAG16>(a, p, lv, stage)) return;
  }
}

// One-warp blocks of the kernel an SM holds (the wrappers size the
// persistent grid and the ring from it); a negative cudaError on failure.
template <bool LOCAL, int RT, class Geom, class Sub = CharSub, bool DIAG16 = false>
int warp_pipe_blocks_per_sm() {
  int nb = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, warp_pipe_kernel<LOCAL, RT, DIAG16, Geom, Sub>, 32, 0);
  return e == cudaSuccess ? nb : -(int)e;
}

template <bool LOCAL, int RT, bool DIAG16 = false, class Geom, class Sub>
int warp_pipe_launch(const WarpPipe<Geom, Sub>& a, int blocks, cudaStream_t s) {
  warp_pipe_kernel<LOCAL, RT, DIAG16, Geom, Sub><<<blocks, 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// FullRows at a run-time strip height (rows_per_lane in 1, 2, 4, 8, 16),
// mode and output: the kernels of K3 and the matrix fill, each policy with
// its 20 compiled forms.
template <class Sub, bool LOCAL, bool DIAG16>
int full_rows_blocks_per_sm_(int rt) {
  switch (rt) {
    case 1: return warp_pipe_blocks_per_sm<LOCAL, 1, FullRows, Sub, DIAG16>();
    case 2: return warp_pipe_blocks_per_sm<LOCAL, 2, FullRows, Sub, DIAG16>();
    case 4: return warp_pipe_blocks_per_sm<LOCAL, 4, FullRows, Sub, DIAG16>();
    case 8: return warp_pipe_blocks_per_sm<LOCAL, 8, FullRows, Sub, DIAG16>();
    case 16: return warp_pipe_blocks_per_sm<LOCAL, 16, FullRows, Sub, DIAG16>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

template <class Sub>
int full_rows_blocks_per_sm(int rt, int is_local, int diag16) {
  if (is_local)
    return diag16 ? full_rows_blocks_per_sm_<Sub, true, true>(rt)
                  : full_rows_blocks_per_sm_<Sub, true, false>(rt);
  return diag16 ? full_rows_blocks_per_sm_<Sub, false, true>(rt)
                : full_rows_blocks_per_sm_<Sub, false, false>(rt);
}

template <bool LOCAL, bool DIAG16, class Sub>
int full_rows_launch_(const WarpPipe<FullRows, Sub>& a, int rt, int blocks, cudaStream_t s) {
  switch (rt) {
    case 1: return warp_pipe_launch<LOCAL, 1, DIAG16>(a, blocks, s);
    case 2: return warp_pipe_launch<LOCAL, 2, DIAG16>(a, blocks, s);
    case 4: return warp_pipe_launch<LOCAL, 4, DIAG16>(a, blocks, s);
    case 8: return warp_pipe_launch<LOCAL, 8, DIAG16>(a, blocks, s);
    case 16: return warp_pipe_launch<LOCAL, 16, DIAG16>(a, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch with diag16 codes when a.dirs is set.
template <class Sub>
int full_rows_launch(const WarpPipe<FullRows, Sub>& a, int rt, int is_local, int blocks,
                     cudaStream_t s) {
  const bool diag16 = a.dirs != nullptr;
  if (is_local)
    return diag16 ? full_rows_launch_<true, true>(a, rt, blocks, s)
                  : full_rows_launch_<true, false>(a, rt, blocks, s);
  return diag16 ? full_rows_launch_<false, true>(a, rt, blocks, s)
                : full_rows_launch_<false, false>(a, rt, blocks, s);
}

// The plan's int32 array [ms(B), ns(B), strip0(B+1), level_start(nlevels+1),
// by_strips(B), slot0(B), slots(B)] as a PipePlan.
__host__ inline PipePlan pipe_plan_of(const int* pl, int B, int nlevels, int total) {
  PipePlan pp;
  pp.ms = pl;
  pp.ns = pl + B;
  pp.strip0 = pl + 2 * B;
  pp.level_start = pl + 3 * B + 1;
  pp.by_strips = pp.level_start + nlevels + 1;
  pp.slot0 = pp.by_strips + B;
  pp.slots = pp.slot0 + B;
  pp.B = B;
  pp.nlevels = nlevels;
  pp.total = total;
  return pp;
}

}  // namespace
