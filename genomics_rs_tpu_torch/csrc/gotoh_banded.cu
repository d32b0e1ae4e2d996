// Banded Gotoh fill for Hopper (sm_90a) on the warp-strip pipeline, bound by
// ctypes.
//
// Replaces two TPU kernels with one:
//   K10  genomics_rs_tpu/ops/gotoh_banded.py, _banded_call (body
//        _kernel_banded, pallas_call at :373): one pair, its own window;
//   K12  genomics_rs_tpu/ops/gotoh_banded_batch.py, _banded_batch_call (body
//        _kernel_banded8, pallas_call at :303): B pairs under one window
//        planned from the batch's (max m, max n).
// K10 is this launch at B = 1. Contract, per pair p (global mode only): lane
// v of row i holds column off(i) + v + 1, off planned by the host from the
// window (M, N) (int64 there, int32 here), rising by 0 or 1 a row. The D
// carry of a lane is the cell above's A = max(max(I, S) + h + g, D + g), its
// S adds the substitution to the up-left cell's M, and I is the (max,+)
// chain along the row; a predecessor outside the band is -inf, and column 0
// (while off(i) = 0) and row 0 are the global boundary. Codes (S > I > D >
// STOP) pack 16 rows to a word: dirs[p, (i-1)/16, v], bits 2*((i-1)%16), for
// every true in-band cell (i <= m_p, j <= n_p), the last row's partial word
// included; score[p] = M at (m_p, n_p), the probe lane v_p = n_p -
// off(m_p) - 1. Cells past m_p or n_p are not computed (their bits stay as
// the caller zeroed them): no true cell depends on them.
//
// Design. The band is the full Gotoh table with its out-of-band cells at
// -inf, so it is gotoh_warp_pipe.cuh's sweep under BandRows: a strip is one
// warp of 128 rows (RT = 4 rows a lane, so a code word's 16 rows fill 4
// lanes), visiting only the columns off(first) .. min(off(last) + V, n_p)
// of its rows' bands; the strips of one pair run on many SMs, each fed the
// strip above's bottom row through a ring slot of V + 128 columns, so one
// kernel serves every V. A word's lanes stage the words still filling
// (their rows reach band lane v over up to 16 columns as the band slides)
// in shared memory by atomic OR, and the lane with the word's last row
// stores each once complete. The TPU kernel's (8, C) pane and its I-chain
// rolls become the sweep's chained column step.
//
// What bounds it: a pair's dependent chain. A strip of H = 32*RT rows starts
// about H * n/m + 95 columns after the one above (the band moves right as
// it goes down, plus the lane skew and lookahead), and each step is RT
// chained cells on a warp nearly alone on its SM: so about m (1 + 95 / H)
// steps a pair, a few strips in flight per pair, with the card's integer
// rate bounding only large batches. Device memory traffic is 2 bits a band
// cell.

#include "gotoh_warp_pipe.cuh"

namespace {

//: rows a lane of the band sweep holds (4 was faster than 8 and 16 on the
//: H100: PERF.md).
constexpr int BAND_RT = 4;

}  // namespace

// One-warp blocks of the band sweep an SM holds.
extern "C" int gotoh_banded_blocks_per_sm() {
  return warp_pipe_blocks_per_sm<false, BAND_RT, BandRows>();
}

// s1c (B, Lm), s2c (B, Ln): encoded characters; offs: off(i) for rows 1..M
// (int32); plan: the strip plan at 32 * BAND_RT rows a strip, rows from 1
// (as gotoh_pallas_launch's); work: zeroed int32 [PIPE_WORK_HEAD + 5*total +
// B]; ring: the plan's slots of 2 * slotw ints (slotw >= the
// widest strip's columns); dirs: (B, KW, V) zeroed; score: (B,).
extern "C" int gotoh_banded_launch(
    const void* s1c, const void* s2c, const void* offs, const void* plan, void* work,
    void* ring, void* dirs, void* score, int B, int Lm, int Ln, int V, int KW, int nlevels,
    int total, int slotw, int sm, int sx, int st, int kimura, int g, int h, int blocks,
    long long spin_ns, void* stream) {
  if (B < 1 || nlevels < 1 || total < 1 || blocks < 1 || spin_ns < 1 || V < 1 ||
      slotw < 1 || KW < 1)
    return (int)cudaErrorInvalidValue;
  WarpPipe<BandRows> a{};
  a.sub = CharSub{(const int*)s1c, (const int*)s2c, Lm, Ln, sm, sx, st, kimura};
  a.geom = BandRows{(const int*)offs, V};
  a.plan = pipe_plan_of((const int*)plan, B, nlevels, total);
  a.work = PipeWork::of((int*)work, total, B);
  a.ring = (int*)ring;
  a.slotw = slotw;
  a.g = g;
  a.h = h;
  a.bound = (unsigned long long)spin_ns;
  a.dirs = (unsigned*)dirs;
  a.score = (int*)score;
  a.KW = KW;
  return warp_pipe_launch<false, BAND_RT>(a, blocks, (cudaStream_t)stream);
}
