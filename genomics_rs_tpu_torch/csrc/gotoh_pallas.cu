// Batched Gotoh scores for Hopper (sm_90a) by the warp-strip pipeline: one
// pair's row strips run on many SMs at once. Bound by ctypes.
//
// Replaces: genomics_rs_tpu/ops/gotoh_pallas.py, gotoh_scores_pallas_batch
// (body _kernel_batch, pallas_call at :1309; K9), and the row-blocked entry
// gotoh_scores_blocked (:826; K16), which is this launch at its own strip
// height. Same contract as K3 (gotoh_stream_body.cuh) without dirs: for every
// pair p of a padded batch, the global score at (m_p, n_p) or the local
// keep-last row-major argmax (v, i, j), classic or kimura scoring, empty
// sequences allowed.
//
// Design. The TPU kernel runs each pair as one flat anti-diagonal over a
// V-lane vector, one pair per grid row, in order on one core. On Hopper a
// lone long pair (the "pallas" tier's own case, B = 1 past 8 kb) has to use
// many SMs: every strip of 32*RT rows is one warp's work in
// gotoh_warp_pipe.cuh's sweep (FullRows), lane l holding RT rows in
// registers, the lanes one column apart, no block barrier; strip s starts as
// soon as strip s-1 has published the first chunks of its bottom row, so the
// 29.9 kb pair at RT = 8 keeps all its 117 strips in flight. Persistent
// one-warp blocks take (pair, strip) tickets level by level; a ring of
// boundary rows per pair, sized by the host from the occupancy, carries the
// rows between strips; a wait that sees nothing of the launch move for the
// bound sets the error word, and the wrapper raises. RT is a launch
// argument (1, 2, 4, 8 or 16; each its own compiled kernel).
//
// What bounds it: integer issue (12 ops a cell global, 19 local) and, per
// warp, a step of RT chained cells and six shuffles; the pipeline adds a
// lag of about 31 + 2 x 32 columns a strip and an L2 poll and a 32-column
// load every 32 columns. Device memory traffic is one character a cell and
// 8 bytes a boundary cell.

#include "gotoh_warp_pipe.cuh"

namespace {

template <bool LOCAL>
int blocks_per_sm(int rt) {
  switch (rt) {
    case 1: return warp_pipe_blocks_per_sm<LOCAL, 1, FullRows>();
    case 2: return warp_pipe_blocks_per_sm<LOCAL, 2, FullRows>();
    case 4: return warp_pipe_blocks_per_sm<LOCAL, 4, FullRows>();
    case 8: return warp_pipe_blocks_per_sm<LOCAL, 8, FullRows>();
    case 16: return warp_pipe_blocks_per_sm<LOCAL, 16, FullRows>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

template <bool LOCAL>
int launch(const WarpPipe<FullRows>& a, int rt, int blocks, cudaStream_t s) {
  switch (rt) {
    case 1: return warp_pipe_launch<LOCAL, 1>(a, blocks, s);
    case 2: return warp_pipe_launch<LOCAL, 2>(a, blocks, s);
    case 4: return warp_pipe_launch<LOCAL, 4>(a, blocks, s);
    case 8: return warp_pipe_launch<LOCAL, 8>(a, blocks, s);
    case 16: return warp_pipe_launch<LOCAL, 16>(a, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One-warp blocks an SM holds at `rows_per_lane` rows a lane.
extern "C" int gotoh_pallas_blocks_per_sm(int rows_per_lane, int is_local) {
  return is_local ? blocks_per_sm<true>(rows_per_lane) : blocks_per_sm<false>(rows_per_lane);
}

// plan: int32 [ms(B), ns(B), strip0(B+1), level_start(nlevels+1),
// by_strips(B), slot0(B), slots(B)] at strips of 32 * rows_per_lane rows;
// work: zeroed int32 [PIPE_WORK_HEAD + 5*total + B] (PipeWork's order);
// ring: the plan's slots of 2 * (Ln + 1) ints; spin_ns > 0 bounds a wait
// that sees nothing move.
extern "C" int gotoh_pallas_launch(
    const void* s1c, const void* s2c, const void* plan, void* work, void* ring,
    void* res, int B, int Lm, int Ln, int nlevels, int total, int sm, int sx,
    int st, int kimura, int g, int h, int is_local, int rows_per_lane, int blocks,
    long long spin_ns, void* stream) {
  if (B < 1 || nlevels < 1 || total < 1 || blocks < 1 || spin_ns < 1)
    return (int)cudaErrorInvalidValue;
  WarpPipe<FullRows> a{};
  a.sub = CharSub{(const int*)s1c, (const int*)s2c, Lm, Ln, sm, sx, st, kimura};
  a.plan = pipe_plan_of((const int*)plan, B, nlevels, total);
  a.work = PipeWork::of((int*)work, total, B);
  a.ring = (int*)ring;
  a.slotw = Ln + 1;
  a.g = g;
  a.h = h;
  a.bound = (unsigned long long)spin_ns;
  a.res = (int*)res;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_local ? launch<true>(a, rows_per_lane, blocks, s)
                  : launch<false>(a, rows_per_lane, blocks, s);
}
