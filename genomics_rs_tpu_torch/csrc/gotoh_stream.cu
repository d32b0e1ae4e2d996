// Batched Gotoh fill for Hopper (sm_90a) on the warp-strip pipeline, bound
// by ctypes.
//
// Replaces: genomics_rs_tpu/ops/gotoh_stream.py, _stream_call (body
// _kernel_stream), behind gotoh_scores_stream and gotoh_stream_fill_dirs;
// and, at scores only under its own launch count, K8:
// genomics_rs_tpu/ops/gotoh_stream8.py, _stream8_call (body
// _kernel_stream8, pallas_call at :528), behind gotoh_scores_stream8.
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
//                    words with no true cell stay zero (the wrapper zeroes)
//
// Design. The TPU kernel lays every pair end to end along one V-lane
// vector and re-injects column 0 at each seam, so its lanes do not idle
// through each pair's diagonal ramp. That answers a TPU constraint (one
// core, one wide vector). On Hopper each row strip of 32*RT rows is one
// warp's work in gotoh_warp_pipe.cuh's sweep (FullRows, CharSub): lane l
// holds RT rows in registers, the lanes run one column apart, a pair's
// strips run on many SMs at once, fed through K9's ring, tickets and error
// word (gotoh_pallas.cu has the same sweep without codes). With dirs, each
// lane fills its rows' code words in registers and stores each once: a
// word holds 16 columns of one row, and a row is one lane's. A pair that
// one strip holds takes no ring slot. The launch does not wait: the
// wrapper returns the error word with the result and the caller raises
// where it reads the scores. RT is a launch argument (1, 2, 4, 8 or 16;
// each its own compiled kernel, with and without codes).
//
// What bounds it: integer issue (12 ops a cell global, 19 local, +9 with
// codes) over the strips in flight, and for a lone pair a warp's step of RT
// chained cells; device memory traffic is one character a cell, 8 bytes a
// boundary cell and 2 bits of dirs a cell.

#include "gotoh_warp_pipe.cuh"

// One-warp blocks an SM holds at `rows_per_lane` rows a lane.
extern "C" int gotoh_stream_blocks_per_sm(int rows_per_lane, int is_local, int dirs) {
  return full_rows_blocks_per_sm<CharSub>(rows_per_lane, is_local, dirs);
}

// plan: int32 [ms(B), ns(B), strip0(B+1), level_start(nlevels+1),
// by_strips(B), slot0(B), slots(B)] at strips of 32 * rows_per_lane rows;
// work: zeroed int32 [PIPE_WORK_HEAD + 5*total + B] (PipeWork's order);
// ring: the plan's slots of 2 * (Ln + 1) ints; dirs: zeroed (B, KW, V) or
// null; spin_ns > 0 bounds a wait that sees nothing move.
extern "C" int gotoh_stream_launch(
    const void* s1c, const void* s2c, const void* plan, void* work, void* ring,
    void* dirs, void* res, int B, int Lm, int Ln, int V, int KW, int nlevels, int total,
    int sm, int sx, int st, int kimura, int g, int h, int is_local, int rows_per_lane,
    int blocks, long long spin_ns, void* stream) {
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
  a.dirs = (unsigned*)dirs;
  a.KW = KW;
  a.DV = V;
  return full_rows_launch(a, rows_per_lane, is_local, blocks, (cudaStream_t)stream);
}
