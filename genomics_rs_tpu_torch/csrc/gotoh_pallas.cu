// Batched Gotoh scores for Hopper (sm_90a) by a strip pipeline: one pair's
// row strips run on many SMs at once. Bound by ctypes.
//
// Replaces: genomics_rs_tpu/ops/gotoh_pallas.py, gotoh_scores_pallas_batch
// (body _kernel_batch, pallas_call at :1309; K9). Same contract as K3
// (gotoh_stream_body.cuh) without dirs: for every pair p of a padded batch,
// the global score at (m_p, n_p) or the local keep-last row-major argmax
// (v, i, j), classic or kimura scoring, empty sequences allowed.
//
// Design. The TPU kernel runs each pair as one flat anti-diagonal over a
// V-lane vector, one pair per grid row, in order on one core. On Hopper K3
// already fills a pair in one thread block; what it cannot do is use more
// than one SM for it, so a lone long pair (the "pallas" tier's own case,
// B = 1 past 8 kb) runs on one SM of 132. Here every row strip of T rows
// is a block's work (pipe_kernel in gotoh_stream_body.cuh): strip s starts
// as soon as strip s-1 has published the first PIPE_CHUNK columns of its
// bottom row, so a 29.9 kb pair at T = 256 keeps ~117 strips in flight,
// each T + PIPE_CHUNK columns behind the one above.
//   - Order: persistent blocks take (pair, strip) from a ticket counter,
//     level by level, so a block only ever waits on a strip that holds an
//     earlier ticket and is running: no deadlock at any occupancy.
//   - Hand-off: the producer's last thread stores its row's A and M, then
//     publishes the column count with release semantics every PIPE_CHUNK
//     columns; the consumer's thread 0 polls with acquire semantics once a
//     chunk and its warp stages the chunk through L2 (__ldcg).
//   - Scratch: a ring of boundary rows per pair, sized by the host from the
//     occupancy (a slot is reused once the strip that read it has released
//     it), so a 1 Mb pair needs a few hundred slots, not one per strip.
//   - No hang: a wait that passes SPIN_NS sets the launch's error word, and
//     every block leaves; the wrapper raises.
//   - Results: global, the thread at (m, n) writes the score; local, each
//     strip's block-merged best goes to a per-strip array and the pair's
//     last strip (an atomic count) merges them by (v, i, j).
//
// What bounds it: integer issue (12 ops a cell global, 19 local) and, per
// block, the dependent step of K3 (a few integer ops and one barrier a
// column); the pipeline adds one L2 poll and one chunk copy every
// PIPE_CHUNK columns and a T + PIPE_CHUNK column lag per strip. Device
// memory traffic is one character a cell and 8 bytes a boundary cell.

#include "gotoh_stream_body.cuh"

extern "C" int gotoh_pallas_blocks_per_sm(int threads, int is_local) {
  return pipe_blocks_per_sm<CharSub>(threads, is_local);
}

// plan: int32 [ms(B), ns(B), strip0(B+1), level_start(nlevels+1),
// by_strips(B), slot0(B), slots(B)]; work: zeroed int32 [2 + 5*total + B]
// (PipeWork's order).
extern "C" int gotoh_pallas_launch(
    const void* s1c, const void* s2c, const void* plan, void* work, void* ring,
    void* res, int B, int Lm, int Ln, int nlevels, int total, int sm, int sx,
    int st, int kimura, int g, int h, int is_local, int threads, int blocks,
    void* stream) {
  if (B < 1 || nlevels < 1) return (int)cudaErrorInvalidValue;
  const CharSub sub{(const int*)s1c, (const int*)s2c, Lm, Ln, sm, sx, st, kimura};
  const int* pl = (const int*)plan;
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
  int* w = (int*)work;
  PipeWork pw;
  pw.ticket = w;
  pw.err = w + 1;
  pw.progress = w + 2;
  pw.released = pw.progress + total;
  pw.finished = pw.released + total;
  pw.best = pw.finished + B;
  return launch_pipe(sub, pp, pw, (int*)ring, (int*)res, Ln, g, h, is_local,
                     threads, blocks, (cudaStream_t)stream);
}
