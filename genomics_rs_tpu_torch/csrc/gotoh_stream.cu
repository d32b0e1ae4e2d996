// Batched Gotoh fill for Hopper (sm_90a), one thread block per pair, bound
// by ctypes.
//
// Replaces: genomics_rs_tpu/ops/gotoh_stream.py, _stream_call (body
// _kernel_stream), behind gotoh_scores_stream and gotoh_stream_fill_dirs.
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
//
// The body (recurrence, codes, argmax) and its character substitution
// (CharSub) are gotoh_stream_body.cuh, shared with the matrix fill
// (gotoh_matrix.cu), K9's strip pipeline (gotoh_pallas.cu) and the
// warp-strip kernel (gotoh_segmented.cu); this file is K3's launcher.
//
// Design. The TPU kernel lays every pair end to end along one V-lane
// vector and re-injects column 0 at each seam, so its lanes do not idle
// through each pair's diagonal ramp. That answers a TPU constraint (one
// core, one wide vector). Hopper has 132 SMs and K1 (gotoh_rowblock.cu)
// already fills one table per SM, so here grid = B: block p runs K1's
// skewed row-strip wavefront over pair p alone, rows 0..m_p and columns
// 0..n_p, with its own global scratch rows. No padded cell is computed, so
// the local argmax needs no padding mask and every pair needs no seam, probe
// chunk or drift guard: the wrapper has no fallback.
//
// What bounds it: as K1, one block is a dependency chain along both axes,
// latency-bound on its SM: ceil((m+1)/T) strips of n + T steps, each step a
// handful of integer max/add ops plus one block barrier. A batch runs
// min(B, 132) blocks at once, so a bucket of up to 132 equal pairs takes
// about one pair's time. Device memory traffic is small (one char load per
// cell, 2 bits of dirs per cell).

#include "gotoh_stream_body.cuh"

extern "C" int gotoh_stream_launch(
    const void* s1c, const void* s2c, const void* ms, const void* ns,
    void* dirs, void* res, void* scratch, int B, int Lm, int Ln, int V,
    int KW, int sm, int sx, int st, int kimura, int g, int h, int is_local,
    int threads, void* stream) {
  const CharSub sub{(const int*)s1c, (const int*)s2c, Lm, Ln, sm, sx, st, kimura};
  return launch_stream(sub, (const int*)ms, (const int*)ns, (unsigned*)dirs,
                       (int*)res, (int*)scratch, B, Ln, V, KW, g, h, is_local,
                       threads, (cudaStream_t)stream);
}
