// Traceback walker for Hopper (sm_90a), bound by ctypes.
//
// Replaces: genomics_rs_tpu/ops/traceback_pallas.py, walk_pallas (body
// _kernel_walk over _run_chase). Chases packed 2-bit direction codes
// (code(li, j) = (dirs[(li+j)/16 * V + li] >> 2*((li+j)%16)) & 3) from a
// start cell with the reference retrace rules: per-axis saturation at 0;
// done on a STOP code or on reaching (0, 0) when j0 == 0; exit up when the
// row falls below i0 (exited = 1) or left onto local column 0 of a
// windowed bitmap when j0 > 0 (exited = 2). Moves (STOP excluded) are
// packed 16 per int32 into `words`; a partial last word still lands.
// meta = (pos, li, j, done, exited, out_of_bounds).
//
// What bounds it: each move's address depends on the previous move, so
// the walk is one dependent global load (mostly an L2 or DRAM miss) plus
// a few integer ops per move; there is no parallelism inside one walk.
// Design: one thread, no staging. The TPU kernel DMA'd a window of the
// bitmap into scalar memory because its scalar core could not gather from
// HBM; here the load goes straight to global memory through the caches,
// so the kernel takes any KW >= 1, V >= 1.
//
// walk_many_kernel (K4) replaces traceback_pallas.py's walk_many (body
// _kernel_walk_many): W independent chases in one launch over one packed
// array (KWT, V), walk w reading the word rows [koff_w, koff_w + KW) and
// the lanes from loff_w on, from its own start cell to the origin (i0 = j0
// = 0: full-width bitmaps, so no exits). One thread per walk: each walk is
// still a chain of dependent loads, but the W chains are in flight together
// and hide each other's latency, which one walk on one thread (K2) cannot.
// The TPU kernel's DMA window needed KW >= 34; here any KW >= 1 goes.
//
// walk_rows16_kernel is the card form of genomics_rs_tpu/ops/
// traceback_batch.py's walk_batch (layout "rows16"), which is XLA code (a
// lax.scan over max_steps lockstep steps), not a Pallas kernel: B walks over
// K6's per-read words codes[b, i-1, (j-1)/16] (interior cells only). The
// boundary codes are synthesized as walk_batch does: row 0 is INS and
// column 0 is DEL, except in local mode where a negative boundary score
// (h + j*g, h + i*g) is a STOP. A stop ends the walk where it stands
// (walk_batch's final cell is the stop cell, unlike K4's). One thread per
// walk, as K4: each walk is a chain of dependent loads, and the B chains
// hide each other's latency; a scan of lockstep torch ops would pay ~15
// launches per step.
//
// walk_banded_kernel (K11) replaces genomics_rs_tpu/ops/gotoh_banded.py's
// _walk_banded_pallas (body _kernel_walk_banded): the chase of the banded
// fill's row-packed codes, dirs[(i-1)/16, v] at band lane v = j - off - 1,
// from (m, n) to the origin. Row 0 is INS and column 0 is DEL (synthesized);
// an interior lane outside [0, V) or a STOP code is corrupt data (oob).
// off is tracked by the per-row slides deltas[i-1] = off(i) - off(i-1),
// never by (i*n)/m, which overflows int32 at chromosome scale. One thread
// per walk: all walks of a banded batch in one launch, each at its own
// word-row offset, under one window geometry (one deltas stream); the TPU
// kernel's DMA windows over the bitmap and the deltas are gone, the loads go
// through the caches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned DIR_INS = 1, DIR_DEL = 2, DIR_STOP = 3;

__global__ void walk_kernel(const unsigned* __restrict__ dirs,
                            unsigned* __restrict__ words, int* __restrict__ meta,
                            int KW, int V, int li, int j, int i0, int j0,
                            int max_steps) {
  int pos = 0, done = 0, exited = 0, oob = 0;
  unsigned acc = 0;
  while (!done && !exited && pos < max_steps) {
    const int k = li + j;
    if (li < 0 || li >= V || k < 0 || (k >> 4) >= KW) {
      oob = 1;
      break;
    }
    const unsigned code = (dirs[(size_t)(k >> 4) * V + li] >> (2 * (k & 15))) & 3u;
    const int ig = i0 + li;
    const int ig_new = max(ig - (code == DIR_INS ? 0 : 1), 0);
    const int j_new = max(j - (code == DIR_DEL ? 0 : 1), 0);
    if (code != DIR_STOP) {
      const int sp = pos & 15;
      if (sp == 0) acc = 0;
      acc |= code << (2 * sp);
      if (sp == 15) words[pos >> 4] = acc;
      ++pos;
    }
    if (code == DIR_STOP || (ig_new == 0 && j_new == 0 && j0 == 0)) {
      done = 1;
    } else if (ig_new < i0) {
      exited = 1;
    } else if (j_new == 0 && j0 > 0) {
      exited = 2;
    }
    // The position moves on every step, stop codes included.
    li = max(ig_new - i0, 0);
    j = j_new;
  }
  if (pos & 15) words[pos >> 4] = acc;
  meta[0] = pos;
  meta[1] = li;
  meta[2] = j;
  meta[3] = done;
  meta[4] = exited;
  meta[5] = oob;
}

// starts[4w .. 4w+3] = (start_li, start_j, koff, loff) of walk w; its moves
// go to words[w*NW ..], its meta to meta[5w ..] = (pos, li, j, done, oob).
__global__ void walk_many_kernel(const unsigned* __restrict__ dirs,
                                 const int* __restrict__ starts,
                                 unsigned* __restrict__ words,
                                 int* __restrict__ meta, int W, int KW,
                                 int KWT, int V, int NW, int max_steps) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int li = starts[4 * w];
  int j = starts[4 * w + 1];
  const int koff = starts[4 * w + 2];
  const int loff = starts[4 * w + 3];
  unsigned* out = words + (size_t)w * NW;
  int pos = 0, done = 0, oob = 0;
  unsigned acc = 0;
  while (!done && pos < max_steps) {
    const int k = li + j;
    const int row = koff + (k >> 4);
    const int lane = loff + li;
    if (li < 0 || lane >= V || k < 0 || (k >> 4) >= KW || row >= KWT) {
      oob = 1;
      break;
    }
    const unsigned code = (dirs[(size_t)row * V + lane] >> (2 * (k & 15))) & 3u;
    const int li_new = max(li - (code == DIR_INS ? 0 : 1), 0);
    const int j_new = max(j - (code == DIR_DEL ? 0 : 1), 0);
    if (code != DIR_STOP) {
      const int sp = pos & 15;
      if (sp == 0) acc = 0;
      acc |= code << (2 * sp);
      if (sp == 15) out[pos >> 4] = acc;
      ++pos;
    }
    if (code == DIR_STOP || (li_new == 0 && j_new == 0)) done = 1;
    li = li_new;
    j = j_new;
  }
  if (pos & 15) out[pos >> 4] = acc;
  int* mt = meta + 5 * w;
  mt[0] = pos;
  mt[1] = li;
  mt[2] = j;
  mt[3] = done;
  mt[4] = oob;
}

// starts[2b .. 2b+1] = (start_i, start_j) of walk b over the (L1, W) words
// of read b; its moves go to words[b*NW ..], its meta to meta[5b ..] =
// (count, i, j, done, oob).
__global__ void walk_rows16_kernel(const unsigned* __restrict__ codes,
                                   const int* __restrict__ starts,
                                   unsigned* __restrict__ words,
                                   int* __restrict__ meta, int B, int L1,
                                   int W, int NW, int max_steps, int h, int g,
                                   int is_local) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int i = starts[2 * b];
  int j = starts[2 * b + 1];
  const unsigned* c = codes + (size_t)b * L1 * W;
  unsigned* out = words + (size_t)b * NW;
  int pos = 0, done = 0, oob = 0;
  unsigned acc = 0;
  for (int step = 0; step < max_steps && !done; ++step) {
    unsigned code;
    if (i == 0) {
      code = (!is_local || h + j * g >= 0) ? DIR_INS : DIR_STOP;
    } else if (j == 0) {
      code = (!is_local || h + i * g >= 0) ? DIR_DEL : DIR_STOP;
    } else {
      if (i > L1 || j < 0 || ((j - 1) >> 4) >= W) {
        oob = 1;
        break;
      }
      code = (c[(size_t)(i - 1) * W + ((j - 1) >> 4)] >> (2 * ((j - 1) & 15))) & 3u;
    }
    if (code == DIR_STOP) {
      done = 1;
      break;
    }
    const int sp = pos & 15;
    if (sp == 0) acc = 0;
    acc |= code << (2 * sp);
    if (sp == 15) out[pos >> 4] = acc;
    ++pos;
    i = max(i - (code == DIR_INS ? 0 : 1), 0);
    j = max(j - (code == DIR_DEL ? 0 : 1), 0);
    if (i == 0 && j == 0) done = 1;
  }
  if (pos & 15) out[pos >> 4] = acc;
  int* mt = meta + 5 * b;
  mt[0] = pos;
  mt[1] = i;
  mt[2] = j;
  mt[3] = done;
  mt[4] = oob;
}

// starts[4w .. 4w+3] = (i, j, off, koff) of walk w over the (KWT, V) words,
// its bitmap the rows [koff, koff + KW); deltas has ND entries. Its moves go
// to words[w*NW ..], its meta to meta[6w ..] = (pos, i, j, off, done, oob).
__global__ void walk_banded_kernel(const unsigned* __restrict__ dirs,
                                   const int* __restrict__ deltas,
                                   const int* __restrict__ starts,
                                   unsigned* __restrict__ words,
                                   int* __restrict__ meta, int W, int KW, int V,
                                   int KWT, int ND, int NW, int max_steps) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int i = starts[4 * w];
  int j = starts[4 * w + 1];
  int off = starts[4 * w + 2];
  const int koff = starts[4 * w + 3];
  unsigned* out = words + (size_t)w * NW;
  int pos = 0, done = i == 0 && j == 0, oob = 0;
  unsigned acc = 0;
  while (!done && pos < max_steps) {
    unsigned code;
    if (i == 0) {
      code = DIR_INS;
    } else if (j == 0) {
      code = DIR_DEL;
    } else {
      const int v = j - off - 1;
      const int row = (i - 1) >> 4;
      if (v < 0 || v >= V || row >= KW || koff + row >= KWT || i > ND) {
        oob = 1;
        break;
      }
      code = (dirs[(size_t)(koff + row) * V + v] >> (2 * ((i - 1) & 15))) & 3u;
      if (code == DIR_STOP) {
        oob = 1;
        break;
      }
    }
    const int sp = pos & 15;
    if (sp == 0) acc = 0;
    acc |= code << (2 * sp);
    if (sp == 15) out[pos >> 4] = acc;
    ++pos;
    if (code != DIR_INS) {
      off -= deltas[i - 1];  // entering row i-1 undoes row i's slide
      --i;
    }
    if (code != DIR_DEL) --j;
    done = i == 0 && j == 0;
  }
  if (pos & 15) out[pos >> 4] = acc;
  int* mt = meta + 6 * w;
  mt[0] = pos;
  mt[1] = i;
  mt[2] = j;
  mt[3] = off;
  mt[4] = done;
  mt[5] = oob;
}

}  // namespace

extern "C" int walk_banded_launch(const void* dirs, const void* deltas,
                                  const void* starts, void* words, void* meta,
                                  int W, int KW, int V, int KWT, int ND, int NW,
                                  int max_steps, void* stream) {
  if (W < 1 || KW < 1 || V < 1) return (int)cudaErrorInvalidValue;
  constexpr int threads = 128;
  walk_banded_kernel<<<(W + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const unsigned*)dirs, (const int*)deltas, (const int*)starts,
      (unsigned*)words, (int*)meta, W, KW, V, KWT, ND, NW, max_steps);
  return (int)cudaGetLastError();
}

extern "C" int traceback_walk_launch(const void* dirs, void* words, void* meta,
                                     int KW, int V, int start_li, int start_j,
                                     int i0, int j0, int max_steps,
                                     void* stream) {
  walk_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const unsigned*)dirs, (unsigned*)words, (int*)meta, KW, V, start_li,
      start_j, i0, j0, max_steps);
  return (int)cudaGetLastError();
}

extern "C" int walk_many_launch(const void* dirs, const void* starts,
                                void* words, void* meta, int W, int KW,
                                int KWT, int V, int NW, int max_steps,
                                void* stream) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  constexpr int threads = 128;
  walk_many_kernel<<<(W + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const unsigned*)dirs, (const int*)starts, (unsigned*)words, (int*)meta,
      W, KW, KWT, V, NW, max_steps);
  return (int)cudaGetLastError();
}

extern "C" int walk_rows16_launch(const void* codes, const void* starts,
                                  void* words, void* meta, int B, int L1,
                                  int W, int NW, int max_steps, int h, int g,
                                  int is_local, void* stream) {
  if (B < 1 || L1 < 1 || W < 1) return (int)cudaErrorInvalidValue;
  constexpr int threads = 128;
  walk_rows16_kernel<<<(B + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const unsigned*)codes, (const int*)starts, (unsigned*)words,
      (int*)meta, B, L1, W, NW, max_steps, h, g, is_local);
  return (int)cudaGetLastError();
}
