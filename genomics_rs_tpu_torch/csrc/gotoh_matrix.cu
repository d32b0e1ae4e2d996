// Protein (substitution-matrix) Gotoh for Hopper (sm_90a), bound by ctypes:
// the query-profile build and the matrix fill.
//
// matrix_profile_kernel replaces genomics_rs_tpu/ops/gotoh_matrix_stream.py,
// _mstream_build_fast (body _kernel_massemble, K15). That kernel builds K14's
// input: byte -> alphabet code -> query profile -> substitution plane,
// sheared diagonal-major for a TPU core's one wide vector, through exact bf16
// one-hot matmuls. Here the profile IS the product, and nothing is sheared:
//   prof[p, a, j] = ext[a, code[s2[p, j]]]   (int16; 0 for j >= n_p)
// for every alphabet row a of the extended matrix (A rows: the alphabet, plus
// one row at the matrix minimum when the alphabet has no X). The row is s1's
// character and the column s2's (an asymmetric matrix scores
// matrix[row = s1][col = s2]). int16 holds every |v| <= 256 exactly.
// What bounds it: bytes (B*Ln read, B*A*Ln*2 written); it does no arithmetic
// beyond a table lookup an entry. The design serves the bytes:
// - One table, byte-indexed: tab[a][b] = ext[a, code[b]] (A x 256 int16, made
//   once per matrix and device by the wrapper), staged into shared memory
//   once per block with 16-byte loads. An entry is one lookup of its byte,
//   with no code step; the lanes of a warp read one row a (512 bytes), so
//   distinct bytes fall in distinct words or share one: no bank conflicts.
// - A persistent grid of 8-warp blocks; a warp takes (pair, column tile,
//   group of rows) units in a grid-stride loop, copies the tile's s2 bytes
//   into its own shared-memory slice (16-byte loads; all of a tile of 384
//   columns in one round), then writes each of its rows.
// - 16-byte stores. The profile is one flat int16 array and a row starts at
//   any element (Ln odd: every alignment mod 8), so a row is written as the
//   16-byte chunks that lie inside it, a lane a chunk (its 8 bytes read as
//   two 8-byte shared loads and two funnel shifts), and its head and tail (at
//   most 7 entries each) as 2-byte stores. Only the chunk holding n_p
//   selects entry by entry; chunks past it store zeros.
//
// gotoh_matrix_launch replaces both protein fills: _matrix_seg_call in
// genomics_rs_tpu/ops/gotoh_matrix.py (K13, scores and starts under a full
// matrix from an int8 sheared stream) and _mstream_fill in
// genomics_rs_tpu/ops/gotoh_matrix_stream.py (K14, the 2-D packed stream:
// scores, starts and diag16 dirs). It is K3's warp-strip pipeline
// (gotoh_warp_pipe.cuh, FullRows: a strip of 32*RT rows a warp, RT rows a
// lane in registers, a pair's strips on many SMs, codes filled in
// registers) with the substitution s(i, j) = prof[p, code(s1[i-1]), j-1]
// (ProfileSub): each lane holds its rows' profile lines and loads, one
// column ahead, the entries of its RT rows for its next column. Outputs and
// codes are K3's, so K4 and K2 walk them; the wrapper reads the error word
// where it reads the scores.
// What bounds it: integer issue (10 ops a cell global, 17 local, +9 with
// codes) and one profile load a cell from L1/L2 (the profile of a launch's
// pairs is a few MB); a 383-aa pair is one or two strips, so a launch of a
// thousand pairs keeps every SM's warps busy.

#include <algorithm>

#include "gotoh_warp_pipe.cuh"

namespace {

constexpr int PROFILE_WARPS = 8;     // warps a block
constexpr int PROFILE_TILE = 2048;   // most s2 columns a warp stages at once
// A warp's tile of s2 bytes lies in shared memory at the byte's own offset
// mod 16 (so whole 16-byte blocks copy across), and the chunk reads touch
// up to 16 bytes past it: PROFILE_PAD bytes a tile.
constexpr int PROFILE_PAD = 32;

// The 8 profile entries of row `ta` (the table's row a) at the 8 bytes b.
__device__ __forceinline__ uint4 profile_chunk(const int16_t* ta, unsigned b0, unsigned b1) {
  const unsigned short* t = reinterpret_cast<const unsigned short*>(ta);
  uint4 v;
  v.x = t[b0 & 0xffu] | (unsigned)t[(b0 >> 8) & 0xffu] << 16;
  v.y = t[(b0 >> 16) & 0xffu] | (unsigned)t[b0 >> 24] << 16;
  v.z = t[b1 & 0xffu] | (unsigned)t[(b1 >> 8) & 0xffu] << 16;
  v.w = t[(b1 >> 16) & 0xffu] | (unsigned)t[b1 >> 24] << 16;
  return v;
}

// Unit u = ((p * tiles + tile) * groups + g): pair p's columns [tile *
// cols, +cols) for the rows [g * rows, +rows). tab: (A, 256) int16, 16-byte
// aligned; prof: 16-byte aligned.
__global__ void __launch_bounds__(32 * PROFILE_WARPS)
matrix_profile_kernel(const uint8_t* __restrict__ s2, const int* __restrict__ ns,
                      const int16_t* __restrict__ tab, int16_t* __restrict__ prof, int B,
                      int Ln, int A, int cols, int tiles, int rows, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  {  // the table, 16 bytes a load
    const uint4* src = reinterpret_cast<const uint4*>(tab);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int u = threadIdx.x; u < A * 32; u += blockDim.x) dst[u] = __ldg(src + u);
  }
  __syncthreads();
  const int16_t* stab = reinterpret_cast<const int16_t*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* scol = smem + (size_t)A * 512 + (size_t)warp * (cols + PROFILE_PAD);
  const long long units = (long long)B * tiles * groups;
  for (long long u = (long long)blockIdx.x * PROFILE_WARPS + warp; u < units;
       u += (long long)gridDim.x * PROFILE_WARPS) {
    const int g = (int)(u % groups);
    const long long pt = u / groups;
    const int p = (int)(pt / tiles);
    const int J0 = (int)(pt % tiles) * cols;
    const int W = min(cols, Ln - J0);
    const int live = ns[p] - J0;  // the tile's columns below n_p
    // The tile's bytes: scol[o0 + x] = s2[p, J0 + x]. The 16-byte blocks
    // wholly inside the row copy as one load a lane; the bytes before the
    // first and after the last (under 16 each) copy one by one.
    const uint8_t* src = s2 + (size_t)p * Ln + J0;
    const int o0 = (int)(reinterpret_cast<uintptr_t>(src) & 15u);
    const int head = min((16 - o0) & 15, W);
    const int blocks = (W - head) >> 4;
    const int rest = W - head - 16 * blocks;
    __syncwarp();  // the last unit's reads of scol are done
    for (int v = lane; v < blocks; v += 32) {
      *reinterpret_cast<uint4*>(scol + o0 + head + 16 * v) =
          __ldg(reinterpret_cast<const uint4*>(src + head) + v);
    }
    if (lane < head + rest) {
      const int x = lane < head ? lane : head + 16 * blocks + lane - head;
      scol[o0 + x] = __ldg(src + x);
    }
    __syncwarp();
    const int a1 = min(A, (g + 1) * rows);
    for (int a = g * rows; a < a1; ++a) {
      const int16_t* ta = stab + a * 256;
      const size_t s = ((size_t)p * A + a) * Ln + J0;  // flat entry of column J0
      int16_t* out = prof + s;
      const int h = min((int)((0u - (unsigned)s) & 7u), W);  // entries before a 16-byte boundary
      const int nfull = (W - h) >> 3;
      // Chunk q's bytes scol[e + 8q ..], e = o0 + h: within the 8-aligned 16
      // bytes at (e & ~7) + 8q, from byte e & 7 of them.
      const int e = o0 + h, e8 = e & ~7, lo_word = (e & 7) < 4;
      const int sh = 8 * (e & 3);  // the first byte within its 4-byte word
      for (int q = lane; q < nfull; q += 32) {
        const int x = h + 8 * q;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (x < live) {
          const uint2 lo = *reinterpret_cast<const uint2*>(scol + e8 + 8 * q);
          const uint2 hi = *reinterpret_cast<const uint2*>(scol + e8 + 8 * q + 8);
          const unsigned w0 = lo_word ? lo.x : lo.y, w1 = lo_word ? lo.y : hi.x;
          const unsigned w2 = lo_word ? hi.x : hi.y;
          v = profile_chunk(ta, __funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
          if (x + 8 > live) {  // the chunk holding n_p: zeros from it on
            unsigned* ev = reinterpret_cast<unsigned*>(&v);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int c = x + 2 * t - live;  // < 0: live
              ev[t] &= c >= 0 ? 0u : c == -1 ? 0xffffu : ~0u;
            }
          }
        }
        *reinterpret_cast<uint4*>(out + x) = v;
      }
      // The head (h entries) and the tail (under 8): 2-byte stores.
      const int tail = h + 8 * nfull;
      const int x = lane < h ? lane : tail + lane - h;
      if (x < W) out[x] = x < live ? ta[scol[o0 + x]] : (int16_t)0;
    }
  }
}

// The matrix fill's substitution in the warp strip's lane form: each row
// reads its profile line, prof[p, code(s1[i-1]), :], one column ahead.
struct ProfileSub {
  const int* code1;     // (B, Lm) alphabet code of each s1 character
  const int16_t* prof;  // (B, A, Ln)
  int Lm, Ln, A;

  static constexpr bool COLS = false;  // nothing travels with the columns
  template <int RT>
  struct Lane {
    const int16_t* pp;  // the pair's profile
    int line[RT];       // each row's line offset, code * Ln
    int nx[RT];         // each row's s(i, j) of the lane's next column
  };

  template <int RT>
  __device__ __forceinline__ void lane(Lane<RT>& L, int p, int i0, int kreal) const {
    L.pp = prof + (size_t)p * A * Ln;
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int i = i0 + k;
      L.line[k] = ((k < kreal && i >= 1) ? __ldg(code1 + (size_t)p * Lm + i - 1) : 0) * Ln;
      L.nx[k] = 0;
    }
  }
  template <int RT>
  __device__ __forceinline__ int col(const Lane<RT>&, int) const {
    return 0;
  }
  template <int RT>
  __device__ __forceinline__ int at(const Lane<RT>& L, int k, int) const {
    return L.nx[k];
  }
  // After column j: s(i, j+1) = prof[line, j] for j < n (a predicated load).
  template <int RT>
  __device__ __forceinline__ void next(Lane<RT>& L, int, int j, int n) const {
#pragma unroll
    for (int k = 0; k < RT; ++k) L.nx[k] = j < n ? (int)__ldg(L.pp + L.line[k] + j) : 0;
  }
};

}  // namespace

// tab: (A, 256) int16 (the wrapper's byte table), prof: (B, A, Ln) int16,
// both 16-byte aligned. The grid holds at most per_sm blocks an SM (as many
// as fit when per_sm < 1): a block stages the whole table, so a small launch
// on fewer blocks reads less of it.
extern "C" int matrix_profile_launch(const void* s2, const void* ns, const void* tab,
                                     void* prof, int B, int Ln, int A, int per_sm,
                                     void* stream) {
  if (B < 1 || Ln < 1 || A < 1 || A > 257 || reinterpret_cast<uintptr_t>(tab) % 16 ||
      reinterpret_cast<uintptr_t>(prof) % 16)
    return (int)cudaErrorInvalidValue;
  const int cols = std::min((Ln + 15) / 16 * 16, PROFILE_TILE);
  const int tiles = (Ln + cols - 1) / cols;
  const size_t smem = (size_t)A * 512 + (size_t)PROFILE_WARPS * (cols + PROFILE_PAD);
  // The grid: as many blocks as the card holds at once (queried once per
  // device and shared-memory size).
  thread_local int last_dev = -1, last_sms = 0, last_per_sm = 0;
  thread_local size_t last_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(matrix_profile_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matrix_profile_kernel,
                                                           32 * PROFILE_WARPS, smem)) !=
            cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_dev = dev, last_smem = smem, last_sms = sms, last_per_sm = per_sm;
  }
  // Rows split into groups while the (pair, tile) units alone leave warps idle.
  const long long resident =
      (long long)(per_sm > 0 ? std::min(per_sm, last_per_sm) : last_per_sm) * last_sms;
  const long long pts = (long long)B * tiles;
  const int groups = (int)std::min<long long>(A, std::max<long long>(1, resident * PROFILE_WARPS / pts));
  const int rows = (A + groups - 1) / groups;
  const int ngroups = (A + rows - 1) / rows;
  const long long units = pts * ngroups;
  const int blocks = (int)std::min<long long>((units + PROFILE_WARPS - 1) / PROFILE_WARPS, resident);
  matrix_profile_kernel<<<blocks, 32 * PROFILE_WARPS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)s2, (const int*)ns, (const int16_t*)tab, (int16_t*)prof, B, Ln, A, cols,
      tiles, rows, ngroups);
  return (int)cudaGetLastError();
}

// One-warp blocks an SM holds at `rows_per_lane` rows a lane.
extern "C" int gotoh_matrix_blocks_per_sm(int rows_per_lane, int is_local, int dirs) {
  return full_rows_blocks_per_sm<ProfileSub>(rows_per_lane, is_local, dirs);
}

// code1: (B, Lm) int32; prof: (B, A, Ln) int16; plan, work and ring as
// gotoh_stream_launch's; dirs: zeroed (B, KW, V) or null.
extern "C" int gotoh_matrix_launch(
    const void* code1, const void* prof, const void* plan, void* work, void* ring,
    void* dirs, void* res, int B, int Lm, int Ln, int A, int V, int KW, int nlevels,
    int total, int g, int h, int is_local, int rows_per_lane, int blocks, long long spin_ns,
    void* stream) {
  if (B < 1 || nlevels < 1 || total < 1 || blocks < 1 || spin_ns < 1)
    return (int)cudaErrorInvalidValue;
  WarpPipe<FullRows, ProfileSub> a{};
  a.sub = ProfileSub{(const int*)code1, (const int16_t*)prof, Lm, Ln, A};
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
