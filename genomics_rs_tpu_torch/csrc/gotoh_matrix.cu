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
// matrix[row = s1][col = s2]). int16 holds every |v| <= 256 exactly. Block
// (p, tile) stages the 256-entry code table and ext in shared memory; thread
// j loads one s2 byte and writes its A profile entries, coalesced along j.
// What bounds it: bytes (B*Ln read, B*A*Ln*2 written); it does no arithmetic.
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

#include "gotoh_warp_pipe.cuh"

namespace {

constexpr int PROFILE_THREADS = 256;

__global__ void __launch_bounds__(PROFILE_THREADS)
matrix_profile_kernel(const uint8_t* __restrict__ s2,
                      const int* __restrict__ ns,
                      const int* __restrict__ code,
                      const int* __restrict__ ext,
                      int16_t* __restrict__ prof, int Ln, int A) {
  extern __shared__ int smem[];
  int* scode = smem;                                   // 256
  int16_t* sext = reinterpret_cast<int16_t*>(smem + 256);  // A x A
  for (int u = threadIdx.x; u < 256; u += blockDim.x) scode[u] = code[u];
  for (int u = threadIdx.x; u < A * A; u += blockDim.x) sext[u] = (int16_t)ext[u];
  __syncthreads();

  const int p = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= Ln) return;
  int16_t* out = prof + (size_t)p * A * Ln + j;
  if (j < ns[p]) {
    const int c = scode[s2[(size_t)p * Ln + j]];
    for (int a = 0; a < A; ++a) out[(size_t)a * Ln] = sext[a * A + c];
  } else {
    for (int a = 0; a < A; ++a) out[(size_t)a * Ln] = 0;
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

extern "C" int matrix_profile_launch(const void* s2, const void* ns,
                                     const void* code, const void* ext,
                                     void* prof, int B, int Ln, int A,
                                     void* stream) {
  if (B < 1 || Ln < 1 || A < 1 || A > 257) return (int)cudaErrorInvalidValue;
  const size_t smem = 256 * sizeof(int) + (size_t)A * A * sizeof(int16_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        matrix_profile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, (Ln + PROFILE_THREADS - 1) / PROFILE_THREADS);
  matrix_profile_kernel<<<grid, PROFILE_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)s2, (const int*)ns, (const int*)code, (const int*)ext,
      (int16_t*)prof, Ln, A);
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
