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
// scores, starts and diag16 dirs). It is K3's body (gotoh_stream_body.cuh:
// one block per pair, skewed row-strip wavefront, true cells only) with the
// substitution s(i, j) = prof[p, code(s1[i-1]), j-1], read one int16 a cell
// along the row's profile line (prefetched one column ahead, as K3 prefetches
// its s2 character). Outputs and codes are K3's, so K4 and K2 walk them.
// What bounds it: as K3, each block's dependent step (a few integer ops and
// one barrier a column); protein rows are a few hundred, so a block is a
// single strip and several blocks share an SM.

#include "gotoh_stream_body.cuh"

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

// The matrix fill's substitution: one profile line per row.
struct ProfileSub {
  const int* code1;     // (B, Lm) alphabet code of each s1 character
  const int16_t* prof;  // (B, A, Ln)
  int Lm, Ln, A;

  struct Row {
    const int16_t* line;  // prof[p, code(s1[i-1]), :]
    int v;                // s(i, j) of the next column, prefetched
  };

  __device__ __forceinline__ Row row(int p, int i, int m, int n) const {
    Row r;
    const int c = (i <= m && i >= 1) ? code1[(size_t)p * Lm + i - 1] : 0;
    r.line = prof + ((size_t)p * A + c) * Ln;
    r.v = n > 0 ? r.line[0] : 0;
    return r;
  }

  __device__ __forceinline__ int next(Row& r, int j, int n) const {
    const int v = r.v;
    r.v = j < n ? r.line[j] : 0;
    return v;
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

extern "C" int gotoh_matrix_launch(
    const void* code1, const void* prof, const void* ms, const void* ns,
    void* dirs, void* res, void* scratch, int B, int Lm, int Ln, int A, int V,
    int KW, int g, int h, int is_local, int threads, void* stream) {
  const ProfileSub sub{(const int*)code1, (const int16_t*)prof, Lm, Ln, A};
  return launch_stream(sub, (const int*)ms, (const int*)ns, (unsigned*)dirs,
                       (int*)res, (int*)scratch, B, Ln, V, KW, g, h, is_local,
                       threads, (cudaStream_t)stream);
}
