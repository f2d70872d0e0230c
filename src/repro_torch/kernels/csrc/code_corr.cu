// Gram of centroid-decoded int8 bin codes: G = c[U]^T c[V], f32.
//
// Replaces the TPU kernel repro/kernels/sign_corr.py::code_corr
// (_code_corr_kernel), which decoded codes by a one-hot contraction into
// bf16 tiles for the MXU. This kernel decodes to f32 instead, so it is
// held to the f32 reference (decode, then contract) within a stated
// tolerance rather than to bf16 rounding.
//
// What bounds it on an H100: f32 arithmetic on the CUDA cores. At the
// main path's shape (n = 2^18, d = 4096, R = 4) the Gram is 2*n*d^2 =
// 8.8e12 flop against 1.1 GB of code bytes, so bytes are no limit. The
// codebook (L <= 128 centroids) sits in shared memory; each block stages
// 32 samples x 64 features of each operand, decoded to f32 in shared
// memory with an explicit range check (codes outside [0, L), the -1 mask
// sentinel included, decode to 0). Each thread keeps 4x4 outputs.
//
// Accuracy: a plain running f32 sum over n = 2^18 terms drifts by
// several units on the diagonal (~n in size). Each thread therefore sums
// 256 samples at a time into a partial and adds the partial to its
// total, so the long sum has n/256 terms and the error shrinks ~16x.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // output tile edge (features)
constexpr int BK = 32;        // samples per stage
constexpr int FLUSH = 8;      // stages per partial sum (256 samples)
constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 128;

__device__ __forceinline__ void stage(const int8_t* __restrict__ base,
                                      long long ld, int n, int width,
                                      int k0, int f0, const float* cb, int L,
                                      float (*dst)[TILE]) {
  const int f = threadIdx.x & (TILE - 1);
  const int g = threadIdx.x >> 6;            // 0..3: an 8-sample slab
  const int col = f0 + f;
  const bool col_ok = col < width;
#pragma unroll
  for (int r = 0; r < BK / 4; ++r) {
    const int kk = g * (BK / 4) + r;
    const int k = k0 + kk;
    int code = -1;
    if (col_ok && k < n) code = base[(long long)k * ld + col];
    dst[kk][f] = (code >= 0 && code < L) ? cb[code] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
code_corr_kernel(const int8_t* __restrict__ u, const int8_t* __restrict__ v,
                 const float* __restrict__ centroids, int L,
                 float* __restrict__ out, int n, int dl, int dr,
                 long long u_sb, long long u_ld, long long v_sb,
                 long long v_ld) {
  __shared__ float cb[MAX_LEVELS];
  __shared__ __align__(16) float As[BK][TILE];
  __shared__ __align__(16) float Bs[BK][TILE];
  if (threadIdx.x < MAX_LEVELS)
    cb[threadIdx.x] = threadIdx.x < L ? centroids[threadIdx.x] : 0.0f;
  __syncthreads();
  const int bz = blockIdx.z;
  const int8_t* ub = u + bz * u_sb;
  const int8_t* vb = v + bz * v_sb;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.0f;

  int stages = 0;
  for (int k0 = 0; k0 < n; k0 += BK) {
    stage(ub, u_ld, n, dl, k0, i0, cb, L, As);
    stage(vb, v_ld, n, dr, k0, j0, cb, L, Bs);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    __syncthreads();
    if (++stages == FLUSH) {
      stages = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.0f;
        }
    }
  }

  float* ob = out + (long long)bz * dl * dr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= dl) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx * 4 + j;
      if (col < dr) ob[(long long)row * dr + col] = acc[i][j] + part[i][j];
    }
  }
}

}  // namespace

// u: (b, n, dl) int8 codes with batch stride u_sb and row stride u_ld,
// last stride 1; v likewise (b, n, dr). centroids: (L,) f32, L <= 128.
// out: contiguous (b, dl, dr) f32.
extern "C" int code_corr_s8(const void* u, const void* v,
                            const void* centroids, int L, void* out, int b,
                            int n, int dl, int dr, long long u_sb,
                            long long u_ld, long long v_sb, long long v_ld,
                            void* stream) {
  if (b == 0 || dl == 0 || dr == 0) return 0;
  if (L < 1 || L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  dim3 grid((dr + TILE - 1) / TILE, (dl + TILE - 1) / TILE, b);
  code_corr_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)u, (const int8_t*)v, (const float*)centroids, L,
      (float*)out, n, dl, dr, u_sb, u_ld, v_sb, v_ld);
  return (int)cudaGetLastError();
}
