// Sign Gram G = U^T V over int8 codes, int32 accumulation, f32 output.
//
// Replaces the TPU kernel repro/kernels/sign_corr.py::sign_corr
// (_sign_corr_kernel), which upcast int8 tiles to bf16 for the MXU and
// accumulated in f32 across a sequential trailing grid axis over n.
//
// What bounds it on an H100: the arithmetic. At the main path's shape
// (n = 2^20 samples, d = 4096 features) the Gram is n*d^2 = 1.8e13
// multiply-adds against 4.3 GB of operand bytes, far above the card's
// byte/op balance. This first version runs on the CUDA cores, not the
// tensor cores: each thread keeps a 4x4 block of int32 sums and feeds
// them with __dp4a, four multiply-adds per instruction. To make that
// possible the block stages a 64-sample x 64-feature slab of each operand
// through shared memory transposed into words that hold four consecutive
// samples of one feature (an in-smem transpose of the sample-major int8
// layout). Blocks are independent 64x64 output tiles; the loop over n
// inside the block replaces the TPU's sequential grid axis, so nothing
// carries over between blocks. The batch is blockIdx.z, and U and V may
// differ in width (rectangular Grams) and be column slices of wider
// operands (row stride passed in).
//
// Exactness: int32 sums are exact while n * max|u| * max|v| < 2^31, and
// the f32 result equals the reference's f32 sum bit for bit while
// |G| < 2^24. For +-1 and 0 codes |G| <= n, so both hold up to n = 2^24
// (the main path has n = 2^20).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // output tile edge (features)
constexpr int BK = 64;            // samples per stage
constexpr int KW = BK / 4;        // 4-sample words per stage
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each

// Stage samples [k0, k0+BK) of features [f0, f0+TILE) into dst[w][f]: word
// w of feature f packs samples k0+4w .. k0+4w+3 (sample k0+4w+q in byte q).
// Out-of-range samples and features load as 0 and add nothing.
__device__ __forceinline__ void stage(const int8_t* __restrict__ base,
                                      long long ld, int n, int width,
                                      int k0, int f0, int (*dst)[TILE]) {
  const int f = threadIdx.x & (TILE - 1);
  const int g = threadIdx.x >> 6;            // 0..3: a 16-sample slab
  const int col = f0 + f;
  const bool col_ok = col < width;
#pragma unroll
  for (int q4 = 0; q4 < 4; ++q4) {
    const int w = g * 4 + q4;
    unsigned int word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + w * 4 + q;
      unsigned int byte = 0;
      if (col_ok && k < n) byte = (uint8_t)base[(long long)k * ld + col];
      word |= byte << (8 * q);
    }
    dst[w][f] = (int)word;
  }
}

__global__ void __launch_bounds__(THREADS)
sign_corr_kernel(const int8_t* __restrict__ u, const int8_t* __restrict__ v,
                 float* __restrict__ out, int n, int dl, int dr,
                 long long u_sb, long long u_ld, long long v_sb,
                 long long v_ld) {
  __shared__ __align__(16) int As[KW][TILE];
  __shared__ __align__(16) int Bs[KW][TILE];
  const int bz = blockIdx.z;
  const int8_t* ub = u + bz * u_sb;
  const int8_t* vb = v + bz * v_sb;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < n; k0 += BK) {
    stage(ub, u_ld, n, dl, k0, i0, As);
    stage(vb, v_ld, n, dr, k0, j0, Bs);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int4 a4 = *reinterpret_cast<const int4*>(&As[w][ty * 4]);
      const int4 b4 = *reinterpret_cast<const int4*>(&Bs[w][tx * 4]);
      const int a[4] = {a4.x, a4.y, a4.z, a4.w};
      const int b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ob = out + (long long)bz * dl * dr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= dl) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx * 4 + j;
      if (col < dr) ob[(long long)row * dr + col] = (float)acc[i][j];
    }
  }
}

}  // namespace

// u: (b, n, dl) int8 with batch stride u_sb and row stride u_ld (elements),
// last stride 1; v likewise (b, n, dr). out: contiguous (b, dl, dr) f32.
extern "C" int sign_corr_s8(const void* u, const void* v, void* out, int b,
                            int n, int dl, int dr, long long u_sb,
                            long long u_ld, long long v_sb, long long v_ld,
                            void* stream) {
  if (b == 0 || dl == 0 || dr == 0) return 0;
  dim3 grid((dr + TILE - 1) / TILE, (dl + TILE - 1) / TILE, b);
  sign_corr_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)u, (const int8_t*)v, (float*)out, n, dl, dr, u_sb, u_ld,
      v_sb, v_ld);
  return (int)cudaGetLastError();
}
