// Sign Gram from bit-packed signs: G = n - 2 * popcount(a XOR b).
//
// Replaces the TPU kernel repro/kernels/sign_corr.py::sign_corr_packed
// (_sign_corr_packed_kernel with the SWAR byte popcount _popcount8), which
// XORed (block_d, block_d, block_b) byte cubes on the vector unit and
// summed them across a sequential trailing grid axis.
//
// Layout: feature-major (b, d, nw) 32-bit words, little bit order — the
// wire's (b, d, ceil(n/8)) uint8 payload with its byte axis zero-padded
// to a multiple of 4 by the wrapper and reinterpreted. Bits beyond n are
// zero in every row, so they XOR to 0 and drop out.
//
// What bounds it on an H100: the integer pipe. At the main path's shape
// (d = 4096, n = 2^18) there are d^2 * n/32 = 1.4e11 word pairs against
// 134 MB of operand bytes, so it is far from memory-bound; each pair is
// an XOR, a POPC and an add. Design: 64x64 output tiles per block, 4x4
// outputs per thread with int32 sums, 16 words of each operand staged
// transposed through shared memory per step so a thread reads four
// features' words with one 16-byte load. The loop over words inside the
// block replaces the TPU's sequential grid axis; blocks are independent.
// Integer-exact: the result is n - 2*pop in int32, converted to f32
// exactly while |G| < 2^24.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;       // output tile edge (features)
constexpr int BW = 16;         // words per stage
constexpr int PAD = 4;         // keeps rows 16-byte aligned, spreads banks
constexpr int THREADS = 256;

__device__ __forceinline__ void stage(const uint32_t* __restrict__ base,
                                      long long ld, int width, int nw,
                                      int w0, int f0,
                                      uint32_t (*dst)[TILE + PAD]) {
  const int w = threadIdx.x & (BW - 1);
  const int fr = threadIdx.x >> 4;           // 0..15
  const bool w_ok = w0 + w < nw;
#pragma unroll
  for (int r = 0; r < TILE / 16; ++r) {
    const int f = fr + 16 * r;
    uint32_t word = 0;
    if (w_ok && f0 + f < width) word = base[(long long)(f0 + f) * ld + w0 + w];
    dst[w][f] = word;
  }
}

__global__ void __launch_bounds__(THREADS)
sign_corr_packed_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        float* __restrict__ out, int n, int dl, int dr,
                        int nw, long long a_sb, long long a_ld,
                        long long b_sb, long long b_ld) {
  __shared__ __align__(16) uint32_t As[BW][TILE + PAD];
  __shared__ __align__(16) uint32_t Bs[BW][TILE + PAD];
  const int bz = blockIdx.z;
  const uint32_t* ab = a + bz * a_sb;
  const uint32_t* bb = b + bz * b_sb;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int pop[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pop[i][j] = 0;

  for (int w0 = 0; w0 < nw; w0 += BW) {
    stage(ab, a_ld, dl, nw, w0, i0, As);
    stage(bb, b_ld, dr, nw, w0, j0, Bs);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < BW; ++w) {
      const uint4 a4 = *reinterpret_cast<const uint4*>(&As[w][ty * 4]);
      const uint4 b4 = *reinterpret_cast<const uint4*>(&Bs[w][tx * 4]);
      const uint32_t av[4] = {a4.x, a4.y, a4.z, a4.w};
      const uint32_t bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pop[i][j] += __popc(av[i] ^ bv[j]);
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
      if (col < dr) ob[(long long)row * dr + col] = (float)(n - 2 * pop[i][j]);
    }
  }
}

}  // namespace

// a: (b, dl, nw) uint32 with batch stride a_sb and row stride a_ld (words),
// last stride 1; bm likewise (b, dr, nw). out: contiguous (b, dl, dr) f32.
extern "C" int sign_corr_packed_u32(const void* a, const void* bm, void* out,
                                    int b, int n, int dl, int dr, int nw,
                                    long long a_sb, long long a_ld,
                                    long long b_sb, long long b_ld,
                                    void* stream) {
  if (b == 0 || dl == 0 || dr == 0) return 0;
  dim3 grid((dr + TILE - 1) / TILE, (dl + TILE - 1) / TILE, b);
  sign_corr_packed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)bm, (float*)out, n, dl, dr, nw,
      a_sb, a_ld, b_sb, b_ld);
  return (int)cudaGetLastError();
}
