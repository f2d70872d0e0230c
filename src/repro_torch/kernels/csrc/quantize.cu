// Fused per-symbol quantizer: R-bit encode, optional centroid decode and
// optional dense R-bit pack, in one pass over x.
//
// Replaces the TPU kernel repro/kernels/quantize.py::quantize_fused
// (_quantize_kernel / _quantize_pack_kernel). The code of x is the count
// of interior boundaries strictly below it, so NaN gives 0, +inf gives
// L-1 and a value equal to a boundary falls in the lower bin — exactly
// repro.core.quantizers.PerSymbolQuantizer.encode. A subnormal x counts as
// 0.0, as XLA (denormals-are-zero) reads it there; the flush is explicit
// because this file is not compiled with -ftz.
//
// What bounds it on an H100: memory. At the main path's shape (x of
// 2^18 x 4096 f32, R = 4) it reads 4.3 GB and writes 1.1 GB of codes
// against 15 compares per element. The boundaries and centroids (at most
// 127 and 128 f32 values) sit in shared memory; each thread handles one
// group of symbols (one symbol, or the 8/R symbols of one packed byte),
// so consecutive threads touch consecutive addresses, and a grid-stride
// loop covers any size. The values and the packed bytes are written only
// when their pointers are non-null.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 128;
constexpr float FLT_MIN_NORMAL = 1.17549435e-38f;  // 2^-126

__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x,
                const float* __restrict__ boundaries,
                const float* __restrict__ centroids, int L,
                int8_t* __restrict__ codes, float* __restrict__ values,
                uint8_t* __restrict__ packed, long long groups, int group,
                int rate) {
  __shared__ float sb[MAX_LEVELS];
  __shared__ float sc[MAX_LEVELS];
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    sb[i] = i < L - 1 ? boundaries[i] : 0.0f;
    sc[i] = centroids[i];
  }
  __syncthreads();
  const int nb = L - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    unsigned int byte = 0;
    for (int s = 0; s < group; ++s) {
      const long long idx = g * group + s;
      float xv = x[idx];
      if (fabsf(xv) < FLT_MIN_NORMAL) xv = 0.0f;
      int c = 0;
      for (int i = 0; i < nb; ++i) c += xv > sb[i];
      codes[idx] = (int8_t)c;
      if (values != nullptr) values[idx] = sc[c];
      byte |= (unsigned int)c << (s * rate);
    }
    if (packed != nullptr) packed[g] = (uint8_t)byte;
  }
}

}  // namespace

// x: contiguous f32 of `total` elements. codes: int8 of the same size;
// values (f32, same size) and packed (uint8, total / (8 / rate)) may be
// null. Packing needs rate | 8 and the last axis a multiple of 8 / rate
// (checked by the caller), so flat groups never straddle rows.
extern "C" int quantize_f32(const void* x, const void* boundaries,
                            const void* centroids, int L, void* codes,
                            void* values, void* packed, long long total,
                            int rate, int num_sms, void* stream) {
  if (total == 0) return 0;
  if (L < 2 || L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const int group = packed != nullptr ? 8 / rate : 1;
  const long long groups = total / group;
  long long blocks = (groups + THREADS - 1) / THREADS;
  const long long cap = (long long)num_sms * 32;
  if (blocks > cap) blocks = cap;
  quantize_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)boundaries, (const float*)centroids, L,
      (int8_t*)codes, (float*)values, (uint8_t*)packed, groups, group, rate);
  return (int)cudaGetLastError();
}
