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
// 2^18 x 4096 f32, R = 4, codes only) it reads 4.3 GB and writes 1.1 GB,
// 1.6 ms at 3.35 TB/s. Design, so that instruction issue stays below
// that: the rate is a template parameter (R = 1..7) and the code a
// branchless binary search of R compares over the sorted boundaries (the
// first in a register, the rest in shared memory), not L - 1 compares;
// x streams in as float4 (16-byte loads, UNROLL of them in flight a
// thread, consecutive threads on consecutive vectors) and each float4's
// four codes leave as one 4-byte store (values as a float4, packed bits as
// the 4R bits of the vector, R = 1 pairing two lanes by a shuffle);
// indices are 32-bit below 2^31 elements. Blocks stride over tiles of
// THREADS x UNROLL vectors; the elements past the last whole tile (a
// total not a multiple of the tile or of 4) go one symbol group (one
// symbol, or the 8/R of a packed byte) a thread. An x off a 16-byte
// boundary (a view at an offset) is read as four 4-byte loads a vector,
// everything else alike. The values and the packed bytes are written only
// when their pointers are non-null.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                 // vectors in flight a thread
constexpr int TILE = THREADS * UNROLL;    // vectors a block takes at once
constexpr int BLOCKS_PER_SM = 8;
constexpr int MAX_LEVELS = 128;
constexpr float FLT_MIN_NORMAL = 1.17549435e-38f;  // 2^-126

// The count of boundaries b[0..L-2] (sorted) strictly below x: after the
// step of size s, the count lies in [pos, pos + s - 1]. NaN compares
// false throughout (0), +inf true (L - 1). mid = b[L/2 - 1].
template <int R>
__device__ __forceinline__ int encode(float x, float mid, const float* sb) {
  constexpr int L = 1 << R;
  if (fabsf(x) < FLT_MIN_NORMAL) x = 0.0f;
  int pos = x > mid ? L / 2 : 0;
#pragma unroll
  for (int s = L / 4; s >= 1; s >>= 1) pos += x > sb[pos + s - 1] ? s : 0;
  return pos;
}

template <bool VEC, typename Idx>
__device__ __forceinline__ float4 load4(const float* __restrict__ x, Idx v) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const float4*>(x) + v);
  } else {
    const float* p = x + 4 * v;
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
}

template <int R, bool VEC, typename Idx>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x,
                const float* __restrict__ boundaries,
                const float* __restrict__ centroids,
                int8_t* __restrict__ codes, float* __restrict__ values,
                uint8_t* __restrict__ packed, Idx total) {
  constexpr int L = 1 << R;
  constexpr bool CAN_PACK = 8 % R == 0;
  __shared__ float sb[MAX_LEVELS];
  __shared__ float sc[MAX_LEVELS];
  for (int i = threadIdx.x; i < L; i += THREADS) {
    sb[i] = i < L - 1 ? boundaries[i] : 0.0f;
    sc[i] = centroids[i];
  }
  __syncthreads();
  const float mid = sb[L / 2 - 1];
  const bool pack = CAN_PACK && packed != nullptr;

  const Idx tiles = total / (4 * TILE);
  for (Idx t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Idx v0 = t * TILE + threadIdx.x;
    float4 xv[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) xv[k] = load4<VEC>(x, v0 + k * THREADS);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const Idx v = v0 + k * THREADS;
      const uint32_t c0 = encode<R>(xv[k].x, mid, sb);
      const uint32_t c1 = encode<R>(xv[k].y, mid, sb);
      const uint32_t c2 = encode<R>(xv[k].z, mid, sb);
      const uint32_t c3 = encode<R>(xv[k].w, mid, sb);
      reinterpret_cast<uint32_t*>(codes)[v] =
          c0 | c1 << 8 | c2 << 16 | c3 << 24;
      if (values != nullptr)
        reinterpret_cast<float4*>(values)[v] =
            make_float4(sc[c0], sc[c1], sc[c2], sc[c3]);
      if constexpr (CAN_PACK) {
        if (pack) {  // the vector's 4R bits, symbol i at bit i R
          const uint32_t bits = c0 | c1 << R | c2 << 2 * R | c3 << 3 * R;
          if constexpr (R == 4) {
            reinterpret_cast<uint16_t*>(packed)[v] = (uint16_t)bits;
          } else if constexpr (R == 2) {
            packed[v] = (uint8_t)bits;
          } else {  // R = 1: the even lane's vector is the byte's low half
            const uint32_t hi = __shfl_down_sync(0xffffffffu, bits, 1);
            if ((threadIdx.x & 1) == 0)
              packed[v >> 1] = (uint8_t)(bits | hi << 4);
          }
        }
      }
    }
  }

  // past the last whole tile: one symbol group a thread (the caller makes
  // the total a multiple of the group when packing)
  const int group = pack ? 8 / R : 1;
  const Idx stride = (Idx)gridDim.x * THREADS;
  for (Idx g = tiles * 4 * TILE / group + (Idx)blockIdx.x * THREADS +
               threadIdx.x;
       g < total / group; g += stride) {
    uint32_t byte = 0;
    for (int s = 0; s < group; ++s) {
      const Idx e = g * group + s;
      const uint32_t c = encode<R>(x[e], mid, sb);
      codes[e] = (int8_t)c;
      if (values != nullptr) values[e] = sc[c];
      byte |= c << (s * R);
    }
    if (pack) packed[g] = (uint8_t)byte;
  }
}

template <int R, typename Idx>
int launch(const float* x, const float* boundaries, const float* centroids,
           int8_t* codes, float* values, uint8_t* packed, Idx total,
           int num_sms, cudaStream_t stream) {
  const int group = packed != nullptr ? 8 / R : 1;
  const long long tiles = (long long)total / (4 * TILE);
  const long long rest = ((long long)total - tiles * 4 * TILE) / group;
  const long long blocks =
      std::max(1LL, std::min(std::max(tiles, (rest + THREADS - 1) / THREADS),
                             (long long)num_sms * BLOCKS_PER_SM));
  auto kernel = (uintptr_t)x % 16 == 0 ? quantize_kernel<R, true, Idx>
                                       : quantize_kernel<R, false, Idx>;
  kernel<<<(unsigned int)blocks, THREADS, 0, stream>>>(
      x, boundaries, centroids, codes, values, packed, total);
  return (int)cudaGetLastError();
}

template <int R>
int launch_rate(const float* x, const float* boundaries,
                const float* centroids, int8_t* codes, float* values,
                uint8_t* packed, long long total, int num_sms,
                cudaStream_t stream) {
  if (total < (1LL << 31))
    return launch<R, uint32_t>(x, boundaries, centroids, codes, values,
                               packed, (uint32_t)total, num_sms, stream);
  return launch<R, unsigned long long>(x, boundaries, centroids, codes,
                                       values, packed,
                                       (unsigned long long)total, num_sms,
                                       stream);
}

}  // namespace

// x: contiguous f32 of `total` elements (4-byte aligned). codes: int8 of
// the same size; values (f32, same size) and packed (uint8, total / (8 /
// rate)) may be null; all three start on a 16-byte boundary. L = 2^rate
// levels (L - 1 sorted boundaries). Packing needs rate | 8 and the last
// axis a multiple of 8 / rate (checked by the caller), so flat groups
// never straddle rows.
extern "C" int quantize_f32(const void* x, const void* boundaries,
                            const void* centroids, int L, void* codes,
                            void* values, void* packed, long long total,
                            int rate, int num_sms, void* stream) {
  if (total == 0) return 0;
  if (rate < 1 || rate > 7 || L != 1 << rate ||
      (packed != nullptr && (8 % rate != 0 || total % (8 / rate) != 0)))
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* bf = (const float*)boundaries;
  const float* cf = (const float*)centroids;
  int8_t* co = (int8_t*)codes;
  float* va = (float*)values;
  uint8_t* pa = (uint8_t*)packed;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rate) {
    case 1: return launch_rate<1>(xf, bf, cf, co, va, pa, total, num_sms, s);
    case 2: return launch_rate<2>(xf, bf, cf, co, va, pa, total, num_sms, s);
    case 3: return launch_rate<3>(xf, bf, cf, co, va, pa, total, num_sms, s);
    case 4: return launch_rate<4>(xf, bf, cf, co, va, pa, total, num_sms, s);
    case 5: return launch_rate<5>(xf, bf, cf, co, va, pa, total, num_sms, s);
    case 6: return launch_rate<6>(xf, bf, cf, co, va, pa, total, num_sms, s);
    default: return launch_rate<7>(xf, bf, cf, co, va, pa, total, num_sms, s);
  }
}
