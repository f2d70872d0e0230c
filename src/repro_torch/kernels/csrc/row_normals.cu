// Row-keyed standard normals of the trial plane, in one pass:
// out[k, i, j] = scale[k, j] * sqrt(2) * erfinv(u), u the uniform in
// (-1, 1) of bits(fold_in(keys[k], r0 + i), (d,))[j].
//
// Replaces no TPU kernel: repro draws these normals with jax.random
// (repro/core/sampler.py::_row_normals, fused by XLA). The plain PyTorch
// version (kernels/ref.py::row_normals_ref, core/prng.py) emulates uint32
// arithmetic in int64 tensors and runs fold_in, the bits, the uniform and
// the erfinv as ~300 separate passes over the block. This kernel keeps
// every step in registers and writes each normal once.
//
// Bit for bit with the plain version on the card. Every step is the plain
// version's own, in its order: threefry2x32 in uint32; the uniform's
// (b >> 9) | 0x3F800000 less 1, its f64 multiply-add by (hi - lo) and lo
// rounded to f32 and the max against lo; XLA's ErfInv32 with w =
// -log1p(-u^2) in f64 (CUDA's log1p, which PyTorch's f64 log1p calls)
// rounded to f32, w - 2.5 or sqrt(w) - 3 in f32, nine f32 coefficients
// each an f64 multiply then add rounded to f32; then * u, * sqrt(2) and
// * scale in f32. The intrinsics (__dmul_rn, __dadd_rn, __fmul_rn,
// __fsqrt_rn, ...) pin each rounding where nvcc could contract a multiply
// and an add into one FMA. Built without --use_fast_math.
//
// What bounds it on an H100: instruction issue, not memory. A normal is
// ~75 uint32 operations (20 threefry rounds of add, rotate, xor and the
// key injections), ~55 f64 operations (log1p and the polynomial) and ~22
// f32 <-> f64 conversions (a quarter of the f64 rate), against 4 bytes
// written. Design: the row key, threefry of (0, r0 + i) under the trial
// key, is computed once per row and block into shared memory, not once
// per element; a block takes a CHUNK of the flat (t, rows, d) output and
// each thread VEC consecutive elements at a time, so its store is one
// 16-byte float4 and a warp's stores are coalesced; a vector may straddle
// rows (any d), and the last partial vector is stored element by element.
// Blocks cover the output once (4,096 at the sweep's 2^24-element block),
// enough to fill 132 SMs at any t. Indices are 32-bit below 2^31
// elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                          // elements a store
constexpr int UNROLL = 4;                       // vectors a thread
constexpr int CHUNK = THREADS * VEC * UNROLL;   // elements a block

constexpr uint32_t PARITY = 0x1BD11BDAu;
// jax.random.normal's minval: the lowest f32 above -1, -(1 - 2^-24)
constexpr float LO = -0x1.fffffep-1f;
// sqrt(2) rounded to f32
constexpr float SQRT2 = 0x1.6a09e6p+0f;
// XLA's ErfInv32 (Giles 2010), highest first: in w - 2.5 for w < 5 and
// in sqrt(w) - 3 otherwise; the f32 values core/prng.py rounds to
__constant__ float ERFINV_LT5[9] = {
    0x1.e2cb1p-26f,  0x1.70966cp-22f,  -0x1.d8e6aep-19f,
    -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
    -0x1.11c9dep-8f, 0x1.f91ec6p-3f,   0x1.805c5ep+0f};
__constant__ float ERFINV_GE5[9] = {
    -0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
    -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
    0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, of counter words (0, x2) under key (k1, k2):
// core/prng.py::threefry2x32 in native uint32.
__device__ __forceinline__ uint2 threefry(uint32_t k1, uint32_t k2,
                                          uint32_t x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ PARITY};
  uint32_t a = ks[0], b = x2 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = i % 2 == 0 ? 13 : 17, r1 = i % 2 == 0 ? 15 : 29,
              r2 = i % 2 == 0 ? 26 : 16, r3 = i % 2 == 0 ? 6 : 24;
    a += b; b = rotl(b, r0) ^ a;
    a += b; b = rotl(b, r1) ^ a;
    a += b; b = rotl(b, r2) ^ a;
    a += b; b = rotl(b, r3) ^ a;
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(a, b);
}

// core/prng.py::normal of bits(row key, (d,))[j]
__device__ __forceinline__ float normal(uint2 rk, uint32_t j) {
  const uint2 o = threefry(rk.x, rk.y, j);
  const uint32_t bits = o.x ^ o.y;
  // uniform: [1, 2) less 1, exact; then f32(f64 f * (hi - lo) + lo)
  const float f = __fsub_rn(__uint_as_float(bits >> 9 | 0x3F800000u), 1.0f);
  const double range = (double)__fsub_rn(1.0f, LO);
  const float u = fmaxf(
      LO, __double2float_rn(__dadd_rn(__dmul_rn((double)f, range),
                                      (double)LO)));
  // erfinv
  const float w = __double2float_rn(-log1p(-(double)__fmul_rn(u, u)));
  const bool lt = w < 5.0f;
  const double x = (double)(lt ? __fsub_rn(w, 2.5f)
                               : __fsub_rn(__fsqrt_rn(w), 3.0f));
  double p = (double)(lt ? ERFINV_LT5[0] : ERFINV_GE5[0]);
#pragma unroll
  for (int c = 1; c < 9; ++c) {
    const double coef = (double)(lt ? ERFINV_LT5[c] : ERFINV_GE5[c]);
    p = (double)__double2float_rn(__dadd_rn(__dmul_rn(p, x), coef));
  }
  return __fmul_rn(__fmul_rn((float)p, u), SQRT2);
}

// keys: (t, 2) int64 words; scale: (t, d) f32 or null; out: (t, rows, d)
// f32, 16-byte aligned. Dynamic shared memory: max_rows row keys and
// their trial indices (the rows a CHUNK of the output can touch).
template <typename Idx>
__global__ void __launch_bounds__(THREADS)
row_normals_kernel(const long long* __restrict__ keys,
                   const float* __restrict__ scale, float* __restrict__ out,
                   Idx total, Idx rows, Idx d, uint32_t r0) {
  extern __shared__ uint32_t smem[];
  const Idx e_first = (Idx)blockIdx.x * CHUNK;
  const Idx e_end = total - e_first < (Idx)CHUNK ? total : e_first + CHUNK;
  const Idx g_first = e_first / d;  // first row (of t * rows) touched
  const int n_rows = (int)((e_end - 1) / d - g_first) + 1;
  uint2* row_key = reinterpret_cast<uint2*>(smem);
  uint32_t* row_trial = smem + 2 * n_rows;
  for (int r = threadIdx.x; r < n_rows; r += THREADS) {
    const Idx g = g_first + r;
    const Idx k = g / rows;
    row_key[r] = threefry((uint32_t)keys[2 * k], (uint32_t)keys[2 * k + 1],
                          r0 + (uint32_t)(g - k * rows));
    row_trial[r] = (uint32_t)k;
  }
  __syncthreads();

#pragma unroll 1
  for (int v = 0; v < UNROLL; ++v) {
    const Idx e0 = e_first + (Idx)(v * THREADS + threadIdx.x) * VEC;
    if (e0 >= e_end) break;
    const Idx g0 = e0 / d;
    int lr = (int)(g0 - g_first);
    Idx j = e0 - g0 * d;
    float z[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      z[q] = normal(row_key[lr], (uint32_t)j);
      if (scale != nullptr)
        z[q] = __fmul_rn(z[q], scale[(Idx)row_trial[lr] * d + j]);
      if (++j == d) {
        j = 0;
        // past the chunk's last row only beyond e_end, never stored
        if (lr + 1 < n_rows) ++lr;
      }
    }
    if (e0 + VEC <= e_end) {
      *reinterpret_cast<float4*>(out + e0) = make_float4(z[0], z[1], z[2],
                                                         z[3]);
    } else {
      for (int q = 0; q < VEC && e0 + q < e_end; ++q) out[e0 + q] = z[q];
    }
  }
}

template <typename Idx>
int launch(const long long* keys, const float* scale, float* out,
           long long total, long long rows, long long d, uint32_t r0,
           cudaStream_t stream) {
  const long long blocks = (total + CHUNK - 1) / CHUNK;
  const long long max_rows =
      (CHUNK - 1) / d + 2 < CHUNK ? (CHUNK - 1) / d + 2 : CHUNK;
  const size_t smem = (size_t)max_rows * 3 * sizeof(uint32_t);
  row_normals_kernel<Idx><<<(unsigned int)blocks, THREADS, smem, stream>>>(
      keys, scale, out, (Idx)total, (Idx)rows, (Idx)d, r0);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: contiguous (t, 2) int64, each word a uint32; scale: contiguous
// (t, d) f32 or null; out: contiguous (t, rows, d) f32 on a 16-byte
// boundary. Row i of trial k is counter r0 + i (mod 2^32). The caller
// refuses d >= 2^32, as prng.bits does.
extern "C" int row_normals_f32(const void* keys, const void* scale,
                               void* out, long long t, long long rows,
                               long long d, long long r0, void* stream) {
  if (t < 0 || rows < 0 || d < 0 || d >= (1LL << 32) ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long total = t * rows * d;
  if (total == 0) return 0;
  const long long* k = (const long long*)keys;
  const float* s = (const float*)scale;
  float* o = (float*)out;
  const uint32_t r = (uint32_t)(r0 & 0xFFFFFFFFLL);
  cudaStream_t st = (cudaStream_t)stream;
  if (total < (1LL << 31))
    return launch<uint32_t>(k, s, o, total, rows, d, r, st);
  return launch<unsigned long long>(k, s, o, total, rows, d, r, st);
}
