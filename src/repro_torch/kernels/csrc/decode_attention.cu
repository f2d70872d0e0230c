// One-token GQA flash-decode against a KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_decode_attn_kernel). For every batch row b and query head h,
// out[b, h] = softmax_i(q[b, h] . k[b, hk, i] / sqrt(Dh)) v[b, hk, i] over
// the cache entries i in [lo, hi) (the caller turns `pos` and the window
// into that range), with hk = h / G.
//
// What bounds it on an H100: bytes. Each cache entry is read once and
// used for G query heads (4 flop per element of K and V and head), far
// below the card's 295 flop per byte, so the least time is the K/V bytes
// over 3.35 TB/s.
//
// Design: one block of 256 threads per (KV head, batch row, chunk of at
// most 64 of its G query heads), so every cache entry streams from device
// memory once per chunk. The block walks the range in tiles of 64 entries
// staged in shared memory as f32 (16-byte loads where the cache's strides
// and address allow, element loads otherwise) and keeps the chunk's
// queries, the scores of the tile and the f32 accumulators there too, so
// the group size lives in no register array. The online softmax runs one
// warp per head. The cache is read through its strides: the model's
// (B, S, Hkv, Dh) cache viewed as (B, Hkv, S, Dh) needs no copy. Entries
// outside [lo, hi) are never read; an empty range writes 0. Every block
// walks the whole range: splitting it across blocks (flash-decoding) is
// the next step for small batches.
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

using attn::Strides;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BS = 64;  // cache entries per tile (two per lane in a warp)
constexpr int PLD = BS + 1;
constexpr int MAX_CHUNK = 64;
constexpr size_t SMEM_LIMIT = 227 * 1024;

template <int DH>
size_t smem_bytes(int gc) {
  return sizeof(float) * (size_t)(2 * gc * DH + gc * PLD + 3 * gc +
                                  BS * (DH + 1) + BS * DH);
}

// Stage the cache rows [s0, s0 + ns) of one KV head as f32: K into Ks
// (rows of DH + 1), V into Vs (rows of DH).
template <typename T, int DH, bool VEC>
__device__ __forceinline__ void load_tile(const T* __restrict__ kb,
                                          const T* __restrict__ vb,
                                          long long kss, long long vss,
                                          int s0, int ns, float* Ks,
                                          float* Vs) {
  constexpr int LD = DH + 1;
  if constexpr (VEC) {
    constexpr int W = 16 / sizeof(T);  // elements per 16-byte load
    constexpr int CH = DH / W;         // loads per row
    for (int i = threadIdx.x; i < ns * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * W;
      const uint4 kw = *reinterpret_cast<const uint4*>(kb + (s0 + r) * kss + c);
      const uint4 vw = *reinterpret_cast<const uint4*>(vb + (s0 + r) * vss + c);
      T ke[W], ve[W];
      memcpy(ke, &kw, sizeof(kw));
      memcpy(ve, &vw, sizeof(vw));
#pragma unroll
      for (int e = 0; e < W; ++e) {
        Ks[r * LD + c + e] = attn::to_f32(ke[e]);
        Vs[r * DH + c + e] = attn::to_f32(ve[e]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ns * DH; i += THREADS) {
      const int r = i / DH, d = i % DH;
      Ks[r * LD + d] = attn::to_f32(kb[(s0 + r) * kss + d]);
      Vs[r * DH + d] = attn::to_f32(vb[(s0 + r) * vss + d]);
    }
  }
}

template <typename T, int DH, bool VEC>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int Hq,
                        int G, int GC, int lo, int hi, long long qsb,
                        long long qsh, Strides ks, Strides vs, float scale) {
  constexpr int LD = DH + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // GC x DH, q * scale
  float* Acc = Qs + GC * DH;     // GC x DH
  float* Ps = Acc + GC * DH;     // GC x PLD: scores, then probabilities
  float* st_m = Ps + GC * PLD;   // running max
  float* st_l = st_m + GC;       // running sum
  float* st_a = st_l + GC;       // rescale factor of this tile
  float* Ks = st_a + GC;         // BS x LD
  float* Vs = Ks + BS * LD;      // BS x DH

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int g0 = blockIdx.z * GC;
  const int gn = min(GC, G - g0);  // query heads of this block
  const int h0 = hk * G + g0;      // its first query head

  for (int i = tid; i < gn * DH; i += THREADS) {
    const int g = i / DH, d = i % DH;
    Qs[i] = attn::to_f32(q[b * qsb + (h0 + g) * qsh + d]) * scale;
    Acc[i] = 0.f;
  }
  if (tid < gn) {
    st_m[tid] = -INFINITY;
    st_l[tid] = 0.f;
  }
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int s0 = lo; s0 < hi; s0 += BS) {
    const int ns = min(BS, hi - s0);
    __syncthreads();  // the previous tile is consumed
    load_tile<T, DH, VEC>(kb, vb, ks.s, vs.s, s0, ns, Ks, Vs);
    __syncthreads();

    for (int i = tid; i < gn * BS; i += THREADS) {
      const int g = i / BS, c = i % BS;
      float s = -INFINITY;
      if (c < ns) {
        const float* qr = Qs + g * DH;
        const float* kr = Ks + c * LD;
        s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) s = fmaf(qr[d], kr[d], s);
      }
      Ps[g * PLD + c] = s;
    }
    __syncthreads();

    for (int g = warp; g < gn; g += WARPS) {  // online softmax, warp per head
      float* pr = Ps + g * PLD;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = st_m[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = x0 == -INFINITY ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == -INFINITY ? 0.f : expf(x1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        st_l[g] = st_l[g] * alpha + sum;
        st_m[g] = m_new;
        st_a[g] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < gn * DH; i += THREADS) {
      const int g = i / DH, d = i % DH;
      const float* pr = Ps + g * PLD;
      float a = Acc[i] * st_a[g];
#pragma unroll 8
      for (int c = 0; c < ns; ++c) a = fmaf(pr[c], Vs[c * DH + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < gn * DH; i += THREADS) {
    const int g = i / DH, d = i % DH;
    out[((long long)b * Hq + h0 + g) * DH + d] =
        attn::from_f32<T>(Acc[i] / fmaxf(st_l[g], 1e-30f));
  }
}

template <typename T, int DH, bool VEC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int lo, int hi, long long qsb, long long qsh,
           Strides ks, Strides vs, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  int gc = G < MAX_CHUNK ? G : MAX_CHUNK;
  while (gc > 1 && smem_bytes<DH>(gc) > SMEM_LIMIT) gc = (gc + 1) / 2;
  const size_t smem = smem_bytes<DH>(gc);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, DH, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B, (G + gc - 1) / gc);
  decode_attention_kernel<T, DH, VEC><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, G, gc, lo, hi, qsb,
      qsh, ks, vs, scale);
  return (int)cudaGetLastError();
}

// 16-byte loads need 16-byte aligned rows: the base addresses and every
// stride of K and V a multiple of 16 bytes.
template <typename T>
bool rows_aligned(const void* k, const void* v, Strides ks, Strides vs) {
  constexpr long long W = 16 / sizeof(T);
  return (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0 && ks.b % W == 0 &&
         ks.s % W == 0 && ks.h % W == 0 && vs.b % W == 0 && vs.s % W == 0 &&
         vs.h % W == 0;
}

template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, void* out,
             int B, int Hq, int Hkv, int lo, int hi, long long qsb,
             long long qsh, Strides ks, Strides vs, float scale,
             cudaStream_t st) {
  const bool vec = rows_aligned<T>(k, v, ks, vs);
#define ATTN_CASE(D)                                                        \
  case D:                                                                   \
    return vec ? launch<T, D, true>(q, k, v, out, B, Hq, Hkv, lo, hi, qsb,  \
                                    qsh, ks, vs, scale, st)                 \
               : launch<T, D, false>(q, k, v, out, B, Hq, Hkv, lo, hi, qsb, \
                                     qsh, ks, vs, scale, st);
  switch (Dh) {
    ATTN_CASE(32)
    ATTN_CASE(48)
    ATTN_CASE(64)
    ATTN_CASE(80)
    ATTN_CASE(96)
    ATTN_CASE(112)
    ATTN_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ATTN_CASE
}

}  // namespace

// q: (B, Hq, Dh) with element strides qsb, qsh; k and v: (B, Hkv, S, Dh)
// with element strides (ksb, ksh, kss) and (vsb, vsh, vss); every feature
// axis has unit stride. f32 (bf16 == 0) or bf16; Dh in {32, 48, 64, 80,
// 96, 112, 128}. Attends to the entries [lo, hi), 0 <= lo, hi <= S. out:
// contiguous (B, Hq, Dh) of q's type.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* out, int bf16, int B, int Hq, int Hkv,
                                int Dh, int lo, int hi, long long qsb,
                                long long qsh, long long ksb, long long ksh,
                                long long kss, long long vsb, long long vsh,
                                long long vss, float scale, void* stream) {
  if (B == 0 || Hq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, out, B, Hq, Hkv, lo, hi, qsb,
                                   qsh, ks, vs, scale, st);
  return dispatch<float>(Dh, q, k, v, out, B, Hq, Hkv, lo, hi, qsb, qsh, ks,
                         vs, scale, st);
}
