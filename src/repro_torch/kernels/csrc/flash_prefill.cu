// Full-sequence GQA flash attention (prefill), causal and sliding window.
//
// Replaces the TPU kernel repro/kernels/flash_prefill.py::flash_prefill
// (_flash_prefill_kernel). out[b, i, h] = softmax_k(q_i . k_k / sqrt(Dh))
// v_k over the keys k that query i sees: k <= i when causal, k > i - window
// when window > 0. Query head h reads KV head h / (Hq / Hkv).
//
// What bounds it on an H100: operations. At the serving shape (B = 8,
// S = 2048, 32 query and 8 KV heads of 128, causal) it does 2.7e11 flop
// against 0.34 GB of q, k, v and out. This first version runs them in f32
// on the CUDA cores, not on the tensor cores, so it sits far above that
// bound.
//
// Design: one block of 256 threads per (batch, query head, tile of 64
// query rows); the Pallas kernel's sequential kv grid axis becomes a loop
// inside the block. Each key tile of 64 rows is staged in shared memory
// as f32, first K (scores, a 4 x 4 register tile per thread), then V
// (output, 4 rows x Dh/16 columns per thread in registers). The online
// softmax (running max m, sum l, f32 accumulator) keeps scores out of
// device memory. Masked scores are -inf and their probability is an
// exact 0, so a row whose keys are all masked ends with l = 0 and writes
// 0 (the division is guarded by max(l, 1e-30), as in the Pallas kernel).
// Tiles wholly above the causal diagonal or before the window are
// skipped, and the longest causal rows are launched first.
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace {

using attn::Strides;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = 4;         // score / output rows per thread
constexpr int TN = 4;         // score columns per thread (stride 16)
constexpr int PLD = BK + 1;   // padded row of the probability tile

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)((BQ + BK) * (DH + 1) + BQ * PLD + 3 * BQ);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Skv, int Hq, int G, Strides qs, Strides ks,
                     Strides vs, int causal, int window, float scale) {
  constexpr int LD = DH + 1;     // odd row length: conflict-free columns
  constexpr int COLS = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x LD, q * scale
  float* KV = Qs + BQ * LD;      // BK x LD: K of the tile, then its V
  float* Ps = KV + BK * LD;      // BQ x PLD: scores, then probabilities
  float* row_m = Ps + BQ * PLD;  // running max
  float* row_l = row_m + BQ;     // running sum
  float* row_a = row_l + BQ;     // rescale factor of this tile

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, qp = q0 + r;
    Qs[r * LD + d] = qp < Sq ? attn::to_f32(qb[qp * qs.s + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[TM][COLS];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[i][j] = 0.f;

  // the key tiles that can hold a key visible to rows [q0, q0 + BQ)
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(Skv, min(q0 + BQ, Sq));
  if (window > 0) k_lo = max(0, q0 - window + 1);
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's V and P are consumed
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i % DH, kp = k0 + r;
      KV[r * LD + d] = kp < Skv ? attn::to_f32(kb[kp * ks.s + d]) : 0.f;
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[TM], bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Qs[(ty * TM + i) * LD + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) bk[j] = KV[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j, kp = k0 + c;
        bool ok = kp < Skv;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && kp > qp - window;
        Ps[r * PLD + c] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    {  // online softmax: 4 neighbouring lanes share a row, 16 keys each
      const int r = tid / 4, part = tid % 4;
      float* pr = Ps + r * PLD + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = pr[c] == -INFINITY ? 0.f : expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
        row_a[r] = alpha;
      }
    }
    __syncthreads();  // K is consumed: stage V in its place
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i % DH, kp = k0 + r;
      KV[r * LD + d] = kp < Skv ? attn::to_f32(vb[kp * vs.s + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float a = row_a[ty * TM + i];
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) vv[j] = KV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = Ps[(ty * TM + i) * PLD + c];
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i, qp = q0 + r;
    if (qp >= Sq) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
    T* o = out + (((long long)b * Sq + qp) * Hq + h) * DH;
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      o[tx + 16 * j] = attn::from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int Hq, int G, Strides qs, Strides ks, Strides vs,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, Hq, G, qs, ks,
      vs, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Skv, int Hq, int G, Strides qs, Strides ks,
             Strides vs, int causal, int window, float scale,
             cudaStream_t st) {
#define ATTN_CASE(D)                                                      \
  case D:                                                                 \
    return launch<T, D>(q, k, v, out, B, Sq, Skv, Hq, G, qs, ks, vs,      \
                        causal, window, scale, st);
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

// q: (B, Sq, Hq, Dh), k and v: (B, Skv, Hkv, Dh), f32 (bf16 == 0) or bf16,
// each with a unit-stride feature axis and the given element strides of
// its batch, sequence and head axes. out: contiguous (B, Sq, Hq, Dh) of
// q's type. Dh in {32, 48, 64, 80, 96, 112, 128}; Hkv divides Hq.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int bf16, int B, int Sq, int Skv,
                             int Hq, int Hkv, int Dh, long long qsb,
                             long long qss, long long qsh, long long ksb,
                             long long kss, long long ksh, long long vsb,
                             long long vss, long long vsh, int causal,
                             int window, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const int G = Hq / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, out, B, Sq, Skv, Hq, G, qs,
                                   ks, vs, causal, window, scale, st);
  return dispatch<float>(Dh, q, k, v, out, B, Sq, Skv, Hq, G, qs, ks, vs,
                         causal, window, scale, st);
}
