// One-token GQA flash-decode against a KV cache, the cache split across
// blocks (flash-decoding) and the splits combined in the same launch.
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
// over 3.35 TB/s. At the serving shape (B = 8, 8 KV heads) one block per
// (KV head, batch row) would give 64 blocks for 132 SMs, each streaming
// its whole range alone; the range is therefore split across blocks. And
// the arithmetic, cheap as it is, must not cost the CUDA cores more
// issue slots than the bytes take: in bf16 each element would be widened
// and multiplied once per query head, so both products run on the
// tensor cores.
//
// Design. Grid (split, KV head x chunk of at most 64 of its G query
// heads, batch row); blocks of 256 threads. The split count fills one
// wave: the SMs times the blocks that fit on one SM, over the (KV head,
// chunk, batch row) groups, no more splits than 64-entry tiles. A split
// walks its tiles through a KV_STAGES-deep cp.async ring: K and V stay
// in their own dtype in shared memory (rows padded by 16 bytes, so that
// neighbouring rows fall in different banks).
// - bf16: S = Q K^T and O += P V by mma.sync m16n8k16 (f32 sums), the
//   chunk's heads padded to m16 tiles: warp w computes the scores of
//   entries 8w .. 8w + 7 (scaled in f32), and the output columns of its
//   n8 tiles, whose accumulators stay in registers across the tiles; P is
//   rounded to bf16 for the product, as flash_prefill rounds it.
// - f32: the two products on the CUDA cores, one score or two output
//   columns a thread, accumulators in shared memory.
// The online softmax (base 2, one warp per head) works on f32 scores in
// shared memory. With more than one split each block writes its partial
// (max, sum, accumulator) to a partials buffer the caller keeps, then
// takes a ticket from its group's atomic counter (in a counter buffer of
// its own, so that no shape's partials overlap another's counters, and
// zero between launches); the block that finishes
// last combines the partials in split order (so the result does not
// depend on which block finished last) and resets the counter to 0.
// The combine is no second launch: the decode step is host-bound, and a
// launch costs host time. A split with no entry (forced split counts, an
// empty range) contributes max -inf, sum 0 and adds nothing; a group with
// no valid entry at all writes 0. Entries outside [lo, hi) are never read.
// Rows whose address or strides are off 16 bytes are staged by element
// loads instead of cp.async.
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "attn_common.cuh"

namespace {

using attn::Strides;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BS = 64;  // cache entries per tile (two per lane in a warp)
constexpr int PLD = BS + 1;
constexpr int MAX_CHUNK = 64;
constexpr int KV_STAGES = 2;  // K/V tiles in flight or in use per block
// dynamic shared memory a block may take: the card's 227 KiB less room
// for the kernel's static `last` flag
constexpr int SMEM_LIMIT = 227 * 1024 - 64;
constexpr float LOG2E = 1.4426950408889634f;

// Bytes of one staged K or V row (16 bytes of padding) and of one tile.
template <typename T, int DH>
__host__ __device__ constexpr int row_bytes() {
  return DH * (int)sizeof(T) + 16;
}
template <typename T, int DH>
__host__ __device__ constexpr int tile_bytes() {
  return BS * row_bytes<T, DH>();
}

// bf16 runs its two products on the tensor cores (below); f32 on the CUDA
// cores, for the f32 card-vs-CPU checks.
template <typename T>
constexpr bool kMma = sizeof(T) == 2;

// Rows of the bf16 operand tiles of the tensor-core path: the chunk's
// heads padded to m16 tiles (at most 4, GC <= 64).
__host__ __device__ constexpr int mma_rows(int gc) {
  return (gc + 15) / 16 * 16;
}

// Shared memory, in this order: KV_STAGES stages of K and V tiles; in
// f32 the accumulators (gc x DH), the scores then probabilities
// (gc x PLD), max, sum and rescale (gc each); then, 16-byte aligned, the
// queries: f32 (gc x DH, scaled) on the CUDA cores, or bf16 Q and P
// tiles (mma_rows x DH + 8 and mma_rows x BS + 8: rows padded by 16 bytes
// against bank conflicts of ldmatrix) on the tensor cores.
template <typename T, int DH>
__host__ __device__ constexpr int q_offset(int gc) {
  return (2 * KV_STAGES * tile_bytes<T, DH>() +
          4 * (gc * DH + gc * PLD + 3 * gc) + 15) / 16 * 16;
}
template <typename T, int DH>
size_t smem_bytes(int gc) {
  const size_t q = kMma<T> ? 2 * (size_t)mma_rows(gc) * (DH + 8 + BS + 8)
                           : 4 * (size_t)gc * DH;
  return q_offset<T, DH>(gc) + q;
}

// Floats of one split's partial: max and sum per head, then gc x DH.
template <int DH>
__host__ __device__ constexpr long long part_floats(int gc) {
  return (long long)gc * (DH + 2);
}

// Stage the cache rows [s0, s0 + ns) of one KV head into Ks and Vs
// (rows of row_bytes, in the cache's dtype): 16-byte cp.async copies
// (committed by the caller) or element loads. On the tensor cores the
// rows ns .. BS - 1 of a short tile are zeroed too (0 x a stale NaN would
// be NaN in the product).
template <typename T, int DH, bool VEC>
__device__ __forceinline__ void load_tile(const T* __restrict__ kb,
                                          const T* __restrict__ vb,
                                          long long kss, long long vss,
                                          int s0, int ns, unsigned char* Ks,
                                          unsigned char* Vs) {
  constexpr int RB = row_bytes<T, DH>();
  constexpr int W = 16 / sizeof(T);  // elements per 16-byte word
  constexpr int CH = DH / W;         // words per row
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < ns * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      attn::cp_async16(Ks + r * RB + c * 16, kb + (s0 + r) * kss + c * W);
      attn::cp_async16(Vs + r * RB + c * 16, vb + (s0 + r) * vss + c * W);
    }
  } else {
    for (int i = threadIdx.x; i < ns * DH; i += THREADS) {
      const int r = i / DH, d = i % DH;
      reinterpret_cast<T*>(Ks + r * RB)[d] = kb[(s0 + r) * kss + d];
      reinterpret_cast<T*>(Vs + r * RB)[d] = vb[(s0 + r) * vss + d];
    }
  }
  if constexpr (kMma<T>) {
    for (int i = ns * CH + threadIdx.x; i < BS * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      *reinterpret_cast<uint4*>(Ks + r * RB + c * 16) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Vs + r * RB + c * 16) = make_uint4(0, 0, 0, 0);
    }
  }
}

// s + q . w over the 16 bytes w of an f32 row (4 elements).
__device__ __forceinline__ float dot16(const float* q, uint4 w, float s) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  s = fmaf(a.x, __uint_as_float(w.x), s);
  s = fmaf(a.y, __uint_as_float(w.y), s);
  s = fmaf(a.z, __uint_as_float(w.z), s);
  return fmaf(a.w, __uint_as_float(w.w), s);
}

// two blocks of the serving shape's 78 KB fit on an SM: 128 registers
template <typename T, int DH, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int Hq,
                        int G, int GC, int lo, int hi, int tiles_per_split,
                        long long qsb, long long qsh, Strides ks, Strides vs,
                        float scale_log2, int* __restrict__ counters,
                        float* __restrict__ parts) {
  constexpr bool MMA = kMma<T>;
  constexpr int RB = row_bytes<T, DH>();
  constexpr int TB = tile_bytes<T, DH>();
  constexpr int QLD = DH + 8, PLB = BS + 8;  // bf16 row lengths
  constexpr int NT = DH / 8;                 // n8 tiles of the output
  constexpr int NTW = (NT + WARPS - 1) / WARPS;  // of them a warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* Acc = reinterpret_cast<float*>(smem + 2 * KV_STAGES * TB);
  float* Ps = Acc + GC * DH;     // GC x PLD: scores, then probabilities
  float* st_m = Ps + GC * PLD;   // running max (base 2)
  float* st_l = st_m + GC;       // running sum
  float* st_a = st_l + GC;       // rescale factor of this tile
  unsigned char* qreg = smem + q_offset<T, DH>(GC);
  float* Qs = reinterpret_cast<float*>(qreg);            // f32 path
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(qreg);  // bf16 path
  __nv_bfloat16* Pb = Qb + mma_rows(GC) * QLD;
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, splits = gridDim.x;
  const int chunks = (G + GC - 1) / GC;
  const int hk = blockIdx.y / chunks, chunk = blockIdx.y % chunks;
  const int b = blockIdx.z;
  const int g0 = chunk * GC;
  const int gn = min(GC, G - g0);  // query heads of this block
  const int h0 = hk * G + g0;      // its first query head
  const int mt_n = (gn + 15) / 16;  // m16 tiles of heads (tensor cores)

  if constexpr (MMA) {  // Q as is and P zero, padding rows included
    for (int i = tid; i < mma_rows(GC) * QLD; i += THREADS) {
      const int g = i / QLD, d = i % QLD;
      Qb[i] = g < gn && d < DH ? q[b * qsb + (h0 + g) * qsh + d]
                               : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < mma_rows(GC) * PLB; i += THREADS)
      Pb[i] = __float2bfloat16_rn(0.f);
  } else {
    for (int i = tid; i < gn * DH; i += THREADS) {
      const int g = i / DH, d = i % DH;
      Qs[i] = attn::to_f32(q[b * qsb + (h0 + g) * qsh + d]) * scale_log2;
      Acc[i] = 0.f;
    }
  }
  if (tid < gn) {
    st_m[tid] = -INFINITY;
    st_l[tid] = 0.f;
  }
  // tensor cores: the P V accumulator of m16 tile mt and the warp's n8
  // tile j (columns 8 (NTW warp + j) ..), in the C fragment layout
  float o[4][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // this split's tiles [t0, t0 + nt) of the range
  const int tiles = hi > lo ? (hi - lo + BS - 1) / BS : 0;
  const int t0 = min(tiles, split * tiles_per_split);
  const int nt = min(tiles, t0 + tiles_per_split) - t0;
  // tile t into buffer t % KV_STAGES; with cp.async one commit group per
  // tile (empty past the split's end), so that waiting for all but the
  // newest KV_STAGES - 1 groups waits for tile t
  auto stage = [&](int t) {
    if (t < nt) {
      const int s0 = lo + (t0 + t) * BS;
      unsigned char* Ks = smem + (t % KV_STAGES) * 2 * TB;
      load_tile<T, DH, VEC>(kb, vb, ks.s, vs.s, s0, min(BS, hi - s0), Ks,
                            Ks + TB);
    }
    if (VEC) attn::cp_async_commit();
  };
  if (VEC)
    for (int t = 0; t < KV_STAGES - 1; ++t) stage(t);

  for (int t = 0; t < nt; ++t) {
    const int s0 = lo + (t0 + t) * BS, ns = min(BS, hi - s0);
    if (VEC) {
      // tile t + KV_STAGES - 1 goes into the buffer that tile t - 1 used:
      // the barrier that ended the last step saw it consumed
      stage(t + KV_STAGES - 1);
      attn::cp_async_wait<KV_STAGES - 1>();
    } else {
      stage(t);
    }
    __syncthreads();  // tile t (and, at t = 0, Q) visible to all
    const unsigned char* Ks = smem + (t % KV_STAGES) * 2 * TB;
    const unsigned char* Vs = Ks + TB;

    if constexpr (MMA) {
      // S = Q K^T: warp w takes entries 8w .. 8w + 7 (one n8 tile), every
      // m16 tile of heads; scaled to base 2 in f32, entries >= ns -inf
      const int c0 = 8 * warp;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mt_n) break;
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t a[4], bk[2];
          attn::ldmatrix_x4(a, Qb + (mt * 16 + lane % 16) * QLD + kk * 16 +
                                   (lane / 16) * 8);
          attn::ldmatrix_x2(bk, Ks + (c0 + lane % 8) * RB +
                                    (kk * 16 + (lane / 8) % 2 * 8) * 2);
          attn::mma_bf16_16816(sc, a, bk);
        }
        const int c = c0 + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = mt * 16 + lane / 4 + 8 * (e / 2), cc = c + e % 2;
          if (g < gn) Ps[g * PLD + cc] = cc < ns ? sc[e] * scale_log2
                                                 : -INFINITY;
        }
      }
    } else {
      constexpr int CH = DH / 4;  // 16-byte words of an f32 row
      for (int i = tid; i < gn * BS; i += THREADS) {
        const int g = i / BS, c = i % BS;
        float s = -INFINITY;
        if (c < ns) {
          const float* qr = Qs + g * DH;
          const unsigned char* kr = Ks + c * RB;
          float sa[2] = {0.f, 0.f};  // two independent chains
#pragma unroll 4
          for (int w = 0; w < CH; ++w)
            sa[w & 1] = dot16(qr + w * 4,
                              *reinterpret_cast<const uint4*>(kr + 16 * w),
                              sa[w & 1]);
          s = sa[0] + sa[1];
        }
        Ps[g * PLD + c] = s;
      }
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
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has an entry
      const float p0 = x0 == -INFINITY ? 0.f : exp2f(x0 - m_new);
      const float p1 = x1 == -INFINITY ? 0.f : exp2f(x1 - m_new);
      if constexpr (MMA) {
        Pb[g * PLB + lane] = __float2bfloat16_rn(p0);
        Pb[g * PLB + lane + 32] = __float2bfloat16_rn(p1);
      } else {
        pr[lane] = p0;
        pr[lane + 32] = p1;
      }
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
        st_l[g] = st_l[g] * alpha + sum;
        st_m[g] = m_new;
        st_a[g] = alpha;
      }
    }
    __syncthreads();

    if constexpr (MMA) {
      // O = O alpha + P V: warp w takes the n8 tiles NTW w .. NTW w +
      // NTW - 1 of the output columns, every m16 tile of heads, all 64
      // entries (rows of P and V past ns are 0)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= mt_n) break;
        const int r0 = mt * 16 + lane / 4;
        const float a0 = r0 < gn ? st_a[r0] : 0.f;
        const float a1 = r0 + 8 < gn ? st_a[r0 + 8] : 0.f;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          o[mt][j][0] *= a0;
          o[mt][j][1] *= a0;
          o[mt][j][2] *= a1;
          o[mt][j][3] *= a1;
        }
#pragma unroll
        for (int ks16 = 0; ks16 < BS / 16; ++ks16) {
          uint32_t a[4];
          attn::ldmatrix_x4(a, Pb + (mt * 16 + lane % 16) * PLB +
                                   ks16 * 16 + (lane / 16) * 8);
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            const int n0 = 8 * (NTW * warp + j);
            if (n0 >= DH) break;
            uint32_t bv[2];
            attn::ldmatrix_x2_trans(
                bv, Vs + (ks16 * 16 + lane % 16) * RB + n0 * 2);
            attn::mma_bf16_16816(o[mt][j], a, bv);
          }
        }
      }
    } else {
      for (int i = tid; i < gn * DH / 2; i += THREADS) {
        const int g = i / (DH / 2), d = 2 * (i % (DH / 2));
        const float* pr = Ps + g * PLD;
        float2* acc = reinterpret_cast<float2*>(Acc + g * DH + d);
        const float alpha = st_a[g];
        float2 a = *acc, bb = make_float2(0.f, 0.f);  // even, odd entries
        a.x *= alpha;
        a.y *= alpha;
        int c = 0;
#pragma unroll 4
        for (; c + 1 < ns; c += 2) {
          const float2 v0 =
              *reinterpret_cast<const float2*>(Vs + c * RB + 4 * d);
          const float2 v1 =
              *reinterpret_cast<const float2*>(Vs + (c + 1) * RB + 4 * d);
          a.x = fmaf(pr[c], v0.x, a.x);
          a.y = fmaf(pr[c], v0.y, a.y);
          bb.x = fmaf(pr[c + 1], v1.x, bb.x);
          bb.y = fmaf(pr[c + 1], v1.y, bb.y);
        }
        if (c < ns) {
          const float2 v0 =
              *reinterpret_cast<const float2*>(Vs + c * RB + 4 * d);
          a.x = fmaf(pr[c], v0.x, a.x);
          a.y = fmaf(pr[c], v0.y, a.y);
        }
        *acc = make_float2(a.x + bb.x, a.y + bb.y);
      }
    }
    __syncthreads();  // the tile's buffers and scores are consumed
  }
  if constexpr (MMA) {  // the accumulators into Acc, rows < gn
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= mt_n) break;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n0 = 8 * (NTW * warp + j);
        if (n0 >= DH) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = mt * 16 + lane / 4 + 8 * (e / 2);
          if (g < gn) Acc[g * DH + n0 + 2 * (lane % 4) + e % 2] = o[mt][j][e];
        }
      }
    }
  }
  __syncthreads();  // Acc and the state complete (also with no tile)

  T* ob = out + ((long long)b * Hq + h0) * DH;
  if (splits == 1) {
    for (int i = tid; i < gn * DH; i += THREADS)
      ob[i] = attn::from_f32<T>(Acc[i] / fmaxf(st_l[i / DH], 1e-30f));
    return;
  }

  // this split's partial, then a ticket; the last block combines
  const int group = (b * gridDim.y) + blockIdx.y;
  const long long pf = part_floats<DH>(GC);
  float* base = parts + (long long)group * splits * pf;
  float* mine = base + split * pf;
  if (tid < gn) {
    mine[tid] = st_m[tid];
    mine[GC + tid] = st_l[tid];
  }
  for (int i = tid; i < gn * DH; i += THREADS) mine[2 * GC + i] = Acc[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + group, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  if (tid < gn) {  // the max over splits and the sum rescaled to it
    float M = -INFINITY, L = 0.f;
    for (int s = 0; s < splits; ++s)
      M = fmaxf(M, __ldcg(base + s * pf + tid));
    if (M != -INFINITY)
      for (int s = 0; s < splits; ++s)
        L += __ldcg(base + s * pf + GC + tid) *
             exp2f(__ldcg(base + s * pf + tid) - M);
    st_m[tid] = M;
    st_l[tid] = L;
  }
  __syncthreads();
  for (int i = tid; i < gn * DH; i += THREADS) {
    const int g = i / DH;
    const float M = st_m[g];
    float a = 0.f;
    if (M != -INFINITY) {
      for (int s = 0; s < splits; ++s) {  // in split order
        const float m = __ldcg(base + s * pf + g);
        if (m != -INFINITY)
          a = fmaf(__ldcg(base + s * pf + 2 * GC + i), exp2f(m - M), a);
      }
      a /= fmaxf(st_l[g], 1e-30f);
    }
    ob[i] = attn::from_f32<T>(a);
  }
  if (tid == 0) counters[group] = 0;  // ready for the next launch
}

// What a launch does at this shape and range: the chunk size, the split
// count, tiles per split, and the counters and partial bytes it needs
// (0 with one split).
struct Plan {
  int gc, chunks, splits, tiles_per_split;
  long long counters, part_bytes;
};

// The blocks of `kernel` with `smem` bytes that one wave of the current
// card holds: its SMs times the blocks an SM holds.
template <typename K>
int wave_slots(K kernel, size_t smem, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// forced > 0 fixes the split count (splits may then hold no tile);
// otherwise one wave of blocks, no split shorter than a tile.
template <typename T, int DH>
int make_plan(int B, int Hq, int Hkv, int lo, int hi, int forced, Plan* p) {
  static bool attr = false;
  if (!attr) {  // both variants may take the largest tiles, and as many
                // blocks an SM as its shared memory holds
    for (auto kern : {decode_attention_kernel<T, DH, true>,
                      decode_attention_kernel<T, DH, false>}) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return (int)e;
    }
    attr = true;
  }
  const int G = Hq / Hkv;
  int gc = G < MAX_CHUNK ? G : MAX_CHUNK;
  while (gc > 1 && smem_bytes<T, DH>(gc) > SMEM_LIMIT) gc = (gc + 1) / 2;
  if (smem_bytes<T, DH>(gc) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int chunks = (G + gc - 1) / gc;
  const long long groups = (long long)B * Hkv * chunks;
  const int tiles = hi > lo ? (hi - lo + BS - 1) / BS : 0;
  int splits = forced;
  if (splits <= 0) {
    static int slots_cache[MAX_CHUNK + 1] = {0};  // by gc (one card)
    if (slots_cache[gc] == 0) {
      const int e = wave_slots(decode_attention_kernel<T, DH, true>,
                               smem_bytes<T, DH>(gc), &slots_cache[gc]);
      if (e != 0) return e;
    }
    const long long want = slots_cache[gc] / groups;
    splits = (int)(want < tiles ? want : tiles);
    if (splits < 1) splits = 1;
  }
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  // the partials are sized by the count before it is evened out below,
  // which never falls as the range grows: the plan of the longest range
  // sizes partials that every shorter one fits
  const int cap = splits;
  int per = (tiles + splits - 1) / splits;
  if (forced <= 0 && per > 0) splits = (tiles + per - 1) / per;
  p->gc = gc;
  p->chunks = chunks;
  p->splits = splits;
  p->tiles_per_split = per;
  // one counter per group; the partials
  p->counters = cap == 1 ? 0 : groups;
  p->part_bytes = cap == 1 ? 0 : groups * cap * part_floats<DH>(gc) * 4;
  return 0;
}

template <typename T, int DH, bool VEC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int lo, int hi, long long qsb, long long qsh,
           Strides ks, Strides vs, float scale, int forced, int* counters,
           long long n_counters, void* parts, long long part_bytes,
           cudaStream_t stream) {
  Plan p;
  int e = make_plan<T, DH>(B, Hq, Hkv, lo, hi, forced, &p);
  if (e != 0) return e;
  if (p.splits > 1 &&
      (counters == nullptr || parts == nullptr ||
       p.counters > n_counters || p.part_bytes > part_bytes))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.splits, Hkv * p.chunks, B);
  decode_attention_kernel<T, DH, VEC>
      <<<grid, THREADS, smem_bytes<T, DH>(p.gc), stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hq / Hkv, p.gc,
          lo, hi, p.tiles_per_split, qsb, qsh, ks, vs, scale * LOG2E,
          counters, static_cast<float*>(parts));
  return (int)cudaGetLastError();
}

// 16-byte copies need 16-byte aligned rows: the base addresses and every
// stride of K and V a multiple of 16 bytes.
template <typename T>
bool rows_aligned(const void* k, const void* v, Strides ks, Strides vs) {
  constexpr long long W = 16 / sizeof(T);
  return (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0 && ks.b % W == 0 &&
         ks.s % W == 0 && ks.h % W == 0 && vs.b % W == 0 && vs.s % W == 0 &&
         vs.h % W == 0;
}

#define ATTN_HEAD_DIMS(X) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, void* out,
             int B, int Hq, int Hkv, int lo, int hi, long long qsb,
             long long qsh, Strides ks, Strides vs, float scale, int forced,
             int* counters, long long n_counters, void* parts,
             long long part_bytes, cudaStream_t st) {
  const bool vec = rows_aligned<T>(k, v, ks, vs);
#define ATTN_CASE(D)                                                       \
  case D:                                                                  \
    return vec ? launch<T, D, true>(q, k, v, out, B, Hq, Hkv, lo, hi, qsb, \
                                    qsh, ks, vs, scale, forced, counters,  \
                                    n_counters, parts, part_bytes, st)     \
               : launch<T, D, false>(q, k, v, out, B, Hq, Hkv, lo, hi,     \
                                     qsb, qsh, ks, vs, scale, forced,      \
                                     counters, n_counters, parts,          \
                                     part_bytes, st);
  switch (Dh) {
    ATTN_HEAD_DIMS(ATTN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ATTN_CASE
}

template <typename T>
int plan_for(int Dh, int B, int Hq, int Hkv, int lo, int hi, int forced,
             Plan* p) {
#define PLAN_CASE(D) \
  case D:            \
    return make_plan<T, D>(B, Hq, Hkv, lo, hi, forced, p);
  switch (Dh) {
    ATTN_HEAD_DIMS(PLAN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PLAN_CASE
}

}  // namespace

// The split count a launch at this shape takes for the range [lo, hi)
// (splits > 0 forces it), and the counters and partial bytes it needs;
// with lo = 0 and hi = S the most any range of the cache needs.
extern "C" int decode_attention_plan(int bf16, int B, int Hq, int Hkv, int Dh,
                                     int lo, int hi, int splits,
                                     int* splits_out, long long* counters,
                                     long long* part_bytes) {
  if (B == 0 || Hq == 0) {  // decode_attention launches nothing
    *splits_out = 1;
    *counters = 0;
    *part_bytes = 0;
    return 0;
  }
  if (B < 0 || Hq < 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  Plan p;
  const int e = bf16 ? plan_for<__nv_bfloat16>(Dh, B, Hq, Hkv, lo, hi,
                                               splits, &p)
                     : plan_for<float>(Dh, B, Hq, Hkv, lo, hi, splits, &p);
  if (e != 0) return e;
  *splits_out = p.splits;
  *counters = p.counters;
  *part_bytes = p.part_bytes;
  return 0;
}

// q: (B, Hq, Dh) with element strides qsb, qsh; k and v: (B, Hkv, S, Dh)
// with element strides (ksb, ksh, kss) and (vsb, vsh, vss); every feature
// axis has unit stride. f32 (bf16 == 0) or bf16; Dh in {32, 48, 64, 80,
// 96, 112, 128}. Attends to the entries [lo, hi), 0 <= lo, hi <= S. out:
// contiguous (B, Hq, Dh) of q's type. splits > 0 forces the split count.
// counters: n_counters ints of device memory, zero (as every launch leaves
// them); parts: part_bytes of device memory; each at least what
// decode_attention_plan reports (both may be null with one split).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* out, int bf16, int B, int Hq, int Hkv,
                                int Dh, int lo, int hi, long long qsb,
                                long long qsh, long long ksb, long long ksh,
                                long long kss, long long vsb, long long vsh,
                                long long vss, float scale, int splits,
                                int* counters, long long n_counters,
                                void* parts, long long part_bytes,
                                void* stream) {
  if (B == 0 || Hq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, out, B, Hq, Hkv, lo, hi, qsb,
                                   qsh, ks, vs, scale, splits, counters,
                                   n_counters, parts, part_bytes, st);
  return dispatch<float>(Dh, q, k, v, out, B, Hq, Hkv, lo, hi, qsb, qsh, ks,
                         vs, scale, splits, counters, n_counters, parts,
                         part_bytes, st);
}
