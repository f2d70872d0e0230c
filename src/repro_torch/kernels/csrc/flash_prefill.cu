// Full-sequence GQA flash attention (prefill), causal and sliding window.
//
// Replaces the TPU kernel repro/kernels/flash_prefill.py::flash_prefill
// (_flash_prefill_kernel). out[b, i, h] = softmax_k(q_i . k_k / sqrt(Dh))
// v_k over the keys k that query i sees: k <= i when causal, k > i - window
// when window > 0. Query head h reads KV head h / (Hq / Hkv).
//
// What bounds it on an H100: operations. At the serving shape (B = 8,
// S = 2048, 32 query and 8 KV heads of 128, causal) it does 2.75e11 flop,
// 0.28 ms on the bf16 tensor cores at 989 TFLOP/s, against 0.34 GB of q,
// k, v and out (0.1 ms at 3.35 TB/s). One exponential per score, at 16 a
// clock per SM, costs half the products' time, so the softmax has to run
// while the tensor cores do.
//
// bf16, the serving path, runs on the tensor cores (wgmma, sm_90a):
// - one block per (128 query rows, query head, batch row): two consumer
//   warpgroups of 64 rows and one producer warp;
// - the producer copies Q once and each 64-key tile of K and V by TMA
//   into a ring of four stages in the 128-byte swizzle, with a full and an
//   empty mbarrier per stage, so the loads run ahead of the products;
//   where a row of q, k or v is off a 16-byte boundary (which TMA cannot
//   copy) the producer warp loads elements instead;
// - S = Q K^T is wgmma m64n64k16 from shared memory, Q and K K-major; the
//   scale multiplies the f32 scores inside the exponent (q is not rounded
//   to bf16 after scaling, which the Pallas kernel does not do either);
// - masking to -inf, the running max and sum (f32, in registers; a row's
//   4 lanes reduce by shuffles) and the rescale factor of O;
// - P is rounded to bf16 in registers and is the A operand of O += P V,
//   wgmma m64nNk16 with V read MN-major through the descriptor's
//   transpose bit (N = Dh padded with zeros to 64 or 128);
// - tile t's S is issued with tile t-1's P V, so P V runs on the tensor
//   cores while the softmax of S_t runs on the other units.
//
// f32 stays on the CUDA cores: one block of 256 threads per 64 query rows,
// K and V staged in shared memory as f32, f32 FMAs. It serves the
// card-vs-CPU check of the f32 model, held to 3e-5, which products from
// bf16 operands could not meet.
//
// Both: masked scores have probability exactly 0, so a row that sees no
// key ends with l = 0 and writes 0 (the division is guarded by
// max(l, 1e-30), as in the Pallas kernel); key tiles wholly above the
// causal diagonal or before the window are skipped, and the longest causal
// rows are launched first.
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include <cuda.h>

#include "attn_common.cuh"
#include "tc_ops.cuh"

namespace {

using attn::Strides;

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

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

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_prefill_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int Sq,
                  int Skv, int Hq, int G, Strides qs, Strides ks, Strides vs,
                  int causal, int window, float scale) {
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, qp = q0 + r;
    Qs[r * LD + d] = qp < Sq ? qb[qp * qs.s + d] * scale : 0.f;
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
      KV[r * LD + d] = kp < Skv ? kb[kp * ks.s + d] : 0.f;
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
      KV[r * LD + d] = kp < Skv ? vb[kp * vs.s + d] : 0.f;
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
    float* o = out + (((long long)b * Sq + qp) * Hq + h) * DH;
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      o[tx + 16 * j] = acc[i][j] / l;
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int Hq, int G, Strides qs, Strides ks,
               Strides vs, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_f32<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_prefill_f32<DH><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Skv,
      Hq, G, qs, ks, vs, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int WG_COUNT = 2;                 // consumer warpgroups per block
constexpr int WG_BQ = 64 * WG_COUNT;        // query rows per block
constexpr int WG_BK = 64;                   // keys per tile
constexpr int WG_CONSUMERS = 128 * WG_COUNT;
constexpr int WG_PRODUCERS = 32;            // one warp stages the tiles
constexpr int WG_THREADS = WG_CONSUMERS + WG_PRODUCERS;
constexpr int WG_STAGES = 4;                // K/V tile pairs in the ring
// 128-byte swizzle atoms (64 bf16 columns) across a staged row
template <int DH>
constexpr int WG_ATOMS = (DH + 63) / 64;
template <int DH>
constexpr int WG_TILE_Q = WG_ATOMS<DH> * WG_BQ * 128;   // bytes
template <int DH>
constexpr int WG_TILE_KV = WG_ATOMS<DH> * WG_BK * 128;  // bytes

// slack to align the tiles to 1 KiB, Q, the ring of K/V tile pairs, and
// a full and an empty barrier per stage
template <int DH>
constexpr size_t wg_smem_bytes() {
  return 1024 + WG_TILE_Q<DH> + WG_STAGES * 2 * WG_TILE_KV<DH> +
         2 * WG_STAGES * sizeof(uint64_t);
}

// Byte offset of 16-byte chunk c of row r in a staged tile of `rows` rows:
// 64-column atoms one after another, each `rows` lines of 128 bytes whose
// chunks are permuted by r mod 8 (the layout wgmma's 128-byte swizzle
// mode reads).
__device__ __forceinline__ int sw128(int r, int c, int rows) {
  return (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// Stages rows [r0, r0 + ROWS) of a (rows, DH) bf16 operand with row stride
// `ld_src` into the swizzled tile `dst`, rows >= n as zeros, by 2-byte
// loads through registers: the route for operands whose rows are not all
// on a 16-byte boundary, which TMA cannot copy. Thread `tid` of the
// WG_PRODUCERS that share the work.
template <int DH, int ROWS>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const bf16* src, long long ld_src,
                                           int r0, int n, int tid) {
  constexpr int CHUNKS = DH / 8;
  for (int i = tid; i < ROWS * CHUNKS; i += WG_PRODUCERS) {
    const int r = i / CHUNKS, c = i % CHUNKS, row = r0 + r;
    const bool valid = row < n;
    const bf16* s = src + (long long)(valid ? row : 0) * ld_src + c * 8;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = valid ? __bfloat16_as_ushort(s[2 * e]) |
                         (uint32_t)__bfloat16_as_ushort(s[2 * e + 1]) << 16
                   : 0u;
    *reinterpret_cast<uint4*>(dst + sw128(r, c, ROWS)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Where a (batch, sequence, head, feature) operand's tensor map keeps its
// sequence, head and batch axes (map dimensions 1..3, sorted by stride;
// dimension 0 is the feature axis).
struct TmaAxes {
  int s, h, b;
};

// One box of an operand (64 columns, the rows its map names): columns
// col.., rows row.. of head `head` of batch row `batch`, into dst,
// completing on bar.
__device__ __forceinline__ void tma_box(unsigned char* dst,
                                        const CUtensorMap& map, TmaAxes ax,
                                        int col, int row, int head, int batch,
                                        uint64_t* bar) {
  auto at = [&](int dim) {
    return ax.s == dim ? row : ax.h == dim ? head : batch;
  };
  tc::tma_load_4d(dst, &map, col, at(1), at(2), at(3), bar);
}

// op over the 2 NS values of s[.][e0] and s[.][e0 + 1], as a tree.
template <int NS, typename Op>
__device__ __forceinline__ float row_reduce(const float (&s)[NS][4], int e0,
                                            Op op) {
  float r[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) r[j] = op(s[j][e0], s[j][e0 + 1]);
#pragma unroll
  for (int w = NS / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) r[j] = op(r[j], r[j + w]);
  return r[0];
}

// The online softmax of one key tile on a warp's score fragment s[j][e]
// (rows row0 + 8 (e / 2), keys k0 + 8 j + 2 c + e % 2, c = lane mod 4):
// mask to -inf (when `mask`), update the running max m (of raw scores)
// and this thread's share of the sum l of rows row0 and row0 + 8, leave
// the probabilities exp2(scale_log2 (s - m)) in s and return the rescale
// factors of the output rows in alpha.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int row0, int k0, bool mask,
                                             int Skv, int causal, int window,
                                             float scale_log2) {
  const int c = threadIdx.x % 4;
  if (mask) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e / 2), col = k0 + 8 * j + 2 * c + e % 2;
        bool ok = col < Skv;
        if (causal) ok = ok && row >= col;
        if (window > 0) ok = ok && col > row - window;
        if (!ok) s[j][e] = -INFINITY;
      }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = row_reduce<NS>(s, 2 * half, [](float a, float b) {
      return fmaxf(a, b);
    });
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[half], mx);
    // a row with no visible key yet keeps m = -inf: subtract 0 instead,
    // so its probabilities and its rescale factor are exact zeros
    const float ms = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    alpha[half] = tc::ex2(m[half] * scale_log2 - ms);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e)
        s[j][e] = tc::ex2(fmaf(s[j][e], scale_log2, -ms));
    l[half] = l[half] * alpha[half] +
              row_reduce<NS>(s, 2 * half, [](float a, float b) { return a + b; });
    m[half] = m_new;
  }
}

// Divides the first NW 8-column blocks of a warp's 16-row output fragment
// by the row sums and writes rows row0 and row0 + 8 (those < Sq) of out
// (B, Sq, Hq, 8 NW) in bf16.
template <int NW, int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO][4],
                                           const float (&l)[2], bf16* out_bh,
                                           long long row_stride, int row0,
                                           int Sq) {
  const int c = threadIdx.x % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float lsafe = fmaxf(sum, 1e-30f);
    const int row = row0 + 8 * half;
    if (row >= Sq) continue;
    bf16* o_row = out_bh + (long long)row * row_stride;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      *reinterpret_cast<uint32_t*>(o_row + 8 * j + 2 * c) = tc::pack_bf16(
          o[j][2 * half] / lsafe, o[j][2 * half + 1] / lsafe);
  }
}

// S = Q K^T for one key tile: DH / 16 wgmmas m64n64k16 from the swizzled
// Q and K tiles (both K-major), issued and committed, not waited.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[WG_BK / 8][4],
                                         const unsigned char* Qs,
                                         const unsigned char* Kt) {
  static_assert(WG_BK == 64, "S is one m64n64 accumulator");
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {  // 16 columns: 32 bytes of an atom
    const int off = (kk % 4) * 32;
    tc::wgmma_m64n64k16_ss(
        s, tc::desc_sw128(Qs + (kk / 4) * WG_BQ * 128 + off, 0, 1024),
        tc::desc_sw128(Kt + (kk / 4) * WG_BK * 128 + off, 0, 1024), kk > 0);
  }
  tc::wgmma_commit();
}

// O += P V for one key tile: P (bf16 A fragments in registers), V read
// MN-major through the descriptor's transpose bit, N = 64 or 128 (V's
// columns padded to whole atoms); issued and committed, not waited.
template <int NO>
__device__ __forceinline__ void issue_pv(float (&o)[NO][4],
                                         const uint32_t (&pa)[WG_BK / 16][4],
                                         const unsigned char* Vt) {
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk) {  // 16 keys: 2 groups of 8 rows
    const uint64_t dv = tc::desc_sw128(Vt + kk * 16 * 128, WG_BK * 128, 1024);
    if constexpr (NO == 8)
      tc::wgmma_m64n64k16_rs(o, pa[kk], dv);
    else
      tc::wgmma_m64n128k16_rs(o, pa[kk], dv);
  }
  tc::wgmma_commit();
}

template <int NS>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[NS / 2][4],
                                       const float (&s)[NS][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    pa[kk][0] = tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// One block per (tile of WG_BQ query rows, query head, batch row), two
// roles. The producer warp stages Q once and each key tile's K and V into
// a ring of WG_STAGES tile pairs: one thread by TMA, whose copies complete
// the stage's full barrier themselves, or, where a row of q, k or v is off
// a 16-byte boundary, the whole warp by element loads, which then arrives
// on it. It refills a stage once both consumers have signalled it empty.
// Each consumer warpgroup owns
// 64 query rows (warp w rows 16 w .. 16 w + 15 of them): for key tile t it
// runs S_t = Q K_t^T on the tensor cores while P_{t-1} V_{t-1} of the tile
// before also runs there, does the online softmax of S_t meanwhile, then
// rescales O and rounds P_t to bf16 in registers, and signals the stage
// of tile t - 1 empty. Consumers never wait on each other.
template <int DH, bool ALIGNED>
__global__ void __launch_bounds__(WG_THREADS)
flash_prefill_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    int Sq, int Skv, int Hq, int G, Strides qs, Strides ks,
                    Strides vs, int causal, int window, float scale_log2,
                    const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, TmaAxes aq,
                    TmaAxes ak, TmaAxes av) {
  constexpr int NS = WG_BK / 8;               // 8-column blocks of S
  constexpr int NO = WG_ATOMS<DH> * 64 / 8;   // 8-column blocks of P V
  constexpr int TKV = WG_TILE_KV<DH>;
  extern __shared__ unsigned char smem_wg[];
  unsigned char* Qs =
      smem_wg + ((1024 - (tc::smem_addr(smem_wg) & 1023)) & 1023);
  unsigned char* ring = Qs + WG_TILE_Q<DH>;  // stage st: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * 2 * TKV);
  uint64_t* empty = full + WG_STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;

  // the key tiles that can hold a key visible to rows [q0, q0 + WG_BQ)
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(Skv, min(q0 + WG_BQ, Sq));
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int k_first = (k_lo / WG_BK) * WG_BK;
  const int n_tiles =
      k_first < k_hi ? (k_hi - k_first + WG_BK - 1) / WG_BK : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < WG_STAGES; ++st) {
      tc::mbar_init(full + st, ALIGNED ? 1 : WG_PRODUCERS);
      tc::mbar_init(empty + st, WG_CONSUMERS);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  // the warp's index, known to the compiler to be the same in all its
  // lanes: a branch on it is not divergent, so the compiler keeps the
  // consumer's wgmma waits where they are written
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= WG_CONSUMERS / 32) {  // producer
    const int p = threadIdx.x - WG_CONSUMERS;
    if (n_tiles == 0 || (ALIGNED && p != 0)) return;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % WG_STAGES, k0 = k_first + t * WG_BK;
      unsigned char* Kt = ring + 2 * st * TKV;
      unsigned char* Vt = Kt + TKV;
      if (t >= WG_STAGES) tc::mbar_wait(empty + st, (t / WG_STAGES - 1) & 1);
      if constexpr (ALIGNED) {  // one thread, TMA: rows and columns past
                                // the operand's end arrive as zeros
        tc::mbar_arrive_expect_tx(
            full + st, 2 * TKV + (t == 0 ? WG_TILE_Q<DH> : 0));
        for (int a = 0; a < WG_ATOMS<DH>; ++a) {
          if (t == 0)
            for (int w = 0; w < WG_COUNT; ++w)
              tma_box(Qs + a * WG_BQ * 128 + w * 64 * 128, tq, aq, a * 64,
                      q0 + 64 * w, h, b, full);
          tma_box(Kt + a * WG_BK * 128, tk, ak, a * 64, k0, hk, b, full + st);
          tma_box(Vt + a * WG_BK * 128, tv, av, a * 64, k0, hk, b, full + st);
        }
      } else {  // the producer warp, element loads
        if constexpr (NO * 8 != DH) {  // V's pad columns: zeros
          constexpr int PAD = NO - DH / 8;
          for (int i = p; t < WG_STAGES && i < WG_BK * PAD; i += WG_PRODUCERS)
            *reinterpret_cast<uint4*>(
                Vt + sw128(i / PAD, DH / 8 + i % PAD, WG_BK)) =
                make_uint4(0u, 0u, 0u, 0u);
        }
        if (t == 0)
          stage_rows<DH, WG_BQ>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq, p);
        stage_rows<DH, WG_BK>(Kt, k + b * ks.b + hk * ks.h, ks.s, k0, Skv, p);
        stage_rows<DH, WG_BK>(Vt, v + b * vs.b + hk * vs.h, vs.s, k0, Skv, p);
        tc::fence_proxy_async();  // visible to wgmma, then signalled
        tc::mbar_arrive(full + st);
      }
    }
    return;
  }

  // consumer
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + warp * 16 + lane / 4;
  // this warpgroup's 64 rows of the Q tile
  const unsigned char* Qw = Qs + warp / 4 * 64 * 128;
  auto needs_mask = [&](int k0) {  // the diagonal, the window's edge, the end
    return k0 + WG_BK > Skv || (causal && k0 + WG_BK - 1 > q0) ||
           (window > 0 && k0 < q0 + WG_BQ - window);
  };
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[NS][4];
  uint32_t pa[NS / 2][4];

  if (n_tiles > 0) {
    tc::mbar_wait(full, 0);
    tc::wgmma_fence();
    issue_qk<DH>(s, Qw, ring);
    tc::wgmma_wait<0>();
    tc::fence_operands(s);
    softmax_tile(s, m, l, alpha, row0, k_first, needs_mask(k_first), Skv,
                 causal, window, scale_log2);
    pack_p(pa, s);
  }
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % WG_STAGES, prev = (t - 1) % WG_STAGES;
    const int k0 = k_first + t * WG_BK;
    tc::mbar_wait(full + st, (t / WG_STAGES) & 1);
    tc::wgmma_fence();
    issue_qk<DH>(s, Qw, ring + 2 * st * TKV);
    issue_pv(o, pa, ring + (2 * prev + 1) * TKV);
    tc::wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
    tc::fence_operands(s);
    softmax_tile(s, m, l, alpha, row0, k0, needs_mask(k0), Skv, causal,
                 window, scale_log2);
    tc::wgmma_wait<0>();
    tc::fence_operands(o);
    tc::mbar_arrive(empty + prev);  // K_{t-1} and V_{t-1} are consumed
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }
    pack_p(pa, s);
  }
  if (n_tiles > 0) {
    tc::wgmma_fence();
    issue_pv(o, pa, ring + (2 * ((n_tiles - 1) % WG_STAGES) + 1) * TKV);
    tc::wgmma_wait<0>();
    tc::fence_operands(o);
  }
  store_rows<DH / 8>(o, l, out + ((long long)b * Sq * Hq + h) * DH,
                     (long long)Hq * DH, row0, Sq);
}

// cuTensorMapEncodeTiled's type: the encoder is looked up through the
// CUDA runtime at first use, so the library links against nothing more.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A 4-D tensor map of a (B, S, H, D) bf16 operand with element strides st
// and a unit-stride feature axis: boxes of 64 features x `rows` positions
// in the 128-byte swizzle, out-of-range elements read as zeros. The sequence,
// head and batch axes go to map dimensions 1..3 in order of stride; their
// places are returned in ax.
int encode_operand(EncodeTiled encode, CUtensorMap* map, TmaAxes* ax,
                   const void* base, int B, int S, int H, int D, Strides st,
                   int rows) {
  struct Axis {
    long long stride;
    cuuint64_t dim;
    cuuint32_t box;
    int* place;
  } axes[3] = {{st.s, (cuuint64_t)S, (cuuint32_t)rows, &ax->s},
               {st.h, (cuuint64_t)H, 1, &ax->h},
               {st.b, (cuuint64_t)B, 1, &ax->b}};
  for (int i = 1; i < 3; ++i)  // sort by stride
    for (int j = i; j > 0 && axes[j].stride < axes[j - 1].stride; --j) {
      const Axis tmp = axes[j];
      axes[j] = axes[j - 1];
      axes[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D}, strides[3];
  cuuint32_t box[4] = {64}, elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = axes[i].dim;
    strides[i] = (cuuint64_t)axes[i].stride * sizeof(bf16);
    box[i + 1] = axes[i].box;
    *axes[i].place = i + 1;
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Skv, int Hq, int Hkv, Strides qs, Strides ks,
                Strides vs, int causal, int window, float scale, bool aligned,
                cudaStream_t stream) {
  CUtensorMap tq{}, tk{}, tv{};
  TmaAxes aq{1, 2, 3}, ak{1, 2, 3}, av{1, 2, 3};
  if (aligned) {
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
      cudaDriverEntryPointQueryResult found;
      void* fn = nullptr;
      cudaError_t e = cudaGetDriverEntryPoint(
          "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
      if (e != cudaSuccess) return (int)e;
      if (found != cudaDriverEntryPointSuccess || fn == nullptr)
        return (int)cudaErrorNotSupported;
      encode = reinterpret_cast<EncodeTiled>(fn);
    }
    int e = encode_operand(encode, &tq, &aq, q, B, Sq, Hq, DH, qs, 64);
    if (e == 0)
      e = encode_operand(encode, &tk, &ak, k, B, Skv, Hkv, DH, ks, WG_BK);
    if (e == 0)
      e = encode_operand(encode, &tv, &av, v, B, Skv, Hkv, DH, vs, WG_BK);
    if (e != 0) return e;
  }
  const size_t smem = wg_smem_bytes<DH>();
  auto kernel =
      aligned ? flash_prefill_wgmma<DH, true> : flash_prefill_wgmma<DH, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + WG_BQ - 1) / WG_BQ, Hq, B);
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Sq, Skv, Hq,
      Hq / Hkv, qs, ks, vs, causal, window, scale * 1.4426950408889634f, tq,
      tk, tv, aq, ak, av);
  return (int)cudaGetLastError();
}

// Routes f32 to the CUDA-core kernel and bf16 to the tensor-core kernel,
// each instantiated for every head size.
int dispatch(int bf16_in, int Dh, const void* q, const void* k, const void* v,
             void* out, int B, int Sq, int Skv, int Hq, int G, Strides qs,
             Strides ks, Strides vs, int causal, int window, float scale,
             bool aligned, cudaStream_t st) {
#define ATTN_CASE(D)                                                        \
  case D:                                                                   \
    return bf16_in ? launch_bf16<D>(q, k, v, out, B, Sq, Skv, Hq, Hq / G, qs,\
                                    ks, vs, causal, window, scale, aligned, \
                                    st)                                     \
                   : launch_f32<D>(q, k, v, out, B, Sq, Skv, Hq, G, qs, ks, \
                                   vs, causal, window, scale, st);
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
  // TMA needs every row of q, k and v on a 16-byte boundary
  bool aligned = true;
  for (const void* p : {q, k, v}) aligned = aligned && (uintptr_t)p % 16 == 0;
  for (long long s : {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh})
    aligned = aligned && s % 8 == 0;
  return dispatch(bf16, Dh, q, k, v, out, B, Sq, Skv, Hq, G, qs, ks, vs,
                  causal, window, scale, aligned, (cudaStream_t)stream);
}
