// Sign Gram G = U^T V over int8 codes on the H100's tensor cores (int8
// wgmma, exact int32 sums, sm_90a), f32 output.
//
// Replaces the TPU kernel repro/kernels/sign_corr.py::sign_corr
// (_sign_corr_kernel), which upcast int8 tiles to bf16 for the MXU and
// accumulated in f32 across a sequential trailing grid axis over n.
//
// What bounds it on an H100. At the main path's shape (n = 2^20 samples,
// d = 4096 features) the Gram is 2 n d^2 = 3.5e13 int8 operations, 17.8
// ms at the int8 tensor-core peak, against 4.3 GB of operand bytes (1.3
// ms at 3.35 TB/s). What keeps it above the tensor-core bound is moving
// the operand tiles: 128 x 256 output tiles read n (d/128)(d/256) 384 B
// = 206 GB through L2, and every stage is transposed through shared
// memory (below).
//
// Exactness: int32 sums are exact while n * max|u| * max|v| < 2^31, and
// the f32 result equals the reference's f32 sum bit for bit while
// |G| < 2^24. For +-1 and 0 codes |G| <= n, so both hold up to n = 2^24.
//
// Design. One block of two warpgroups per 128 x 256 output tile (features
// of U x features of V), in a grouped raster order (GROUP_M row tiles at a
// time) so that blocks running together share operand rows in L2; the
// whole grid of tiles, also for a symmetric Gram. Warpgroup w holds rows
// 64 w .. 64 w + 63 of the tile in a wgmma m64n256k32 accumulator (128
// int32 registers a thread).
// - int8 wgmma takes K-major operands only, and the payload is sample-
//   major (features contiguous). So each stage of 128 samples is
//   transposed in shared memory: thread 0 brings the stage's (128 samples
//   x 128 features) int8 boxes by TMA (one of U, two of V) into a ring of
//   STAGES, in the 128-byte swizzle; both warpgroups transpose them into
//   128-byte-swizzled K-major tiles, one swizzle row (128 samples) per
//   feature, with 4 x 4 byte transposes in registers (__byte_perm), so
//   every shared-memory load and store is 4 bytes wide and, by the lane
//   mapping in transpose_box, free of bank conflicts.
// - The warpgroups issue the wgmmas of stage t, then transpose stage
//   t + 1 into the other of two buffers while those run.
// - Edges by value: TMA fills samples >= n and features past the width
//   with 0, and a 0 adds nothing, so the product needs no mask. Where a
//   row or the batch stride is off a 16-byte boundary (which TMA cannot
//   copy) the transpose reads the operand from global memory itself,
//   loading 0 outside it. Nothing falls back.
#include <stdint.h>

#include <initializer_list>

#include <cuda.h>
#include <cuda_runtime.h>

#include "tc_ops.cuh"

namespace {

constexpr int BM = 128, BN = 256;  // output tile: features of U x of V
constexpr int BK = 128;            // samples per stage: one 128-byte row
constexpr int BOX = 128;           // features of one TMA box (128 bytes)
constexpr int STAGES = 2;          // int8 stages in the ring
constexpr int THREADS = 256;       // two warpgroups of 64 output rows
constexpr int GROUP_M = 8;
constexpr int BOX_BYTES = BK * BOX;            // 16 KiB
constexpr int STAGE = BOX_BYTES * (BM + BN) / BOX;  // 48 KiB: U, V0, V1
// slack to align to 1 KiB, two transposed buffers, the ring, a barrier
// per ring stage
constexpr size_t SMEM = 1024 + 2 * STAGE + STAGES * STAGE + STAGES * 8;
static_assert(SMEM <= 227 * 1024, "shared memory");

struct Operand {
  const int8_t* p;
  long long sb, ld;  // batch and row strides in bytes
  int width;         // features
};

// The bytes f of x[0..3] as one word, for f = 0..3: a 4 x 4 byte
// transpose (x[i] holds 4 features of sample i; y[f] 4 samples of
// feature f).
__device__ __forceinline__ void transpose4(const uint32_t (&x)[4],
                                           uint32_t (&y)[4]) {
  const uint32_t a = __byte_perm(x[0], x[1], 0x5140);  // x0.0 x1.0 x0.1 x1.1
  const uint32_t b = __byte_perm(x[0], x[1], 0x7362);  // x0.2 x1.2 x0.3 x1.3
  const uint32_t c = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t d = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(a, c, 0x5410);
  y[1] = __byte_perm(a, c, 0x7632);
  y[2] = __byte_perm(b, d, 0x5410);
  y[3] = __byte_perm(b, d, 0x7632);
}

// Transposes one box of 128 samples x 128 features into the K-major tile
// dst: feature m's 128 samples are row m, 16-byte chunk c (samples
// 16c .. 16c + 15) at m * 128 + ((c ^ (m % 8)) << 4), the layout wgmma's
// 128-byte swizzle reads. The box comes from the ring (TMA), sample r's
// feature chunk q at r * 128 + ((q ^ (r % 8)) << 4), or, without TMA, from
// the operand at `src` (feature col0, sample k0 of its batch row; 0
// outside it). A thread moves 4 x 4 blocks (word w = features 4w .. 4w+3,
// samples 4s .. 4s+3): w = lane and s = s_lane ^ (warp + 8 it), where
// s_lane takes lane bits 2, 3, 1, 4 as its bits 0..3. Then a warp's 32
// loads (rows 4s + i, word w) and 32 stores (rows 4w + f, samples 4s..)
// each fall in 32 different banks.
template <bool TMA>
__device__ __forceinline__ void transpose_box(const uint8_t* ring,
                                              const Operand& src, int col0,
                                              int k0, int n, uint8_t* dst,
                                              int tid) {
  const int lane = tid % 32, warp = tid / 32, w = lane;
  const int s_lane = ((lane >> 2) & 3) | ((lane >> 1) & 1) << 2 |
                     (lane >> 4) << 3;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int s = s_lane ^ (warp + 8 * it);
    uint32_t x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * s + i;
      if constexpr (TMA) {
        x[i] = *reinterpret_cast<const uint32_t*>(
            ring + r * 128 + ((((w >> 2) ^ (r & 7)) << 4) | ((w & 3) << 2)));
      } else {
        x[i] = 0;
        const int k = k0 + r;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int col = col0 + 4 * w + f;
          if (k < n && col < src.width)
            x[i] |= (uint32_t)(uint8_t)src.p[(long long)k * src.ld + col]
                    << (8 * f);
        }
      }
    }
    transpose4(x, y);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int m = 4 * w + f;
      *reinterpret_cast<uint32_t*>(
          dst + m * 128 + ((((s >> 2) ^ (m & 7)) << 4) | ((s & 3) << 2))) =
          y[f];
    }
  }
}

// The 4 wgmmas of one stage for warpgroup wg (32 samples each), issued
// and committed, not waited; `first` starts the accumulator afresh (no
// other instruction writes it, or ptxas serializes the wgmmas).
__device__ __forceinline__ void issue_stage(int (&acc)[32][4],
                                            const uint8_t* buf, int wg,
                                            bool first) {
  const uint8_t* a = buf + wg * 64 * 128;
  const uint8_t* b = buf + BM * 128;
#pragma unroll
  for (int s = 0; s < BK / 32; ++s) {
    tc::wgmma_m64n256k32_s8_ss(acc, tc::desc_sw128(a + 32 * s, 0, 1024),
                               tc::desc_sw128(b + 32 * s, 0, 1024),
                               first && s == 0 ? 0 : 1);
  }
  tc::wgmma_commit();
}

template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
sign_corr_s8_wgmma(Operand U, Operand V, float* __restrict__ out, int n,
                   int tiles_m, int tiles_n,
                   const __grid_constant__ CUtensorMap map_u,
                   const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ unsigned char smem_raw[];
  uint8_t* bufs = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = bufs + 2 * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);

  // grouped raster: GROUP_M row tiles, then every column tile of them
  const int pid = blockIdx.x, per_group = GROUP_M * tiles_n;
  const int first_m = pid / per_group * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int i0 = (first_m + (pid % per_group) % group_m) * BM;
  const int j0 = (pid % per_group) / group_m * BN;
  const int bz = blockIdx.y;
  const int stages = (n + BK - 1) / BK;
  const int tid = threadIdx.x;
  const Operand Ub{U.p + bz * U.sb, U.sb, U.ld, U.width};
  const Operand Vb{V.p + bz * V.sb, V.sb, V.ld, V.width};

  // stage t's boxes into ring slot t % STAGES: U, then V's two halves
  auto load = [&](int t) {
    if (TMA && tid == 0 && t < stages) {
      const int st = t % STAGES;
      uint8_t* slot = ring + st * STAGE;
      tc::mbar_arrive_expect_tx(full + st, STAGE);
      tc::tma_load_3d(slot, &map_u, i0, t * BK, bz, full + st);
      tc::tma_load_3d(slot + BOX_BYTES, &map_v, j0, t * BK, bz, full + st);
      tc::tma_load_3d(slot + 2 * BOX_BYTES, &map_v, j0 + BOX, t * BK, bz,
                      full + st);
    }
  };
  if (TMA && tid == 0) {
    for (int st = 0; st < STAGES; ++st) tc::mbar_init(full + st, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  for (int t = 0; t < STAGES; ++t) load(t);

  // waits for stage t's boxes, transposes them into buffer t % 2 and
  // makes the tiles visible to wgmma (after the barrier that follows)
  auto transpose_stage = [&](int t) {
    const int st = t % STAGES;
    if (TMA) tc::mbar_wait(full + st, (t / STAGES) & 1);
    const uint8_t* slot = ring + st * STAGE;
    uint8_t* buf = bufs + (t & 1) * STAGE;
    transpose_box<TMA>(slot, Ub, i0, t * BK, n, buf, tid);
    transpose_box<TMA>(slot + BOX_BYTES, Vb, j0, t * BK, n,
                       buf + BM * 128, tid);
    transpose_box<TMA>(slot + 2 * BOX_BYTES, Vb, j0 + BOX, t * BK, n,
                       buf + (BM + BOX) * 128, tid);
    tc::fence_proxy_async();
  };

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), wg = warp / 4;
  int acc[32][4];  // set by the first wgmma (n > 0)

  if (stages > 0) {
    transpose_stage(0);
    __syncthreads();
    load(STAGES);  // into stage 0's slot, transposed by all
  }
  for (int t = 0; t < stages; ++t) {
    tc::wgmma_fence();
    issue_stage(acc, bufs + (t & 1) * STAGE, wg, t == 0);
    tc::wgmma_wait<1>();  // this warpgroup's stage t - 1 is done
    // both warpgroups' stage t - 1 is done: its buffer may be rewritten
    __syncthreads();
    if (t + 1 < stages) transpose_stage(t + 1);
    // stage t + 1 is transposed by all: it may be issued, and its ring
    // slot refilled
    __syncthreads();
    load(t + 1 + STAGES);
  }
  tc::wgmma_wait<0>();
  tc::fence_operands(acc);

  // accumulator fragment: rows g and g + 8 of the warp's 16, columns
  // 8 j + 2 c and 8 j + 2 c + 1 (tc_ops.cuh)
  const int lane = tid % 32, g = lane / 4, c = lane % 4;
  const int dl = U.width, dr = V.width;
  float* ob = out + (long long)bz * dl * dr;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = i0 + wg * 64 + (warp % 4) * 16 + g + 8 * half;
    if (row >= dl) continue;
    float* orow = ob + (long long)row * dr;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = j0 + 8 * j + 2 * c;
      if (col < dr) orow[col] = stages ? (float)acc[j][2 * half] : 0.f;
      if (col + 1 < dr)
        orow[col + 1] = stages ? (float)acc[j][2 * half + 1] : 0.f;
    }
  }
}

// cuTensorMapEncodeTiled's type: the encoder is looked up through the
// CUDA runtime at first use, so the library links against nothing more.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A 3-D tensor map of a (b, n, width) int8 operand: boxes of BOX features
// x BK samples of one batch row in the 128-byte swizzle, out-of-range
// bytes as zeros.
int encode_operand(EncodeTiled encode, CUtensorMap* map, const Operand& op,
                   int b, int n) {
  const cuuint64_t dims[3] = {(cuuint64_t)op.width, (cuuint64_t)n,
                              (cuuint64_t)b};
  const cuuint64_t strides[2] = {
      (cuuint64_t)op.ld, (cuuint64_t)(b > 1 ? op.sb : op.ld * n)};
  const cuuint32_t box[3] = {BOX, BK, 1}, elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(op.p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return 0;
}

}  // namespace

// u: (b, n, dl) int8 with batch stride u_sb and row stride u_ld (elements),
// last stride 1; v likewise (b, n, dr). out: contiguous (b, dl, dr) f32.
extern "C" int sign_corr_s8(const void* u, const void* v, void* out, int b,
                            int n, int dl, int dr, long long u_sb,
                            long long u_ld, long long v_sb, long long v_ld,
                            void* stream) {
  if (b == 0 || dl == 0 || dr == 0) return 0;
  const Operand U{(const int8_t*)u, u_sb, u_ld, dl};
  const Operand V{(const int8_t*)v, v_sb, v_ld, dr};
  // TMA needs the operands and every row (and batch row) of them on a
  // 16-byte boundary
  bool tma = n > 0;
  for (const Operand* op : {&U, &V})
    tma = tma && (uintptr_t)op->p % 16 == 0 && op->ld % 16 == 0 &&
          (b == 1 || op->sb % 16 == 0);
  CUtensorMap map_u{}, map_v{};
  if (tma) {
    EncodeTiled encode;
    int e = encoder(&encode);
    if (e == 0) e = encode_operand(encode, &map_u, U, b, n);
    if (e == 0) e = encode_operand(encode, &map_v, V, b, n);
    if (e != 0) return e;
  }
  auto kernel = tma ? sign_corr_s8_wgmma<true> : sign_corr_s8_wgmma<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (dl + BM - 1) / BM, tiles_n = (dr + BN - 1) / BN;
  const dim3 grid(tiles_m * tiles_n, b);
  kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      U, V, (float*)out, n, tiles_m, tiles_n, map_u, map_v);
  return (int)cudaGetLastError();
}
