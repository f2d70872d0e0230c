// Gram of centroid-decoded int8 bin codes: G = c[U]^T c[V], f32, on the
// H100's tensor cores (3xTF32 wgmma, sm_90a).
//
// Replaces the TPU kernel repro/kernels/sign_corr.py::code_corr
// (_code_corr_kernel), which decoded codes by a one-hot contraction into
// bf16 tiles for the MXU. This kernel keeps f32 accuracy instead: it is
// held to the f32 reference (decode, then contract in f64) within
// 1e-5 n + 1e-5 |G|.
//
// What bounds it on an H100: operations. At the main path's shape (n =
// 2^18, d = 4096) the three TF32 products below are 3 * 2 n d^2 =
// 2.6e13 operations, 53 ms at the dense TF32 peak, against 1.1 GB of
// codes (0.3 ms at 3.35 TB/s). What keeps it above that is shared memory:
// each stage's decoded tiles are written there and wgmma reads both
// operands from there, three products per 8 samples.
//
// Precision (3xTF32). The decode splits each centroid c (a table of
// L <= 128 in shared memory) into hi = tf32(c) and lo = tf32(c - hi),
// rounded as cvt.rna rounds, both with their low 13 mantissa bits zero,
// so the tensor core, which reads
// the top 19 bits of a .tf32 operand, reads them exactly; hi + lo = c to
// 2^-22 |c|. A code pair's product is hi hi + hi lo + lo hi (lo lo, below
// 2^-22 of it, is dropped): one GEMM over K = 3n, issued small terms first.
// The ISA does not say that a chain of wgmma accumulations rounds as f32
// adds do, so the tensor cores never sum more than FLUSH samples: then the
// accumulator is added into an f32 total on the CUDA cores by an exact
// two-sum, whose rounding error stays in the accumulator as the start of
// the next FLUSH samples (a compensated sum that costs no registers).
//
// Design. One block per 128 x 128 output tile, in a grouped raster order
// (GROUP_M row tiles at a time) so that blocks running together share
// code rows in L2; the whole grid of tiles, also for a symmetric Gram.
// - Thread 0 brings each stage's int8 code tiles (32 samples x 128
//   features of U and of V, features contiguous) by TMA into a ring of
//   STAGES, issued STAGES stages ahead of their decode (the tensor maps
//   are built per call). Where a row or the batch stride is off a
//   16-byte boundary (which TMA cannot copy) the decode reads the codes
//   from global memory itself. No thread is set aside to load: a block
//   of 256 threads may hold 255 registers each, one of 288 only 168.
// - Two warpgroups decode a stage: each code's centroid is
//   looked up in shared memory, split into hi and lo, and written K-major
//   (.tf32 operands are K-major only) into 128-byte-swizzled tiles, 32
//   samples x 4 B = one swizzle row per feature; the transpose is free in
//   the decode. Codes outside [0, L), samples >= n and features past the
//   operand's width decode to 0 by their index (TMA fills with code 0,
//   which is c_0 != 0).
// - Warpgroup w runs wgmma m64n128k8 for output rows 64 w .. 64 w + 63
//   from the decoded tiles of stage t while both warpgroups decode stage
//   t + 1 into the next of three buffers; stage t stays in flight across
//   the barrier that ends the step, so the tensor cores drain only where
//   an accumulator is flushed, and warpgroup 1 flushes half a chunk after
//   warpgroup 0, so that the other's products run meanwhile.
#include <stdint.h>

#include <cuda.h>
#include <cuda_runtime.h>

#include "tc_ops.cuh"

namespace {

constexpr int BM = 128, BN = 128;  // output tile: features of U x of V
constexpr int BK = 32;             // samples per stage: one 128-byte row
constexpr int STAGES = 3;          // int8 code tiles in the ring
constexpr int BUFS = 3;            // decoded stages: read, in flight, next
constexpr int THREADS = 256;       // two warpgroups of 64 output rows
constexpr int MAX_LEVELS = 128;
constexpr int TABLE = 256;         // centroid by code as a byte; >= L is 0
constexpr int GROUP_M = 8;
// samples per wgmma partial sum, a multiple of 2 BK (the warpgroups flush
// half a chunk apart). Measured on an H100 80GB HBM3 (700 W) at n = 2^18,
// d = 4096, max |kernel - code_corr_ref| at R = 2 / 4 / 7 and ms at R = 4:
// 64: 0.047 / 0.094 / 0.125, 114.3; 128: 0.078 / 0.17 / 0.27, 106.0;
// 256: 0.047 / 0.31 / 0.53, 101.9; 512: 0.17 / 0.66 / 1.09, 100.9. 128 is
// the longest whose R = 7 error stays under the CUDA-core kernel's 0.484.
constexpr int FLUSH = 128;
constexpr int FLUSH_STAGES = FLUSH / BK;
static_assert(FLUSH % (2 * BK) == 0 && FLUSH_STAGES >= 2,
              "FLUSH must be a positive multiple of 2 BK");

constexpr int RING_A = BK * BM;         // bytes of an int8 code tile of U
constexpr int RING_B = BK * BN;
constexpr int RING = RING_A + RING_B;
constexpr int DEC_A = BM * BK * 4;      // bytes of a decoded tf32 tile
constexpr int DEC_B = BN * BK * 4;
constexpr int DEC = 2 * DEC_A + 2 * DEC_B;  // A hi, A lo, B hi, B lo
// slack to align to 1 KiB, the decoded buffers, the ring, the table and a
// barrier per ring stage
constexpr size_t SMEM =
    1024 + BUFS * DEC + STAGES * RING + TABLE * 4 + STAGES * 8;

struct Operand {
  const int8_t* p;
  long long sb, ld;  // batch and row strides in bytes
  int width;         // features
};

// Decodes one operand's codes of a stage into its hi and lo tf32 tiles:
// feature m's 32 samples are row m, 16-byte chunk c (samples 4c .. 4c + 3)
// at byte m * 128 + ((c ^ (m % 8)) << 4), the layout wgmma's 128-byte
// swizzle reads. Features >= rows_valid and samples >= k_valid decode to
// 0. Thread `tid` takes the codes of features 4j .. 4j + 3 at samples
// 4c .. 4c + 3 as four 4-byte words (from the ring tile `ring`, [sample]
// [feature] with ROWS features a sample, or, without TMA, from the
// operand at `src`, feature col0 and sample k0 of its batch row) and
// writes their 4 chunks, starting at feature (j / 2) % 4 of the 4, so that
// 8 neighbouring lanes write rows of 8 different m % 8: no bank conflict.
template <bool TMA, int ROWS>
__device__ __forceinline__ void decode(const uint8_t* ring,
                                       const Operand& src, int col0, int k0,
                                       const float* tab, unsigned char* hi,
                                       unsigned char* lo, int rows_valid,
                                       int k_valid, int tid) {
  static_assert(ROWS / 4 * (BK / 4) == THREADS, "one word group a thread");
  const int j = tid % (ROWS / 4), c = tid / (ROWS / 4);
  uint32_t w[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int kk = 4 * c + s;
    if constexpr (TMA) {
      w[s] = *reinterpret_cast<const uint32_t*>(ring + kk * ROWS + 4 * j);
    } else {  // bytes outside the operand as 0xff, which decodes to 0
      w[s] = 0;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int col = col0 + 4 * j + f;
        const uint32_t b =
            kk < k_valid && col < src.width
                ? (uint8_t)src.p[(long long)(k0 + kk) * src.ld + col]
                : 0xffu;
        w[s] |= b << (8 * f);
      }
    }
  }
#pragma unroll
  for (int f0 = 0; f0 < 4; ++f0) {
    const int f = (f0 + (j >> 1)) & 3, m = 4 * j + f;
    float h[4], l[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t code = __byte_perm(w[s], 0, 0x4440 | f);  // byte f
      const bool ok = m < rows_valid && 4 * c + s < k_valid;
      tc::tf32_split(tab[ok ? code : 255u], h[s], l[s]);
    }
    const int off = m * 128 + ((c ^ (m & 7)) << 4);
    *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + off) = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// The 12 wgmmas of one stage for warpgroup wg: for each 8-sample step,
// lo hi, hi lo, then hi hi into acc; `restart` starts acc afresh.
// Issued and committed, not waited.
__device__ __forceinline__ void issue_stage(float (&acc)[16][4],
                                            const unsigned char* buf, int wg,
                                            bool restart) {
  const unsigned char* a_hi = buf + wg * 64 * 128;
  const unsigned char* a_lo = a_hi + DEC_A;
  const unsigned char* b_hi = buf + 2 * DEC_A;
  const unsigned char* b_lo = b_hi + DEC_B;
#pragma unroll
  for (int s = 0; s < BK / 8; ++s) {  // 8 samples: 32 bytes of a row
    const int off = s * 32;
    const uint64_t ah = tc::desc_sw128(a_hi + off, 0, 1024);
    const uint64_t al = tc::desc_sw128(a_lo + off, 0, 1024);
    const uint64_t bh = tc::desc_sw128(b_hi + off, 0, 1024);
    const uint64_t bl = tc::desc_sw128(b_lo + off, 0, 1024);
    tc::wgmma_m64n128k8_tf32_ss(acc, al, bh, restart && s == 0 ? 0 : 1);
    tc::wgmma_m64n128k8_tf32_ss(acc, ah, bl, 1);
    tc::wgmma_m64n128k8_tf32_ss(acc, ah, bh, 1);
  }
  tc::wgmma_commit();
}

template <bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
code_corr_tf32(Operand U, Operand V, const float* __restrict__ centroids,
               int L, float* __restrict__ out, int n, int tiles_m,
               int tiles_n, const __grid_constant__ CUtensorMap map_u,
               const __grid_constant__ CUtensorMap map_v) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* dec =
      smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = dec + BUFS * DEC;
  float* tab = reinterpret_cast<float*>(ring + STAGES * RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + TABLE);

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

  for (int e = tid; e < TABLE; e += THREADS)
    tab[e] = e < L ? centroids[e] : 0.f;
  // stage t's codes into ring slot t % STAGES (TMA: rows and columns past
  // an operand's end arrive as zeros)
  auto load = [&](int t) {
    if (TMA && tid == 0 && t < stages) {
      const int st = t % STAGES;
      tc::mbar_arrive_expect_tx(full + st, RING);
      tc::tma_load_3d(ring + st * RING, &map_u, i0, t * BK, bz, full + st);
      tc::tma_load_3d(ring + st * RING + RING_A, &map_v, j0, t * BK, bz,
                      full + st);
    }
  };
  if (TMA && tid == 0) {
    for (int st = 0; st < STAGES; ++st) tc::mbar_init(full + st, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  for (int t = 0; t < STAGES; ++t) load(t);

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), wg = warp / 4;
  const int rows_u = min(BM, U.width - i0), rows_v = min(BN, V.width - j0);
  float acc[16][4], total[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = total[j][e] = 0.f;

  // waits for stage t's codes, decodes them into buffer t % BUFS and
  // makes the tiles visible to wgmma (after the barrier that follows)
  auto decode_stage = [&](int t) {
    const int st = t % STAGES, k_valid = n - t * BK;
    if (TMA) tc::mbar_wait(full + st, (t / STAGES) & 1);
    const uint8_t* slot = ring + st * RING;
    unsigned char* buf = dec + (t % BUFS) * DEC;
    decode<TMA, BM>(slot, Ub, i0, t * BK, tab, buf, buf + DEC_A, rows_u,
                    k_valid, tid);
    decode<TMA, BN>(slot + RING_A, Vb, j0, t * BK, tab, buf + 2 * DEC_A,
                    buf + 2 * DEC_A + DEC_B, rows_v, k_valid, tid);
    tc::fence_proxy_async();
  };

  if (stages > 0) {
    decode_stage(0);
    __syncthreads();
    load(STAGES);  // into stage 0's slot, decoded by all
  }
  // chunks of FLUSH_STAGES stages, warpgroup 1's starting half a chunk
  // later, so that the tensor cores run one warpgroup's stages while the
  // other drains and flushes. The flush sits outside the stage loop: with
  // it inside, ptxas waits for every stage right after its issue.
  for (int t0 = 0, len = wg ? FLUSH_STAGES / 2 : FLUSH_STAGES; t0 < stages;
       t0 += len, len = FLUSH_STAGES) {
    const int t_end = min(t0 + len, stages);
    for (int t = t0; t < t_end; ++t) {
      tc::wgmma_fence();
      issue_stage(acc, dec + (t % BUFS) * DEC, wg, t == 0);
      // buffer (t + 1) % BUFS was read by stage t - 2, which both
      // warpgroups waited for before the last barrier
      if (t + 1 < stages) decode_stage(t + 1);
      tc::wgmma_wait<1>();  // stage t - 1 is done; stage t may still run
      // stage t + 1 is decoded by all: it may be issued, and its ring slot
      // refilled
      __syncthreads();
      load(t + 1 + STAGES);
    }
    tc::wgmma_wait<0>();
    tc::fence_operands(acc);
    // total += acc exactly as a sum and its rounding error (2Sum); the
    // error stays in acc, which the next stages add to
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = total[j][e], b = acc[j][e], sum = a + b;
        const float bb = sum - a;
        acc[j][e] = (a - (sum - bb)) + (b - bb);
        total[j][e] = sum;
      }
  }

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
    for (int j = 0; j < 16; ++j) {
      const int col = j0 + 8 * j + 2 * c;
      if (col < dr) orow[col] = total[j][2 * half];
      if (col + 1 < dr) orow[col + 1] = total[j][2 * half + 1];
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

// A 3-D tensor map of a (b, n, width) int8 operand: boxes of `rows`
// features x BK samples of one batch row, unswizzled, out-of-range bytes
// as zeros.
int encode_operand(EncodeTiled encode, CUtensorMap* map, const Operand& op,
                   int b, int n, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)op.width, (cuuint64_t)n,
                              (cuuint64_t)b};
  const cuuint64_t strides[2] = {
      (cuuint64_t)op.ld, (cuuint64_t)(b > 1 ? op.sb : op.ld * n)};
  const cuuint32_t box[3] = {(cuuint32_t)rows, BK, 1}, elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(op.p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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

// u: (b, n, dl) int8 codes with batch stride u_sb and row stride u_ld,
// last stride 1; v likewise (b, n, dr). centroids: (L,) f32, L <= 128.
// out: contiguous (b, dl, dr) f32.
extern "C" int code_corr_s8(const void* u, const void* v,
                            const void* centroids, int L, void* out, int b,
                            int n, int dl, int dr, long long u_sb,
                            long long u_ld, long long v_sb, long long v_ld,
                            void* stream) {
  if (b == 0 || dl == 0 || dr == 0) return 0;
  if (L < 1 || L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
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
    if (e == 0) e = encode_operand(encode, &map_u, U, b, n, BM);
    if (e == 0) e = encode_operand(encode, &map_v, V, b, n, BN);
    if (e != 0) return e;
  }
  auto kernel = tma ? code_corr_tf32<true> : code_corr_tf32<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (dl + BM - 1) / BM, tiles_n = (dr + BN - 1) / BN;
  const dim3 grid(tiles_m * tiles_n, b);
  kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      U, V, (const float*)centroids, L, (float*)out, n, tiles_m, tiles_n,
      map_u, map_v);
  return (int)cudaGetLastError();
}
