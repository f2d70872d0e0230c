// Sign Gram from bit-packed signs on the H100's int8 tensor cores: the
// bits are unpacked to +-1 bytes in shared memory and contracted by int8
// wgmma (exact int32 sums, sm_90a), f32 output.
//
// Replaces the TPU kernel repro/kernels/sign_corr.py::sign_corr_packed
// (_sign_corr_packed_kernel with the SWAR byte popcount _popcount8), which
// XORed (block_d, block_d, block_b) byte cubes on the vector unit and
// summed them across a sequential trailing grid axis.
//
// Layout: feature-major (b, d, nb) bytes, little bit order (byte k, bit j
// is sample 8k + j) -- the wire's payload, seen by the wrapper as 32-bit
// words over a byte axis zero-padded to a multiple of 16 (TMA needs 16-
// byte rows). Samples >= n unpack to 0, whatever their bits, so they drop
// out of the Gram.
//
// What bounds it on an H100. At the main path's shape (d = 4096, n = 2^18)
// the Gram is 2 n d^2 = 8.8e12 int8 operations, 4.4 ms at the int8
// tensor-core peak, against 134 MB of packed operand (0.04 ms at 3.35
// TB/s). A popcount design (XOR + POPC per word pair on the CUDA cores,
// this file's first version) is held by the POPC pipe, 16 results per
// clock and SM: d^2 n / 32 = 1.4e11 word pairs take ~33 ms.
//
// Design: sign_corr.cu's int8 wgmma kernel without its transpose. One
// block of two warpgroups per 128 x 256 output tile (features of the left
// x of the right operand), grouped raster (GROUP_M row tiles at a time),
// the whole grid of tiles also for a symmetric Gram. Warpgroup w holds
// rows 64 w .. 64 w + 63 in a wgmma m64n256k32 accumulator.
// - Thread 0 brings (128 features x 128 bytes) boxes of packed bits by
//   TMA, one of the left operand and two of the right a slot, in the
//   128-byte swizzle: a slot holds 8 stages of 128 samples (16 bytes a
//   feature each), in a ring of RING slots.
// - A stage's 16 bytes of a feature are its 128 samples: unpacked to one
//   +-1 byte per sample they are one 128-byte row of a K-major 128-byte-
//   swizzled tile, the layout int8 wgmma reads, so nothing is transposed.
//   Each thread unpacks (feature, 64-sample half) items: an 8-byte load,
//   a nibble at a time to a 4-byte word by multiplications (unpack4),
//   16-byte stores; the lane mapping keeps every load and store free of
//   bank conflicts.
// - The warpgroups issue the wgmmas of stage t, then unpack stage t + 1
//   into the other of two buffers while those run.
// - Edges by value: TMA fills features past the width and bytes past the
//   row with 0 bits, and the unpack zeroes samples >= n, so only rows and
//   columns that are not stored see anything but the Gram.
#include <stdint.h>

#include <initializer_list>

#include <cuda.h>
#include <cuda_runtime.h>

#include "tc_ops.cuh"

namespace {

constexpr int BM = 128, BN = 256;  // output tile: features of A x of B
constexpr int BK = 128;            // samples per stage: one 128-byte row
constexpr int BOX = 128;           // features of one TMA box
constexpr int SPS = 8;             // stages per ring slot (128-byte boxes)
constexpr int RING = 2;            // packed slots in the ring
constexpr int THREADS = 256;       // two warpgroups of 64 output rows
constexpr int GROUP_M = 8;
constexpr int BOX_BYTES = BOX * 128;               // 16 KiB: 8 stages
constexpr int SLOT = BOX_BYTES * (BM + BN) / BOX;  // 48 KiB: A, B0, B1
constexpr int BUF = (BM + BN) * BK;                // 48 KiB unpacked
constexpr int ITEMS = (BM + BN) * 2 / THREADS;     // (row, half) a thread
// slack to align to 1 KiB, two unpacked buffers, the ring, a barrier per
// ring slot
constexpr size_t SMEM = 1024 + 2 * BUF + RING * SLOT + RING * 8;
static_assert(SMEM <= 227 * 1024, "shared memory");
static_assert(ITEMS * THREADS == (BM + BN) * 2, "items");

// Four sign bits (nibble q, sample i at bit i) as four +-1 bytes, sample i
// in byte i: the multiplication by 0x00204081 copies bit i to bit 8 i
// (the four shifted copies do not overlap, so nothing carries), and
// b * -0xFE - 1 maps each 0/1 byte b to 0xFF / 0x01 (no byte borrows:
// every byte of -1 is 0xFF >= 0xFE).
__device__ __forceinline__ uint32_t unpack4(uint32_t q) {
  const uint32_t b = (q * 0x00204081u) & 0x01010101u;
  return b * 0xFFFFFF02u + 0xFFFFFFFFu;
}

// 0xFF in byte i where bit i of the nibble v is set, else 0.
__device__ __forceinline__ uint32_t mask4(uint32_t v) {
  return ((v * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// Unpacks stage s (0..SPS-1) of a ring slot into the K-major tile dst:
// feature m's 128 samples are row m, 16-byte chunk c (samples 16c ..
// 16c + 15) at m * 128 + ((c ^ (m % 8)) << 4). The slot holds feature m's
// 16 bytes of stage s at m * 128 + ((s ^ (m % 8)) << 4) (TMA's 128-byte
// swizzle). Item i of a thread is (row m, half h) with m = 8 (i / 16) +
// i % 8 and h = (i / 8) % 2: the 8 lanes of a quarter warp store 8
// distinct chunks of one 128-byte line, a half warp loads 128 distinct
// bytes. `valid` is n - (the stage's first sample): samples at or past it
// unpack to 0.
__device__ __forceinline__ void unpack_stage(const uint8_t* slot, int s,
                                             uint8_t* dst, int valid,
                                             int tid) {
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = tid + THREADS * it;
    const int m = 8 * (i >> 4) + (i & 7), h = (i >> 3) & 1;
    const uint2 p = *reinterpret_cast<const uint2*>(
        slot + m * 128 + ((s ^ (m & 7)) << 4) + 8 * h);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * h + j;  // 16-sample chunk of the stage
      const uint32_t bits = ((j < 2 ? p.x : p.y) >> (16 * (j & 1))) & 0xFFFF;
      uint4 w;
      w.x = unpack4(bits & 0xF);
      w.y = unpack4((bits >> 4) & 0xF);
      w.z = unpack4((bits >> 8) & 0xF);
      w.w = unpack4(bits >> 12);
      if (valid < BK) {  // the last stage: zero samples >= n
        const int v = min(max(valid - 16 * c, 0), 16);
        const uint32_t vm = (1u << v) - 1u;  // v <= 16
        w.x &= mask4(vm & 0xF);
        w.y &= mask4((vm >> 4) & 0xF);
        w.z &= mask4((vm >> 8) & 0xF);
        w.w &= mask4(vm >> 12);
      }
      *reinterpret_cast<uint4*>(dst + m * 128 + ((c ^ (m & 7)) << 4)) = w;
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

__global__ void __launch_bounds__(THREADS, 1)
sign_corr_packed_s8_wgmma(float* __restrict__ out, int n, int dl, int dr,
                          int tiles_m, int tiles_n,
                          const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b) {
  extern __shared__ unsigned char smem_raw[];
  uint8_t* bufs = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = bufs + 2 * BUF;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * SLOT);

  // grouped raster: GROUP_M row tiles, then every column tile of them
  const int pid = blockIdx.x, per_group = GROUP_M * tiles_n;
  const int first_m = pid / per_group * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int i0 = (first_m + (pid % per_group) % group_m) * BM;
  const int j0 = (pid % per_group) / group_m * BN;
  const int bz = blockIdx.y;
  const int stages = (n + BK - 1) / BK;
  const int slots = (stages + SPS - 1) / SPS;
  const int tid = threadIdx.x;

  // slot g's boxes (stages SPS g ..) into ring slot g % RING: A, then B's
  // two halves
  auto load = [&](int g) {
    if (tid == 0 && g < slots) {
      uint8_t* slot = ring + (g % RING) * SLOT;
      uint64_t* bar = full + g % RING;
      tc::mbar_arrive_expect_tx(bar, SLOT);
      tc::tma_load_3d(slot, &map_a, g * 128, i0, bz, bar);
      tc::tma_load_3d(slot + BOX_BYTES, &map_b, g * 128, j0, bz, bar);
      tc::tma_load_3d(slot + 2 * BOX_BYTES, &map_b, g * 128, j0 + BOX, bz,
                      bar);
    }
  };
  if (tid == 0) {
    for (int r = 0; r < RING; ++r) tc::mbar_init(full + r, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  for (int g = 0; g < RING; ++g) load(g);

  // waits for stage t's slot, unpacks it into buffer t % 2 and makes the
  // tiles visible to wgmma (after the barrier that follows)
  auto unpack = [&](int t) {
    const int g = t / SPS;
    if (t % SPS == 0) tc::mbar_wait(full + g % RING, (g / RING) & 1);
    unpack_stage(ring + (g % RING) * SLOT, t % SPS, bufs + (t & 1) * BUF,
                 n - t * BK, tid);
    tc::fence_proxy_async();
  };

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), wg = warp / 4;
  int acc[32][4];  // set by the first wgmma (n > 0)

  if (stages > 0) {
    unpack(0);
    __syncthreads();
  }
  for (int t = 0; t < stages; ++t) {
    tc::wgmma_fence();
    issue_stage(acc, bufs + (t & 1) * BUF, wg, t == 0);
    tc::wgmma_wait<1>();  // this warpgroup's stage t - 1 is done
    // both warpgroups' stage t - 1 is done: its buffer may be rewritten
    __syncthreads();
    if (t + 1 < stages) unpack(t + 1);
    // stage t + 1 is unpacked by all: it may be issued, and a slot whose
    // last stage it was refilled
    __syncthreads();
    if ((t + 2) % SPS == 0) load((t + 1) / SPS + RING);
  }
  tc::wgmma_wait<0>();
  tc::fence_operands(acc);

  // accumulator fragment: rows g and g + 8 of the warp's 16, columns
  // 8 j + 2 c and 8 j + 2 c + 1 (tc_ops.cuh)
  const int lane = tid % 32, g = lane / 4, c = lane % 4;
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

// A 3-D tensor map of a (b, rows, width) byte operand with row stride ld
// and batch stride sb (bytes): boxes of 128 bytes x BOX rows of one batch
// row in the 128-byte swizzle, out-of-range bytes as zeros.
int encode_operand(EncodeTiled encode, CUtensorMap* map, const void* p,
                   int b, int rows, long long width, long long ld,
                   long long sb) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows,
                              (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)ld,
                                 (cuuint64_t)(b > 1 ? sb : ld * rows)};
  const cuuint32_t box[3] = {128, BOX, 1}, elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(p), dims,
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

// a: (b, dl, nw) 32-bit words of packed bits with batch stride a_sb and
// row stride a_ld (words), last stride 1; bm likewise (b, dr, nw). The
// operands, nw and every stride must be 16-byte multiples (the wrapper
// pads the byte axis), and n <= 32 nw. out: contiguous (b, dl, dr) f32.
extern "C" int sign_corr_packed_u32(const void* a, const void* bm, void* out,
                                    int b, int n, int dl, int dr, int nw,
                                    long long a_sb, long long a_ld,
                                    long long b_sb, long long b_ld,
                                    void* stream) {
  if (b == 0 || dl == 0 || dr == 0) return 0;
  if (n < 0 || (long long)n > 32LL * nw) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a{}, map_b{};
  if (n > 0) {
    for (long long s : {a_ld, b_ld, b > 1 ? a_sb : 0LL, b > 1 ? b_sb : 0LL})
      if (s % 4 != 0) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)a % 16 != 0 || (uintptr_t)bm % 16 != 0 || nw % 4 != 0)
      return (int)cudaErrorInvalidValue;
    EncodeTiled encode;
    int e = encoder(&encode);
    if (e == 0)
      e = encode_operand(encode, &map_a, a, b, dl, 4LL * nw, 4 * a_ld,
                         4 * a_sb);
    if (e == 0)
      e = encode_operand(encode, &map_b, bm, b, dr, 4LL * nw, 4 * b_ld,
                         4 * b_sb);
    if (e != 0) return e;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      sign_corr_packed_s8_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (dl + BM - 1) / BM, tiles_n = (dr + BN - 1) / BN;
  const dim3 grid(tiles_m * tiles_n, b);
  sign_corr_packed_s8_wgmma<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (float*)out, n, dl, dr, tiles_m, tiles_n, map_a, map_b);
  return (int)cudaGetLastError();
}
