// Shared helpers of the attention kernels: f32 <-> storage-type moves,
// 16-byte asynchronous copies global -> shared (cp.async), and the bf16
// tensor-core product mma.sync m16n8k16 with its ldmatrix loads.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element strides of a (batch, sequence, head, feature) operand whose
// feature axis has unit stride.
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from global src to shared dst without passing through
// registers; completes with the commit group it is issued in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's commit groups are still pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- mma.sync m16n8k16 bf16 (sm_80 and later) ---------------------------
//
// Fragments (PTX ISA, "mma.m16n8k16"): lane = 4 g + c holds of A (16 x
// 16, row-major) rows g, g + 8 at columns 2c, 2c + 1 and 2c + 8, 2c + 9
// (registers a0..a3 = (g, 2c), (g + 8, 2c), (g, 2c + 8), (g + 8, 2c + 8)),
// of B (16 x 8) rows 2c, 2c + 1 and 2c + 8, 2c + 9 at column g, and of C
// (16 x 8, f32) rows g, g + 8 at columns 2c, 2c + 1.

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. With rows 0-15 at column 0 (lanes 0-15) and at column 8
// (lanes 16-31) of a row-major 16 x 16 tile, r is its A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two 8 x 8 b16 matrices (lanes 0-15 give the row addresses). With the
// 8 rows of an (n x k)-stored tile at columns 0 and 8 it is a B fragment.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// The same, transposed: with rows 0-7 and 8-15 of a (k x n)-stored tile
// at one column it is a B fragment.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += A B, bf16 x bf16 -> f32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace attn
