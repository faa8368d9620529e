// 3xTF32 building blocks shared by the tensor-core kernels that keep fp32
// accuracy with `mma.sync` (gemm_tf32x3.cuh, ssd_mma.cuh, attn_tf32x3.cuh):
// the hi / lo split of an fp32 operand, the m16n8k8 TF32 product, ldmatrix
// of four 8x8 b16 matrices (four 8x4 fp32 ones), and the 16-byte cp.async
// copies that stage the operands.  Why the split is made this way, and why
// the sums restart, is told in ssd_mma.cuh's note.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tf32 {

// x = hi + lo: hi is x cut to TF32, lo = x − hi exactly (the mma reads
// only its TF32 bits).  An EXACT operand (bf16, exact in TF32) has lo 0.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// d += a · b on one m16n8k8 tile: a the A fragment (rows g, g + 8;
// columns t, t + 4 of the lane's g = lane / 4, t = lane % 4), b0 / b1 the
// B fragment (row t / t + 4, column g), d the accumulator (row g columns
// 2t, 2t + 1, then row g + 8).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x4 fp32 matrices (ldmatrix's 8x8 b16): lane l gets row l / 4,
// word l % 4 of each, i.e. a TF32 mma fragment; lanes 8q..8q+7 name the
// rows of matrix q.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (4 floats) from src, of which `bytes` are read and the rest
// zero-filled (0: nothing is read, src need only be a valid address).
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace tf32
