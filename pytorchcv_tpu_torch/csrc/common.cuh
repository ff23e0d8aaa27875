// Helpers shared by the port's CUDA kernels.
//
// Every epilogue here replays the JAX reference's float32 op order
// exactly (pytorchcv_tpu/quant/resnet_int8.py). nvcc contracts a*b+c into
// one FMA by default, which rounds once where the reference rounds twice,
// so epilogues spell each multiply and add with the _rn intrinsics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pcv {

// clip(rint(v * q), -127, 127) -> int8: jnp.round is half-to-even, as rintf.
__device__ __forceinline__ int8_t quant_i8(float v, float q) {
  float z = rintf(__fmul_rn(v, q));
  z = fminf(fmaxf(z, -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(z));
}

// The int8 routes' activation codes (K2, K3, K12): 0 none, 1 ReLU
// (max(y, 0)), 2 ReLU6 (clip(y, 0, 6): jnp.clip is min(max(y, 0), 6)),
// 3 DarkNet's leaky ReLU, max(y, 0) + 0.1 min(y, 0), two roundings as
// pytorchcv_tpu/quant/darknet_int8.py:_leaky spells it (K2, K3 only).
__device__ __forceinline__ float activate_i8(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return fminf(fmaxf(v, 0.f), 6.f);
  if (act == 3) return __fadd_rn(fmaxf(v, 0.f), __fmul_rn(0.1f, fminf(v, 0.f)));
  return v;
}

// float32 -> bfloat16 -> float32, round to nearest even (XLA's astype).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- asynchronous copies and matrix loads (sm_80+), shared by the
// tensor-core kernels (K2, K3, K4, K7, K8)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each); lane l
// gives the address of row l % 8 of matrix l / 8 and receives, in r[i],
// the 4 bytes at column l % 4 of row l / 4 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x32, row) * b (32x8, col), s8 in, s32 accumulate (K2, K8).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate (K3).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace pcv

extern "C" {
// Message for a cudaError_t returned by any pcv_* entry point.
const char* pcv_error_string(int err);
}
