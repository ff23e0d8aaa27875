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

// float32 -> bfloat16 -> float32, round to nearest even (XLA's astype).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- asynchronous copies and matrix loads (sm_80+), shared by the
// tensor-core kernels (K4, K7, K8)

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

}  // namespace pcv

extern "C" {
// Message for a cudaError_t returned by any pcv_* entry point.
const char* pcv_error_string(int err);
}
