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

}  // namespace pcv

extern "C" {
// Message for a cudaError_t returned by any pcv_* entry point.
const char* pcv_error_string(int err);
}
