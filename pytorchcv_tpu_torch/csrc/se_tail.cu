// K11: the squeeze-and-excitation unit's tail of the int8 ResNet pipeline.
//
// Replaces: the XLA fusion of pytorchcv_tpu/quant/resnet_int8.py:_forward
//   (:308-361) after _se_gate (:194): the gate's product, the bf16-domain
//   residual add, the ReLU and the requantization, which XLA fused on the
//   TPU (no Pallas kernel). The squeeze (an f32 mean over H, W) and the two
//   small products with the sigmoid stay torch calls beside it, as they
//   were XLA ops outside any kernel.
//
// Computes, per element of t (B, H, W, C) bf16 with the gate g (B, C) f32:
//   s = bf16(t * g[b, c]); r = the residual: int8 * res_scale (rounded to
//   bf16 in mode 2), or a bf16 residual (mode 3); y = max(s + r, 0); out
//   int8 = clip(rint(y * q), +-127), or bf16(y) without q. Each step is
//   one f32 rounding spelled __fmul_rn / __fadd_rn / rintf, as K2's unit
//   tail, so the result is bit-exact against the plain version.
//
// Bound on the H100: bytes. Per element t's 2 bytes and the residual's 1
//   or 2 are read and 1 or 2 written; 3 f32 operations.
// Design: a thread takes 8 channels of one pixel: a 16-byte load of t,
//   8- or 16-byte residual loads and 8- or 16-byte stores, the 8 gate
//   values from L1 (the gate is B x C x 4 bytes); grid-stride over the
//   tensor. Where C % 8 != 0 or a pointer is not 16-byte aligned, a thread
//   takes one element.
#include "common.cuh"

namespace {

enum ResMode { kResI8 = 1, kResI8RoundBf16 = 2, kResBf16 = 3 };

constexpr int kThreads = 256;

__device__ __forceinline__ float tail(float t, float g, float r, float q,
                                      int out_i8, int8_t* o8,
                                      __nv_bfloat16* o16) {
  const float y = fmaxf(__fadd_rn(pcv::round_bf16(__fmul_rn(t, g)), r), 0.f);
  if (out_i8) *o8 = pcv::quant_i8(y, q);
  else *o16 = __float2bfloat16_rn(y);
  return y;
}

__device__ __forceinline__ float residual_at(const void* res, size_t i,
                                             int mode, float res_scale) {
  if (mode == kResBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(res)[i]);
  const float r = __fmul_rn(
      __int2float_rn(static_cast<const int8_t*>(res)[i]), res_scale);
  return mode == kResI8RoundBf16 ? pcv::round_bf16(r) : r;
}

// One element a thread.
__global__ void __launch_bounds__(kThreads) se_tail_scalar_kernel(
    const __nv_bfloat16* __restrict__ t, const float* __restrict__ g,
    const void* __restrict__ res, int mode, float res_scale, float q,
    int out_i8, void* __restrict__ out, size_t total, int C, size_t HWC) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const float gv = g[i / HWC * C + i % C];
    tail(__bfloat162float(t[i]), gv, residual_at(res, i, mode, res_scale), q,
         out_i8, static_cast<int8_t*>(out) + i,
         static_cast<__nv_bfloat16*>(out) + i);
  }
}

// 8 channels a thread (C % 8 == 0, every pointer 16-byte aligned).
__global__ void __launch_bounds__(kThreads) se_tail_vec8_kernel(
    const __nv_bfloat16* __restrict__ t, const float* __restrict__ g,
    const void* __restrict__ res, int mode, float res_scale, float q,
    int out_i8, void* __restrict__ out, size_t vecs, int C, size_t HWC) {
  for (size_t v = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       v < vecs; v += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t i = v * 8;
    const float* gp = g + i / HWC * C + i % C;
    const float4 g0 = *reinterpret_cast<const float4*>(gp);
    const float4 g1 = *reinterpret_cast<const float4*>(gp + 4);
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const uint4 tu = *reinterpret_cast<const uint4*>(t + i);
    const uint32_t tw[4] = {tu.x, tu.y, tu.z, tu.w};
    float rv[8];
    if (mode == kResBf16) {
      const uint4 ru = *reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(res) + i);
      const uint32_t rw[4] = {ru.x, ru.y, ru.z, ru.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rv[2 * k] = __uint_as_float(rw[k] << 16);
        rv[2 * k + 1] = __uint_as_float(rw[k] & 0xffff0000u);
      }
    } else {
      const uint2 ru = *reinterpret_cast<const uint2*>(
          static_cast<const int8_t*>(res) + i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e =
            static_cast<int8_t>((j < 4 ? ru.x : ru.y) >> (8 * (j & 3)));
        rv[j] = __fmul_rn(__int2float_rn(e), res_scale);
        if (mode == kResI8RoundBf16) rv[j] = pcv::round_bf16(rv[j]);
      }
    }
    float y[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t0 = __uint_as_float(tw[k] << 16);
      const float t1 = __uint_as_float(tw[k] & 0xffff0000u);
      y[2 * k] = fmaxf(
          __fadd_rn(pcv::round_bf16(__fmul_rn(t0, gv[2 * k])), rv[2 * k]), 0.f);
      y[2 * k + 1] = fmaxf(__fadd_rn(pcv::round_bf16(__fmul_rn(
                                         t1, gv[2 * k + 1])),
                                     rv[2 * k + 1]),
                           0.f);
    }
    if (out_i8) {
      uint32_t wd[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wd[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                         pcv::quant_i8(y[j], q))) << (8 * (j & 3));
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + i) =
          make_uint2(wd[0], wd[1]);
    } else {
      uint32_t wd[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 p2 = __floats2bfloat162_rn(y[2 * k], y[2 * k + 1]);
        wd[k] = *reinterpret_cast<const uint32_t*>(&p2);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + i) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// t (B, H, W, C) bf16, g (B, C) f32, res int8 or bf16 (mode 1-3), out
// int8 (out_i8) or bf16; total = B * H * W * C elements.
extern "C" int pcv_se_tail(const void* t, const void* g, const void* res,
                           int mode, float res_scale, float q, int out_i8,
                           void* out, int B, int HW, int C, void* stream) {
  if (mode < kResI8 || mode > kResBf16 || B <= 0 || HW <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t HWC = static_cast<size_t>(HW) * C;
  const size_t total = static_cast<size_t>(B) * HWC;
  const bool vec = C % 8 == 0 && aligned16(t) && aligned16(g) &&
                   aligned16(res) && aligned16(out);
  const size_t work = vec ? total / 8 : total;
  const unsigned blocks = static_cast<unsigned>(
      work < static_cast<size_t>(132) * 16 * kThreads
          ? (work + kThreads - 1) / kThreads
          : static_cast<size_t>(132) * 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    se_tail_vec8_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(t), static_cast<const float*>(g),
        res, mode, res_scale, q, out_i8, out, work, C, HWC);
  else
    se_tail_scalar_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(t), static_cast<const float*>(g),
        res, mode, res_scale, q, out_i8, out, work, C, HWC);
  return static_cast<int>(cudaGetLastError());
}
