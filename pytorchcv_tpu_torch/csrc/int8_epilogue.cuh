// The fused epilogue of K2's dense and grouped kernels (int8_conv.cu,
// int8_gconv.cu): 8 channels of one output pixel, from their exact int32
// sums to the int8, bf16 or f32 output (and the bend), each step rounded
// in the JAX reference's f32 order (pytorchcv_tpu/quant/resnet_int8.py:
// _cell and the unit tail of _forward; quant/mobilenet_int8.py:_cell6 and
// MobileNetV2's linear residual; quant/darknet_int8.py:_cell_lk and the
// DarkUnit's add; quant/preresnet_int8.py's conv epilogue followed by the
// next conv's _pre_quant): __fmul_rn, __fadd_rn, round_bf16, quant_i8.
#pragma once

#include "common.cuh"

namespace pcv {

// Residual operand of the unit tail: the ResNet tails (bf16 conv term,
// add, ReLU), kResF32, MobileNetV2's linear one (f32 conv term plus
// f32(res) * res_scale, no rounding to bf16, no activation), or
// kResActF32, DarkNet's (the activation first, then + f32(res) *
// res_scale in f32).
enum ResMode { kNoRes = 0, kResI8 = 1, kResI8RoundBf16 = 2, kResBf16 = 3,
               kResF32 = 4, kResActF32 = 5 };
// The output: bf16, int8 (quantized by q) or f32.
enum OutMode { kOutBf16 = 0, kOutI8 = 1, kOutF32 = 2 };

// Channels [n, n + cnt) of output pixel m (idx = m * Cout + n), their sums
// in lo (channels 0-3) and hi (4-7), A and B of the 8 channels in the same
// halves. vec: 8 channels, each access 8, 16 or 32 bytes and aligned. act:
// activate_i8's code, applied where there is no residual and before
// kResActF32's. gp: null, or the 8 channels' pre-activation gains G (the
// PreResNet body: y = (f32(acc) * A) * G + B, three roundings).
__device__ __forceinline__ void epilogue8(
    int4 lo, int4 hi, float4 alo, float4 ahi, float4 blo, float4 bhi,
    const float4* gp, size_t idx, int cnt, bool vec,
    const void* __restrict__ res, float res_scale, int res_mode, int act,
    float q, int out_mode, void* __restrict__ out,
    __nv_bfloat16* __restrict__ out_bf16) {
  const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const float a[8] = {alo.x, alo.y, alo.z, alo.w, ahi.x, ahi.y, ahi.z, ahi.w};
  const float b[8] = {blo.x, blo.y, blo.z, blo.w, bhi.x, bhi.y, bhi.z, bhi.w};
  float y[8];
  if (gp != nullptr) {
    const float4 glo = gp[0], ghi = gp[1];
    const float g[8] = {glo.x, glo.y, glo.z, glo.w,
                        ghi.x, ghi.y, ghi.z, ghi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      // t = f32(acc) * A, then the next conv's bn: t * G + B.
      y[j] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v[j]), a[j]), g[j]),
                       b[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      // _cell: y = f32(acc) * A + B, two roundings.
      y[j] = __fadd_rn(__fmul_rn(__int2float_rn(v[j]), a[j]), b[j]);
  }
  if (res_mode == kNoRes || res_mode == kResActF32) {
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = activate_i8(y[j], act);
  }
  if (res_mode != kNoRes) {
    // Unit tail: bf16 conv term + residual, add and ReLU in f32.
    float rv[8];
    if (res_mode == kResBf16) {
      const __nv_bfloat16* rp = static_cast<const __nv_bfloat16*>(res) + idx;
      if (vec) {
        const uint4 u = *reinterpret_cast<const uint4*>(rp);
        const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rv[2 * i] = __uint_as_float(wd[i] << 16);
          rv[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rv[j] = j < cnt ? __bfloat162float(rp[j]) : 0.f;
      }
    } else {
      const int8_t* rp = static_cast<const int8_t*>(res) + idx;
      int e[8];
      if (vec) {
        const uint2 u = *reinterpret_cast<const uint2*>(rp);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = static_cast<int8_t>((j < 4 ? u.x : u.y) >> (8 * (j & 3)));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = j < cnt ? rp[j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rv[j] = __fmul_rn(__int2float_rn(e[j]), res_scale);
        if (res_mode == kResI8RoundBf16) rv[j] = round_bf16(rv[j]);
      }
    }
    if (res_mode == kResF32 || res_mode == kResActF32) {
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(y[j], rv[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = fmaxf(__fadd_rn(round_bf16(y[j]), rv[j]), 0.f);
    }
  }
  // The bend (the bf16 value before requantization) and the bf16 output:
  // pairs packed into words, so no array leaves the registers.
  if (out_mode == kOutF32) {
    float* dst = static_cast<float*>(out) + idx;
    if (vec) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(y[4], y[5], y[6], y[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < cnt) dst[j] = y[j];
    }
  }
  if (out_bf16 != nullptr || out_mode == kOutBf16) {
    uint32_t wd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p2 = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      wd[i] = *reinterpret_cast<const uint32_t*>(&p2);
    }
    __nv_bfloat16* dsts[2] = {
        out_bf16, out_mode == kOutBf16 ? static_cast<__nv_bfloat16*>(out)
                                       : nullptr};
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (dsts[d] == nullptr) continue;
      __nv_bfloat16* dst = dsts[d] + idx;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < cnt) dst[j] = __float2bfloat16_rn(y[j]);
      }
    }
  }
  if (out_mode == kOutI8) {
    int8_t* dst = static_cast<int8_t*>(out) + idx;
    if (vec) {
      // quant_i8 in the integers: rint (round half to even) is exact in
      // int32, so clamping after the conversion gives the same bytes.
      int z[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        z[j] = min(max(__float2int_rn(__fmul_rn(y[j], q)), -127), 127);
      const uint32_t w0 = __byte_perm(__byte_perm(z[0], z[1], 0x0040),
                                      __byte_perm(z[2], z[3], 0x0040), 0x5410);
      const uint32_t w1 = __byte_perm(__byte_perm(z[4], z[5], 0x0040),
                                      __byte_perm(z[6], z[7], 0x0040), 0x5410);
      *reinterpret_cast<uint2*>(dst) = make_uint2(w0, w1);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < cnt) dst[j] = quant_i8(y[j], q);
    }
  }
}

}  // namespace pcv
