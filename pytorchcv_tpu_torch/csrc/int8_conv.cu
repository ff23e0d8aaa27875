// K2: int8 NHWC convolution with the int8 serving pipeline's fused epilogue.
//
// Replaces: the XLA conv_general_dilated + elementwise epilogue of
//   pytorchcv_tpu/quant/resnet_int8.py:_conv_i8/_cell (the unit tail of
//   _forward included), and the per-conv stage of the Pallas kernel
//   pytorchcv_tpu/kernels/fused_bottleneck.py:_kernel (_requant and the
//   unit tail at :106-115). It serves every int8 conv of ResNet-50:
//   1x1 and 3x3, stride 1 and 2, pad k//2, and the downsample identity conv;
//   and every int8 conv of the dilated segmentation backbone
//   (pytorchcv_tpu/quant/seg_backbone_int8.py:_forward): 3x3 at dilation
//   2 and 4 with pad dilation*(k//2), and the stage-3 "bend", the bf16 tail
//   value that the last stage-3 unit writes beside its int8 output.
//
// Bound on the H100: integer multiply-adds. ResNet-50 spends ~4.1 GMAC per
//   224x224 image in these convs; with CUDA-core __dp4a (4 int8 MACs per
//   instruction) the kernel is compute bound at every stage, while its
//   memory traffic (int8 activations in, int8 out) is small.
// Design: implicit GEMM, M = output pixels, N = output channels,
//   K = kh*kw*Cin taken as 4-byte words (Cin % 4 == 0, so a word never
//   straddles two taps and every load is aligned). A 64x64 output tile per
//   256-thread block; each K step stages 64x32 bytes of activations
//   (gathered on the fly from the padded window, zero outside the image) and
//   of weights in shared memory; each thread accumulates a 4x4 int32
//   sub-tile with __dp4a, which is exact. The epilogue runs in registers and
//   writes int8 or bf16 straight to the NHWC output (and the optional bf16
//   second output), so no int32 or float tensor reaches device memory.
//   Tensor cores (mma.sync / wgmma int8) are the next step for speed.
#include "common.cuh"

namespace {

constexpr int kBM = 64;       // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBKW = 8;       // K words (4 int8 each) per step
constexpr int kThreads = 256;

// Residual operand of the unit tail (mode 3).
enum ResMode { kNoRes = 0, kResI8 = 1, kResI8RoundBf16 = 2, kResBf16 = 3 };

// kDilated = false fixes the tap spacing at 1 and kBend = false drops the
// second output at compile time, so the convs that need neither (every
// ResNet conv) run the kernel without their arithmetic and registers.
template <bool kDilated, bool kBend>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ gain_a, const float* __restrict__ bias_b,
    const void* __restrict__ res, float res_scale, int res_mode, int relu,
    float q, int out_i8, void* __restrict__ out, int N, int H, int W,
    int Cin, int Ho, int Wo, int Cout, int KH, int KW, int stride, int pad,
    int dil, __nv_bfloat16* __restrict__ out_bf16) {
  __shared__ __align__(16) int sA[kBKW][kBM];
  __shared__ __align__(16) int sB[kBKW][kBN];

  const int tid = threadIdx.x;
  const int M = N * Ho * Wo;
  const int cin4 = Cin >> 2;
  const int kw_total = KH * KW * cin4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int* xw = reinterpret_cast<const int*>(x);
  const int* ww = reinterpret_cast<const int*>(w);

  // Each thread stages two rows of A and of B, at K word `kk` of the step.
  const int kk = tid % kBKW;
  int a_img[2], a_h[2], a_w[2];
  bool a_ok[2];
  for (int l = 0; l < 2; ++l) {
    const int m = m0 + tid / kBKW + l * (kThreads / kBKW);
    a_ok[l] = m < M;
    const int mm = a_ok[l] ? m : 0;
    const int ow = mm % Wo;
    const int oh = (mm / Wo) % Ho;
    a_img[l] = mm / (Wo * Ho);
    a_h[l] = oh * stride - pad;
    a_w[l] = ow * stride - pad;
  }

  const int ty = tid / 16;  // 4 output pixels: ty*4 .. ty*4+3
  const int tx = tid % 16;  // 4 output channels: tx*4 .. tx*4+3
  int acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < kw_total; k0 += kBKW) {
    const int kword = k0 + kk;
    const bool k_ok = kword < kw_total;
    const int tap = k_ok ? kword / cin4 : 0;
    const int cw = k_ok ? kword - tap * cin4 : 0;
    const int r = tap / KW;
    const int s = tap - r * KW;
    for (int l = 0; l < 2; ++l) {
      const int row = tid / kBKW + l * (kThreads / kBKW);
      const int ih = a_h[l] + (kDilated ? r * dil : r);
      const int iw = a_w[l] + (kDilated ? s * dil : s);
      int v = 0;
      if (a_ok[l] && k_ok && ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = xw[((static_cast<size_t>(a_img[l]) * H + ih) * W + iw) * cin4 +
               cw];
      sA[kk][row] = v;
      const int co = n0 + row;
      sB[kk][row] = (co < Cout && k_ok)
                        ? ww[static_cast<size_t>(co) * kw_total + kword]
                        : 0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBKW; ++k) {
      const int4 a4 = *reinterpret_cast<const int4*>(&sA[k][ty * 4]);
      const int4 b4 = *reinterpret_cast<const int4*>(&sB[k][tx * 4]);
      const int av[4] = {a4.x, a4.y, a4.z, a4.w};
      const int bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Cout) continue;
      const size_t idx = static_cast<size_t>(m) * Cout + n;
      // _cell: y = f32(acc) * A + B, two roundings.
      float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), gain_a[n]),
                          bias_b[n]);
      if (res_mode == kNoRes) {
        if (relu) y = fmaxf(y, 0.f);
      } else {
        // Unit tail: bf16 conv term + residual, add and ReLU in f32.
        const float t = pcv::round_bf16(y);
        float rv;
        if (res_mode == kResBf16) {
          rv = __bfloat162float(static_cast<const __nv_bfloat16*>(res)[idx]);
        } else {
          rv = __fmul_rn(
              __int2float_rn(static_cast<const int8_t*>(res)[idx]), res_scale);
          if (res_mode == kResI8RoundBf16) rv = pcv::round_bf16(rv);
        }
        y = fmaxf(__fadd_rn(t, rv), 0.f);
      }
      // The bend: the bf16 value before requantization.
      if (kBend) out_bf16[idx] = __float2bfloat16_rn(y);
      if (out_i8)
        static_cast<int8_t*>(out)[idx] = pcv::quant_i8(y, q);
      else
        static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
    }
  }
}

}  // namespace

extern "C" int pcv_int8_conv(const void* x, const void* w, const void* gain_a,
                             const void* bias_b, const void* res,
                             float res_scale, int res_mode, int relu, float q,
                             int out_i8, void* out, int N, int H, int W,
                             int Cin, int Ho, int Wo, int Cout, int KH, int KW,
                             int stride, int pad, int dilation, void* out_bf16,
                             void* stream) {
  const int M = N * Ho * Wo;
  dim3 grid((M + kBM - 1) / kBM, (Cout + kBN - 1) / kBN);
  const bool bend = out_bf16 != nullptr;
  auto* kernel = dilation == 1 ? (bend ? int8_conv_kernel<false, true>
                                       : int8_conv_kernel<false, false>)
                               : (bend ? int8_conv_kernel<true, true>
                                       : int8_conv_kernel<true, false>);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(gain_a), static_cast<const float*>(bias_b),
      res, res_scale, res_mode, relu, q, out_i8, out, N, H, W, Cin, Ho, Wo,
      Cout, KH, KW, stride, pad, dilation,
      static_cast<__nv_bfloat16*>(out_bf16));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pcv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
