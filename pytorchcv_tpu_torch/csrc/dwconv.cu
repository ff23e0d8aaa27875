// K6: depthwise k x k convolution, per-channel affine (folded BatchNorm) and
// activation, in one pass.
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/dwconv.py
//   (dwconv2d_bn_act :152, pallas_call in _pallas_fwd at :124, body _kernel
//   at :62-86): the depthwise conv -> BN -> activation block of every
//   depthwise family. EfficientNet's EffiDwsConvUnit.dw_conv and
//   EffiInvResUnit.conv2 compute exactly this in eval mode.
//
// Computes, for every output (n, c, oy, ox) of x (N, C, H, W):
//   acc = sum over di (outer), dj (inner) of
//         x[n, c, oy*s - top + di, ox*s - left + dj] * w[c, di, dj]
//   in f32 (a tap outside the image reads zero), each product and sum
//   rounded on its own in the TPU body's order (:71-80), then
//   y = acc * scale[c] + shift[c] as two rounded operations (:85), the
//   activation in f32, and one cast to x's type. The activation codes are
//   the order of _ACTS (dwconv.py:35-43); hswish is x*clip(x+3,0,6)*(1/6),
//   as there.
//
// Bound on the H100: bytes. At EfficientNet-B0's 16 depthwise calls (224 x
//   224 input) one image reads and writes ~6.1 M elements, 12.2 MB in bf16;
//   the arithmetic is 2 k*k f32 operations an output element, at most 50,
//   far below the 295 operations a byte where the card's compute would
//   bind.
// Design: one thread per output element, W fastest, so that a warp's loads
//   of a tap row and its stores are contiguous runs; the k*k taps are
//   unrolled (k is a template parameter) and the channel's weights are
//   block-uniform loads. Zero padding is a bounds test: the TPU kernel's
//   padded copy (dwconv.py:119) and its stride-2 parity reshapes (:67-83)
//   staged data in VMEM and are not part of the function, so K6 reads the
//   model's own NCHW tensor with no padded or layout copy. Staging a tile
//   with its halo in shared memory, several channels a block and vector
//   loads are the next steps for speed.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // output pixels of one plane per block

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float clip06(float v) {
  return fminf(fmaxf(v, 0.f), 6.f);
}

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

// 0 none, 1 relu, 2 relu6, 3 hswish, 4 hsigmoid, 5 swish, 6 sigmoid.
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);
    case 2: return clip06(v);
    case 3: return __fmul_rn(__fmul_rn(v, clip06(__fadd_rn(v, 3.f))),
                             1.f / 6.f);
    case 4: return __fmul_rn(clip06(__fadd_rn(v, 3.f)), 1.f / 6.f);
    case 5: return __fmul_rn(v, sigmoid(v));
    case 6: return sigmoid(v);
    default: return v;
  }
}

// Grid: x = plane (n * C + c), y = chunk of kThreads output pixels.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    dwconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ out,
                  int C, int H, int W, int Ho, int Wo, int stride, int top,
                  int left, int act) {
  const int s = blockIdx.y * kThreads + threadIdx.x;
  if (s >= Ho * Wo) return;
  const int plane = blockIdx.x;
  const int c = plane % C;
  const int oy = s / Wo, ox = s - oy * Wo;
  const T* xp = x + static_cast<size_t>(plane) * H * W;
  const T* wp = w + c * K * K;
  const int y0 = oy * stride - top, x0 = ox * stride - left;
  float acc = 0.f;
#pragma unroll
  for (int di = 0; di < K; ++di) {
    const int yy = y0 + di;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int dj = 0; dj < K; ++dj) {
      const int xx = x0 + dj;
      if (xx < 0 || xx >= W) continue;
      acc = __fadd_rn(acc, __fmul_rn(load(xp + yy * W + xx),
                                     load(wp + di * K + dj)));
    }
  }
  const float y = __fadd_rn(__fmul_rn(acc, scale[c]), shift[c]);
  store(out + static_cast<size_t>(plane) * Ho * Wo + s, activate(y, act));
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* shift, void* out, int planes, int C, int H,
                   int W, int Ho, int Wo, int k, int stride, int top,
                   int left, int act, cudaStream_t st) {
  const dim3 grid(planes, (Ho * Wo + kThreads - 1) / kThreads);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  switch (k) {
    case 3:
      dwconv_kernel<T, 3><<<grid, kThreads, 0, st>>>(
          xt, wt, scale, shift, ot, C, H, W, Ho, Wo, stride, top, left, act);
      break;
    case 5:
      dwconv_kernel<T, 5><<<grid, kThreads, 0, st>>>(
          xt, wt, scale, shift, ot, C, H, W, Ho, Wo, stride, top, left, act);
      break;
    case 7:
      dwconv_kernel<T, 7><<<grid, kThreads, 0, st>>>(
          xt, wt, scale, shift, ot, C, H, W, Ho, Wo, stride, top, left, act);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x (N, C, H, W) and w (C, 1, k, k) in x's type (bf16 when bf16 != 0, else
// f32), scale and shift f32 (C,), out (N, C, Ho, Wo) in x's type.
extern "C" int pcv_dwconv(const void* x, const void* w, const void* scale,
                          const void* shift, void* out, int N, int C, int H,
                          int W, int Ho, int Wo, int k, int stride, int top,
                          int left, int act, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const int planes = N * C;
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, w, sc, sh, out, planes, C, H, W, Ho,
                                   Wo, k, stride, top, left, act, st)
           : launch<float>(x, w, sc, sh, out, planes, C, H, W, Ho, Wo, k,
                           stride, top, left, act, st);
  return static_cast<int>(err);
}
