// K12: int8 NHWC depthwise 3x3 convolution with the int8 routes' fused
// epilogue (folded BN, ReLU or ReLU6, requantization to int8).
//
// Replaces: no Pallas kernel. The JAX package computes this conv in XLA
//   (pytorchcv_tpu/quant/mobilenet_int8.py:_conv_i8, :61-69, a
//   conv_general_dilated with feature_group_count = C and int32 sums), then
//   _cell6's (:72-97) or _forward_v1's cell_relu's (:219-226) elementwise
//   epilogue: y = f32(acc) * A + B, clip(y, 0, 6) or max(y, 0), and
//   clip(rint(y * q), +-127). PyTorch's CUDA convolutions take no int8, so
//   the port needs a kernel of its own, as for K2, K3 and maxpool_i8.
//
// Exactness: |x|, |w| <= 127 and 9 taps, so a sum is below 9 * 127^2 <
//   2^24 in magnitude and the int32 sum is exact; the epilogue spells each
//   step with __fmul_rn / __fadd_rn / rint in _cell6's f32 order, so the
//   kernel, its plain version and the JAX cell agree bit for bit.
//
// Bound on the H100: bytes. An output is 9 multiply-adds against at least
//   one input byte read and one output byte written (stride 1; four input
//   bytes a stride-2 output), far below the tensor cores' or even the
//   CUDA cores' integer rate per byte; MobileNetV2's 17 depthwise convs at
//   batch 128 move ~0.9 GB.
// Design (a first, simple one): maxpool_i8's walk (stem.cu) with a weight
//   per tap and the epilogue. A thread owns one VB-byte channel vector
//   (VB = 16, 8, 4 or 1: the widest that divides C and the pointers'
//   alignment, the host's choice) of one output column and walks a run of
//   output rows. It holds the 9 taps' weight vectors in registers, reads
//   each tap's input vector as one VB-byte load (neighbouring threads on
//   neighbouring vectors of one pixel, so a warp's loads are contiguous),
//   sums the signed bytes' products per channel in int32, and writes the
//   run's VB-byte outputs. Rows and columns outside the map are skipped
//   (pad 1, zeros). Input rows shared by two output rows of a run are read
//   again (from L1). All indices are 32-bit: the wrapper bounds the maps
//   below 2^31 bytes.
#include "common.cuh"

namespace {

template <int VB>
struct Vec {
  static constexpr int kWords = VB >= 4 ? VB / 4 : 1;
  static constexpr int kBytesWord = VB >= 4 ? 4 : 1;   // bytes used a word
  unsigned w[kWords];
};

template <int VB>
__device__ __forceinline__ Vec<VB> load_vec(const int8_t* p) {
  Vec<VB> v;
  if constexpr (VB == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = u.x; v.w[1] = u.y; v.w[2] = u.z; v.w[3] = u.w;
  } else if constexpr (VB == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v.w[0] = u.x; v.w[1] = u.y;
  } else if constexpr (VB == 4) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    v.w[0] = static_cast<unsigned char>(__ldg(p));
  }
  return v;
}

__device__ __forceinline__ int sbyte(unsigned w, int j) {
  return static_cast<int>(static_cast<signed char>(w >> (8 * j)));
}

template <int VB>
__global__ void __launch_bounds__(256) dwconv_i8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
    const float* __restrict__ gain_a, const float* __restrict__ bias_b,
    float q, int act, int8_t* __restrict__ out, int B, int H, int W, int Ho,
    int Wo, int C, int stride, int run, int runs) {
  using V = Vec<VB>;
  const int nv = C / VB;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * runs * Wo * nv) return;
  const int cv = idx % nv;
  idx /= nv;
  const int pw = idx % Wo;
  idx /= Wo;
  const int rr = idx % runs;
  const int b = idx / runs;
  const int cb = cv * VB;
  V w[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) w[t] = load_vec<VB>(wt + t * C + cb);
  const int ph0 = rr * run, ph1 = min(ph0 + run, Ho);
  const int iw0 = pw * stride - 1;
  const int8_t* img = x + b * H * W * C + cb;
  int8_t* dst = out + ((b * Ho + ph0) * Wo + pw) * C + cb;
  for (int ph = ph0; ph < ph1; ++ph, dst += Wo * C) {
    int acc[VB];
#pragma unroll
    for (int c = 0; c < VB; ++c) acc[c] = 0;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int ih = ph * stride - 1 + di;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int iw = iw0 + dj;
        if (iw < 0 || iw >= W) continue;
        const V xv = load_vec<VB>(img + (ih * W + iw) * C);
        const V& wv = w[di * 3 + dj];
#pragma unroll
        for (int k = 0; k < V::kWords; ++k)
#pragma unroll
          for (int j = 0; j < V::kBytesWord; ++j)
            acc[4 * k + j] += sbyte(xv.w[k], j) * sbyte(wv.w[k], j);
      }
    }
    // _cell6: y = f32(acc) * A + B (two roundings), the activation,
    // clip(rint(y * q), +-127).
    V o;
#pragma unroll
    for (int k = 0; k < V::kWords; ++k) {
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < V::kBytesWord; ++j) {
        const int c = 4 * k + j;
        const float a = __ldg(gain_a + cb + c), bb = __ldg(bias_b + cb + c);
        const float y = pcv::activate_i8(
            __fadd_rn(__fmul_rn(__int2float_rn(acc[c]), a), bb), act);
        word |= static_cast<unsigned>(static_cast<unsigned char>(
                    pcv::quant_i8(y, q)))
                << (8 * j);
      }
      o.w[k] = word;
    }
    if constexpr (VB == 16)
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(o.w[0], o.w[1], o.w[2], o.w[3]);
    else if constexpr (VB == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(o.w[0], o.w[1]);
    else if constexpr (VB == 4)
      *reinterpret_cast<unsigned*>(dst) = o.w[0];
    else
      *dst = static_cast<int8_t>(o.w[0] & 0xff);
  }
}

using Kernel = void (*)(const int8_t*, const int8_t*, const float*,
                        const float*, float, int, int8_t*, int, int, int, int,
                        int, int, int, int, int);

Kernel instance(int vb) {
  switch (vb) {
    case 16: return dwconv_i8_kernel<16>;
    case 8: return dwconv_i8_kernel<8>;
    case 4: return dwconv_i8_kernel<4>;
    case 1: return dwconv_i8_kernel<1>;
    default: return nullptr;
  }
}

}  // namespace

// The conv of x (B, H, W, C) int8 with wt (3, 3, C) int8, stride 1 or 2,
// pad 1, into out (B, Ho, Wo, C) int8: vb-byte channel vectors (C % vb ==
// 0, x, wt and out vb-aligned), `run` output rows a thread; act 0 none, 1
// ReLU, 2 ReLU6.
extern "C" int pcv_dwconv_i8(const void* x, const void* wt, const void* gain_a,
                             const void* bias_b, float q, int act, void* out,
                             int B, int H, int W, int Ho, int Wo, int C,
                             int stride, int vb, int run, void* stream) {
  const Kernel kernel = instance(vb);
  if (kernel == nullptr || C % vb != 0 || run < 1 || act < 0 || act > 2 ||
      (stride != 1 && stride != 2) ||
      reinterpret_cast<uintptr_t>(x) % vb != 0 ||
      reinterpret_cast<uintptr_t>(wt) % vb != 0 ||
      reinterpret_cast<uintptr_t>(out) % vb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int runs = (Ho + run - 1) / run;
  const long long threads_total =
      static_cast<long long>(B) * runs * Wo * (C / vb);
  if (threads_total >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  kernel<<<static_cast<unsigned>((threads_total + threads - 1) / threads),
           threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const float*>(gain_a), static_cast<const float*>(bias_b), q,
      act, static_cast<int8_t*>(out), B, H, W, Ho, Wo, C, stride, run, runs);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes of the vb-byte instance.
extern "C" int pcv_dwconv_i8_info(int vb, int* out) {
  const Kernel kernel = instance(vb);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
