// K3: the serving stem of the int8 pipelines, and their int8 max-pool.
//
// Replaces: XLA's bf16 stride-2 conv (f32 accumulation), bias, ReLU, _quant
//   and int8 reduce_window max-pool of the two serving stems:
//   - 7x7/s2 pad 3 + pool, the planar ResNet stem of
//     pytorchcv_tpu/quant/resnet_int8.py:_forward (:252-264). Its role is
//     that of the Pallas kernel pytorchcv_tpu/kernels/stem_conv.py:_kernel,
//     which computes an int8-input variant that serving does not run;
//   - 3x3/s2 pad 1, conv1 of the SENet deep stem of
//     pytorchcv_tpu/quant/seg_backbone_int8.py:_forward (:85-93), which
//     pools (_maxpool_i8) after its int8 conv2 and conv3.
//   Both pools run as a launch of their own, pcv_maxpool_i8.
//
// Bound on the H100: with 3 input channels the conv is 27 or 147 MACs per
//   output value: small for the card, so the limit is moving the planar
//   bf16 image in and the int8 map out, plus the f32 CUDA-core FMAs.
// Design: kernel 1 (templated on the kernel size) gives each block one
//   output row of 32 pixels for one image. The block stages the input
//   window it needs (f32, zero padded) and the whole folded weight
//   (3*k*k taps x Cout, <= 37.6 KB) in shared memory; each of its 64
//   threads owns 4 pixels x 8 channels, so per tap 4 scalar and 2 vector
//   shared loads feed 32 FMAs. It sums the exact bf16 x bf16 products in
//   f32, adds the bias, applies ReLU and quantizes to int8, writing the
//   NHWC map. Kernel 2 max-pools an int8 NHWC map 3x3/s2 with pad value
//   -128. The int8 intermediate is a quarter of an f32 one; fusing the
//   pool into kernel 1 (halo rows) is left for later.
#include "common.cuh"

namespace {

constexpr int kTileW = 32;                    // output pixels per block
constexpr int kMaxCout = 64;
constexpr int kThreads = 64;                  // 8 pixel groups x 8 channel groups
constexpr int kPix = 4;                       // pixels per thread

// KS x KS conv, stride 2, pad KS / 2.
template <int KS>
__global__ void __launch_bounds__(kThreads) stem_conv_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, float q, int8_t* __restrict__ y, int H,
    int W, int Ho, int Wo, int Cout) {
  constexpr int kPad = KS / 2;
  constexpr int kInW = 2 * kTileW + KS - 2;   // input columns a tile reads
  constexpr int kTaps = 3 * KS * KS;
  __shared__ float s_in[3][KS][kInW];
  __shared__ __align__(16) float s_w[kTaps * kMaxCout];

  const int tid = threadIdx.x;
  const int ow0 = blockIdx.x * kTileW;
  const int oh = blockIdx.y;
  const int b = blockIdx.z;

  for (int i = tid; i < kTaps * Cout; i += kThreads)
    s_w[i] = __bfloat162float(wt[i]);
  for (int i = tid; i < 3 * KS * kInW; i += kThreads) {
    const int c = i / (KS * kInW);
    const int r = (i / kInW) % KS;
    const int col = i % kInW;
    const int ih = oh * 2 - kPad + r;
    const int iw = ow0 * 2 - kPad + col;
    float v = 0.f;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = __bfloat162float(x[((static_cast<size_t>(b) * 3 + c) * H + ih) * W + iw]);
    s_in[c][r][col] = v;
  }
  __syncthreads();

  // Pixels pg, pg+8, pg+16, pg+24 of the tile; channels c0 .. c0+7.
  const int pg = tid / 8;
  const int c0 = (tid % 8) * 8;
  if (c0 >= Cout) return;
  float acc[kPix][8];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < 3; ++c)
    for (int r = 0; r < KS; ++r)
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        // Cout % 8 == 0 and c0 % 8 == 0 keep these float4 loads aligned.
        const float4* wrow = reinterpret_cast<const float4*>(
            &s_w[((c * KS + r) * KS + s) * Cout + c0]);
        const float4 w0 = wrow[0], w1 = wrow[1];
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const float xv = s_in[c][r][2 * (pg + 8 * i) + s];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int ow = ow0 + pg + 8 * i;
    if (ow >= Wo) continue;
    int8_t* dst =
        y + ((static_cast<size_t>(b) * Ho + oh) * Wo + ow) * Cout + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = fmaxf(__fadd_rn(acc[i][j], bias[c0 + j]), 0.f);
      dst[j] = pcv::quant_i8(v, q);
    }
  }
}

// 3x3 / stride 2 / pad 1 max-pool of an int8 NHWC map, pad value -128.
__global__ void maxpool_i8_kernel(const int8_t* __restrict__ src,
                                  int8_t* __restrict__ dst, int B, int Hi,
                                  int Wi, int Hp, int Wp, int C) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(B) * Hp * Wp * C;
  if (idx >= total) return;
  const int c = idx % C;
  const int pw = (idx / C) % Wp;
  const int ph = (idx / (static_cast<size_t>(C) * Wp)) % Hp;
  const int b = idx / (static_cast<size_t>(C) * Wp * Hp);
  int m = -128;
  for (int dy = 0; dy < 3; ++dy) {
    const int ih = ph * 2 - 1 + dy;
    if (ih < 0 || ih >= Hi) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int iw = pw * 2 - 1 + dx;
      if (iw < 0 || iw >= Wi) continue;
      const int v = src[((static_cast<size_t>(b) * Hi + ih) * Wi + iw) * C + c];
      m = v > m ? v : m;
    }
  }
  dst[idx] = static_cast<int8_t>(m);
}

}  // namespace

extern "C" int pcv_stem(const void* x, const void* wt, const void* bias,
                        float q, int ksize, void* conv_out, int B, int H,
                        int W, int Ho, int Wo, int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((Wo + kTileW - 1) / kTileW, Ho, B);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wt);
  const auto* bb = static_cast<const float*>(bias);
  auto* yb = static_cast<int8_t*>(conv_out);
  if (ksize == 7)
    stem_conv_kernel<7><<<grid, kThreads, 0, st>>>(xb, wb, bb, q, yb, H, W,
                                                   Ho, Wo, Cout);
  else if (ksize == 3)
    stem_conv_kernel<3><<<grid, kThreads, 0, st>>>(xb, wb, bb, q, yb, H, W,
                                                   Ho, Wo, Cout);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcv_maxpool_i8(const void* src, void* dst, int B, int Hi,
                              int Wi, int Hp, int Wp, int C, void* stream) {
  const size_t total = static_cast<size_t>(B) * Hp * Wp * C;
  const int threads = 256;
  maxpool_i8_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                      threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(src), static_cast<int8_t*>(dst), B, Hi, Wi,
      Hp, Wp, C);
  return static_cast<int>(cudaGetLastError());
}
