// K3: the serving stem of the int8 ResNet pipeline.
//
// Replaces: XLA's bf16 7x7/s2 conv (f32 accumulation), bias, ReLU, _quant
//   and int8 reduce_window max-pool on the planar serving stem,
//   pytorchcv_tpu/quant/resnet_int8.py:_forward (:252-264). Its role is that
//   of the Pallas kernel pytorchcv_tpu/kernels/stem_conv.py:_kernel, which
//   computes an int8-input variant that serving does not run.
//
// Bound on the H100: with 3 input channels the conv is 147 MACs per output
//   value (~118 MFLOP per 224x224 image): small for the card, so the limit
//   is moving the planar bf16 image in and the int8 map out, plus the
//   f32 CUDA-core FMAs.
// Design: kernel 1 gives each block one output row of 32 pixels for one
//   image. The block stages the 3x7x69 input window it needs (f32, zero
//   padded) and the whole folded weight (147 taps x Cout, <= 37.6 KB) in
//   shared memory; each of its 64 threads owns 4 pixels x 8 channels, so per
//   tap 4 scalar and 2 vector shared loads feed 32 FMAs. It sums the 147
//   exact bf16 x bf16 products in f32, adds the bias, applies ReLU and
//   quantizes to int8, writing the NHWC map (112x112x64 at 224 input).
//   Kernel 2 max-pools that int8 map 3x3/s2 with pad value -128 to NHWC.
//   The int8 intermediate is a quarter of an f32 one; fusing the pool into
//   kernel 1 (halo rows) is left for later.
#include "common.cuh"

namespace {

constexpr int kTileW = 32;                    // output pixels per block
constexpr int kInW = 2 * kTileW + 5;          // input columns a tile reads
constexpr int kTaps = 3 * 7 * 7;
constexpr int kMaxCout = 64;
constexpr int kThreads = 64;                  // 8 pixel groups x 8 channel groups
constexpr int kPix = 4;                       // pixels per thread

__global__ void __launch_bounds__(kThreads) stem_conv_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, float q, int8_t* __restrict__ y, int H,
    int W, int Ho, int Wo, int Cout) {
  __shared__ float s_in[3][7][kInW];
  __shared__ __align__(16) float s_w[kTaps * kMaxCout];

  const int tid = threadIdx.x;
  const int ow0 = blockIdx.x * kTileW;
  const int oh = blockIdx.y;
  const int b = blockIdx.z;

  for (int i = tid; i < kTaps * Cout; i += kThreads)
    s_w[i] = __bfloat162float(wt[i]);
  for (int i = tid; i < 3 * 7 * kInW; i += kThreads) {
    const int c = i / (7 * kInW);
    const int r = (i / kInW) % 7;
    const int col = i % kInW;
    const int ih = oh * 2 - 3 + r;
    const int iw = ow0 * 2 - 3 + col;
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
    for (int r = 0; r < 7; ++r)
#pragma unroll
      for (int s = 0; s < 7; ++s) {
        // Cout % 8 == 0 and c0 % 8 == 0 keep these float4 loads aligned.
        const float4* wrow = reinterpret_cast<const float4*>(
            &s_w[((c * 7 + r) * 7 + s) * Cout + c0]);
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
                        float q, void* conv_out, void* out, int B, int H,
                        int W, int Ho, int Wo, int Hp, int Wp, int Cout,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((Wo + kTileW - 1) / kTileW, Ho, B);
  stem_conv_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const float*>(bias),
      q, static_cast<int8_t*>(conv_out), H, W, Ho, Wo, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * Hp * Wp * Cout;
  const int threads = 256;
  maxpool_i8_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                      threads, 0, st>>>(static_cast<const int8_t*>(conv_out),
                                        static_cast<int8_t*>(out), B, Ho, Wo,
                                        Hp, Wp, Cout);
  return static_cast<int>(cudaGetLastError());
}
