// K9: the int8-input 7x7 / stride-2 / pad-3 stem over a 3-channel image.
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/stem_conv.py
//   (stem_conv7x7_s2 :106, pallas_call at :149, body _kernel :85,
//   prepare_stem :66), with the XLA pass around it that quantizes and
//   rearranges the image (:121-141). No serving route runs it, as in the
//   JAX package: it changes the stem's quantization (the routes run K3).
//
// Computes, for x (B, H, W, 3) f32 NHWC and wq (3, 7, 7, O) int8 (input
//   channel first; the wrapper quantizes the float kernel per output
//   channel as prepare_stem does):
//     xq = clip(rint(x * q_img), +-127)        (zero outside the image)
//     acc = sum over c, r, s of xq * wq        (exact int32)
//     y = clip(rint(max(f32(acc) * g + bias, 0) * q_out), +-127) int8
//   (B, H/2, W/2, O), each multiply and add rounded on its own as in
//   _kernel's epilogue (:99-101).
//
// Bound on the H100: bytes. 147 multiply-adds an output value on 3 input
//   channels are few for the card; the image in (12 bytes a pixel of f32)
//   and the int8 map out are what it must move.
// Design: K3's loop structure (csrc/stem.cu). A block takes one output row
//   of 32 pixels of one image; it quantizes the input window it needs
//   (3 x 7 x 69 values, read channel-fastest, as the NHWC image lies) into
//   shared memory as it loads it, and stages the whole int8 kernel (147 x O
//   <= 9,408 values) beside it; each of its 64 threads owns 4 pixels x 8
//   channels and sums 147 integer products into int32. The TPU kernel's
//   banded (7, 128, 16 O) matrix and its even/odd row planes were Mosaic
//   layout, not the function, and are not carried over.
#include "common.cuh"

namespace {

constexpr int kKS = 7;
constexpr int kPad = 3;
constexpr int kTileW = 32;                     // output pixels per block
constexpr int kMaxCout = 64;
constexpr int kThreads = 64;                   // 8 pixel groups x 8 channel groups
constexpr int kPix = 4;                        // pixels per thread
constexpr int kInW = 2 * kTileW + kKS - 2;     // input columns a tile reads
constexpr int kTaps = 3 * kKS * kKS;

__global__ void __launch_bounds__(kThreads) stem_int8_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ g, const float* __restrict__ bias, float q_img,
    float q_out, int8_t* __restrict__ y, int H, int W, int Ho, int Wo,
    int Cout) {
  __shared__ int s_in[3][kKS][kInW];
  __shared__ __align__(16) int s_w[kTaps * kMaxCout];

  const int tid = threadIdx.x;
  const int ow0 = blockIdx.x * kTileW;
  const int oh = blockIdx.y;
  const int b = blockIdx.z;

  for (int i = tid; i < kTaps * Cout; i += kThreads) s_w[i] = wq[i];
  for (int i = tid; i < kKS * kInW * 3; i += kThreads) {
    const int c = i % 3;
    const int col = (i / 3) % kInW;
    const int r = i / (3 * kInW);
    const int ih = oh * 2 - kPad + r;
    const int iw = ow0 * 2 - kPad + col;
    int v = 0;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = pcv::quant_i8(x[((static_cast<size_t>(b) * H + ih) * W + iw) * 3 + c],
                        q_img);
    s_in[c][r][col] = v;
  }
  __syncthreads();

  // Pixels pg, pg+8, pg+16, pg+24 of the tile; channels c0 .. c0+7.
  const int pg = tid / 8;
  const int c0 = (tid % 8) * 8;
  if (c0 >= Cout) return;
  int acc[kPix][8];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;
  for (int c = 0; c < 3; ++c)
    for (int r = 0; r < kKS; ++r)
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        // Cout % 8 == 0 and c0 % 8 == 0 keep these int4 loads aligned.
        const int4* wrow = reinterpret_cast<const int4*>(
            &s_w[((c * kKS + r) * kKS + s) * Cout + c0]);
        const int4 w0 = wrow[0], w1 = wrow[1];
        const int wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const int xv = s_in[c][r][2 * (pg + 8 * i) + s];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += xv * wv[j];
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
      const float v = fmaxf(
          __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), g[c0 + j]),
                    bias[c0 + j]),
          0.f);
      dst[j] = pcv::quant_i8(v, q_out);
    }
  }
}

}  // namespace

extern "C" int pcv_stem_int8(const void* x, const void* wq, const void* g,
                             const void* bias, float q_img, float q_out,
                             void* out, int B, int H, int W, int Ho, int Wo,
                             int Cout, void* stream) {
  dim3 grid((Wo + kTileW - 1) / kTileW, Ho, B);
  stem_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(g), static_cast<const float*>(bias), q_img,
      q_out, static_cast<int8_t*>(out), H, W, Ho, Wo, Cout);
  return static_cast<int>(cudaGetLastError());
}
