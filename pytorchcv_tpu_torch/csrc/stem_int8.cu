// K9: the int8-input 7x7 / stride-2 / pad-3 stem over a 3-channel image.
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/stem_conv.py
//   (stem_conv7x7_s2 :106, pallas_call at :149, body _kernel :85,
//   prepare_stem :66), with the XLA pass around it that quantizes and
//   rearranges the image (:121-141). No serving route runs it, as in the
//   JAX package: it changes the stem's quantization (the routes run K3).
//
// Computes, for x (B, H, W, 3) f32 NHWC and wq (7, 7, 3, O) int8 (the
//   float kernel quantized per output channel as prepare_stem does):
//     xq = clip(rint(x * q_img), +-127)        (zero outside the image)
//     acc = sum over r, s, c of xq * wq        (exact int32)
//     y = clip(rint(max(f32(acc) * g + bias, 0) * q_out), +-127) int8
//   (B, H/2, W/2, O), each multiply and add rounded on its own as in
//   _kernel's epilogue (:99-101).
//
// Bound on the H100: bytes. At batch 128 and 224x224 the image in (12
//   bytes a pixel of f32, 77 MB) and the int8 map out (103 MB) take 0.054
//   ms at 3.35 TB/s; the 15.1 G multiply-adds take 0.015 ms on the int8
//   tensor cores (and ~1 ms as int32 multiply-adds on the CUDA cores, the
//   first design).
// Design: an implicit GEMM on the int8 tensor cores, mma.sync m16n8k32 s8
//   with exact int32 sums, so the epilogue gives the plain version's bits
//   by construction. M = output pixels, N = O (<= 64), K = the taps in
//   (r, s, c) order with the channel padded 3 -> 4 and s padded 7 -> 8:
//   K = 7 x 8 x 4 = 224, one k32 step per kernel row r, and one 32-bit word
//   of A is one input pixel's 4 channels, so every A fragment is an aligned
//   32-bit load. The pad taps (c 3, s 7) carry zero weights. Persistent
//   blocks of 8 warps (two an SM) stage the int8 kernel once as mma's B
//   operand ([O][K] bytes, rows padded by 16 so ldmatrix's 8 rows read 8
//   bank groups), then walk tiles of R output rows of one image (the
//   host's plan). A tile's window (2 R + 5 input rows, the pad columns
//   included) is quantized into shared memory as it is read: one word a
//   pixel, in two planes of even and odd input columns. Where W % 4 == 0 a
//   thread reads 4 pixels as three 16-byte loads, 4 such groups in flight
//   before it quantizes any (the window's reads are the kernel's DRAM
//   traffic; one dependent load at a time left them latency-bound). At
//   stride 2 the lanes of an mma row group read pixels 2 columns apart; in
//   the planes they read neighbouring words, and the odd plane starts 16
//   banks after the even one, so a fragment load's 32 lanes never share a
//   bank with a different word. Each warp takes 32 output pixels at a
//   time (two m16 tiles x O); the epilogue (f32 gain and bias, ReLU, rintf
//   requant) is staged per warp in shared memory and written as 16-byte
//   (8-byte where O % 16 != 0) stores of the warp's contiguous 32 x O
//   bytes.
#include "common.cuh"

namespace {

using pcv::ldmatrix_x4;
using pcv::mma_s8;

constexpr int kKS = 7;
constexpr int kPad = 3;
constexpr int kMaxCout = 64;
constexpr int kThreads = 256;                 // 8 warps
constexpr int kKP = kKS * 8 * 4;              // 224: K in bytes, 7 k32 steps
constexpr int kWPitch = kKP + 16;             // bytes a staged weight row
constexpr int kStagePitch = kMaxCout + 16;    // bytes a staged output pixel
constexpr int kFixed = kMaxCout * kWPitch + 2 * kMaxCout * 4 +
                       8 * 32 * kStagePitch;

// Words a window row holds in one column plane: output columns plus the
// 3 that the taps reach beyond them (s >> 1 <= 3).
__host__ __device__ constexpr int plane_pitch(int wo) { return wo + 3; }
// The odd plane's first word: past the even plane, at bank 16.
__host__ __device__ constexpr int odd_plane(int rows_in, int wo) {
  return (rows_in * plane_pitch(wo) + 15) / 32 * 32 + 16;
}
__host__ __device__ constexpr int window_words(int rows_in, int wo) {
  return odd_plane(rows_in, wo) + rows_in * plane_pitch(wo);
}
__host__ __device__ constexpr int stem_int8_smem(int rows, int wo) {
  return kFixed + 4 * window_words(2 * rows + kKS - 2, wo);
}

__device__ __forceinline__ uint32_t quant_word(const float* p, float q) {
  const uint32_t c0 = static_cast<uint8_t>(pcv::quant_i8(__ldg(p), q));
  const uint32_t c1 = static_cast<uint8_t>(pcv::quant_i8(__ldg(p + 1), q));
  const uint32_t c2 = static_cast<uint8_t>(pcv::quant_i8(__ldg(p + 2), q));
  return c0 | (c1 << 8) | (c2 << 16);
}

// VEC4: W % 4 == 0 and x 16-byte aligned; a thread reads 4 pixels (12
// floats) of an image row as 3 16-byte loads.
template <bool VEC4>
__global__ void __launch_bounds__(kThreads, 2) stem_int8_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ g, const float* __restrict__ bias, float q_img,
    float q_out, int8_t* __restrict__ y, int B, int H, int W, int Ho, int Wo,
    int Cout, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;
  float* s_g = reinterpret_cast<float*>(s_w + kMaxCout * kWPitch);
  float* s_b = s_g + kMaxCout;
  unsigned char* s_stage = reinterpret_cast<unsigned char*>(s_b + kMaxCout);
  uint32_t* win = reinterpret_cast<uint32_t*>(s_stage + 8 * 32 * kStagePitch);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int hp = plane_pitch(Wo);
  const int rows_in = 2 * R + kKS - 2;
  const int po = odd_plane(rows_in, Wo);
  const int cols_in = 2 * hp;           // input columns -3 .. 2 hp - 4
  const int per_img = (Ho + R - 1) / R;
  const int tiles = B * per_img;

  // The kernel as B, [n][k] with k = (r * 8 + s) * 4 + c; zero at c 3, s 7
  // and n >= Cout. wq's reads coalesce along n.
  for (int i = tid; i < kMaxCout * kKP; i += kThreads) {
    const int n = i % kMaxCout, k = i / kMaxCout;
    const int c = k & 3, s = (k >> 2) & 7, r = k >> 5;
    int8_t v = 0;
    if (n < Cout && c < 3 && s < kKS)
      v = wq[((r * kKS + s) * 3 + c) * Cout + n];
    reinterpret_cast<int8_t*>(s_w + n * kWPitch)[k] = v;
  }
  for (int i = tid; i < kMaxCout; i += kThreads) {
    s_g[i] = i < Cout ? g[i] : 0.f;
    s_b[i] = i < Cout ? bias[i] : 0.f;
  }

  // ldmatrix: lane l addresses row l % 8 of matrix l / 8 = (n tile of the
  // pair, K half).
  const int mi = lane >> 3;
  const int brow = ((mi >> 1) * 8 + (lane & 7)) * kWPitch + (mi & 1) * 16;
  // Tap s = t (a0, a1) and s = 4 + t (a2, a3) of a kernel row: its plane
  // and word within the plane row.
  const int koff0 = (t & 1) * po + (t >> 1);
  const int koff2 = koff0 + 2;
  unsigned char* stage = s_stage + warp * 32 * kStagePitch;
  // Word (plane cc & 1, row, cc >> 1) of the window holds input pixel
  // (ih0 + row, cc - 3). The columns outside the image stay zero from here.
  if (VEC4)
    for (int i = tid; i < window_words(rows_in, Wo); i += kThreads) win[i] = 0;

  for (int ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
    const int img = ti / per_img, oh0 = (ti % per_img) * R;
    const int ih0 = 2 * oh0 - kPad;
    __syncthreads();   // the previous tile's fragment loads are done
    // The window, quantized as it is read; rows outside the image zero.
    const float* xi = x + static_cast<size_t>(img) * H * W * 3;
    if (VEC4) {
      // Groups of 4 pixels of a row, kUnroll groups a thread in flight.
      constexpr int kUnroll = 4;
      const int gw = W / 4, n = rows_in * gw;
      for (int i0 = tid; i0 < n; i0 += kUnroll * kThreads) {
        float4 v[kUnroll][3];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads;
          const int row = i / gw, ih = ih0 + row;
          if (i < n && static_cast<unsigned>(ih) < static_cast<unsigned>(H)) {
            const float4* src = reinterpret_cast<const float4*>(
                xi + (static_cast<size_t>(ih) * W + (i - row * gw) * 4) * 3);
            v[u][0] = __ldg(src);
            v[u][1] = __ldg(src + 1);
            v[u][2] = __ldg(src + 2);
          } else {
            v[u][0] = v[u][1] = v[u][2] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads;
          if (i >= n) break;
          const int row = i / gw, cc = (i - row * gw) * 4 + kPad;
          const float f[12] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                               v[u][1].x, v[u][1].y, v[u][1].z, v[u][1].w,
                               v[u][2].x, v[u][2].y, v[u][2].z, v[u][2].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t w =
                static_cast<uint8_t>(pcv::quant_i8(f[3 * j], q_img)) |
                static_cast<uint32_t>(static_cast<uint8_t>(
                    pcv::quant_i8(f[3 * j + 1], q_img))) << 8 |
                static_cast<uint32_t>(static_cast<uint8_t>(
                    pcv::quant_i8(f[3 * j + 2], q_img))) << 16;
            win[((cc + j) & 1) * po + row * hp + ((cc + j) >> 1)] = w;
          }
        }
      }
    } else {
      for (int i = tid; i < rows_in * cols_in; i += kThreads) {
        const int row = i / cols_in, cc = i - row * cols_in;
        const int ih = ih0 + row, iw = cc - kPad;
        uint32_t v = 0;
        if (static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
            static_cast<unsigned>(iw) < static_cast<unsigned>(W))
          v = quant_word(xi + (static_cast<size_t>(ih) * W + iw) * 3, q_img);
        win[(cc & 1) * po + row * hp + (cc >> 1)] = v;
      }
    }
    __syncthreads();

    const int P = min(R, Ho - oh0) * Wo;
    int8_t* out = y + (static_cast<size_t>(img) * Ho + oh0) * Wo * Cout;
    for (int p0 = warp * 32; p0 < P; p0 += 8 * 32) {
      // Row gq (+ 8) of m tile mt: pixel p0 + 16 mt + 8 h + gq.
      int base[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = min(p0 + 16 * mt + 8 * h + gq, P - 1);
          const int ohl = p / Wo, ow = p - ohl * Wo;
          base[mt][h] = 2 * ohl * hp + ow;
        }
      int acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
#pragma unroll
      for (int r = 0; r < kKS; ++r) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[mt][0] = win[base[mt][0] + r * hp + koff0];
          a[mt][1] = win[base[mt][1] + r * hp + koff0];
          a[mt][2] = win[base[mt][0] + r * hp + koff2];
          a[mt][3] = win[base[mt][1] + r * hp + koff2];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (16 * jj >= Cout) break;
          uint32_t v[4];
          ldmatrix_x4(v, s_w + brow + 16 * jj * kWPitch + r * 32);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_s8(acc[mt][2 * jj], a[mt], v[0], v[1]);
            if (16 * jj + 8 < Cout)
              mma_s8(acc[mt][2 * jj + 1], a[mt], v[2], v[3]);
          }
        }
      }
      // f32 gain and bias, ReLU, requant, into the warp's staging: pixel
      // 16 mt + 8 h + gq, channels nt * 8 + 2 t (+ 1).
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + 2 * t;
        if (n >= Cout) break;
        const float g0 = s_g[n], g1 = s_g[n + 1];
        const float b0 = s_b[n], b1 = s_b[n + 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int8_t o0 = pcv::quant_i8(
                fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h]),
                                          g0),
                                b0),
                      0.f),
                q_out);
            const int8_t o1 = pcv::quant_i8(
                fmaxf(__fadd_rn(
                          __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]),
                                    g1),
                          b1),
                      0.f),
                q_out);
            *reinterpret_cast<char2*>(
                stage + (16 * mt + 8 * h + gq) * kStagePitch + n) =
                make_char2(o0, o1);
          }
      }
      __syncwarp();
      // The warp's pixels p0 .. p0 + 31 are 32 x Cout contiguous bytes.
      const int np = min(32, P - p0);
      const int vb = Cout % 16 == 0 ? 16 : 8, per = Cout / vb;
      for (int i = lane; i < np * per; i += 32) {
        const int pl = i / per, c = i - pl * per;
        const unsigned char* src = stage + pl * kStagePitch + c * vb;
        int8_t* dst = out + static_cast<size_t>(p0 + pl) * Cout + c * vb;
        if (vb == 16)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// The stem over x (B, H, W, 3) in tiles of `rows` output rows (the host's
// plan), two persistent blocks an SM; 16-byte image reads where W % 4 == 0
// and x is 16-byte aligned.
extern "C" int pcv_stem_int8(const void* x, const void* wq, const void* g,
                             const void* bias, float q_img, float q_out,
                             void* out, int B, int H, int W, int Ho, int Wo,
                             int Cout, int rows, void* stream) {
  if (Cout % 8 != 0 || Cout > kMaxCout || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto kernel = vec4 ? stem_int8_kernel<true> : stem_int8_kernel<false>;
  const int smem = stem_int8_smem(rows, Wo);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  static int sms_of[64] = {};  // SMs of each device, asked once
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sms_of[dev],
                                    cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int tiles = B * ((Ho + rows - 1) / rows);
  const int grid = tiles < 2 * sms_of[dev] ? tiles : 2 * sms_of[dev];
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(g), static_cast<const float*>(bias), q_img,
      q_out, static_cast<int8_t*>(out), B, H, W, Ho, Wo, Cout, rows);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes, static and dynamic shared
// bytes of the kernel (16-byte image reads or not) at `rows` output rows a
// tile of a map `wo` wide.
extern "C" int pcv_stem_int8_info(int rows, int wo, int vec4, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, vec4 ? stem_int8_kernel<true> : stem_int8_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = stem_int8_smem(rows, wo);
  return 0;
}
