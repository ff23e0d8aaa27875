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
//   value that the last stage-3 unit writes beside its int8 output; and the
//   1x1 convs of the int8 MobileNet routes (pytorchcv_tpu/quant/
//   mobilenet_int8.py:_cell6, cell_relu): ReLU6, the projection's linear
//   residual in f32, the final block's f32 output.
//
// Bound on the H100: ResNet-50's 19 K2 convs are 0.401 T int8 operations at
//   batch 128 (0.20 ms at the int8 tensor-core peak) against 1.26 GB of
//   activations, weights and outputs (0.38 ms at 3.35 TB/s): bytes, by a
//   little; DANet's dilated stages at batch 8 are bound by operations.
// Design: implicit GEMM on the int8 tensor cores, M = output pixels, N =
//   output channels, K = taps x Cin. Products run on mma.sync m16n8k32 s8 x
//   s8 -> s32, whose sums are exact (|sum| <= 127^2 * 4608 < 2^31), so the
//   epilogue below gives the same bits as the plain version by
//   construction. A block of 8 warps computes a BM x BN output tile (128 x
//   128, 128 x 64, 64 x 128 or 64 x 64: the host's plan,
//   kernels/int8_conv.py:plan); each warp a (BM / WARPS_M) x (BN / WARPS_N)
//   sub-tile. Both operands are K-major as they lie (NHWC activations,
//   (Cout, k, k, Cin) weights), which is mma's row x col layout, and reach
//   the fragments through ldmatrix. K is walked tap by tap in 64-byte
//   chunks of Cin, so a chunk never straddles two taps: a 4-stage cp.async
//   ring stages the chunk's BM activation rows and BN weight rows, one
//   barrier a stage, the next three stages' copies in flight under the
//   products. Each loader thread computes its rows' image, ih0 and iw0 once,
//   before the K loop, and steps the tap by additions: the loop holds no
//   integer division. cp.async with src_bytes = 0 writes the zeros of the
//   image border (any stride and dilation) and of a tap's ragged end where
//   Cin % 64 != 0; copies are 16 bytes where Cin % 16 == 0, else 4 bytes
//   (a pixel's channels are then only 4-byte aligned). Rows of 64 bytes
//   hold their four 16-byte chunks XOR-swizzled by row / 2, so ldmatrix's
//   8 rows read 8 bank groups. The epilogue stages the int32 tile in shared
//   memory (over the ring) and walks it row by row, 8 channels a thread:
//   per-channel A and B from shared memory, the residual read and the int8,
//   bf16 or f32 output (and the bend) written with coalesced vector
//   accesses, each step rounded in _cell's f32 order (__fmul_rn, __fadd_rn,
//   round_bf16, quant_i8) as before.
//
// Grouped convs (groups > 1) run int8_gconv_kernel in int8_gconv.cu, which
//   shares this kernel's epilogue (int8_epilogue.cuh).
#include "int8_epilogue.cuh"

namespace {

using pcv::cp_async16;
using pcv::cp_async4;
using pcv::cp_async_commit;
using pcv::cp_async_wait;
using pcv::ldmatrix_x4;
using pcv::mma_s8;

constexpr int kThreads = 256;  // 8 warps
constexpr int kStages = 4;     // ring slots
constexpr int kKS = 64;        // K bytes a ring stage

// Dynamic shared bytes of a BM x BN block: the ring or, over it, the
// epilogue's int32 tile (rows padded by 8), then A and B per channel.
__host__ __device__ constexpr int ring_bytes(int bm, int bn) {
  return kStages * (bm + bn) * kKS;
}
__host__ __device__ constexpr int stage_tile_bytes(int bm, int bn) {
  return bm * (bn + 8) * 4;
}
__host__ __device__ constexpr int smem_bytes(int bm, int bn) {
  return (ring_bytes(bm, bn) > stage_tile_bytes(bm, bn)
              ? ring_bytes(bm, bn)
              : stage_tile_bytes(bm, bn)) +
         8 * bn;
}

// A 64-byte row's 16-byte chunk, swizzled by row / 2.
__device__ __forceinline__ int slot_at(int row, int chunk) {
  return row * kKS + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// 16 bytes of a K chunk into the ring, zeros past `valid` bytes.
template <bool VEC16>
__device__ __forceinline__ void load_chunk(int8_t* dst, const int8_t* src,
                                           int valid, const int8_t* any) {
  if (VEC16) {
    cp_async16(dst, valid > 0 ? src : any, valid > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w)
      cp_async4(dst + 4 * w, 4 * w < valid ? src + 4 * w : any,
                4 * w < valid ? 4 : 0);
  }
}

template <int BM, int BN, bool VEC16>
__global__ void __launch_bounds__(kThreads, 2) int8_conv_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ gain_a, const float* __restrict__ bias_b,
    const void* __restrict__ res, float res_scale, int res_mode, int act,
    float q, int out_mode, void* __restrict__ out,
    __nv_bfloat16* __restrict__ out_bf16, int vec_out, int H, int W,
    int Cin, int Ho, int Wo, int Cout, int KS, int stride, int pad, int dil,
    int M) {
  constexpr int WARPS_N = (BM == 128 && BN == 64) ? 2 : 4;
  constexpr int WARPS_M = 8 / WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int kSlot = (BM + BN) * kKS;
  constexpr int SP = BN + 8;          // epilogue tile's row pitch (int32)
  extern __shared__ __align__(128) int8_t smem[];
  constexpr int kMain = smem_bytes(BM, BN) - 8 * BN;
  float* s_a = reinterpret_cast<float*>(smem + kMain);
  float* s_b = s_a + BN;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = (Cout + BN - 1) / BN;
  const int m0 = blockIdx.x / n_tiles * BM;
  const int n0 = blockIdx.x % n_tiles * BN;
  for (int i = tid; i < BN; i += kThreads) {
    const int n = n0 + i;
    s_a[i] = n < Cout ? gain_a[n] : 0.f;
    s_b[i] = n < Cout ? bias_b[n] : 0.f;
  }

  // ---- the loader: thread tid fills chunk tid % 4 of A rows tid / 4 (+ 64)
  // and of B rows tid / 4 (+ 64) of a ring stage.
  constexpr int AR = BM / 64, BR = BN / 64;
  const int lrow = tid / 4, lchunk = tid % 4;
  const int8_t* a_img[AR];
  int a_h[AR], a_w[AR];
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int m = m0 + lrow + 64 * i;
    const int mm = m < M ? m : 0;
    const int ow = mm % Wo, rest = mm / Wo;
    a_img[i] = x + static_cast<size_t>(rest / Ho) * H * W * Cin;
    // A row past M never meets the image: its chunks are zeros.
    a_h[i] = m < M ? (rest % Ho) * stride - pad : -(1 << 28);
    a_w[i] = ow * stride - pad;
  }
  const int KK = KS * KS * Cin;
  const int8_t* b_row[BR];
#pragma unroll
  for (int i = 0; i < BR; ++i) {
    const int n = n0 + lrow + 64 * i;
    b_row[i] = n < Cout ? w + static_cast<size_t>(n) * KK : nullptr;
  }
  const int kpt = (Cin + kKS - 1) / kKS;    // chunks a tap
  const int total = KS * KS * kpt;
  int l_kc = 0, l_s = 0, l_rd = 0, l_sd = 0, l_tap = 0;  // tap offset l_tap
  auto load_stage = [&](int slot) {
    int8_t* sB = smem + slot * kSlot;
    int8_t* sA = sB + BN * kKS;
    const int kb = l_kc * kKS + lchunk * 16;
    const int valid = Cin - kb;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const int ih = a_h[i] + l_rd, iw = a_w[i] + l_sd;
      const bool in = static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(W);
      load_chunk<VEC16>(
          sA + slot_at(lrow + 64 * i, lchunk),
          in ? a_img[i] + (static_cast<size_t>(ih * W + iw) * Cin + kb) : x,
          in ? valid : 0, x);
    }
#pragma unroll
    for (int i = 0; i < BR; ++i)
      load_chunk<VEC16>(sB + slot_at(lrow + 64 * i, lchunk),
                        b_row[i] ? b_row[i] + l_tap + kb : w,
                        b_row[i] ? valid : 0, w);
    if (++l_kc == kpt) {
      l_kc = 0;
      l_tap += Cin;
      l_sd += dil;
      if (++l_s == KS) {
        l_s = 0;
        l_sd = 0;
        l_rd += dil;
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }

  // ---- the products: warp (wm, wn), MT x NT mma tiles. ldmatrix offsets
  // into a ring slot, by n-tile pair / m-tile and 32-byte K step.
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int mi = lane >> 3;
  const int arow = (lane & 7) + (mi & 1) * 8, ahalf = mi >> 1;
  int boff[NT / 2][2], aoff[MT][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj)
      boff[jj][kk] = slot_at(wn * WN + (2 * jj + (mi >> 1)) * 8 + (lane & 7),
                             2 * kk + (mi & 1));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      aoff[mt][kk] =
          BN * kKS + slot_at(wm * WM + mt * 16 + arow, 2 * kk + ahalf);
  }
  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
  const int m_warp = m0 + wm * WM;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < total) load_stage((it + kStages - 1) % kStages);
    cp_async_commit();
    const int8_t* slot = smem + (it % kStages) * kSlot;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t b[NT][2];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t v[4];
        ldmatrix_x4(v, slot + boff[jj][kk]);
        b[2 * jj][0] = v[0];
        b[2 * jj][1] = v[1];
        b[2 * jj + 1][0] = v[2];
        b[2 * jj + 1][1] = v[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (m_warp + mt * 16 >= M) continue;
        uint32_t a[4];
        ldmatrix_x4(a, slot + aoff[mt][kk]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- the epilogue: the int32 tile into shared memory (over the ring),
  // then row by row, 8 channels a thread.
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * WM + mt * 16 + g, c = wn * WN + nt * 8 + 2 * t;
      *reinterpret_cast<int2*>(tile + r * SP + c) =
          make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(tile + (r + 8) * SP + c) =
          make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();

  constexpr int GROUPS = BN / 8;
  for (int i = tid; i < BM * GROUPS; i += kThreads) {
    const int r = i / GROUPS, cg = i % GROUPS;
    const int m = m0 + r, n = n0 + cg * 8;
    if (m >= M || n >= Cout) continue;
    const int cnt = min(8, Cout - n);
    const bool vec = vec_out && cnt == 8;
    const size_t idx = static_cast<size_t>(m) * Cout + n;
    // The two 16-byte halves in turn by cg / 4: 8 threads, 8 bank groups.
    const int sw = (cg >> 2) & 1;
    const int4* src = reinterpret_cast<const int4*>(tile + r * SP + cg * 8);
    const int4 h0 = src[sw], h1 = src[sw ^ 1];
    const float4* sa = reinterpret_cast<const float4*>(s_a + cg * 8);
    const float4* sb = reinterpret_cast<const float4*>(s_b + cg * 8);
    pcv::epilogue8(sw ? h1 : h0, sw ? h0 : h1, sa[0], sa[1], sb[0], sb[1],
                   idx, cnt, vec, res, res_scale, res_mode, act, q, out_mode,
                   out, out_bf16);
  }
}


// The instance for a plan's tile and the copy width.
template <int BM, int BN>
auto pick(bool vec16) {
  return vec16 ? int8_conv_kernel<BM, BN, true>
               : int8_conv_kernel<BM, BN, false>;
}

using Kernel = decltype(pick<128, 128>(true));

bool instance(int bm, int bn, bool vec16, Kernel* kernel, int* smem) {
  if (bm == 128 && bn == 128) {
    *kernel = pick<128, 128>(vec16);
    *smem = smem_bytes(128, 128);
  } else if (bm == 128 && bn == 64) {
    *kernel = pick<128, 64>(vec16);
    *smem = smem_bytes(128, 64);
  } else if (bm == 64 && bn == 128) {
    *kernel = pick<64, 128>(vec16);
    *smem = smem_bytes(64, 128);
  } else if (bm == 64 && bn == 64) {
    *kernel = pick<64, 64>(vec16);
    *smem = smem_bytes(64, 64);
  } else {
    return false;
  }
  return true;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One conv in tiles of bm x bn (the plan's: 128 or 64 each); copies are
// 16 bytes where Cin % 16 == 0 and x and w are 16-byte aligned, and the
// epilogue's accesses 8 channels wide where Cout % 8 == 0 and every
// output and the residual are 16-byte aligned.
extern "C" int pcv_int8_conv(const void* x, const void* w, const void* gain_a,
                             const void* bias_b, const void* res,
                             float res_scale, int res_mode, int act, float q,
                             int out_mode, void* out, int N, int H, int W,
                             int Cin, int Ho, int Wo, int Cout, int KH, int KW,
                             int stride, int pad, int dilation, void* out_bf16,
                             int bm, int bn, void* stream) {
  if (KH != KW || Cin % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 = Cin % 16 == 0 && aligned16(x) && aligned16(w);
  Kernel kernel;
  int smem;
  if (!instance(bm, bn, vec16, &kernel, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_out = Cout % 8 == 0 && aligned16(out) &&
                      (res == nullptr || aligned16(res)) &&
                      (out_bf16 == nullptr || aligned16(out_bf16));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = N * Ho * Wo;
  const unsigned blocks = static_cast<unsigned>((M + bm - 1) / bm) *
                          static_cast<unsigned>((Cout + bn - 1) / bn);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(gain_a), static_cast<const float*>(bias_b),
      res, res_scale, res_mode, act, q, out_mode, out,
      static_cast<__nv_bfloat16*>(out_bf16), vec_out, H, W, Cin, Ho, Wo,
      Cout, KH, stride, pad, dilation, M);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes, static and dynamic shared
// bytes of the instance of tile bm x bn with 16-byte (vec16) or 4-byte
// copies.
extern "C" int pcv_int8_conv_info(int bm, int bn, int vec16, int* out) {
  Kernel kernel;
  int smem;
  if (!instance(bm, bn, vec16 != 0, &kernel, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = smem;
  return 0;
}

extern "C" const char* pcv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
