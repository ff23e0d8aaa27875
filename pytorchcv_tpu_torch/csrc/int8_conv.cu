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
//   per-channel A and B from shared memory, the residual read and the int8
//   or bf16 output (and the bend) written with 8- or 16-byte coalesced
//   accesses, each step rounded in _cell's f32 order (__fmul_rn, __fadd_rn,
//   round_bf16, quant_i8) as before.
//
// Grouped convs (int8_gconv_kernel: ResNeXt's and SENet's grouped 3x3,
//   per-group widths cg = Cin / groups in {2, 4, 8, 16, 32}, og = Cout /
//   groups = cg or 2 cg): a first design on the CUDA cores. K per output is
//   only k*k*cg (18-288 bytes), too shallow for an m16n8k32 tile without
//   densifying the groups (the JAX package's block-diagonal merge, 16-32x
//   the multiply-adds), so each product is a __dp4a of four int8 pairs.
//   A block takes 128 output pixels x BC channels (whole groups, the
//   host's gconv_plan); it stages its channels' weights in shared memory
//   as 4-byte words of each output's (tap, channel) sequence, zero-padded
//   to a word (at cg = 2 a word spans two taps), laid out [chunk][word]
//   [OPT], a chunk being OPT consecutive outputs of one group. A thread
//   computes one chunk at one pixel: it reads its group's cg channels of
//   each tap (2-32 bytes, vectors of up to 16) and meets each word with
//   OPT weight words, which the 32 lanes (32 pixels of one chunk) read at
//   one shared address. Sums are exact, and the epilogue is the dense
//   kernel's, step for step, so the result is bit-exact against the plain
//   version (F.conv2d with groups in float64). Bound on the H100: the
//   grouped convs of ResNeXt-50 are 60 G int8 operations at batch 128,
//   under 0.1 ms at the tensor cores' peak; this design runs at the
//   __dp4a rate of the CUDA cores.
#include "common.cuh"

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

// Residual operand of the unit tail.
enum ResMode { kNoRes = 0, kResI8 = 1, kResI8RoundBf16 = 2, kResBf16 = 3 };

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
    const void* __restrict__ res, float res_scale, int res_mode, int relu,
    float q, int out_i8, void* __restrict__ out,
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
    const int4 lo = sw ? h1 : h0, hi = sw ? h0 : h1;
    const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      // _cell: y = f32(acc) * A + B, two roundings.
      y[j] = __fadd_rn(__fmul_rn(__int2float_rn(v[j]), s_a[cg * 8 + j]),
                       s_b[cg * 8 + j]);
    if (res_mode == kNoRes) {
      if (relu)
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = fmaxf(y[j], 0.f);
    } else {
      // Unit tail: bf16 conv term + residual, add and ReLU in f32.
      float rv[8];
      if (res_mode == kResBf16) {
        const __nv_bfloat16* rp =
            static_cast<const __nv_bfloat16*>(res) + idx;
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
          if (res_mode == kResI8RoundBf16) rv[j] = pcv::round_bf16(rv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = fmaxf(__fadd_rn(pcv::round_bf16(y[j]), rv[j]), 0.f);
    }
    // The bend (the bf16 value before requantization) and the bf16 output:
    // pairs packed into words, so no array leaves the registers.
    if (out_bf16 != nullptr || !out_i8) {
      uint32_t wd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 p2 = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
        wd[i] = *reinterpret_cast<const uint32_t*>(&p2);
      }
      __nv_bfloat16* dsts[2] = {out_bf16, out_i8 ? nullptr
                                                 : static_cast<__nv_bfloat16*>(out)};
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
    if (out_i8) {
      int8_t* dst = static_cast<int8_t*>(out) + idx;
      if (vec) {
        uint32_t wd[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wd[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                           pcv::quant_i8(y[j], q))) << (8 * (j & 3));
        *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < cnt) dst[j] = pcv::quant_i8(y[j], q);
      }
    }
  }
}


// ---- grouped convs

constexpr int kGBP = 128;      // output pixels a grouped block

// Words of one output's (tap, channel) sequence: k*k*cg bytes, padded.
__host__ __device__ constexpr int gconv_words(int ks, int cg) {
  return (ks * ks * cg + 3) / 4;
}

// Dynamic shared bytes of a grouped block of bc channels.
__host__ __device__ constexpr int gconv_smem(int ks, int cg, int bc) {
  return bc * gconv_words(ks, cg) * 4 + 8 * bc;
}

// n words (n = 2 or a multiple of 4) from a 4n-byte aligned address.
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&v)[N], const void* p) {
  if constexpr (N == 1) {
    v[0] = *static_cast<const uint32_t*>(p);
  } else if constexpr (N == 2) {
    const uint2 u = *static_cast<const uint2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 u = static_cast<const uint4*>(p)[i];
      v[4 * i] = u.x;
      v[4 * i + 1] = u.y;
      v[4 * i + 2] = u.z;
      v[4 * i + 3] = u.w;
    }
  }
}

template <int OPT>
__device__ __forceinline__ void dp4a_chunk(int (&acc)[OPT], uint32_t xv,
                                           const uint32_t* wp) {
  uint32_t wv[OPT];
  load_words<OPT>(wv, wp);
#pragma unroll
  for (int o = 0; o < OPT; ++o)
    acc[o] = __dp4a(static_cast<int>(xv), static_cast<int>(wv[o]), acc[o]);
}

template <int CG, int OPT>
__global__ void __launch_bounds__(kThreads, 1) int8_gconv_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ gain_a, const float* __restrict__ bias_b,
    const void* __restrict__ res, float res_scale, int res_mode, int relu,
    float q, int out_i8, void* __restrict__ out,
    __nv_bfloat16* __restrict__ out_bf16, int H, int W, int Cin, int Ho,
    int Wo, int Cout, int KS, int stride, int pad, int dil, int M, int og,
    int BC) {
  extern __shared__ __align__(16) int8_t gsmem[];
  const int KW = gconv_words(KS, CG), K = KS * KS * CG;
  uint32_t* s_w = reinterpret_cast<uint32_t*>(gsmem);   // [chunk][KW][OPT]
  float* s_a = reinterpret_cast<float*>(s_w + BC * KW);
  float* s_b = s_a + BC;
  const int n_tiles = (Cout + BC - 1) / BC;
  const int m0 = blockIdx.x / n_tiles * kGBP;
  const int n0 = blockIdx.x % n_tiles * BC;
  for (int i = threadIdx.x; i < BC * KW; i += kThreads) {
    const int o = i / KW, j = i % KW, n = n0 + o;
    uint32_t word = 0;
    if (n < Cout) {
      const int8_t* src = w + static_cast<size_t>(n) * K + 4 * j;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * j + b < K)
          word |= static_cast<uint32_t>(static_cast<uint8_t>(src[b]))
                  << (8 * b);
    }
    s_w[((o / OPT) * KW + j) * OPT + o % OPT] = word;
  }
  for (int i = threadIdx.x; i < BC; i += kThreads) {
    const int n = n0 + i;
    s_a[i] = n < Cout ? gain_a[n] : 0.f;
    s_b[i] = n < Cout ? bias_b[n] : 0.f;
  }
  __syncthreads();

  const int items = kGBP * (BC / OPT);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int ch = it / kGBP, m = m0 + it % kGBP;
    const int n = n0 + ch * OPT;
    if (m >= M || n >= Cout) continue;
    const int ow = m % Wo, rest = m / Wo, oh = rest % Ho;
    const int8_t* xg = x + static_cast<size_t>(rest / Ho) * H * W * Cin +
                       (n / og) * CG;
    const int ih0 = oh * stride - pad, iw0 = ow * stride - pad;
    const uint32_t* wc = s_w + ch * KW * OPT;
    int acc[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o) acc[o] = 0;
    if constexpr (CG >= 4) {
      // A tap's CG channels are CG / 4 whole words; a tap outside the
      // image adds zeros, so it is skipped.
      for (int r = 0; r < KS; ++r) {
        const int ih = ih0 + r * dil;
        if (static_cast<unsigned>(ih) >= static_cast<unsigned>(H)) continue;
        for (int s = 0; s < KS; ++s) {
          const int iw = iw0 + s * dil;
          if (static_cast<unsigned>(iw) >= static_cast<unsigned>(W))
            continue;
          uint32_t xv[CG / 4];
          load_words<CG / 4>(
              xv, xg + (static_cast<size_t>(ih) * W + iw) * Cin);
          const uint32_t* wt = wc + (r * KS + s) * (CG / 4) * OPT;
#pragma unroll
          for (int jj = 0; jj < CG / 4; ++jj)
            dp4a_chunk<OPT>(acc, xv[jj], wt + jj * OPT);
        }
      }
    } else {
      // CG == 2: word j holds taps 2j and 2j + 1, two channels each.
      for (int j = 0; j < KW; ++j) {
        uint32_t xv = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tap = 2 * j + h;
          if (tap >= KS * KS) break;
          const int ih = ih0 + tap / KS * dil, iw = iw0 + tap % KS * dil;
          if (static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
              static_cast<unsigned>(iw) < static_cast<unsigned>(W))
            xv |= static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
                      xg + (static_cast<size_t>(ih) * W + iw) * Cin))
                  << (16 * h);
        }
        dp4a_chunk<OPT>(acc, xv, wc + j * OPT);
      }
    }

    // The dense kernel's epilogue, OPT channels of one pixel.
    float y[OPT];
#pragma unroll
    for (int o = 0; o < OPT; ++o)
      y[o] = __fadd_rn(__fmul_rn(__int2float_rn(acc[o]), s_a[ch * OPT + o]),
                       s_b[ch * OPT + o]);
    const size_t idx = static_cast<size_t>(m) * Cout + n;
    if (res_mode == kNoRes) {
      if (relu)
#pragma unroll
        for (int o = 0; o < OPT; ++o) y[o] = fmaxf(y[o], 0.f);
    } else {
      float rv[OPT];
      if (res_mode == kResBf16) {
        uint32_t u[OPT / 2];
        load_words<OPT / 2>(u, static_cast<const __nv_bfloat16*>(res) + idx);
#pragma unroll
        for (int i = 0; i < OPT / 2; ++i) {
          rv[2 * i] = __uint_as_float(u[i] << 16);
          rv[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
      } else {
        const int8_t* rp = static_cast<const int8_t*>(res) + idx;
        int e[OPT];
        if constexpr (OPT == 2) {
          const uint16_t u = *reinterpret_cast<const uint16_t*>(rp);
          e[0] = static_cast<int8_t>(u & 0xff);
          e[1] = static_cast<int8_t>(u >> 8);
        } else {
          uint32_t u[OPT / 4];
          load_words<OPT / 4>(u, rp);
#pragma unroll
          for (int o = 0; o < OPT; ++o)
            e[o] = static_cast<int8_t>(u[o / 4] >> (8 * (o & 3)));
        }
#pragma unroll
        for (int o = 0; o < OPT; ++o) {
          rv[o] = __fmul_rn(__int2float_rn(e[o]), res_scale);
          if (res_mode == kResI8RoundBf16) rv[o] = pcv::round_bf16(rv[o]);
        }
      }
#pragma unroll
      for (int o = 0; o < OPT; ++o)
        y[o] = fmaxf(__fadd_rn(pcv::round_bf16(y[o]), rv[o]), 0.f);
    }
    // bf16 pairs as words, no array or address taken: the bend and the
    // bf16 output.
#pragma unroll
    for (int i = 0; i < OPT / 2; ++i) {
      const uint32_t wd =
          static_cast<uint32_t>(__bfloat16_as_ushort(
              __float2bfloat16_rn(y[2 * i]))) |
          static_cast<uint32_t>(__bfloat16_as_ushort(
              __float2bfloat16_rn(y[2 * i + 1]))) << 16;
      if (out_bf16 != nullptr)
        reinterpret_cast<uint32_t*>(out_bf16 + idx)[i] = wd;
      if (!out_i8)
        reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + idx)
            [i] = wd;
    }
    if (out_i8) {
      int8_t* dst = static_cast<int8_t*>(out) + idx;
      if constexpr (OPT == 2) {
        *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(
            static_cast<uint8_t>(pcv::quant_i8(y[0], q)) |
            (static_cast<uint32_t>(static_cast<uint8_t>(
                 pcv::quant_i8(y[1], q))) << 8));
      } else {
#pragma unroll
        for (int i = 0; i < OPT / 4; ++i) {
          uint32_t wd = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            wd |= static_cast<uint32_t>(static_cast<uint8_t>(
                      pcv::quant_i8(y[4 * i + b], q))) << (8 * b);
          reinterpret_cast<uint32_t*>(dst)[i] = wd;
        }
      }
    }
  }
}

using GKernel = decltype(&int8_gconv_kernel<4, 4>);

template <int CG>
GKernel gpick(int opt) {
  if (opt == 8) return int8_gconv_kernel<CG, 8>;
  if (opt == 4) return int8_gconv_kernel<CG, 4>;
  if (opt == 2) return int8_gconv_kernel<CG, 2>;
  return nullptr;
}

// The instance for a group width and outputs a thread (nullptr if none).
GKernel ginstance(int cg, int opt) {
  switch (cg) {
    case 2: return gpick<2>(opt);
    case 4: return gpick<4>(opt);
    case 8: return gpick<8>(opt);
    case 16: return gpick<16>(opt);
    case 32: return gpick<32>(opt);
    default: return nullptr;
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
                             float res_scale, int res_mode, int relu, float q,
                             int out_i8, void* out, int N, int H, int W,
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
      res, res_scale, res_mode, relu, q, out_i8, out,
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

// One grouped conv (groups > 1): per-group widths cg = Cin / groups in
// {2, 4, 8, 16, 32}, og = Cout / groups a multiple of opt (2, 4 or 8), in
// blocks of 128 pixels x bc channels (a multiple of og); x, w, the
// residual and the outputs 16-byte aligned.
extern "C" int pcv_int8_gconv(const void* x, const void* w,
                              const void* gain_a, const void* bias_b,
                              const void* res, float res_scale, int res_mode,
                              int relu, float q, int out_i8, void* out,
                              void* out_bf16, int N, int H, int W, int Cin,
                              int Ho, int Wo, int Cout, int KS, int stride,
                              int pad, int dilation, int groups, int bc,
                              int opt, void* stream) {
  if (groups < 2 || Cin % groups != 0 || Cout % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cg = Cin / groups, og = Cout / groups;
  const GKernel kernel = ginstance(cg, opt);
  if (kernel == nullptr || og % opt != 0 || bc % og != 0 || bc <= 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out) ||
      (res != nullptr && !aligned16(res)) ||
      (out_bf16 != nullptr && !aligned16(out_bf16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = gconv_smem(KS, cg, bc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = N * Ho * Wo;
  const unsigned blocks = static_cast<unsigned>((M + kGBP - 1) / kGBP) *
                          static_cast<unsigned>((Cout + bc - 1) / bc);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(gain_a), static_cast<const float*>(bias_b),
      res, res_scale, res_mode, relu, q, out_i8, out,
      static_cast<__nv_bfloat16*>(out_bf16), H, W, Cin, Ho, Wo, Cout, KS,
      stride, pad, dilation, M, og, bc);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes, static shared bytes of the
// grouped instance (cg, opt).
extern "C" int pcv_int8_gconv_info(int cg, int opt, int* out) {
  const GKernel kernel = ginstance(cg, opt);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

extern "C" const char* pcv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
