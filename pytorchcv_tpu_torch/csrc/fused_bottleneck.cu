// K8: one stride-1 int8 bottleneck unit (1x1 -> 3x3 -> 1x1 + identity),
// with its two intermediates kept in shared memory. A chain of units is one
// launch per unit (the wrapper loops).
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/fused_bottleneck.py
//   (fused_bottleneck_chain :166, pallas_call at :176, body _kernel :73,
//   _requant :67): a run of stride-1 bottleneck units with no downsample
//   and no SE of the int8 ResNet pipeline (quant/resnet_int8.py:_forward),
//   there as three K2 launches a unit whose t1 and t2 round-trip through
//   device memory.
//
// Computes, for x (B, H, W, C) int8 and one unit's W1 (M, C), W2 (M, 3, 3,
//   M), W3 (C, M) int8 (output channel first, the K dimension contiguous):
//     t1 = rq(relu(x @ W1 * A1 + B1), q1)          (a 1x1 conv)
//     t2 = rq(relu(conv3x3(t1, pad 1) * A2 + B2), q2)   (t1 zero padded)
//     out = rq(relu(bf16(t2 @ W3 * A3 + B3) + bf16(x * R)), q3)
//   with exact int32 sums and rq(v, q) = clip(rint(v * q), +-127), every
//   multiply and add rounded on its own in _cell's order, as K2 does
//   (PERF.md section 6): the kernel is bit-exact against the K2 chain.
//
// Bound on the H100: integer multiply-adds, 2 B H W (2 C M + 9 M^2)
//   operations a unit (55.9 G at ResNet-50's batch 128: 28 us at the int8
//   peak) against 2 B H W C bytes of activations (26 MB: 8 us).
// Design: a block takes a tile of TH output rows and TW columns of one
//   image (the wrapper's plan: whole rows, TW = W, unless one row leaves
//   the weight ring no room). It
//   1. zeroes t1's tile with its 1-row / 1-column halo, (TH+2) x (TW+2)
//      x M int8, and computes t1 at the halo positions inside the image
//      only: a halo position outside the image is the 3x3's zero padding
//      and holds 0, not rq(relu(B1)); the halo rows and columns inside the
//      image are computed again by the neighbouring tiles;
//   2. computes t2, TH x TW x M int8, reading the nine taps of t1 in
//      place;
//   3. computes conv3 and the residual tail straight to the output.
//   Each step is an implicit GEMM on the int8 tensor cores: mma.sync
//   m16n8k32 s8 x s8 -> s32 (its sums are exact: |sum| <= 127^2 * 4608 <
//   2^31, so the epilogues above stay as they were). 8 warps of 32 pixels
//   x 32 channels make a pass of 64 pixels x 128 channels, 128 x 64 or
//   256 x 32: the widest that the step's pixels fill, as every pass
//   streams its channels' weights again; a warp skips its 16-pixel rows
//   past the step's pixels. A is read by ldmatrix: for step 1 from x's
//   pixels, staged by cp.async; for steps 2 and 3 in place from t1 and t2,
//   whose pixels are channel-last rows of M (padded to 64) bytes with
//   their 16-byte chunks XOR-swizzled by the pixel's index, so the 8 rows
//   of an ldmatrix read 8 bank groups (a row pitch that is a multiple of
//   128 bytes would put them on one); the epilogue stores follow the
//   swizzle.
//   B, the weights (N, K) with K contiguous, is mma's .col operand as
//   stored: 64-byte K slices of each pass's rows stream from L2 through a
//   3-stage cp.async ring (swizzled likewise), one stream over the three
//   steps' passes, so the next step's weights load while the last pass of
//   the step before finishes. Only x is read and out written in device
//   memory; every block reads the unit's weights from L2 once a pass.
#include "common.cuh"

namespace {

using pcv::cp_async16;
using pcv::cp_async4;
using pcv::cp_async_commit;
using pcv::cp_async_wait;
using pcv::ldmatrix_x4;
using pcv::mma_s8;

constexpr int kThreads = 256;       // 8 warps
constexpr int kStages = 3;          // ring slots
constexpr int kKS = 64;             // K bytes a ring stage
constexpr int kSlot = 192 * kKS;    // a stage's B rows and (step 1) A rows

// _cell's int8 path: clip(rint(max(f32(acc) * A + B, 0) * q)).
__device__ __forceinline__ int8_t requant(int acc, float a, float b, float q) {
  const float y =
      fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), a), b), 0.f);
  return pcv::quant_i8(y, q);
}

// One GEMM step of the unit: its pixels, outputs, K bytes a tap and taps;
// passes of (256 >> wsh) pixels x (32 << wsh) channels, the widest that
// the step's pixels fill, since each pass streams its channels' weights
// (64 x 128 or 128 x 64 for step 1, which stages x beside the weights).
struct Step {
  int P, N, K, taps, kpt, wsh, bm, bn, mpass, npass;
};

__device__ __forceinline__ Step make_step(int st, int P1, int P, int C,
                                          int M) {
  Step f;
  f.P = st == 0 ? P1 : P;
  f.N = st == 2 ? C : M;
  f.K = st == 0 ? C : M;
  f.taps = st == 1 ? 9 : 1;
  f.kpt = (f.K + kKS - 1) / kKS;
  f.wsh = f.P <= 64 ? 2 : f.P <= 128 ? 1 : 0;
  if (f.N <= 64) f.wsh = min(f.wsh, 1);
  if (f.N <= 32) f.wsh = 0;
  if (st == 0) f.wsh = max(f.wsh, 1);
  f.bm = 256 >> f.wsh;
  f.bn = 32 << f.wsh;
  f.mpass = (f.P + f.bm - 1) / f.bm;
  f.npass = (f.N + f.bn - 1) / f.bn;
  return f;
}

// Where a stream of ring stages stands: step, pass (m, n), tap, K stage of
// the tap; and the step's pass counts and shape (make_step's kpt, mpass,
// npass, wsh; the rest follows from st).
struct Cursor {
  int st, mp, np, tap, kc, kpt, mpass, npass, wsh;
  __device__ void start(int s, int P1, int P, int C, int M) {
    const Step f = make_step(s, P1, P, C, M);
    st = s;
    kpt = f.kpt;
    mpass = f.mpass;
    npass = f.npass;
    wsh = f.wsh;
  }
  __device__ bool pass_start() const { return tap == 0 && kc == 0; }
  __device__ bool pass_end() const {
    return tap == (st == 1 ? 8 : 0) && kc == kpt - 1;
  }
  __device__ void next(int P1, int P, int C, int M) {
    if (++kc < kpt) return;
    kc = 0;
    if (++tap < (st == 1 ? 9 : 1)) return;
    tap = 0;
    if (++np < npass) return;
    np = 0;
    if (++mp < mpass) return;
    mp = 0;
    if (st < 2) start(st + 1, P1, P, C, M);
    else ++st;
  }
};

// Byte offset of channel chunk `chunk` (16 bytes) of pixel `pos` in t1 or
// t2 (pitch MP bytes): chunks XOR-swizzled within aligned groups of 8
// (MP a multiple of 128) or of 4 (by pos / 2), so 8 consecutive pixels'
// same chunk lie in 8 different bank groups.
__device__ __forceinline__ int chunk_at(int pos, int chunk, int MP, int sh,
                                        int mk) {
  return pos * MP + ((chunk ^ ((pos >> sh) & mk)) << 4);
}

// A stage's row (64 bytes, 4 chunks) chunk, swizzled by row / 2.
__device__ __forceinline__ int slot_at(int row, int chunk) {
  return row * kKS + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// 16 bytes of a K slice into the ring, zeros past `valid` bytes.
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

template <bool VEC16>
__global__ void __launch_bounds__(kThreads, 2) bottleneck_unit_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w1,
    const int8_t* __restrict__ w2, const int8_t* __restrict__ w3,
    const float* __restrict__ a1, const float* __restrict__ b1,
    const float* __restrict__ a2, const float* __restrict__ b2,
    const float* __restrict__ a3, const float* __restrict__ b3, float q1,
    float q2, float q3, float r, int8_t* __restrict__ out, int H, int W,
    int C, int M, int TH, int TW) {
  extern __shared__ __align__(128) int8_t smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int MP = (M + 63) / 64 * 64;
  const int sh = (MP / 16) % 8 == 0 ? 0 : 1, mk = sh ? 3 : 7;
  const int ncol = (W + TW - 1) / TW, img = blockIdx.y;
  const int r0 = blockIdx.x / ncol * TH, rows = min(TH, H - r0);
  const int c0 = blockIdx.x % ncol * TW, cols = min(TW, W - c0);
  const int W2 = TW + 2, T1 = (TH + 2) * W2;
  // step 1's pixels: the tile with its halo inside the image
  const int lo = max(r0 - 1, 0), rows1 = min(r0 + rows, H - 1) - lo + 1;
  const int cl = max(c0 - 1, 0), cols1 = min(c0 + cols, W - 1) - cl + 1;
  const int P1 = rows1 * cols1, P = rows * cols;
  int8_t* t1 = smem;
  int8_t* t2 = t1 + T1 * MP;
  int8_t* ring = t2 + TH * TW * MP;

  // 1. t1 starts as zeros: its halo outside the image stays so.
  for (int i = tid; i < T1 * MP / 16; i += kThreads)
    reinterpret_cast<int4*>(t1)[i] = make_int4(0, 0, 0, 0);
  int total = 0;
#pragma unroll
  for (int st = 0; st < 3; ++st) {
    const Step f = make_step(st, P1, P, C, M);
    total += f.mpass * f.npass * f.taps * f.kpt;
  }

  // ---- the loader: one ring stage, kStages - 1 ahead of the arithmetic.
  // Thread tid fills chunk tid % 4 of B rows tid / 4 and tid / 4 + 64 and,
  // in step 1, of A rows tid / 4 and tid / 4 + 64 (after the B rows).
  Cursor lc{0, 0, 0, 0, 0, 0, 0, 0, 0};
  lc.start(0, P1, P, C, M);
  int lslot = 0;
  const int lrow = tid / 4, lchunk = tid % 4;
  int boffs[2], aoffs[2];      // this thread's rows in w and x, or -1
  auto load_stage = [&]() {
    const int bm = 256 >> lc.wsh, bn = 32 << lc.wsh;
    const int N = lc.st == 2 ? C : M, K = lc.st == 0 ? C : M;
    const int8_t* w = lc.st == 0 ? w1 : lc.st == 1 ? w2 : w3;
    if (lc.pass_start()) {
      const int ld = lc.st == 1 ? 9 * M : K;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = lrow + 64 * i, n = lc.np * bn + row;
        boffs[i] = row < bn && n < N ? n * ld : -1;
        const int p = lc.mp * bm + row;
        aoffs[i] = -1;
        if (lc.st == 0 && row < bm && p < P1)
          aoffs[i] = ((img * H + lo + p / cols1) * W + cl + p % cols1) * C;
      }
    }
    const int kb = lc.kc * kKS + lchunk * 16;
    const int valid = min(16, K - kb);
    const int koff = lc.tap * M + kb;
    int8_t* sB = ring + lslot * kSlot;
    int8_t* sA = sB + bn * kKS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = slot_at(lrow + 64 * i, lchunk);
      if (lrow + 64 * i < bn)
        load_chunk<VEC16>(sB + at, boffs[i] >= 0 ? w + boffs[i] + koff : w,
                          boffs[i] >= 0 ? valid : 0, w);
      if (lc.st == 0 && lrow + 64 * i < bm)
        load_chunk<VEC16>(sA + at, aoffs[i] >= 0 ? x + aoffs[i] + kb : x,
                          aoffs[i] >= 0 ? valid : 0, x);
    }
    lc.next(P1, P, C, M);
    lslot = lslot + 1 == kStages ? 0 : lslot + 1;
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage();
    cp_async_commit();
  }

  // ---- the arithmetic: warp (wm, wn) of a pass computes 32 pixels x 32
  // channels, 2 x 4 mma tiles, accumulators acc[mt][nt]. What a pass's
  // stages share is set at its first stage: the warp's first pixel m0,
  // its ldmatrix offsets into a ring slot (boff: B by n-tile pair and
  // k-step; aoff: step 1's A by m-tile and k-step) and its A pixels in t1
  // or t2 (apos).
  Cursor cc{0, 0, 0, 0, 0, 0, 0, 0, 0};
  cc.start(0, P1, P, C, M);
  int cslot = 0;
  int acc[2][4][4];
  int m0 = 0, wnn = 0;
  int boff[2][2], aoff[2][2], apos[2];
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, ahalf = lane >> 4;
  const int mi = lane >> 3;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < total) load_stage();
    cp_async_commit();

    const int Ps = cc.st == 0 ? P1 : P;      // the step's pixels
    const int bn = 32 << cc.wsh;
    if (cc.pass_start()) {
      const int wm = warp >> cc.wsh;
      wnn = warp & ((1 << cc.wsh) - 1);
      m0 = cc.mp * (256 >> cc.wsh) + wm * 32;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
        const int p = min(m0 + mt * 16 + arow, Ps - 1);
        // step 2: t1's pixel of tap 0; step 3: t2's pixel; step 1: unused
        apos[mt] = cc.st == 1 ? p / cols * W2 + p % cols : p;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // n-tiles 2 jj and 2 jj + 1 (jj = mt here), and m-tile mt.
          boff[mt][kk] = slot_at(wnn * 32 + (2 * mt + (mi >> 1)) * 8 +
                                     (lane & 7),
                                 2 * kk + (mi & 1));
          aoff[mt][kk] = bn * kKS +
                         slot_at(wm * 32 + mt * 16 + arow, 2 * kk + ahalf);
        }
      }
    }
    const int8_t* slot = ring + cslot * kSlot;
    const int tapoff = (cc.tap / 3) * W2 + cc.tap % 3;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t b[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t v[4];
        ldmatrix_x4(v, slot + boff[jj][kk]);
        b[2 * jj][0] = v[0];
        b[2 * jj][1] = v[1];
        b[2 * jj + 1][0] = v[2];
        b[2 * jj + 1][1] = v[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (m0 + mt * 16 >= Ps) continue;
        const int chunk = cc.kc * 4 + 2 * kk + ahalf;
        const int8_t* pa;
        if (cc.st == 0)
          pa = slot + aoff[mt][kk];
        else if (cc.st == 1)
          pa = t1 + chunk_at(apos[mt] + tapoff, chunk, MP, sh, mk);
        else
          pa = t2 + chunk_at(apos[mt], chunk, MP, sh, mk);
        uint32_t a[4];
        ldmatrix_x4(a, pa);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }

    if (cc.pass_end()) {
      // The pass's epilogue, element (pixel p, channels n, n + 1). Its
      // loads (the channels' A and B; a pixel's residual x) go out
      // together before their use, so their latency is paid once.
      const float* ea = cc.st == 0 ? a1 : cc.st == 1 ? a2 : a3;
      const float* eb = cc.st == 0 ? b1 : cc.st == 1 ? b2 : b3;
      const float q = cc.st == 0 ? q1 : cc.st == 1 ? q2 : q3;
      const int N = cc.st == 2 ? C : M;
      const int n0 = cc.np * bn + wnn * 32 + 2 * t;
      float2 av[4], bv[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = min(n0 + nt * 8, N - 2);
        av[nt] = make_float2(__ldg(ea + n), __ldg(ea + n + 1));
        bv[nt] = make_float2(__ldg(eb + n), __ldg(eb + n + 1));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int p = m0 + mt * 16 + g + 8 * hr;
          if (p >= Ps) continue;
          int pos;                // t1 / t2 pixel, or x's pixel (step 3)
          char2 xv[4];
          if (cc.st == 0) {
            pos = (lo + p / cols1 - r0 + 1) * W2 + cl + p % cols1 - c0 + 1;
          } else if (cc.st == 1) {
            pos = p;
          } else {
            pos = (img * H + r0 + p / cols) * W + c0 + p % cols;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              xv[nt] = *reinterpret_cast<const char2*>(
                  x + static_cast<size_t>(pos) * C +
                  min(n0 + nt * 8, N - 2));
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int n = n0 + nt * 8;
            if (n >= N) continue;
            const int v0 = acc[mt][nt][2 * hr], v1 = acc[mt][nt][2 * hr + 1];
            if (cc.st < 2) {
              const char2 o = make_char2(requant(v0, av[nt].x, bv[nt].x, q),
                                         requant(v1, av[nt].y, bv[nt].y, q));
              *reinterpret_cast<char2*>(
                  (cc.st == 0 ? t1 : t2) +
                  chunk_at(pos, n >> 4, MP, sh, mk) + (n & 15)) = o;
            } else {
              // The unit tail (resnet_int8.py:339-365), to the output.
              const float av2[2] = {av[nt].x, av[nt].y};
              const float bv2[2] = {bv[nt].x, bv[nt].y};
              const int vv[2] = {v0, v1};
              const int8_t xe[2] = {xv[nt].x, xv[nt].y};
              int8_t o[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float tt = pcv::round_bf16(__fadd_rn(
                    __fmul_rn(__int2float_rn(vv[e]), av2[e]), bv2[e]));
                const float id =
                    pcv::round_bf16(__fmul_rn(__int2float_rn(xe[e]), r));
                o[e] = pcv::quant_i8(fmaxf(__fadd_rn(tt, id), 0.f), q);
              }
              *reinterpret_cast<char2*>(
                  out + static_cast<size_t>(pos) * C + n) =
                  make_char2(o[0], o[1]);
            }
          }
        }
    }
    cc.next(P1, P, C, M);
    cslot = cslot + 1 == kStages ? 0 : cslot + 1;
  }
  cp_async_wait<0>();
}

}  // namespace

// One unit over x (B, H, W, C) -> out in blocks of TH x TW output pixels of
// one image; smem_bytes: the plan's t1, t2 and ring, ((TH + 2)(TW + 2) +
// TH TW) MP + 3 x 12,288, MP = M rounded up to 64.
extern "C" int pcv_fused_bottleneck(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* a1, const void* b1, const void* a2, const void* b2,
    const void* a3, const void* b3, float q1, float q2, float q3, float r,
    void* out, int B, int H, int W, int C, int M, int TH, int TW,
    int smem_bytes, void* stream) {
  const bool vec16 = C % 16 == 0 && M % 16 == 0;
  const auto kernel = vec16 ? bottleneck_unit_kernel<true>
                            : bottleneck_unit_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((H + TH - 1) / TH * ((W + TW - 1) / TW), B);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
      static_cast<const int8_t*>(w2), static_cast<const int8_t*>(w3),
      static_cast<const float*>(a1), static_cast<const float*>(b1),
      static_cast<const float*>(a2), static_cast<const float*>(b2),
      static_cast<const float*>(a3), static_cast<const float*>(b3), q1, q2, q3,
      r, static_cast<int8_t*>(out), H, W, C, M, TH, TW);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes and static shared bytes of
// the instance (16-byte or 4-byte weight loads) that (C, M) launches.
extern "C" int pcv_fused_bottleneck_info(int C, int M, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, C % 16 == 0 && M % 16 == 0 ? bottleneck_unit_kernel<true>
                                        : bottleneck_unit_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
