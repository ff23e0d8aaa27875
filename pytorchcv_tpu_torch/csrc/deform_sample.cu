// K5: bounded-offset modulated deformable sampling, the taps of a 3x3
// stride-1 pad-1 deformable conv (DCNv2) before its (9*C, O) product.
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/deform_patch.py
//   (deform_sample_patch :102, pallas_call in _sample at :81, body _kernel
//   at :44-69), which ProPainter's SecondOrderDeformableAlignment reaches
//   through nn/deform.py:deform_conv2d's bounded-offset branch (:73-97).
//
// Computes, for every pixel n = (y, x), tap k = (ky, kx) and channel c of
//   group g = c / (C / G):
//     py = (y - 1 + ky) + off_y,  px = (x - 1 + kx) + off_x   (f32 always)
//     out[n, k, c] = lerp_x(lerp_y(four corners of x at floor(py, px)))
//                    * mask[n, g, k]
//   with a corner outside the image read as zero, the lerp along y first,
//   then along x (the TPU kernel's row-then-column order, :56-66), each
//   multiply and add rounded on its own (the plain version's order, no FMA
//   contraction). x is (C, H, W) or channels-last (H, W, C), f32 or bf16;
//   offset (f32) and mask (x's type) are NCHW as the offset conv writes
//   them: channel (g*9 + k)*2 + {0: y, 1: x} and g*9 + k. Output (H*W, 9, C)
//   in x's type.
//
// Bound on the H100: bytes. At ProPainter RFC's shape (H 30, W 54, C 256,
//   G 16) one call reads 1.66 MB of x, 1.87 MB of offsets and 0.93 MB of
//   mask and writes 14.93 MB, ~0.006 ms at 3.35 TB/s; the arithmetic is
//   10 f32 operations an output element, far below the bytes.
// Design: the TPU kernel staged a (P, P) window of the map per pixel in
//   VMEM because its gathers paid per index. With |residual| <= the
//   caller's bound, every sample of a pixel lies in that window, so reading
//   the four corners directly computes the same function; the centers are
//   per pixel and unbounded, so no tile of pixels has a window to stage.
//   - One launch a call. A channels-last x is read as it lies. An NCHW x is
//     first transposed by the same launch, in 32 x 32 tiles through shared
//     memory, into a scratch (H*W, C) map, and a grid-wide barrier
//     (cooperative launch: every block resident) separates that from the
//     sampling.
//   - A block takes a tile of npix pixels (the host's plan: 4, the fastest
//     at RFC's and the generator's shapes; a cooperative launch takes more
//     where the tiles outnumber its resident blocks) and all nine taps. It first stages each (pixel, tap, group)'s sample position and
//     mask in shared memory, computed once from loads that run along the
//     pixels (NCHW: pixel-contiguous, so they coalesce). Where 9 G samples
//     of one pixel do not fit (G > 227), each thread computes its own.
//   - Then each thread takes vectors of VEC channels of one group (16 bytes:
//     4 f32 or 8 bf16, narrower where C/G is not a multiple: VEC is the
//     widest that divides C/G, down to one element), neighbouring threads
//     on neighbouring vectors of one (pixel, tap): every corner read and
//     the output store are VEC-wide accesses of contiguous channels, and a
//     warp's corner reads of one group are whole sectors. The index walk
//     steps by additions (no division in the loop but by the constant 9
//     and C/G).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace coop = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxSamples = 2048;  // staged samples a tile (24 KB)
constexpr int kTT = 32;            // transpose tile side

// VEC elements of T as one load or store of raw bits.
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<2> { using type = unsigned short; };

template <bool NC, typename R>
__device__ __forceinline__ R ld_raw(const R* p) {
  if constexpr (NC) return __ldg(p);
  else return *p;
}

__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned bf_pair(float lo, float hi) {
  return bf_bits(lo) | (bf_bits(hi) << 16);
}

// f[0 .. VEC) = the VEC elements at p; NC: through the read-only path.
template <typename T, int VEC, bool NC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  const R r = ld_raw<NC>(reinterpret_cast<const R*>(p));
  if constexpr (sizeof(T) == 4) {
    if constexpr (VEC == 4) {
      f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
      f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
    } else if constexpr (VEC == 2) {
      f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    } else {
      f[0] = __uint_as_float(r);
    }
  } else {
    if constexpr (VEC == 8) {
      f[0] = bf_lo(r.x); f[1] = bf_hi(r.x); f[2] = bf_lo(r.y);
      f[3] = bf_hi(r.y); f[4] = bf_lo(r.z); f[5] = bf_hi(r.z);
      f[6] = bf_lo(r.w); f[7] = bf_hi(r.w);
    } else if constexpr (VEC == 4) {
      f[0] = bf_lo(r.x); f[1] = bf_hi(r.x); f[2] = bf_lo(r.y);
      f[3] = bf_hi(r.y);
    } else if constexpr (VEC == 2) {
      f[0] = bf_lo(r); f[1] = bf_hi(r);
    } else {
      f[0] = bf_lo(r);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  R r;
  if constexpr (sizeof(T) == 4) {
    if constexpr (VEC == 4)
      r = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                     __float_as_uint(f[2]), __float_as_uint(f[3]));
    else if constexpr (VEC == 2)
      r = make_uint2(__float_as_uint(f[0]), __float_as_uint(f[1]));
    else
      r = __float_as_uint(f[0]);
  } else {
    if constexpr (VEC == 8)
      r = make_uint4(bf_pair(f[0], f[1]), bf_pair(f[2], f[3]),
                     bf_pair(f[4], f[5]), bf_pair(f[6], f[7]));
    else if constexpr (VEC == 4)
      r = make_uint2(bf_pair(f[0], f[1]), bf_pair(f[2], f[3]));
    else if constexpr (VEC == 2)
      r = bf_pair(f[0], f[1]);
    else
      r = static_cast<unsigned short>(bf_bits(f[0]));
  }
  *reinterpret_cast<R*>(p) = r;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);   // exact: v came from a bf16
}

// x (C, HW) -> xs (HW, C), the block's share of the 32 x 32 tiles through
// `tile` (kTT x (kTT + 1) floats of shared memory): reads run along the
// pixels, writes along the channels.
template <typename T>
__device__ __forceinline__ void transpose_tiles(const T* x, T* xs, int C,
                                                int HW, float* tile) {
  const int tid = threadIdx.x;
  const int tp = (HW + kTT - 1) / kTT;
  const int tiles = (C + kTT - 1) / kTT * tp;
  for (int tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    const int c0 = tt / tp * kTT, p0 = tt % tp * kTT;
    for (int i = tid; i < kTT * kTT; i += kThreads) {
      const int r = i / kTT, l = i % kTT;
      if (c0 + r < C && p0 + l < HW)
        tile[r * (kTT + 1) + l] =
            to_f32(x[static_cast<size_t>(c0 + r) * HW + p0 + l]);
    }
    __syncthreads();
    for (int i = tid; i < kTT * kTT; i += kThreads) {
      const int r = i / kTT, l = i % kTT;
      if (c0 + l < C && p0 + r < HW)
        xs[static_cast<size_t>(p0 + r) * C + c0 + l] =
            from_f32<T>(tile[l * (kTT + 1) + r]);
    }
    __syncthreads();
  }
}

// TRANSPOSE: x is (C, H*W); the launch is cooperative and writes xs (H*W, C)
// before it samples from it. Else x is (H*W, C) and xs is unused.
template <typename T, int VEC, bool TRANSPOSE>
__global__ void __launch_bounds__(kThreads) deform_sample_kernel(
    const void* __restrict__ xv, void* xsv, const float* __restrict__ offset,
    const void* __restrict__ maskv, void* __restrict__ outv, int H, int W,
    int C, int G, int npix) {
  __shared__ float s_par[3][kMaxSamples];   // py, px, m of a tile's samples
  const T* x = static_cast<const T*>(xv);
  T* xs = static_cast<T*>(xsv);
  const T* mask = static_cast<const T*>(maskv);
  T* out = static_cast<T*>(outv);
  const int tid = threadIdx.x;
  const int HW = H * W;

  if constexpr (TRANSPOSE) {
    transpose_tiles(x, xs, C, HW, &s_par[0][0]);
    coop::this_grid().sync();
  }
  // The scratch map is written by this launch: read it through the
  // coherent path, x (read-only here) through the read-only one.
  const T* src = TRANSPOSE ? xs : x;

  const int cpg = C / G;
  const int nvg = cpg / VEC;                  // vectors a group
  const int NV = C / VEC;                     // vectors a (pixel, tap)
  const int dv = kThreads % NV, dpk = kThreads / NV;
  const bool staged = 9 * G * npix <= kMaxSamples;
  const int ntiles = (HW + npix - 1) / npix;
  const float fH = static_cast<float>(H), fW = static_cast<float>(W);

  // Sample (pixel n, tap k, group g): position and mask, as the plain
  // version computes them.
  auto sample = [&](int n, int k, int g, float& py, float& px, float& m) {
    const int y = n / W, xq = n - y * W;
    const int gk = g * 9 + k;
    py = __fadd_rn(static_cast<float>(y - 1 + k / 3),
                   offset[static_cast<size_t>(2 * gk) * HW + n]);
    px = __fadd_rn(static_cast<float>(xq - 1 + k % 3),
                   offset[static_cast<size_t>(2 * gk + 1) * HW + n]);
    m = to_f32(mask[static_cast<size_t>(gk) * HW + n]);
  };

  for (int tt = blockIdx.x; tt < ntiles; tt += gridDim.x) {
    const int n0 = tt * npix;
    const int np = min(npix, HW - n0);
    if (staged) {
      __syncthreads();   // the previous tile's readers are done
      // i = (g * 9 + k) * np + p: lanes along the pixels
      for (int i = tid; i < 9 * G * np; i += kThreads) {
        const int gk = i / np, p = i - gk * np;
        const int g = gk / 9, k = gk - g * 9;
        const int s = (p * 9 + k) * G + g;     // [p][k][g]
        sample(n0 + p, k, g, s_par[0][s], s_par[1][s], s_par[2][s]);
      }
      __syncthreads();
    }
    // Item (p, k, v), v fastest: thread tid starts at item tid and steps by
    // kThreads items, (dpk, dv) in (pixel-tap, vector).
    int pk = tid / NV, v = tid - (tid / NV) * NV;
    for (; pk < np * 9; pk += dpk) {
      const int p = pk / 9, k = pk - p * 9;
      const int g = v / nvg;
      float py, px, m;
      if (staged) {
        const int s = pk * G + g;
        py = s_par[0][s];
        px = s_par[1][s];
        m = s_par[2][s];
      } else {
        sample(n0 + p, k, g, py, px, m);
      }
      const float y0 = floorf(py), x0 = floorf(px);
      const float y1 = y0 + 1.f, x1 = x0 + 1.f;
      const float fy = __fsub_rn(py, y0), fx = __fsub_rn(px, x0);
      const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
      // Validity is decided on the float corners, so no out-of-range float
      // is converted to int.
      const bool vy0 = y0 >= 0.f && y0 < fH, vy1 = y1 >= 0.f && y1 < fH;
      const bool vx0 = x0 >= 0.f && x0 < fW, vx1 = x1 >= 0.f && x1 < fW;
      const int iy0 = vy0 ? static_cast<int>(y0) : 0;
      const int iy1 = vy1 ? static_cast<int>(y1) : 0;
      const int ix0 = vx0 ? static_cast<int>(x0) : 0;
      const int ix1 = vx1 ? static_cast<int>(x1) : 0;
      const T* base = src + v * VEC;
      float c00[VEC], c10[VEC], c01[VEC], c11[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) c00[e] = c10[e] = c01[e] = c11[e] = 0.f;
      if (vy0 && vx0)
        load_vec<T, VEC, !TRANSPOSE>(base + (iy0 * W + ix0) * C, c00);
      if (vy1 && vx0)
        load_vec<T, VEC, !TRANSPOSE>(base + (iy1 * W + ix0) * C, c10);
      if (vy0 && vx1)
        load_vec<T, VEC, !TRANSPOSE>(base + (iy0 * W + ix1) * C, c01);
      if (vy1 && vx1)
        load_vec<T, VEC, !TRANSPOSE>(base + (iy1 * W + ix1) * C, c11);
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float r0 =
            __fadd_rn(__fmul_rn(gy, c00[e]), __fmul_rn(fy, c10[e]));
        const float r1 =
            __fadd_rn(__fmul_rn(gy, c01[e]), __fmul_rn(fy, c11[e]));
        o[e] = __fmul_rn(__fadd_rn(__fmul_rn(gx, r0), __fmul_rn(fx, r1)), m);
      }
      store_vec<T, VEC>(out + ((n0 + p) * 9 + k) * C + v * VEC, o);
      v += dv;
      if (v >= NV) {
        v -= NV;
        ++pk;
      }
    }
  }
}

template <typename T, int VEC>
auto pick(bool transpose) {
  return transpose ? deform_sample_kernel<T, VEC, true>
                   : deform_sample_kernel<T, VEC, false>;
}

using SampleKernel = decltype(pick<float, 1>(false));

// The instance for x's type, VEC and layout; false if VEC is not one.
bool instance(bool bf16, int vec, bool transpose, SampleKernel* k) {
  if (!bf16 && vec == 4) *k = pick<float, 4>(transpose);
  else if (!bf16 && vec == 2) *k = pick<float, 2>(transpose);
  else if (!bf16 && vec == 1) *k = pick<float, 1>(transpose);
  else if (bf16 && vec == 8) *k = pick<__nv_bfloat16, 8>(transpose);
  else if (bf16 && vec == 4) *k = pick<__nv_bfloat16, 4>(transpose);
  else if (bf16 && vec == 2) *k = pick<__nv_bfloat16, 2>(transpose);
  else if (bf16 && vec == 1) *k = pick<__nv_bfloat16, 1>(transpose);
  else return false;
  return true;
}

}  // namespace

// x: channels-last (H*W, C) when nhwc, else NCHW (C, H*W), transposed into
// `scratch` (H*W, C) by the same (cooperative) launch. npix pixels a tile
// (the host's plan; a cooperative launch doubles it while the tiles
// outnumber the blocks resident at once and the samples fit), vec channels
// a vector (it divides C / G; x, scratch and out aligned to it).
extern "C" int pcv_deform_sample(const void* x, void* scratch,
                                 const void* offset, const void* mask,
                                 void* out, int H, int W, int C, int groups,
                                 int bf16, int npix, int vec, int nhwc,
                                 void* stream) {
  SampleKernel kernel;
  if (npix < 1 || groups < 1 || C % groups || (C / groups) % vec ||
      !instance(bf16 != 0, vec, nhwc == 0, &kernel))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  if (nhwc) {
    kernel<<<(HW + npix - 1) / npix, kThreads, 0, st>>>(
        x, nullptr, static_cast<const float*>(offset), mask, out, H, W, C,
        groups, npix);
    return static_cast<int>(cudaGetLastError());
  }
  // Cooperative: the grid may not exceed the blocks resident at once.
  cudaError_t err;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  static int resident_of[64][8] = {};  // per device and instance, asked once
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const int id = (bf16 ? 4 : 0) + (vec == 8 ? 3 : vec == 4 ? 2 : vec == 2);
  int& resident = resident_of[dev][id];
  if (resident == 0) {
    int sms, per_sm;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, 0)) != cudaSuccess)
      return static_cast<int>(err);
    resident = sms * per_sm;
  }
  while ((HW + npix - 1) / npix > resident &&
         9 * groups * 2 * npix <= kMaxSamples)
    npix *= 2;
  const int tiles = (HW + npix - 1) / npix;
  const int ttiles = (C + kTT - 1) / kTT * ((HW + kTT - 1) / kTT);
  int grid = tiles > ttiles ? tiles : ttiles;
  grid = grid < resident ? grid : resident;
  void* args[] = {const_cast<void**>(&x), &scratch,
                  const_cast<void**>(&offset), const_cast<void**>(&mask),
                  &out, &H, &W, &C, &groups, &npix};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), grid, kThreads, args, 0, st));
}

// out: registers a thread, local (spill) bytes, static and dynamic shared
// bytes of the instance for x's type, vec and layout.
extern "C" int pcv_deform_sample_info(int bf16, int vec, int nhwc, int* out) {
  SampleKernel kernel;
  if (!instance(bf16 != 0, vec, nhwc == 0, &kernel))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = 0;
  return 0;
}
