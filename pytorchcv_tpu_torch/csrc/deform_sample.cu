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
//   contraction). x is channels-last (H, W, C) f32 or bf16; offset (f32) and
//   mask (x's type) are NCHW as the offset conv writes them: channel
//   (g*9 + k)*2 + {0: y, 1: x} and g*9 + k. Output (H*W, 9, C) in x's type.
//
// Bound on the H100: bytes. At ProPainter RFC's shape (H 30, W 54, C 256,
//   G 16) one call reads 1.66 MB of x, 1.87 MB of offsets and 0.93 MB of
//   mask and writes 14.93 MB, ~0.006 ms at 3.35 TB/s; the arithmetic is
//   10 f32 operations an output element, far below the bytes.
// Design: the TPU kernel staged a (P, P) window of the map per pixel in
//   VMEM because its gathers paid per index. With |residual| <= the
//   caller's bound, every sample of a pixel lies in that window, so reading
//   the four corners directly computes the same function. One block row
//   per (pixel, tap), one thread per channel: the stores are coalesced, a
//   warp's corner reads are runs of C/G contiguous channels, and the
//   offsets and mask of one (pixel, tap, group) are one broadcast load.
//   The index arithmetic divides 32-bit values only, by constants or by
//   per-block values (64-bit division is a long software sequence).
//   Staging a tile's shared window in shared memory and fusing the
//   (9*C, O) product on tensor cores are the next steps for speed.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // channels per block

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Grid: x = pixel * 9 + tap, y = chunk of kThreads channels.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    deform_sample_kernel(const T* __restrict__ x,
                         const float* __restrict__ offset,
                         const T* __restrict__ mask, T* __restrict__ out,
                         int H, int W, int C, int cg) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;
  const int nk = blockIdx.x;
  const int n = nk / 9, k = nk - n * 9;
  const int y = n / W, xq = n - y * W;
  const size_t hw = static_cast<size_t>(H) * W;
  const size_t tap = static_cast<size_t>(c / cg) * 9 + k;
  const float oy = offset[2 * tap * hw + n];
  const float ox = offset[(2 * tap + 1) * hw + n];
  const float m = load(mask + tap * hw + n);
  const float py = __fadd_rn(static_cast<float>(y - 1 + k / 3), oy);
  const float px = __fadd_rn(static_cast<float>(xq - 1 + k % 3), ox);
  const float y0 = floorf(py), x0 = floorf(px);
  const float fy = __fsub_rn(py, y0), fx = __fsub_rn(px, x0);
  // Validity is decided on the float corners, so no out-of-range float is
  // converted to int.
  auto at = [&](float yy, float xx) -> float {
    if (!(yy >= 0.f && yy < H && xx >= 0.f && xx < W)) return 0.f;
    const size_t i = static_cast<size_t>(yy) * W + static_cast<size_t>(xx);
    return load(x + i * C + c);
  };
  const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
  const float r0 = __fadd_rn(__fmul_rn(gy, at(y0, x0)),
                             __fmul_rn(fy, at(y0 + 1.f, x0)));
  const float r1 = __fadd_rn(__fmul_rn(gy, at(y0, x0 + 1.f)),
                             __fmul_rn(fy, at(y0 + 1.f, x0 + 1.f)));
  const float s = __fadd_rn(__fmul_rn(gx, r0), __fmul_rn(fx, r1));
  store(out + static_cast<size_t>(nk) * C + c, __fmul_rn(s, m));
}

}  // namespace

extern "C" int pcv_deform_sample(const void* x, const void* offset,
                                 const void* mask, void* out, int H, int W,
                                 int C, int groups, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H * W * 9, (C + kThreads - 1) / kThreads);
  const int cg = C / groups;
  const float* off = static_cast<const float*>(offset);
  if (bf16)
    deform_sample_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), off,
        static_cast<const __nv_bfloat16*>(mask),
        static_cast<__nv_bfloat16*>(out), H, W, C, cg);
  else
    deform_sample_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), off, static_cast<const float*>(mask),
        static_cast<float*>(out), H, W, C, cg);
  return static_cast<int>(cudaGetLastError());
}
