// K10: the window-sum probe: per start (sy, sx), the f32 sum over a
// (10, 24, C) bf16 window of an (H, W, C) map, sx aligned down to 8.
//
// Replaces: the Pallas kernel tools/exp_pallas_patch_probe.py (run_pallas
//   :48, pallas_call at :51, body kernel :37; its oracle :65), the access
//   probe of the deformable-sampling kernel.
//
// Computes, for starts (n, 2) int32 and x (H, W, C) bf16 (H >= 10,
//   W >= 24): sy = clamp(sy, 0, H - 10), sx = clamp(floor(sx / 8) * 8, 0,
//   W - 24) (the oracle's gather in mode "clip"), then out[i, c] = the sum
//   of x[sy + r, sx + q, c] over r < 10, q < 24, each value widened to f32
//   and added in that order: r outer, q inner, one rounding an add.
//
// Bound on the H100: operations. 240 f32 adds an output value (199 M at
//   the tool's n 6480, C 128) against the map read once (2 MB) and the f32
//   sums written once (3.3 MB).
// Design: one block of C threads (one per channel, up to 1024) per start.
//   A warp reads 64 contiguous bytes of a pixel, the block one pixel's
//   256-byte row at C = 128; the windows of neighbouring starts overlap
//   and come from L2. The TPU kernel's 8-aligned VMEM loads were a Mosaic
//   limit; here the alignment is only the function's definition.
#include "common.cuh"

namespace {

constexpr int kRows = 10;
constexpr int kCols = 24;

__global__ void patch_window_sum_kernel(const __nv_bfloat16* __restrict__ x,
                                        const int* __restrict__ starts,
                                        float* __restrict__ out, int H, int W,
                                        int C) {
  const int i = blockIdx.x;
  const int sy = min(max(starts[2 * i], 0), H - kRows);
  const int sx_raw = starts[2 * i + 1];
  const int sx_al = (sx_raw >= 0 ? sx_raw / 8 : -((-sx_raw + 7) / 8)) * 8;
  const int sx = min(max(sx_al, 0), W - kCols);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < kRows; ++r) {
      const __nv_bfloat16* row =
          x + (static_cast<size_t>(sy + r) * W + sx) * C + c;
      for (int q = 0; q < kCols; ++q)
        acc = __fadd_rn(acc, __bfloat162float(row[static_cast<size_t>(q) * C]));
    }
    out[static_cast<size_t>(i) * C + c] = acc;
  }
}

}  // namespace

extern "C" int pcv_patch_window_sum(const void* x, const void* starts,
                                    void* out, int n, int H, int W, int C,
                                    void* stream) {
  patch_window_sum_kernel<<<n, C < 1024 ? C : 1024, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(starts),
      static_cast<float*>(out), H, W, C);
  return static_cast<int>(cudaGetLastError());
}
