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
// Bound on the H100: bytes. The starts fall on few distinct windows: sy
//   takes H - 9 values and the aligned, clamped sx ceil((W - 24) / 8) + 1
//   (714 windows at H 60, W 128, against n 6480 starts), so the function
//   needs 240 f32 adds per distinct window and channel (22 M at C 128,
//   0.65 us at the 33.5 T adds/s of the CUDA cores) against the map read
//   once (2 MB) and the f32 sums written once (3.3 MB): 1.6 us.
// Design: where n >= the number of distinct windows, two launches: a table
//   pass sums each distinct window once, a thread 8 channels (16-byte
//   loads, a row's 24 issued while the previous row is added, 8
//   independent chains in the fixed order), into a scratch table
//   (windows x C f32); a gather pass copies each start's row of the table
//   to its output in 16-byte vectors. Where n is smaller, one launch sums
//   each start's window directly with the same loads and order. Every sum
//   is the same sequence of f32 adds either way, so the output is bit-equal
//   to the fixed-order sum. C % 8 != 0 or an unaligned map falls back to a
//   thread a channel (and the gather to 4-byte copies).
#include "common.cuh"

namespace {

constexpr int kRows = 10;
constexpr int kCols = 24;
constexpr int kThreads = 128;

__device__ __forceinline__ int clamp_sy(int sy, int H) {
  return min(max(sy, 0), H - kRows);
}

__device__ __forceinline__ int clamp_sx(int sx_raw, int W) {
  const int al = (sx_raw >= 0 ? sx_raw / 8 : -((-sx_raw + 7) / 8)) * 8;
  return min(max(al, 0), W - kCols);
}

// Sums of item k's window, VEC channels a thread: item k is distinct window
// k (row k / nx, column slot k % nx) when starts is null, else start k.
template <int VEC>
__global__ void __launch_bounds__(kThreads) window_sum_kernel(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ starts,
    float* __restrict__ dst, int count, int H, int W, int C, int nx) {
  const int slots = C / VEC;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= count * slots) return;
  const int k = idx / slots, c = idx % slots * VEC;
  int sy, sx;
  if (starts == nullptr) {
    sy = k / nx;
    sx = min(k % nx * 8, W - kCols);
  } else {
    sy = clamp_sy(starts[2 * k], H);
    sx = clamp_sx(starts[2 * k + 1], W);
  }
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const __nv_bfloat16* base = x + (static_cast<size_t>(sy) * W + sx) * C + c;
  if constexpr (VEC == 8) {
    // A row's 24 vectors are loaded a row ahead of their adds, so 24-48
    // loads are in flight under the adds' dependent chains.
    uint4 cur[kCols], nxt[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      cur[q] = __ldg(reinterpret_cast<const uint4*>(
          base + static_cast<size_t>(q) * C));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r + 1 < kRows) {
        const __nv_bfloat16* row = base + static_cast<size_t>(r + 1) * W * C;
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          nxt[q] = __ldg(reinterpret_cast<const uint4*>(
              row + static_cast<size_t>(q) * C));
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const uint32_t wd[4] = {cur[q].x, cur[q].y, cur[q].z, cur[q].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[2 * i] = __fadd_rn(acc[2 * i], __uint_as_float(wd[i] << 16));
          acc[2 * i + 1] =
              __fadd_rn(acc[2 * i + 1], __uint_as_float(wd[i] & 0xffff0000u));
        }
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) cur[q] = nxt[q];
    }
  } else {
    for (int r = 0; r < kRows; ++r) {
      const __nv_bfloat16* row = base + static_cast<size_t>(r) * W * C;
#pragma unroll 8
      for (int q = 0; q < kCols; ++q)
        acc[0] = __fadd_rn(acc[0],
                           __bfloat162float(row[static_cast<size_t>(q) * C]));
    }
  }
  float* o = dst + static_cast<size_t>(k) * C + c;
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(o)[0] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    reinterpret_cast<float4*>(o)[1] =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
    o[0] = acc[0];
  }
}

// out[i] = table[window of start i], VEC floats a thread.
template <int VEC>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ table, const int* __restrict__ starts,
    float* __restrict__ out, int n, int H, int W, int C, int nx) {
  const int slots = C / VEC;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n * slots) return;
  const int i = idx / slots, c = idx % slots * VEC;
  const int sy = clamp_sy(starts[2 * i], H);
  const int sx = clamp_sx(starts[2 * i + 1], W);
  const int win = sy * nx + (sx + 7) / 8;     // the clamped W - 24 is last
  const float* src = table + static_cast<size_t>(win) * C + c;
  float* o = out + static_cast<size_t>(i) * C + c;
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(o) = __ldg(reinterpret_cast<const float4*>(src));
  else
    *o = src[0];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned grid(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// n starts into out (n, C) f32; table: scratch of (H - 9) x (ceil((W - 24)
// / 8) + 1) rows (the distinct windows) of C f32, used only where n is at
// least that count. launches: the kernels started.
extern "C" int pcv_patch_window_sum(const void* x, const void* starts,
                                    void* out, void* table, int n, int H,
                                    int W, int C, int* launches,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nx = (W - kCols + 7) / 8 + 1;
  const int windows = (H - kRows + 1) * nx;
  const bool vec8 = C % 8 == 0 && aligned16(x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int* st = static_cast<const int*>(starts);
  if (n < windows) {
    float* o = static_cast<float*>(out);
    const int vec_out = vec8 && aligned16(out);
    if (vec_out)
      window_sum_kernel<8><<<grid(1LL * n * C / 8), kThreads, 0, s>>>(
          xb, st, o, n, H, W, C, nx);
    else
      window_sum_kernel<1><<<grid(1LL * n * C), kThreads, 0, s>>>(
          xb, st, o, n, H, W, C, nx);
    *launches = 1;
    return static_cast<int>(cudaGetLastError());
  }
  float* tb = static_cast<float*>(table);
  if (vec8 && aligned16(table))
    window_sum_kernel<8><<<grid(1LL * windows * C / 8), kThreads, 0, s>>>(
        xb, nullptr, tb, windows, H, W, C, nx);
  else
    window_sum_kernel<1><<<grid(1LL * windows * C), kThreads, 0, s>>>(
        xb, nullptr, tb, windows, H, W, C, nx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C % 4 == 0 && aligned16(table) && aligned16(out))
    gather_kernel<4><<<grid(1LL * n * C / 4), kThreads, 0, s>>>(
        tb, st, static_cast<float*>(out), n, H, W, C, nx);
  else
    gather_kernel<1><<<grid(1LL * n * C), kThreads, 0, s>>>(
        tb, st, static_cast<float*>(out), n, H, W, C, nx);
  *launches = 2;
  return static_cast<int>(cudaGetLastError());
}
