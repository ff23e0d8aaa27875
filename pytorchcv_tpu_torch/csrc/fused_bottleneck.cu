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
//   peak) against 2 B H W C bytes of activations (26 MB: 8 us). On CUDA-core
//   __dp4a, as K2, it runs far from that peak.
// Design: a block takes one image and a tile of TH output rows (TH from
//   H, W and M, so that t1 and t2 fit in shared memory: 219 KB a block at
//   most, 105 KB where two blocks fit on an SM, beside 8 KB of GEMM
//   staging). It
//   1. zeroes t1's tile with its 1-row / 1-column halo, (TH+2) x (W+2) x M
//      int8, and computes t1 at the halo positions inside the image only:
//      a halo position outside the image is the 3x3's zero padding and
//      holds 0, not rq(relu(B1)); the two halo rows inside the image are
//      computed again by the neighbouring tiles ((TH+2)/TH of conv1's work);
//   2. computes t2, TH x W x M int8, reading the nine taps of t1 in place;
//   3. computes conv3 and the residual tail straight to the output.
//   Each step is K2's implicit GEMM: 64 pixels x 64 channels a pass, 8 K
//   words (32 int8) a step staged in shared memory (double-buffered, the
//   next step's words prefetched into registers), a 4x4 int32 sub-tile a
//   thread. Weights stream from global memory (they stay in L2); only x
//   is read and out written in device memory. Tensor cores and TMA rings
//   of weight tiles are the next steps for speed.
#include "common.cuh"

namespace {

constexpr int kBM = 64;       // pixels per pass
constexpr int kBN = 64;       // output channels per pass
constexpr int kBKW = 8;       // K words (4 int8 each) per step
constexpr int kThreads = 256;

// One 64 x 64 pass of C[p][n] = sum_k A(p, k) B(n, k) over Kw words:
// ``base(p)`` locates pixel p's row of A (called once per pass), ``load``
// reads word k of it; B is row n of ``w`` (Kw words each). The K steps
// are double-buffered in shared memory, and each thread loads its words
// of step s + 1 into registers before it multiplies step s, so that the
// weights' trip from L2 overlaps the arithmetic: K8 keeps only one or two
// blocks on an SM (its t1 and t2 fill shared memory), too few warps to
// hide that latency by switching.
template <class Base, class Load>
__device__ __forceinline__ void gemm_pass(int (&acc)[4][4], int p0, int n0,
                                          int P, int N, int Kw,
                                          const Base& base, const Load& load,
                                          const int* __restrict__ w,
                                          int (*sA)[kBKW][kBM],
                                          int (*sB)[kBKW][kBN]) {
  const int tid = threadIdx.x;
  const int kk = tid % kBKW;
  const int ty = tid / 16, tx = tid % 16;
  long long a_base[2];
  const int* b_row[2];
  for (int l = 0; l < 2; ++l) {
    const int row = tid / kBKW + l * (kThreads / kBKW);
    a_base[l] = p0 + row < P ? base(p0 + row) : -1;
    b_row[l] = n0 + row < N ? w + static_cast<size_t>(n0 + row) * Kw
                            : nullptr;
  }
  int ra[2], rb[2];
  auto fetch = [&](int k0) {
    const int kword = k0 + kk;
    const bool k_ok = kword < Kw;
    for (int l = 0; l < 2; ++l) {
      ra[l] = (k_ok && a_base[l] >= 0) ? load(a_base[l], kword) : 0;
      rb[l] = (k_ok && b_row[l] != nullptr) ? b_row[l][kword] : 0;
    }
  };
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  fetch(0);
  int buf = 0;
  for (int k0 = 0; k0 < Kw; k0 += kBKW, buf ^= 1) {
    for (int l = 0; l < 2; ++l) {
      const int row = tid / kBKW + l * (kThreads / kBKW);
      sA[buf][kk][row] = ra[l];
      sB[buf][kk][row] = rb[l];
    }
    __syncthreads();
    if (k0 + kBKW < Kw) fetch(k0 + kBKW);
#pragma unroll
    for (int k = 0; k < kBKW; ++k) {
      const int4 a4 = *reinterpret_cast<const int4*>(&sA[buf][k][ty * 4]);
      const int4 b4 = *reinterpret_cast<const int4*>(&sB[buf][k][tx * 4]);
      const int av[4] = {a4.x, a4.y, a4.z, a4.w};
      const int bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
  }
  // The next pass writes buffer 0 again: every thread must be done here.
  __syncthreads();
}

// _cell's int8 path: clip(rint(max(f32(acc) * A + B, 0) * q)).
__device__ __forceinline__ int8_t requant(int acc, float a, float b, float q) {
  const float y =
      fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), a), b), 0.f);
  return pcv::quant_i8(y, q);
}

__device__ __forceinline__ char4 pack(const int8_t (&v)[4]) {
  return make_char4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads) bottleneck_unit_kernel(
    const int8_t* __restrict__ x, const int* __restrict__ w1,
    const int* __restrict__ w2, const int* __restrict__ w3,
    const float* __restrict__ a1, const float* __restrict__ b1,
    const float* __restrict__ a2, const float* __restrict__ b2,
    const float* __restrict__ a3, const float* __restrict__ b3, float q1,
    float q2, float q3, float r, int8_t* __restrict__ out, int H, int W,
    int C, int M, int TH, int t1_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) int sA[2][kBKW][kBM];
  __shared__ __align__(16) int sB[2][kBKW][kBN];
  int* t1w = reinterpret_cast<int*>(smem);
  int* t2w = reinterpret_cast<int*>(smem + t1_bytes);

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int r0 = blockIdx.x * TH;
  const int rows = min(TH, H - r0);
  const int b = blockIdx.y;
  const int W2 = W + 2;
  const int C4 = C >> 2, M4 = M >> 2;
  const long long img = static_cast<long long>(b) * H * W;
  const int* xw = reinterpret_cast<const int*>(x);
  int acc[4][4];

  // 1. t1 over the tile and its halo; positions outside the image stay 0.
  for (int i = tid; i < (rows + 2) * W2 * M4; i += kThreads) t1w[i] = 0;
  __syncthreads();
  const int lo = max(r0 - 1, 0);
  const int hi = min(r0 + rows, H - 1);
  const int P1 = (hi - lo + 1) * W;
  auto x_base = [&](int p) {
    return (img + static_cast<long long>(lo + p / W) * W + p % W) * C4;
  };
  auto x_load = [&](long long base, int k) { return xw[base + k]; };
  for (int p0 = 0; p0 < P1; p0 += kBM)
    for (int n0 = 0; n0 < M; n0 += kBN) {
      gemm_pass(acc, p0, n0, P1, M, C4, x_base, x_load, w1, sA, sB);
      const int n = n0 + tx * 4;
      if (n >= M) continue;
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty * 4 + i;
        if (p >= P1) continue;
        const int hr = lo + p / W - (r0 - 1);
        const int cs = p % W + 1;
        int8_t v[4];
        for (int j = 0; j < 4; ++j)
          v[j] = requant(acc[i][j], a1[n + j], b1[n + j], q1);
        reinterpret_cast<char4*>(t1w)[((hr * W2 + cs) * M + n) >> 2] = pack(v);
      }
    }
  __syncthreads();

  // 2. t2 = the 3x3 over t1, its nine taps read in place.
  const int P = rows * W;
  auto t1_base = [&](int p) {
    return static_cast<long long>((p / W) * W2 + p % W) * M4;
  };
  auto t1_load = [&](long long base, int k) {
    const int tap = k / M4;
    const int rr = tap / 3;
    return t1w[base + (rr * W2 + tap - 3 * rr) * M4 + (k - tap * M4)];
  };
  for (int p0 = 0; p0 < P; p0 += kBM)
    for (int n0 = 0; n0 < M; n0 += kBN) {
      gemm_pass(acc, p0, n0, P, M, 9 * M4, t1_base, t1_load, w2, sA, sB);
      const int n = n0 + tx * 4;
      if (n >= M) continue;
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty * 4 + i;
        if (p >= P) continue;
        int8_t v[4];
        for (int j = 0; j < 4; ++j)
          v[j] = requant(acc[i][j], a2[n + j], b2[n + j], q2);
        reinterpret_cast<char4*>(t2w)[(p * M + n) >> 2] = pack(v);
      }
    }
  __syncthreads();

  // 3. conv3 and the unit tail (resnet_int8.py:339-365), to the output.
  auto t2_base = [&](int p) { return static_cast<long long>(p) * M4; };
  auto t2_load = [&](long long base, int k) { return t2w[base + k]; };
  for (int p0 = 0; p0 < P; p0 += kBM)
    for (int n0 = 0; n0 < C; n0 += kBN) {
      gemm_pass(acc, p0, n0, P, C, M4, t2_base, t2_load, w3, sA, sB);
      const int n = n0 + tx * 4;
      if (n >= C) continue;
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty * 4 + i;
        if (p >= P) continue;
        const long long g =
            (img + static_cast<long long>(r0 + p / W) * W + p % W) * C + n;
        const char4 x4 = *reinterpret_cast<const char4*>(x + g);
        const int8_t xv[4] = {x4.x, x4.y, x4.z, x4.w};
        int8_t v[4];
        for (int j = 0; j < 4; ++j) {
          const float t = pcv::round_bf16(
              __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), a3[n + j]),
                        b3[n + j]));
          const float id = pcv::round_bf16(__fmul_rn(__int2float_rn(xv[j]), r));
          v[j] = pcv::quant_i8(fmaxf(__fadd_rn(t, id), 0.f), q3);
        }
        *reinterpret_cast<char4*>(out + g) = pack(v);
      }
    }
}

}  // namespace

// One unit over x (B, H, W, C) -> out, row tiles of TH; t1_bytes is t1's
// tile, (TH + 2) (W + 2) M rounded up to 16, and t2's follows it.
extern "C" int pcv_fused_bottleneck(
    const void* x, const void* w1, const void* w2, const void* w3,
    const void* a1, const void* b1, const void* a2, const void* b2,
    const void* a3, const void* b3, float q1, float q2, float q3, float r,
    void* out, int B, int H, int W, int C, int M, int TH, int t1_bytes,
    int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_unit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((H + TH - 1) / TH, B);
  bottleneck_unit_kernel<<<grid, kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int*>(w1),
      static_cast<const int*>(w2), static_cast<const int*>(w3),
      static_cast<const float*>(a1), static_cast<const float*>(b1),
      static_cast<const float*>(a2), static_cast<const float*>(b2),
      static_cast<const float*>(a3), static_cast<const float*>(b3), q1, q2, q3,
      r, static_cast<int8_t*>(out), H, W, C, M, TH, t1_bytes);
  return static_cast<int>(cudaGetLastError());
}
