// K1: fused eval preprocessing, uint8 NHWC frames -> normalized planes.
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/preprocess.py:
//   _preprocess_kernel (driven by _preprocess_pallas / preprocess_batch).
//   Per (image, channel): Y = R @ X @ Ct, then Y * a[c] + b[c], where R and
//   Ct fold the PIL-bilinear resize and the centre crop.
// Bound on the H100: the two products are ~2*224*256*(256+224) FLOP per
//   plane (~165 MFLOP per 256x256 image), done in f32 on CUDA cores; the
//   bytes are small (uint8 in, bf16 out, an f32 intermediate).
// Design: two launches of one tiled product. rows_kernel computes
//   T = R @ X for every plane, reading the interleaved uint8 frame with
//   channel stride C (no transpose pass), into an f32 scratch buffer: one
//   224x256 f32 plane is 229 KB, more than the 227 KB of shared memory a
//   block may hold, so T goes through device memory (L2 for small batches).
//   cols_kernel computes Y = T @ Ct, applies the per-channel affine and
//   writes bf16 or f32, planar or NHWC. Each block computes a 64x64 output
//   tile; each thread a 4x4 register tile, so a shared-memory load feeds
//   four FMAs.
#include "common.cuh"

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kK = 16;        // reduction step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) {
  return static_cast<float>(v);
}

// acc += A[m0:m0+64, :] @ B[:, n0:n0+64] for one plane, with
// A(m, k) = a[m * K + k] (f32, row-major) and B(k, n) = b[(k * N + n) * ldn]
// (elements n of a row ldn apart). Rows and columns past M / N read zero.
template <typename TB>
__device__ __forceinline__ void tile_product(const float* __restrict__ a,
                                             const TB* __restrict__ b, int M,
                                             int N, int K, int ldn, int m0,
                                             int n0, float (&acc)[4][4]) {
  // +4 pads rows so the transposing stores below spread over banks.
  __shared__ __align__(16) float s_a[kK][kTile + 4];
  __shared__ __align__(16) float s_b[kK][kTile];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < K; k0 += kK) {
    for (int i = tid; i < kK * kTile; i += kThreads) {
      // A: consecutive threads walk k (contiguous in memory).
      const int am = i / kK, ak = i % kK;
      const int gm = m0 + am, gk = k0 + ak;
      s_a[ak][am] = (gm < M && gk < K) ? a[static_cast<size_t>(gm) * K + gk]
                                       : 0.f;
      // B: consecutive threads walk n.
      const int bk = i / kTile, bn = i % kTile;
      const int gk2 = k0 + bk, gn = n0 + bn;
      s_b[bk][bn] =
          (gk2 < K && gn < N)
              ? to_f32(b[(static_cast<size_t>(gk2) * N + gn) * ldn])
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&s_a[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&s_b[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// T[p, o, w] = sum_h R[o, h] * X[b, h, w, c], p = b * C + c.
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const uint8_t* __restrict__ x, const float* __restrict__ r,
                float* __restrict__ t, int C, int H, int W, int OH) {
  const int p = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const uint8_t* plane =
      x + static_cast<size_t>(p / C) * H * W * C + p % C;
  float acc[4][4] = {};
  tile_product(r, plane, OH, W, H, C, m0, n0, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* tp = t + static_cast<size_t>(p) * OH * W;
  for (int i = 0; i < 4; ++i) {
    const int o = m0 + ty * 4 + i;
    for (int j = 0; j < 4; ++j) {
      const int w = n0 + tx * 4 + j;
      if (o < OH && w < W) tp[static_cast<size_t>(o) * W + w] = acc[i][j];
    }
  }
}

// Y[b, c, o, q] = (sum_w T[p, o, w] * Ct[w, q]) * a[c] + bb[c].
__global__ void __launch_bounds__(kThreads)
    cols_kernel(const float* __restrict__ t, const float* __restrict__ ct,
                const float* __restrict__ a, const float* __restrict__ bb,
                void* __restrict__ out, int C, int OH, int W, int OW,
                int planar, int out_bf16) {
  const int p = blockIdx.z;
  const int b = p / C, c = p % C;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  tile_product(t + static_cast<size_t>(p) * OH * W, ct, OH, OW, W, 1, m0, n0,
               acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float ac = a[c], bc = bb[c];
  for (int i = 0; i < 4; ++i) {
    const int o = m0 + ty * 4 + i;
    for (int j = 0; j < 4; ++j) {
      const int q = n0 + tx * 4 + j;
      if (o >= OH || q >= OW) continue;
      const float y = __fadd_rn(__fmul_rn(acc[i][j], ac), bc);
      const size_t idx =
          planar ? ((static_cast<size_t>(b) * C + c) * OH + o) * OW + q
                 : ((static_cast<size_t>(b) * OH + o) * OW + q) * C + c;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(out)[idx] = y;
    }
  }
}

}  // namespace

extern "C" int pcv_preprocess(const void* x, const void* r, const void* ct,
                              const void* a, const void* b, void* t_scratch,
                              void* out, int B, int C, int H, int W, int OH,
                              int OW, int planar, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 g1((W + kTile - 1) / kTile, (OH + kTile - 1) / kTile, B * C);
  rows_kernel<<<g1, kThreads, 0, st>>>(static_cast<const uint8_t*>(x),
                                       static_cast<const float*>(r),
                                       static_cast<float*>(t_scratch), C, H,
                                       W, OH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2((OW + kTile - 1) / kTile, (OH + kTile - 1) / kTile, B * C);
  cols_kernel<<<g2, kThreads, 0, st>>>(
      static_cast<const float*>(t_scratch), static_cast<const float*>(ct),
      static_cast<const float*>(a), static_cast<const float*>(b), out, C, OH,
      W, OW, planar, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
