// K4: flash (online-softmax) attention, out = softmax(q k^T * scale) v.
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/flash_attention.py
//   (flash_attention, pallas_call at :110; body _kernel at :31-62), which
//   DANet's position attention calls at L = H*W = 3600 (480x480 input).
//
// Bound on the H100: operations. At DANet's shapes (L = 3600, d = 64,
//   dv = 512) one image needs 2*L*L*(d + dv) = 14.9 GFLOP against 8.3 MB of
//   q, k, v and out, far above the card's ridge. The products run here in
//   f32 on the CUDA cores (67 TFLOP/s peak, not the tensor cores): p.v is
//   f32 in the TPU kernel too (:54-56), and rounding p to bf16 for a tensor
//   core would compute another function.
// Design: one 256-thread block per (image, 64-query tile, 128-column chunk
//   of dv). The block keeps its query tile in shared memory, streams
//   64-key tiles of k and of its v chunk through shared memory, and keeps
//   the running max and sum of each row in f32 (initial max -1e30, as the
//   TPU kernel) and a 64x128 f32 accumulator in registers (4 rows x 8
//   columns a thread). Per key tile: scores as a 4x4 register tile a
//   thread (exact bf16 products, f32 sums), then one warp per 8 rows for
//   the max, expf and sum, then acc = acc * alpha + p v. Splitting dv into
//   chunks recomputes q k^T once per chunk (d / 128 = 50 % more work at
//   d = 64) so that the accumulator fits. Keys and queries past L are
//   masked, so any L works. bf16 and f32 inputs share the kernel (a
//   template); the output is q's type, rounded to nearest. Tensor cores
//   (mma/wgmma for q k^T, a bf16x3 split for p v) and TMA are the next
//   step for speed.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kDVC = 128;          // output columns per block (a dv chunk)
constexpr int kThreads = 256;
constexpr int kPadQK = kBQ + 4;    // row stride of the transposed q, k tiles
constexpr int kPadS = kBK + 1;     // row stride of the score tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(d) * kPadQK + kBK * kDVC + kBQ * kPadS +
          3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Lq, int Lk, int d, int dv, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                   // [d][kPadQK]: q tile, transposed
  float* sKt = sQt + d * kPadQK;       // [d][kPadQK]: k tile, transposed
  float* sV = sKt + d * kPadQK;        // [kBK][kDVC]: v tile, this chunk
  float* sS = sV + kBK * kDVC;         // [kBQ][kPadS]: scores, then p
  float* sM = sS + kBQ * kPadS;        // [kBQ] running max
  float* sL = sM + kBQ;                // [kBQ] running sum
  float* sA = sL + kBQ;                // [kBQ] this tile's rescale

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int c0 = blockIdx.y * kDVC;
  const size_t n = blockIdx.z;
  const T* qn = q + n * Lq * d;
  const T* kn = k + n * Lk * d;
  const T* vn = v + n * Lk * dv;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    sQt[c * kPadQK + r] =
        q0 + r < Lq ? to_f32(qn[static_cast<size_t>(q0 + r) * d + c]) : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kNeg;
    sL[tid] = 0.f;
  }

  // Scores: rows ty*4+i, keys tx*4+j. Output: rows ty*4+i, columns
  // tx*4+j and 64+tx*4+j of the chunk.
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      sKt[c * kPadQK + r] =
          k0 + r < Lk ? to_f32(kn[static_cast<size_t>(k0 + r) * d + c]) : 0.f;
    }
    for (int i = tid; i < kBK * kDVC; i += kThreads) {
      const int r = i / kDVC, c = i - r * kDVC;
      sV[i] = (k0 + r < Lk && c0 + c < dv)
                  ? to_f32(vn[static_cast<size_t>(k0 + r) * dv + c0 + c])
                  : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float4 qa =
          *reinterpret_cast<const float4*>(&sQt[c * kPadQK + ty * 4]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&sKt[c * kPadQK + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sS[(ty * 4 + i) * kPadS + tx * 4 + j] = __fmul_rn(s[i][j], scale);
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w+7, a lane keys lane and
    // lane+32. Keys past Lk take no part.
    const bool ok0 = k0 + lane < Lk, ok1 = k0 + lane + 32 < Lk;
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      float* row = sS + r * kPadS;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float mx =
          warp_max(fmaxf(ok0 ? s0 : -INFINITY, ok1 ? s1 : -INFINITY));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sM[r] = m_new;
        sL[r] = __fadd_rn(__fmul_rn(sL[r], alpha), sum);
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= a;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty * 4 + i) * kPadS + kk];
      const float4 v0 =
          *reinterpret_cast<const float4*>(&sV[kk * kDVC + tx * 4]);
      const float4 v1 =
          *reinterpret_cast<const float4*>(&sV[kk * kDVC + 64 + tx * 4]);
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float l = sL[ty * 4 + i];
    T* dst = out + (n * Lq + r) * dv;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < dv) store(dst + col, acc[i][j] / l);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int N, int Lq, int Lk, int d, int dv, float scale,
                   cudaStream_t st) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBQ - 1) / kBQ, (dv + kDVC - 1) / kDVC, N);
  flash_attention_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk, d, dv, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pcv_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int N, int Lq,
                                   int Lk, int d, int dv, float scale,
                                   int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, N, Lq, Lk, d, dv, scale, st)
              : launch<float>(q, k, v, out, N, Lq, Lk, d, dv, scale, st);
  return static_cast<int>(err);
}
