// K7: windowed multi-head attention, out = softmax(q k^T * scale + mask) v,
// one independent problem per (batch x window x head).
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/attention.py
//   (fused_window_attention, pallas_call at :91 in _pallas; bodies
//   _attn_kernel and _attn_mask_kernel at :29-51), the attention of
//   ProPainter's SparseWindowAttention (pytorchcv_tpu/models/propainter.py,
//   the full path at :424-426 and the window-local path at :430-432).
//
// Bound on the H100: operations on the full path, bytes on the local one.
//   ProPainter's full path at t = 18 frames (n = 64 problems, Lq = 810,
//   Lk = 2142, D = 128) needs 4 n Lq Lk D = 56.9 GFLOP against ~193 MB,
//   far above the card's ridge; the local path (n = 1152, Lq = Lk = 45)
//   1.2 GFLOP against ~106 MB. The products run in f32 on the CUDA cores
//   (67 TFLOP/s peak), as the TPU kernel's math is f32 throughout.
// Design: the TPU kernel holds a problem's whole (Lq, Lk) score tile in
//   VMEM; at the full path's shape that is 6.9 MB, so here the scores
//   never leave the block. One 256-thread block per (problem, 64-query
//   tile) keeps its query tile in shared memory (transposed), streams
//   64-key tiles of k and v through shared memory, and keeps the running
//   max and sum of each row in f32 (initial max -1e30) with a 64x128 f32
//   accumulator in registers (4 rows x 8 columns a thread). Per key tile:
//   scores as a 4x4 register tile a thread, times the scale, plus the
//   additive mask (f32, (n, Lq, Lk)) where one is given; then one warp per
//   8 rows for the max, expf and sum; then acc = acc * alpha + p v. Keys
//   and queries past Lk and Lq are masked, so any Lq and Lk work; D <= 128.
//   The problem index is the grid's x dimension (up to 2^31 - 1): the
//   local path at batch > 1 passes 65,535 problems. bf16 and f32 inputs
//   share the kernel (a template); the output is q's type, rounded to
//   nearest. Tensor cores (a 3xTF32 or bf16x3 split to keep f32 accuracy)
//   and TMA are the next step for speed.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kMaxD = 128;         // head width the accumulator holds
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
  return sizeof(float) * (2 * static_cast<size_t>(d) * kPadQK +
                          kBK * kMaxD + kBQ * kPadS + 3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) window_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, T* __restrict__ out, int Lq, int Lk,
    int d, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                   // [d][kPadQK]: q tile, transposed
  float* sKt = sQt + d * kPadQK;       // [d][kPadQK]: k tile, transposed
  float* sV = sKt + d * kPadQK;        // [kBK][kMaxD]: v tile, zero past d
  float* sS = sV + kBK * kMaxD;        // [kBQ][kPadS]: scores, then p
  float* sM = sS + kBQ * kPadS;        // [kBQ] running max
  float* sL = sM + kBQ;                // [kBQ] running sum
  float* sA = sL + kBQ;                // [kBQ] this tile's rescale

  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const T* qn = q + n * Lq * d;
  const T* kn = k + n * Lk * d;
  const T* vn = v + n * Lk * d;
  const float* mn = mask == nullptr ? nullptr : mask + n * Lq * Lk;

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
  // tx*4+j and 64+tx*4+j.
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
    for (int i = tid; i < kBK * kMaxD; i += kThreads) {
      const int r = i / kMaxD, c = i - r * kMaxD;
      sV[i] = (k0 + r < Lk && c < d)
                  ? to_f32(vn[static_cast<size_t>(k0 + r) * d + c])
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
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        float sc = __fmul_rn(s[i][j], scale);
        if (mn != nullptr && r < Lq && key < Lk)
          sc = __fadd_rn(sc, mn[static_cast<size_t>(r) * Lk + key]);
        sS[(ty * 4 + i) * kPadS + tx * 4 + j] = sc;
      }
    }
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
    const int kend = min(kBK, Lk - k0);
    for (int kk = 0; kk < kend; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty * 4 + i) * kPadS + kk];
      const float4 v0 =
          *reinterpret_cast<const float4*>(&sV[kk * kMaxD + tx * 4]);
      const float4 v1 =
          *reinterpret_cast<const float4*>(&sV[kk * kMaxD + 64 + tx * 4]);
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
    T* dst = out + (n * Lq + r) * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
      if (col < d) store(dst + col, acc[i][j] / l);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int N, int Lq, int Lk, int d,
                   float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(N, (Lq + kBQ - 1) / kBQ);
  window_attention_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), Lq, Lk, d, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pcv_window_attention(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int N, int Lq, int Lk, int d,
                                    float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, mask, out, N, Lq, Lk, d,
                                      scale, st)
              : launch<float>(q, k, v, mask, out, N, Lq, Lk, d, scale, st);
  return static_cast<int>(err);
}
