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
//   1.2 GFLOP against ~106 MB. The function is f32's, as the TPU kernel's:
//   on the CUDA cores (67 TFLOP/s) the full path needs 0.85 ms; on the
//   tensor cores, three TF32 products a product (below), 0.35 ms.
// Design (FlashAttention-2 on mma.sync, as K4's bf16 instance): a block of
//   4 warps owns 64 query rows, 16 a warp (3 warps and 48 rows where
//   Lq <= 48, the local path's 45), and walks Lk in 32-key tiles of k and
//   v, double-buffered in shared memory by cp.async (f32; 105 KB a block
//   at D = 128, so two blocks share an SM). Both products run on
//   mma.sync m16n8k8 tf32 -> f32 with the 3xTF32 split: x = hi + lo with
//   hi = tf32(x), lo = tf32(x - hi) (cvt.rna), and a b = a_lo b_hi +
//   a_hi b_lo + a_hi b_hi (the a_lo b_lo term and the rounding of lo leave
//   ~2^-21 of |a b|): the f32 function within the 2e-5 gate, where one
//   TF32 product keeps ~3 digits. The tensor cores truncate as they
//   accumulate, so no long sum runs in one accumulator: q k^T's small
//   terms sum apart from its hi x hi ones, and each 32-key tile's p v sums
//   afresh (small terms first) and joins o in f32. S = q k^T stays in
//   registers as the mma C fragments; the online softmax runs on them in
//   base 2 (scores times scale, plus the additive f32 mask (n, Lq, Lk)
//   where one is given, times log2(e); exp2f), with the running max
//   (initial -1e30) and sum per row reduced over the quad of lanes that
//   shares it. p's C fragment (row g, keys 2t and 2t + 1) is not the A
//   layout (row g, columns t and t + 4), but the sum over keys takes any
//   order: A column t is key 2t and column t + 4 key 2t + 1, and v's B
//   fragment reads its rows in the same order, so p never leaves the
//   registers. The head dimension is permuted the same way inside each
//   product, so that every fragment is one 16-byte shared load: q k^T's
//   k-steps 2i and 2i + 1 take columns 16i + 4t .. 16i + 4t + 3, and p v's
//   n-tiles 4c .. 4c + 3 columns 32c + 4g + j, whose outputs land on
//   32c + 8t .. 32c + 8t + 7 of rows g and g + 8. Row pitches D + 16 (q, k)
//   and D + 4 (v) floats keep those loads free of bank conflicts. The
//   16 x D output o stays in registers (64 a thread at D = 128).
//   Keys and queries past Lk and Lq are masked, so any Lq and Lk work;
//   D <= 128 (padded to 32, 64 or 128 with zeros). The problem index is the
//   grid's x dimension (up to 2^31 - 1): the local path at batch > 1 passes
//   65,535 problems. bf16 inputs share the kernel: they are exact in TF32,
//   so q k^T and the v side of p v take one product, and p still splits.
//   The output is q's type, rounded to nearest.
#include <type_traits>

#include "common.cuh"

namespace {

using pcv::cp_async16;
using pcv::cp_async_commit;
using pcv::cp_async_wait;

constexpr int kKeys = 32;          // keys a tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int WARPS>
struct Layout {
  static constexpr int kRows = 16 * WARPS;  // query rows a block
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kQP = D + 16;        // row pitch of q and k (floats)
  static constexpr int kVP = D + 4;         // row pitch of v
  static constexpr size_t kBytes =
      sizeof(float) * (static_cast<size_t>(kRows) * kQP + 2 * kKeys * kQP +
                       2 * kKeys * kVP);
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; with SPLIT false (bf16 inputs, exact in TF32)
// lo is not formed.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  if (SPLIT) lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, small terms first; A_SPLIT / B_SPLIT false: that
// operand is exact in TF32 and has no lo part.
template <bool A_SPLIT, bool B_SPLIT>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bhi0,
                                     uint32_t bhi1, uint32_t blo0,
                                     uint32_t blo1) {
  if (A_SPLIT) mma_tf32(c, alo, bhi0, bhi1);
  if (B_SPLIT) mma_tf32(c, ahi, blo0, blo1);
  mma_tf32(c, ahi, bhi0, bhi1);
}

// ROWS rows of a row-major (., d) matrix from row0 on, into shared memory
// as f32 with `pitch` floats a row and D columns; rows past `rows` and
// columns past d read as zeros. vec (f32, d a multiple of 4, 16-byte
// aligned base): 16-byte cp.async; otherwise element by element.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src,
                                          int d, int row0, int rows,
                                          bool vec) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    float* dp = dst + r * pitch + c;
    const T* sp = src + static_cast<size_t>(row0 + r) * d + c;
    if (std::is_same<T, float>::value && vec) {
      const bool ok = r < rows && c < d;
      cp_async16(dp, ok ? static_cast<const void*>(sp) : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[e] = (r < rows && c + e < d) ? to_f32(sp[e]) : 0.f;
    }
  }
}

template <typename T, int D, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) window_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, T* __restrict__ out, int Lq, int Lk,
    int d, float scale, int vec) {
  using L = Layout<D, WARPS>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kQP = L::kQP, kVP = L::kVP;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // [kRows][kQP]
  float* sK = sQ + L::kRows * kQP;     // [2][kKeys][kQP]
  float* sV = sK + 2 * kKeys * kQP;    // [2][kKeys][kVP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t n = blockIdx.x;
  const int q0 = blockIdx.y * L::kRows;
  const T* qn = q + n * Lq * d;
  const T* kn = k + n * Lk * d;
  const T* vn = v + n * Lk * d;
  const int ntiles = (Lk + kKeys - 1) / kKeys;
  const float scale_log2 = scale * kLog2e;
  // This lane's two rows (g and g + 8 of the warp's 16) and their masks.
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mrow[r] = (mask != nullptr && row[r] < Lq)
                  ? mask + (n * Lq + row[r]) * Lk
                  : nullptr;

  load_tile<T, D, L::kRows, L::kThreads>(sQ, kQP, qn, d, q0, Lq - q0, vec);
  load_tile<T, D, kKeys, L::kThreads>(sK, kQP, kn, d, 0, Lk, vec);
  load_tile<T, D, kKeys, L::kThreads>(sV, kVP, vn, d, 0, Lk, vec);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // Rows g and g + 8: running max, this lane's share of the running sum
  // (the quad's four shares add up at the end).
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const float* qw = sQ + (warp * 16 + g) * kQP + 4 * t;

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      const int r0 = (j + 1) * kKeys;
      load_tile<T, D, kKeys, L::kThreads>(sK + (buf ^ 1) * kKeys * kQP, kQP,
                                          kn, d, r0, Lk - r0, vec);
      load_tile<T, D, kKeys, L::kThreads>(sV + (buf ^ 1) * kKeys * kVP, kVP,
                                          vn, d, r0, Lk - r0, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tK = sK + buf * kKeys * kQP + g * kQP + 4 * t;
    const float* tV = sV + buf * kKeys * kVP + 2 * t * kVP + 4 * g;

    // S = q k^T: 4 tiles of 8 keys, C fragments (rows g, g + 8; keys
    // 2t, 2t + 1 of the tile). k-steps 2i, 2i + 1 take head columns
    // 16i + 4t + {0, 1} and {2, 3} as their columns t, t + 4.
    // The hi x hi products and the two small ones sum apart: the tensor
    // cores truncate as they accumulate, each step's error a fraction of
    // the running sum, so the small terms' errors stay at their scale.
    float s[kKeys / 8][4], sl[kKeys / 8][4];
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = sl[i][e] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const float4 qa = *reinterpret_cast<const float4*>(qw + 16 * i);
      const float4 qb = *reinterpret_cast<const float4*>(qw + 8 * kQP +
                                                         16 * i);
      uint32_t ah[2][4], al[2][4];
      split<kSplit>(qa.x, ah[0][0], al[0][0]);
      split<kSplit>(qb.x, ah[0][1], al[0][1]);
      split<kSplit>(qa.y, ah[0][2], al[0][2]);
      split<kSplit>(qb.y, ah[0][3], al[0][3]);
      split<kSplit>(qa.z, ah[1][0], al[1][0]);
      split<kSplit>(qb.z, ah[1][1], al[1][1]);
      split<kSplit>(qa.w, ah[1][2], al[1][2]);
      split<kSplit>(qb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        const float4 kb =
            *reinterpret_cast<const float4*>(tK + 8 * nt * kQP + 16 * i);
        uint32_t bh[4], bl[4];
        split<kSplit>(kb.x, bh[0], bl[0]);
        split<kSplit>(kb.y, bh[1], bl[1]);
        split<kSplit>(kb.z, bh[2], bl[2]);
        split<kSplit>(kb.w, bh[3], bl[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (kSplit) {
            mma_tf32(sl[nt], al[h], bh[2 * h], bh[2 * h + 1]);
            mma_tf32(sl[nt], ah[h], bl[2 * h], bl[2 * h + 1]);
          }
          mma_tf32(s[nt], ah[h], bh[2 * h], bh[2 * h + 1]);
        }
      }
    }

    // Online softmax over this tile, in base 2. Keys past Lk (the last
    // tile only) take no part.
    const int k0 = j * kKeys;
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + i * 8 + 2 * t + e;
          float& sv = s[i][2 * r + e];
          if (kSplit) sv = __fadd_rn(sv, sl[i][2 * r + e]);
          if (key >= Lk)
            sv = -INFINITY;
          else if (mrow[r] != nullptr)
            sv = __fmul_rn(__fadd_rn(__fmul_rn(sv, scale), mrow[r][key]),
                           kLog2e);
          else
            sv = __fmul_rn(sv, scale_log2);
          mx = fmaxf(mx, sv);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sv = s[i][2 * r + e];
          sv = exp2f(sv - m_new);
          sum += sv;
        }
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), sum);
    }

    // o = o alpha + p v. The C fragment of keys 8i .. 8i + 7 is the A
    // fragment of k-step i with column t = key 2t, column t + 4 = key
    // 2t + 1; v's B fragment reads rows 8i + 2t and 8i + 2t + 1 to match.
    // This tile's p v sums in fresh accumulators, kCW columns at a time
    // (its truncation stays at the tile's scale), then joins o in f32.
    uint32_t ph[kKeys / 8][4], pl[kKeys / 8][4];
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) {
      split<true>(s[i][0], ph[i][0], pl[i][0]);
      split<true>(s[i][2], ph[i][1], pl[i][1]);
      split<true>(s[i][1], ph[i][2], pl[i][2]);
      split<true>(s[i][3], ph[i][3], pl[i][3]);
    }
    constexpr int kCW = D < 64 ? D : 64;
#pragma unroll
    for (int h = 0; h < D / kCW; ++h) {
      float acc[kCW / 8][4];
#pragma unroll
      for (int c = 0; c < kCW / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
        const float* vr = tV + 8 * i * kVP + h * kCW;
#pragma unroll
        for (int c = 0; c < kCW / 32; ++c) {
          const float4 v0 = *reinterpret_cast<const float4*>(vr + 32 * c);
          const float4 v1 =
              *reinterpret_cast<const float4*>(vr + kVP + 32 * c);
          const float b0[4] = {v0.x, v0.y, v0.z, v0.w};
          const float b1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bh0, bl0, bh1, bl1;
            split<kSplit>(b0[jj], bh0, bl0);
            split<kSplit>(b1[jj], bh1, bl1);
            mma3<true, kSplit>(acc[4 * c + jj], ph[i], pl[i], bh0, bh1, bl0,
                               bl1);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCW / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& y = o[h * (kCW / 8) + c][e];
          y = fmaf(y, alpha[e / 2], acc[c][e]);
        }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  // Rows g and g + 8: columns 32c + 8t .. 32c + 8t + 7 are o[4c + jj][e]
  // at 32c + 8t + jj (e = 0 / 2) and 32c + 8t + 4 + jj (e = 1 / 3).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (row[r] >= Lq) continue;
    T* dst = out + (n * Lq + row[r]) * d;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      float y[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        y[jj] = o[4 * c + jj][2 * r] / sum;
        y[4 + jj] = o[4 * c + jj][2 * r + 1] / sum;
      }
      const int col = 32 * c + 8 * t;
      if (std::is_same<T, float>::value && vec && col + 8 <= d) {
        float4* dp = reinterpret_cast<float4*>(dst + col);
        dp[0] = make_float4(y[0], y[1], y[2], y[3]);
        dp[1] = make_float4(y[4], y[5], y[6], y[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < d) store(dst + col + e, y[e]);
      }
    }
  }
}

// The instances: dtype, head width padded to 32, 64 or 128, 3 or 4 warps.
template <typename T, int D, int WARPS>
struct Tag {};

template <typename T, int D, int WARPS>
cudaError_t launch(Tag<T, D, WARPS>, const void* q, const void* k,
                   const void* v, const void* mask, void* out, int N, int Lq,
                   int Lk, int d, float scale, cudaStream_t st) {
  using L = Layout<D, WARPS>;
  const auto kernel = window_attention_kernel<T, D, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return err;
  const bool vec = std::is_same<T, float>::value && d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  dim3 grid(N, (Lq + L::kRows - 1) / L::kRows);
  kernel<<<grid, L::kThreads, L::kBytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), Lq, Lk, d, scale, int(vec));
  return cudaGetLastError();
}

template <typename T, int D, int WARPS>
cudaError_t attributes(Tag<T, D, WARPS>, cudaFuncAttributes* attr,
                       size_t* smem) {
  *smem = Layout<D, WARPS>::kBytes;
  return cudaFuncGetAttributes(attr, window_attention_kernel<T, D, WARPS>);
}

// fn(Tag<...>{}) for the instance a call of (dtype, d, Lq) launches.
template <int WARPS, typename F>
cudaError_t by_width(int is_bf16, int d, F&& fn) {
  if (is_bf16) {
    if (d <= 32) return fn(Tag<__nv_bfloat16, 32, WARPS>{});
    if (d <= 64) return fn(Tag<__nv_bfloat16, 64, WARPS>{});
    return fn(Tag<__nv_bfloat16, 128, WARPS>{});
  }
  if (d <= 32) return fn(Tag<float, 32, WARPS>{});
  if (d <= 64) return fn(Tag<float, 64, WARPS>{});
  return fn(Tag<float, 128, WARPS>{});
}

template <typename F>
cudaError_t dispatch(int is_bf16, int d, int Lq, F&& fn) {
  return Lq <= 48 ? by_width<3>(is_bf16, d, fn) : by_width<4>(is_bf16, d, fn);
}

}  // namespace

extern "C" int pcv_window_attention(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int N, int Lq, int Lk, int d,
                                    float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(is_bf16, d, Lq, [&](auto tag) {
    return launch(tag, q, k, v, mask, out, N, Lq, Lk, d, scale, st);
  }));
}

// out: registers a thread, local (spill) bytes, static and dynamic shared
// bytes a block of the instance that (d, dtype, Lq) launches.
extern "C" int pcv_window_attention_info(int d, int is_bf16, int Lq,
                                         int* out) {
  cudaFuncAttributes attr;
  size_t smem = 0;
  const cudaError_t err = dispatch(is_bf16, d, Lq, [&](auto tag) {
    return attributes(tag, &attr, &smem);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(smem);
  return 0;
}
