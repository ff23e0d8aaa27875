// K4: flash (online-softmax) attention, out = softmax(q k^T * scale) v.
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/flash_attention.py
//   (flash_attention, pallas_call at :110; body _kernel at :31-62), which
//   DANet's position attention calls at L = H*W = 3600 (480x480 input).
//
// Bound on the H100: operations. At DANet's shapes (L = 3600, d = 64,
//   dv = 512) one image needs 2*L*L*(d + dv) = 14.9 GFLOP against 8.3 MB of
//   q, k, v and out, far above the card's ridge.
// Two instances, chosen by dtype (both hand kernels; nothing switches on
//   failure):
// - bf16 (DANet's serving path): tensor cores, FlashAttention-2 style. A
//   block of 4 warps owns 64 query rows (16 a warp) and a 128-column chunk
//   of dv; 64-key tiles of k and of v's chunk are double-buffered in
//   shared memory by cp.async (rows padded by 16 bytes, so ldmatrix reads
//   them without bank conflicts). S = q k^T runs on mma.sync m16n8k16
//   bf16 -> f32: bf16 products are exact in f32, so S is the reference's
//   up to summation order. The running max (initial -1e30, as the TPU
//   kernel) and sum stay in registers, reduced over the quad of lanes
//   that shares a row; the softmax runs in base 2 (the scores times
//   scale * log2(e), exp2f: within 2^-21 of expf's p). p is f32; it stays
//   in registers and becomes the A fragments of p v split as p = hi + lo,
//   two bf16 terms (|p - hi - lo| <= 2^-17 p), each one mma against v's
//   bf16 fragments, which are exact: p v keeps the f32 function within
//   the kernel gates.
//   A 16 x 512 f32 accumulator would be 256 registers a thread, so dv goes
//   in chunks of 128 (64 registers), recomputing S once a chunk (d / 128
//   = 50 % more S work at d = 64, 12.5 % of the block's mma count).
// - f32 (calibration's attention, the f32 reference forward): CUDA cores.
//   One 256-thread block per (image, 64-query tile, 128-column chunk of
//   dv); k and v tiles through shared memory, scores as a 4x4 register
//   tile a thread, one warp per 8 rows for the softmax, acc = acc * alpha
//   + p v in registers.
// Keys and queries past L are masked, so any L works; d <= 128 (the bf16
// instance pads d to 32, 64 or 128 with zeros). The output is q's type,
// rounded to nearest.
#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;

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

// ------------------------------------------------------------ bf16, mma

constexpr int kTcRows = 64;    // query rows a block, 16 a warp
constexpr int kTcKeys = 64;    // keys a tile
constexpr int kTcCols = 128;   // output columns a block (a dv chunk)
constexpr int kTcThreads = 128;
constexpr int kTcVP = kTcCols + 8;   // row pitch of the v tiles (bf16)

template <int D>
struct TcLayout {
  static constexpr int kQP = D + 8;  // row pitch of the q and k tiles
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) *
      (static_cast<size_t>(kTcRows) * kQP + 2 * kTcKeys * kQP +
       2 * kTcKeys * kTcVP);
};

using pcv::cp_async16;
using pcv::cp_async_commit;
using pcv::cp_async_wait;
using pcv::ldmatrix_x4;
using pcv::smem_addr;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate. Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p0, p1 (f32) -> hi, lo bf16 pairs with p = hi + lo to 2^-17.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - __low2float(h),
                                    p1 - __high2float(h)));
}

// A 64-row tile of a row-major (rows, ld) bf16 matrix, columns col0 ..
// col0 + COLS - 1, into shared memory (pitch elements a row). Rows past
// `rows` and columns past `cols` (both counted from the tile's origin)
// read as zeros. vec: 16-byte cp.async (cols and ld multiples of 8, the
// base 16-byte aligned); otherwise element by element.
template <int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int pitch,
                                          const __nv_bfloat16* src, int ld,
                                          int row0, int rows, int col0,
                                          int cols, bool vec) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < kTcKeys * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    __nv_bfloat16* d = dst + r * pitch + c;
    const __nv_bfloat16* s =
        src + static_cast<size_t>(row0 + r) * ld + col0 + c;
    if (vec) {
      const bool ok = r < rows && c < cols;
      cp_async16(d, ok ? s : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (r < rows && c + e < cols) ? s[e] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int Lq, int Lk, int d, int dv, float scale, int vec) {
  constexpr int kQP = TcLayout<D>::kQP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTcRows * kQP;   // [2][kTcKeys][kQP]
  __nv_bfloat16* sV = sK + 2 * kTcKeys * kQP;  // [2][kTcKeys][kTcVP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTcRows, c0 = blockIdx.y * kTcCols;
  const size_t n = blockIdx.z;
  const __nv_bfloat16* qn = q + n * Lq * d;
  const __nv_bfloat16* kn = k + n * Lk * d;
  const __nv_bfloat16* vn = v + n * Lk * dv;
  const int ncols = min(kTcCols, dv - c0);
  const int ntiles = (Lk + kTcKeys - 1) / kTcKeys;
  const float scale_log2 = scale * 1.4426950408889634f;

  load_tile<D>(sQ, kQP, qn, d, q0, Lq - q0, 0, d, vec);
  load_tile<D>(sK, kQP, kn, d, 0, Lk, 0, d, vec);
  load_tile<kTcCols>(sV, kTcVP, vn, dv, 0, Lk, c0, ncols, vec);
  cp_async_commit();

  uint32_t qa[D / 16][4];
  float o[kTcCols / 8][4];
#pragma unroll
  for (int j = 0; j < kTcCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // Rows g and g + 8 of the warp's 16: running max, this lane's share of
  // the running sum (the quad's four shares add up at the end).
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      const int r0 = (j + 1) * kTcKeys;
      load_tile<D>(sK + (buf ^ 1) * kTcKeys * kQP, kQP, kn, d, r0, Lk - r0,
                   0, d, vec);
      load_tile<kTcCols>(sV + (buf ^ 1) * kTcKeys * kTcVP, kTcVP, vn, dv, r0,
                         Lk - r0, c0, ncols, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        ldmatrix_x4(qa[ks], sQ + (warp * 16 + (lane % 8) +
                                  ((lane / 8) % 2) * 8) * kQP +
                                ks * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* tK = sK + buf * kTcKeys * kQP;
    const __nv_bfloat16* tV = sV + buf * kTcKeys * kTcVP;

    // S = q k^T: 8 tiles of 8 keys, C fragments (rows g, g + 8; keys
    // 2t, 2t + 1 of the tile).
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, tK + (np * 16 + (lane / 16) * 8 + lane % 8) * kQP +
                           ks * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qa[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[ks], b[2], b[3]);
      }
    }

    // Online softmax over this tile, in base 2: sl = s * scale * log2(e),
    // p = 2^(sl - m). Keys past Lk (the last tile only) take no part.
    if ((j + 1) * kTcKeys > Lk) {
#pragma unroll
      for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * kTcKeys + i * 8 + 2 * t + (e & 1) >= Lk) s[i][e] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sv = s[i][2 * r + e];
          sv = __fmul_rn(sv, scale_log2);
          mx = fmaxf(mx, sv);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sv = s[i][2 * r + e];
          sv = exp2f(sv - m_new);
          sum += sv;
        }
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), sum);
#pragma unroll
      for (int c = 0; c < kTcCols / 8; ++c) {
        o[c][2 * r] *= alpha;
        o[c][2 * r + 1] *= alpha;
      }
    }

    // o += p v, p = hi + lo: the C fragments of keys 16kk .. 16kk + 15
    // are the A fragment of that k-step.
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      // 32 columns at a time: the hi products of four accumulators, then
      // the lo ones, so no product waits on the one just before it.
#pragma unroll
      for (int cq = 0; cq < kTcCols / 32; ++cq) {
        uint32_t b[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ldmatrix_x4_trans(
              b[h], tV + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * kTcVP +
                        cq * 32 + h * 16 + (lane / 16) * 8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_bf16(o[4 * cq + 2 * h], hi, b[h][0], b[h][1]);
          mma_bf16(o[4 * cq + 2 * h + 1], hi, b[h][2], b[h][3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_bf16(o[4 * cq + 2 * h], lo, b[h][0], b[h][1]);
          mma_bf16(o[4 * cq + 2 * h + 1], lo, b[h][2], b[h][3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* dst = out + (n * Lq + row) * dv;
#pragma unroll
    for (int c = 0; c < kTcCols / 8; ++c) {
      const int col = c0 + c * 8 + 2 * t;
      const float y0 = o[c][2 * r] / sum, y1 = o[c][2 * r + 1] / sum;
      if (col + 1 < dv && dv % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < dv) dst[col] = __float2bfloat16_rn(y0);
        if (col + 1 < dv) dst[col + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int N, int Lq, int Lk, int d, int dv, float scale,
                      cudaStream_t st) {
  const size_t smem = TcLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec = d % 8 == 0 && dv % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  dim3 grid((Lq + kTcRows - 1) / kTcRows, (dv + kTcCols - 1) / kTcCols, N);
  flash_attention_tc_kernel<D><<<grid, kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Lq, Lk, d, dv, scale, int(vec));
  return cudaGetLastError();
}

// ------------------------------------------------------------- f32, SIMT

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kDVC = 128;          // output columns per block (a dv chunk)
constexpr int kThreads = 256;
constexpr int kPadQK = kBQ + 4;    // row stride of the transposed q, k tiles
constexpr int kPadS = kBK + 1;     // row stride of the score tile

size_t smem_bytes(int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(d) * kPadQK + kBK * kDVC + kBQ * kPadS +
          3 * kBQ);
}

__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Lq, int Lk,
    int d, int dv, float scale) {
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
  const float* qn = q + n * Lq * d;
  const float* kn = k + n * Lk * d;
  const float* vn = v + n * Lk * dv;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    sQt[c * kPadQK + r] =
        q0 + r < Lq ? qn[static_cast<size_t>(q0 + r) * d + c] : 0.f;
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
          k0 + r < Lk ? kn[static_cast<size_t>(k0 + r) * d + c] : 0.f;
    }
    for (int i = tid; i < kBK * kDVC; i += kThreads) {
      const int r = i / kDVC, c = i - r * kDVC;
      sV[i] = (k0 + r < Lk && c0 + c < dv)
                  ? vn[static_cast<size_t>(k0 + r) * dv + c0 + c]
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
    float* dst = out + (n * Lq + r) * dv;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < dv) dst[col] = acc[i][j] / l;
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int N, int Lq, int Lk, int d, int dv,
                       float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBQ - 1) / kBQ, (dv + kDVC - 1) / kDVC, N);
  flash_attention_f32_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Lq, Lk, d, dv,
      scale);
  return cudaGetLastError();
}

cudaError_t attributes(int d, int is_bf16, cudaFuncAttributes* attr,
                       size_t* smem) {
  if (!is_bf16) {
    *smem = smem_bytes(d);
    return cudaFuncGetAttributes(attr, flash_attention_f32_kernel);
  }
  if (d <= 32) {
    *smem = TcLayout<32>::kBytes;
    return cudaFuncGetAttributes(attr, flash_attention_tc_kernel<32>);
  }
  if (d <= 64) {
    *smem = TcLayout<64>::kBytes;
    return cudaFuncGetAttributes(attr, flash_attention_tc_kernel<64>);
  }
  *smem = TcLayout<128>::kBytes;
  return cudaFuncGetAttributes(attr, flash_attention_tc_kernel<128>);
}

}  // namespace

extern "C" int pcv_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int N, int Lq,
                                   int Lk, int d, int dv, float scale,
                                   int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16)
    err = launch_f32(q, k, v, out, N, Lq, Lk, d, dv, scale, st);
  else if (d <= 32)
    err = launch_tc<32>(q, k, v, out, N, Lq, Lk, d, dv, scale, st);
  else if (d <= 64)
    err = launch_tc<64>(q, k, v, out, N, Lq, Lk, d, dv, scale, st);
  else
    err = launch_tc<128>(q, k, v, out, N, Lq, Lk, d, dv, scale, st);
  return static_cast<int>(err);
}

// out: registers a thread, local (spill) bytes, static and dynamic shared
// bytes a block of the instance that (d, dtype) launches.
extern "C" int pcv_flash_attention_info(int d, int is_bf16, int* out) {
  cudaFuncAttributes attr;
  size_t smem = 0;
  const cudaError_t err = attributes(d, is_bf16, &attr, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(smem);
  return 0;
}
