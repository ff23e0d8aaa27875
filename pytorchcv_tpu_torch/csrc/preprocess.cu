// K1: fused eval preprocessing, uint8 NHWC frames -> normalized planes.
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/preprocess.py:
//   _preprocess_kernel (driven by _preprocess_pallas / preprocess_batch).
//   Per (image, channel): Y = (R @ X) @ Ct, then Y * a[c] + b[c], where R
//   and Ct fold the PIL-bilinear resize and the centre crop.
// Bound on the H100: bytes. R and Ct are banded: a PIL-bilinear row has
//   about 2 * scale + 1 non-zero taps (about 5 in R and 9 in Ct for
//   1024x2048 -> 480x480, one at 256 -> 256 with a 224 crop), so the
//   products need a few multiply-adds an output while the uint8 frame is
//   read once and the output written once.
// Design: one launch. The host reduces R and Ct to band tables once
//   (kernels/preprocess.py:resize_bands): per output row o of R its first
//   tap lo_r(o), its tap count n_r(o) and the taps themselves, packed;
//   the same per output column of Ct. A block owns kTO output rows x kTP
//   output columns of one image, all channels. It takes the union of its
//   rows' and columns' bands, copies the uint8 input rows and columns of
//   that window into shared memory with 16-byte cp.async loads over the
//   interleaved NHWC frame, runs the row pass T = R X into an f32 tile in
//   shared memory, then the column pass from that tile into the output
//   tile, then the affine step and coalesced stores. Nothing but the
//   output reaches device memory. A window wider than the shared memory
//   budget (a dense matrix) is walked in chunks: the column chunks in the
//   outer loop, the row chunks inside, so T = R X is complete for a chunk
//   of columns before the column pass reads it, and the association of
//   the two products is the reference's. Rows and columns without taps
//   give 0 before the affine step.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTO = 8;          // output rows a block (kernels/preprocess.py)
constexpr int kTP = 64;         // output columns a block (the same)
constexpr int kThreads = 256;
// Blocks an SM the registers must allow (at most 51 a thread): the 1-tap
// crop tiles are short and latency-bound, so more of them in flight help.
constexpr int kMinBlocks = 5;
constexpr int kTBudget = 32 * 1024;   // bytes of the f32 T chunk
constexpr int kXBudget = 32 * 1024;   // bytes of the uint8 input chunk
constexpr int kMaxC = 32;             // channels (kernels/preprocess.py)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static_assert(kTO * kTP == 2 * kThreads, "the column pass takes 2 rows");

// One tap of a row of R in a staged chunk: the staged input row's byte
// offset and the weight.
struct __align__(8) Tap {
  int off;
  float w;
};

// Chunk sizes: wc input columns, hc input rows, xp the byte pitch of a
// staged input row (16-byte loads from the aligned-down start).
struct Plan {
  int wc, hc, xp;
  size_t smem;
};

// Y's partial sums need shared memory only when a tile's columns take
// more than one chunk.
Plan make_plan(int C, int row_span, int col_span) {
  Plan p;
  p.wc = max(1, min(col_span, kTBudget / (kTO * C * 4)));
  p.xp = ((p.wc * C + 15) / 16 + 1) * 16;
  p.hc = max(1, min(row_span, kXBudget / p.xp));
  p.smem = static_cast<size_t>(p.hc) * p.xp + sizeof(Tap) * kTO * p.hc +
           sizeof(float) * (static_cast<size_t>(kTO) * p.wc * C +
                            (col_span > p.wc ? kTO * kTP * C : 0));
  p.smem = (p.smem + 15) / 16 * 16;
  return p;
}

__device__ __forceinline__ void store(void* out, size_t i, float y,
                                      int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(out)[i] = y;
}

// kC: the channel count, or 0 for any count up to kMaxC (read from C).
template <int kC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) preprocess_kernel(
    const uint8_t* __restrict__ xbase, int xoff, size_t total,
    const int* __restrict__ idx, const float* __restrict__ rtaps, int KR,
    const float* __restrict__ ctaps, const float* __restrict__ a,
    const float* __restrict__ bb, void* __restrict__ out, int C_, int H,
    int W, int OH, int OW, int HC, int WC, int XP, int planar, int out_bf16) {
  const int C = kC > 0 ? kC : C_;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* xs = smem;                                   // [HC][XP] bytes
  Tap* taps = reinterpret_cast<Tap*>(smem + HC * XP);  // [HC][kTO]
  float* ts = reinterpret_cast<float*>(taps + HC * kTO);  // [kTO][C][WC]
  float* ys = ts + kTO * C * WC;                          // [C][kTO][kTP]
  __shared__ int s_lor[kTO], s_nr[kTO], s_loc[kTP], s_nc[kTP], s_box[4];
  __shared__ int s_tmax;
  __shared__ float s_a[kMaxC], s_b[kMaxC];

  const int tid = threadIdx.x;
  const int o0 = blockIdx.y * kTO, p0 = blockIdx.x * kTP;
  const size_t b = blockIdx.z;
  const int to = min(kTO, OH - o0), tp = min(kTP, OW - p0);
  const int* lo_r = idx;
  const int* n_r = idx + OH;
  const int* lo_c = idx + 2 * OH;
  const int* n_c = lo_c + OW;

  // The union of the tile's bands: input rows [box0, box1], columns
  // [box2, box3]; empty (box1 < box0) when no row has a tap.
  if (tid < 32) {
    int lo = INT_MAX, hi = -1, l = 0, n = 0;
    if (tid < to) {
      l = lo_r[o0 + tid];
      n = n_r[o0 + tid];
      if (n > 0) lo = l, hi = l + n - 1;
    }
    if (tid < kTO) s_lor[tid] = l, s_nr[tid] = n;
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (tid == 0) s_box[0] = lo, s_box[1] = hi;
  } else if (tid < 64) {
    int lo = INT_MAX, hi = -1;
    for (int p = tid - 32; p < tp; p += 32) {
      const int l = lo_c[p0 + p], n = n_c[p0 + p];
      s_loc[p] = l;
      s_nc[p] = n;
      if (n > 0) lo = min(lo, l), hi = max(hi, l + n - 1);
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (tid == 32) s_box[2] = lo, s_box[3] = hi;
  } else if (tid < 64 + C) {
    s_a[tid - 64] = a[tid - 64];
    s_b[tid - 64] = bb[tid - 64];
  }
  __syncthreads();
  const int rlo = s_box[0], rhi = s_box[1], clo = s_box[2], chi = s_box[3];

  if (rlo > rhi || clo > chi) {  // no taps: y = 0 * a + b
    for (int op = tid; op < kTO * kTP; op += kThreads) {
      const int o = op / kTP, p = op % kTP;
      if (o >= to || p >= tp) continue;
      for (int c = 0; c < C; ++c) {
        const size_t oo = o0 + o, pp = p0 + p;
        store(out,
              planar ? ((b * C + c) * OH + oo) * OW + pp
                     : ((b * OH + oo) * OW + pp) * C + c,
              __fadd_rn(__fmul_rn(0.f, s_a[c]), s_b[c]), out_bf16);
      }
    }
    return;
  }

  for (int wc0 = clo; wc0 <= chi; wc0 += WC) {
    const int nw = min(WC, chi + 1 - wc0);
    const int ncols = nw * C;  // input bytes a row: (w, c) interleaved
    for (int hc0 = rlo; hc0 <= rhi; hc0 += HC) {
      const int nh = min(HC, rhi + 1 - hc0);
      // Input rows hc0 .. hc0 + nh - 1, columns wc0 .. wc0 + nw - 1, all
      // channels: ncols bytes a row from byte s (relative to xbase, which
      // is x aligned down to 16 bytes), copied from s & ~15 in 16-byte
      // pieces. Pieces that leave the tensor are copied byte by byte.
      const int kc = (ncols + 15) / 16 + 1;
      for (int i = tid; i < nh * kc; i += kThreads) {
        const int r = i / kc, k = i - r * kc;
        const size_t s =
            ((b * H + hc0 + r) * static_cast<size_t>(W) + wc0) * C + xoff;
        const size_t piece = (s & ~static_cast<size_t>(15)) + 16 * k;
        if (piece >= s + ncols) continue;
        uint8_t* dst = xs + r * XP + 16 * k;
        if (piece >= static_cast<size_t>(xoff) && piece + 16 <= xoff + total) {
          cp_async16(dst, xbase + piece);
        } else {
          for (int e = 0; e < 16; ++e) {
            const size_t g = piece + e;
            dst[e] = (g >= static_cast<size_t>(xoff) && g < xoff + total)
                         ? xbase[g]
                         : 0;
          }
        }
      }
      // Tap t of each row in this chunk: the staged row's offset and the
      // weight; past a row's last tap, weight 0 at offset 0.
      for (int i = tid; i < HC * kTO; i += kThreads) {
        const int t = i / kTO, o = i - t * kTO;
        const int l = s_lor[o];
        const int h = max(l, hc0) + t;
        Tap e = {0, 0.f};
        if (h < min(l + s_nr[o], hc0 + nh)) {
          const int r = h - hc0;
          const size_t s =
              ((b * H + h) * static_cast<size_t>(W) + wc0) * C + xoff;
          e.off = r * XP + static_cast<int>(s & 15);
          e.w = rtaps[static_cast<size_t>(o0 + o) * KR + h - l];
        }
        taps[i] = e;
      }
      if (tid < 32) {
        int n = 0;
        if (tid < kTO) {
          const int l = s_lor[tid];
          n = max(0, min(l + s_nr[tid], hc0 + nh) - max(l, hc0));
        }
        n = warp_max(n);
        if (tid == 0) s_tmax = n;
      }
      cp_async_wait_all();
      __syncthreads();
      // Row pass: T[o][c][w] (+)= sum over this chunk's taps of row o; a
      // thread takes one (c, w), w fastest, so a warp reads bytes C apart
      // and writes consecutive words. The kTO rows run side by side, tap
      // by tap, so their loads overlap.
      const bool first_h = hc0 == rlo;
      const int tmax = s_tmax;
      for (int j = tid; j < ncols; j += kThreads) {
        const int c = j / nw, wl = j - c * nw;
        const int xcol = wl * C + c;
        float acc[kTO];
#pragma unroll
        for (int o = 0; o < kTO; ++o) acc[o] = 0.f;
        for (int t = 0; t < tmax; ++t) {
#pragma unroll
          for (int o = 0; o < kTO; ++o) {
            const Tap e = taps[t * kTO + o];
            acc[o] = fmaf(e.w, static_cast<float>(xs[e.off + xcol]), acc[o]);
          }
        }
        float* tcol = ts + c * WC + wl;
#pragma unroll
        for (int o = 0; o < kTO; ++o) {
          float& tv = tcol[o * C * WC];
          tv = first_h ? acc[o] : tv + acc[o];
        }
      }
      __syncthreads();
    }
    // Column pass: Y[c][o][p] (+)= sum over this chunk's taps of column p;
    // a warp takes 32 consecutive p of one row o, so the taps (stored
    // tap-major) load coalesced. The last chunk applies the affine step
    // and stores: planar by (c, o, p), NHWC by (o, p) and C channels.
    // A thread takes column p of rows o and o + kTO / 2, which share its
    // taps.
    const bool first_w = wc0 == clo, last_w = wc0 + WC > chi;
    const int p = tid % kTP, oa = tid / kTP, ob = oa + kTO / 2;
    if (p < tp) {
      const int l = s_loc[p];
      const int w0 = max(l, wc0), w1 = min(l + s_nc[p], wc0 + nw);
      const float* ct = ctaps + static_cast<size_t>(w0 - l) * OW + p0 + p;
      const float* ta = ts + oa * C * WC - wc0;
      const float* tb = ts + ob * C * WC - wc0;
      const size_t pp = p0 + p;
      const auto finish = [&](int o, int c, float acc) {
        if (o >= to) return;
        float& yv = ys[(c * kTO + o) * kTP + p];
        const float y = first_w ? acc : yv + acc;
        if (!last_w) {
          yv = y;
          return;
        }
        const size_t oo = o0 + o;
        store(out,
              planar ? ((b * C + c) * OH + oo) * OW + pp
                     : ((b * OH + oo) * OW + pp) * C + c,
              __fadd_rn(__fmul_rn(y, s_a[c]), s_b[c]), out_bf16);
      };
      if constexpr (kC > 0) {
        float acc_a[kC], acc_b[kC];
#pragma unroll
        for (int c = 0; c < C; ++c) acc_a[c] = acc_b[c] = 0.f;
        for (int w = w0; w < w1; ++w) {
          const float cv = ct[static_cast<size_t>(w - w0) * OW];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc_a[c] = fmaf(ta[c * WC + w], cv, acc_a[c]);
            acc_b[c] = fmaf(tb[c * WC + w], cv, acc_b[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          finish(oa, c, acc_a[c]);
          finish(ob, c, acc_b[c]);
        }
      } else {
        for (int c = 0; c < C; ++c) {
          float acc_a = 0.f, acc_b = 0.f;
          for (int w = w0; w < w1; ++w) {
            const float cv = ct[static_cast<size_t>(w - w0) * OW];
            acc_a = fmaf(ta[c * WC + w], cv, acc_a);
            acc_b = fmaf(tb[c * WC + w], cv, acc_b);
          }
          finish(oa, c, acc_a);
          finish(ob, c, acc_b);
        }
      }
    }
    __syncthreads();
  }
}

template <int kC>
cudaError_t launch(const void* x, const void* idx, const void* rtaps, int KR,
                   const void* ctaps, const void* a, const void* b, void* out,
                   int B, int C, int H, int W, int OH, int OW,
                   const Plan& plan, int planar, int out_bf16,
                   cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      preprocess_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  const uint8_t* xbase = reinterpret_cast<const uint8_t*>(xp & ~uintptr_t(15));
  const size_t total = static_cast<size_t>(B) * H * W * C;
  const dim3 grid((OW + kTP - 1) / kTP, (OH + kTO - 1) / kTO, B);
  preprocess_kernel<kC><<<grid, kThreads, plan.smem, st>>>(
      xbase, static_cast<int>(xp & 15), total, static_cast<const int*>(idx),
      static_cast<const float*>(rtaps), KR, static_cast<const float*>(ctaps),
      static_cast<const float*>(a), static_cast<const float*>(b), out, C, H,
      W, OH, OW, plan.hc, plan.wc, plan.xp, planar, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// idx: int32 [lo_r (OH), n_r (OH), lo_c (OW), n_c (OW)]; rtaps f32 (OH, KR):
// each row's taps from its first one on; ctaps f32 (KC, OW): tap t of each
// column, tap-major. row_span / col_span: the widest union of bands over
// kTO rows / kTP columns (the host's, from the same tables). C <= kMaxC.
extern "C" int pcv_preprocess(const void* x, const void* idx,
                              const void* rtaps, int KR, const void* ctaps,
                              const void* a, const void* b, void* out, int B,
                              int C, int H, int W, int OH, int OW,
                              int row_span, int col_span, int planar,
                              int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan plan = make_plan(C, row_span, col_span);
  const cudaError_t err =
      C == 3 ? launch<3>(x, idx, rtaps, KR, ctaps, a, b, out, B, C, H, W, OH,
                         OW, plan, planar, out_bf16, st)
             : launch<0>(x, idx, rtaps, KR, ctaps, a, b, out, B, C, H, W, OH,
                         OW, plan, planar, out_bf16, st);
  return static_cast<int>(err);
}

// out: registers a thread, local (spill) bytes, static shared bytes, and
// the dynamic shared bytes of the instance a launch with these spans takes.
extern "C" int pcv_preprocess_info(int C, int row_span, int col_span,
                                   int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, C == 3 ? preprocess_kernel<3> : preprocess_kernel<0>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(make_plan(C, row_span, col_span).smem);
  return 0;
}
