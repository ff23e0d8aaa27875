// K6: depthwise k x k convolution, per-channel affine (folded BatchNorm) and
// activation, in one pass.
//
// Replaces: the Pallas kernel pytorchcv_tpu/kernels/dwconv.py
//   (dwconv2d_bn_act :152, pallas_call in _pallas_fwd at :124, body _kernel
//   at :62-86): the depthwise conv -> BN -> activation block of every
//   depthwise family. EfficientNet's EffiDwsConvUnit.dw_conv and
//   EffiInvResUnit.conv2 compute exactly this in eval mode.
//
// Computes, for every output (n, c, oy, ox) of x (N, C, H, W):
//   acc = sum over di (outer), dj (inner) of
//         x[n, c, oy*s - top + di, ox*s - left + dj] * w[c, di, dj]
//   in f32 (a tap outside the image reads zero), each product and sum
//   rounded on its own in the TPU body's order (:71-80), then
//   y = acc * scale[c] + shift[c] as two rounded operations (:85), the
//   activation in f32, and one cast to x's type. The activation codes are
//   the order of _ACTS (dwconv.py:35-43); hswish is x*clip(x+3,0,6)*(1/6),
//   as there. The sigmoid (and swish's) takes the fast exponential and a
//   correctly rounded reciprocal in f32, and 0.5 + 0.5 tanh(y / 2) by the
//   hardware's tanh for bf16 outputs (both well inside the gates: 1e-6 of
//   the largest plain value, and 1 bf16 ulp).
//
// Bound on the H100: bytes. At EfficientNet-B0's 16 depthwise calls (224 x
//   224 input) one image reads and writes ~6.1 M elements, 12.2 MB in bf16;
//   the arithmetic is 2 k*k f32 operations an output element, at most 50.
//   In f32 no product may fuse with its sum, so those are 2 k*k
//   instructions, which at batch 128 is a third to half of the bytes bound
//   in issue slots; in bf16 a product is exact and fuses (k*k). The kernel
//   is bound by issue and latency, not bytes: on B0's calls at batch 128
//   it takes 3-6x the bytes bound, and laying the staged span out in
//   shared memory is its largest part (kernels/dwconv_parts.py).
// Design: a block owns a tile of whole output rows: P whole planes (small
//   planes; consecutive channels of one image are consecutive planes) or a
//   band of R rows of one plane (large planes). Either way its input is one
//   contiguous span of x and its output one contiguous span of out. The
//   block copies the input span into shared memory as it lies, in the
//   aligned 16-byte vectors around it (cp.async; any W: a vector may
//   straddle rows and planes), while it writes the layout's zeros, then
//   lays it out, as f32, a warp's stores on consecutive words (a warp a
//   row of 32 or more, else consecutive threads on consecutive elements),
//   in a zero-padded layout in shared memory:
//   per plane, the tile's (R - 1) s + k input rows, each row the padded
//   columns the strips read, split by column parity for stride 2 (even
//   columns, then odd), so the tap loop has no bounds tests and a strip
//   reads consecutive words. Each thread computes strips of V consecutive
//   outputs of one row: per kernel row it loads the V + k - 1 (stride 1) or
//   2 (V + (k - 1) / 2) (stride 2) inputs once into registers (16-byte
//   shared loads where V % 4 == 0), and keeps its plane's k*k weights in
//   registers across its strips. The block stages its outputs in shared
//   memory at the global address's 16-byte phase and writes the span in
//   16-byte vectors (the unaligned ends element by element). The host's
//   plan (kernels/dwconv.py:dwconv_plan) picks V, P or R, the threads and
//   the layout's pitches, which spread a warp's strips over the banks.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float clip06(float v) {
  return fminf(fmaxf(v, 0.f), 6.f);
}

// 1 / (1 + e^-v): the reciprocal correctly rounded (as a division of 1
// would be), e^-v by the fast exponential (a few ulps; the gate for sigmoid
// and swish is 1e-6 of the largest plain value in f32).
__device__ __forceinline__ float sigmoid(float v) {
  return __frcp_rn(__fadd_rn(1.f, __expf(-v)));
}

// For bf16 outputs: 0.5 + 0.5 tanh(v / 2) with the hardware's tanh
// (relative error below 2^-11, an eighth of a bf16 ulp; the gate is 1 ulp).
__device__ __forceinline__ float sigmoid_bf16(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * v));
  return fmaf(0.5f, t, 0.5f);
}

// 0 none, 1 relu, 2 relu6, 3 hswish, 4 hsigmoid, 5 swish, 6 sigmoid, then
// the port's 7 hswish_div: the model's hswish, x * clip(x + 3, 0, 6) / 6
// with a rounded division (MobileNetV3's blocks); BF16: the result is
// cast to bf16.
template <bool BF16>
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);
    case 2: return clip06(v);
    case 3: return __fmul_rn(__fmul_rn(v, clip06(__fadd_rn(v, 3.f))),
                             1.f / 6.f);
    case 4: return __fmul_rn(clip06(__fadd_rn(v, 3.f)), 1.f / 6.f);
    case 5: return __fmul_rn(v, BF16 ? sigmoid_bf16(v) : sigmoid(v));
    case 6: return BF16 ? sigmoid_bf16(v) : sigmoid(v);
    case 7: return __fdiv_rn(__fmul_rn(v, clip06(__fadd_rn(v, 3.f))), 6.f);
    default: return v;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// q = v / d for 0 <= v, d < 2^20 as a multiply and a shift: m = ceil(2^40 / d).
struct Div {
  unsigned long long m;
};

inline Div make_div(int d) {
  return Div{((1ULL << 40) + static_cast<unsigned long long>(d) - 1) /
             static_cast<unsigned long long>(d)};
}

__device__ __forceinline__ int divide(int v, Div d) {
  return static_cast<int>((static_cast<unsigned long long>(v) * d.m) >> 40);
}

// N consecutive floats of a staged row into r; 16-byte loads when VEC (p
// is then 16-byte aligned).
template <int N, bool VEC>
__device__ __forceinline__ void load_row(float* r, const float* p) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i + 4 <= N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x; r[i + 1] = v.y; r[i + 2] = v.z; r[i + 3] = v.w;
    }
    constexpr int n4 = N / 4 * 4;
    if constexpr (N - n4 >= 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + n4);
      r[n4] = v.x; r[n4 + 1] = v.y;
    }
    if constexpr ((N - n4) & 1) r[N - 1] = p[N - 1];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

// A tile's shared layout (f32 words unless said): per plane rows_in rows of
// row_pitch words (stride 2: `half` even columns, then `half` odd ones),
// planes plane_pitch apart; then the planes' weights, scales and shifts;
// then, from a 16-byte boundary, the input span as it lies in x (the
// aligned 16-byte vectors around it), which the outputs in x's type (+ 16
// bytes for their phase) overwrite once it is laid out. The host picks the
// pitches (kernels/dwconv.py:tile_geometry: the least that hold the
// strips' reach and spread a warp's strips over the banks); `layout`
// checks them and places the rest.
struct Geom {
  int spr, rows_in, row_pitch, half, plane_pitch, w_off, out_off, smem;
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// False where the pitches do not hold a tile of `planes` x `rows` output
// rows of an (h, w) -> (ho, wo) map, strips of v (16-byte aligned where
// v % 4 == 0).
inline bool layout(int h, int w, int ho, int wo, int k, int stride, int v,
                   int planes, int rows, int esize, int row_pitch, int half,
                   int plane_pitch, Geom* g) {
  g->spr = (wo + v - 1) / v;
  g->rows_in = (rows - 1) * stride + k;
  g->row_pitch = row_pitch;
  g->half = half;
  g->plane_pitch = plane_pitch;
  const int al = v % 4 == 0 ? 4 : 1;
  const bool ok =
      stride == 1
          ? half == 0 && row_pitch >= g->spr * v + k - 1
          : half >= g->spr * v + (k - 1) / 2 && row_pitch == 2 * half &&
                half % al == 0;
  if (!ok || row_pitch % al != 0 || plane_pitch % al != 0 ||
      plane_pitch < g->rows_in * row_pitch)
    return false;
  const int span = rows == ho ? planes * h * w
                              : (g->rows_in < h ? g->rows_in : h) * w;
  const int raw = round_up(span * esize + 15, 16);
  const int outs = planes * rows * wo * esize + 16;
  g->w_off = planes * plane_pitch;
  g->out_off = round_up(4 * (g->w_off + planes * (k * k + 2)), 16);
  g->smem = g->out_off + (raw > outs ? raw : outs);
  return true;
}

struct Args {
  const void* x;
  const void* w;
  const float* scale;
  const float* shift;
  void* out;
  int planes_total, C, H, W, Ho, Wo, top, left, act;
  int P, R, bands;   // planes a tile, rows a tile, bands a plane (R < Ho)
  Div div_w, div_h;  // by W, and by H (tiles of whole planes)
  Div div_spr;       // by the strips a row
  Geom g;
};

// A thread's strips i = tid, tid + threads, ... of a tile: V outputs of one
// row, summed over the k*k taps (row di outer, column dj inner). For bf16
// x and w each product is exact in f32 (8-bit by 8-bit significands), so
// one fused multiply-add rounds as the product's and the sum's two
// roundings do; f32 rounds them apart. ACT is the activation's code, or -1
// for the one in `act`.
template <typename T, int K, int S, int V, int ACT>
__device__ __forceinline__ void strips_of(
    const float* xs, const float* ws, const float* scs, const float* shs,
    T* ost, const Geom& g, Div div_spr, Div div_plane, int strips, int nr,
    int Wo, int act) {
  constexpr bool VEC = V % 4 == 0;
  int cur = -1;
  float wr[K * K], sc = 0.f, sh = 0.f;
  for (int i = threadIdx.x; i < strips; i += blockDim.x) {
    const int pl = divide(i, div_plane);
    const int rem = i - pl * nr * g.spr;
    const int r = divide(rem, div_spr);
    const int ox0 = (rem - r * g.spr) * V;
    if (pl != cur) {
      cur = pl;
#pragma unroll
      for (int t = 0; t < K * K; ++t) wr[t] = ws[pl * K * K + t];
      sc = scs[pl];
      sh = shs[pl];
    }
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    const float* base = xs + pl * g.plane_pitch + r * S * g.row_pitch + ox0;
#pragma unroll
    for (int di = 0; di < K; ++di) {
      const float* row = base + di * g.row_pitch;
      // even columns ev, odd columns od for stride 2 (od sized as ev: its
      // last (K - 1) / 2 - (K - 3) / 2 words are never read)
      constexpr int NE = S == 1 ? V + K - 1 : V + (K - 1) / 2;
      constexpr int NO = V + (K - 3) / 2;
      float ev[NE], od[NE];
      load_row<NE, VEC>(ev, row);
      if constexpr (S == 2) load_row<NO, VEC>(od, row + g.half);
#pragma unroll
      for (int dj = 0; dj < K; ++dj)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float xv;
          if constexpr (S == 1)
            xv = ev[j + dj];
          else
            xv = dj & 1 ? od[j + dj / 2] : ev[j + dj / 2];
          if constexpr (sizeof(T) == 2)
            acc[j] = __fmaf_rn(xv, wr[di * K + dj], acc[j]);
          else
            acc[j] = __fadd_rn(acc[j], __fmul_rn(xv, wr[di * K + dj]));
        }
    }
    T* o = ost + (pl * nr + r) * Wo + ox0;
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (ox0 + j < Wo)
        o[j] = from_f32<T>(activate<sizeof(T) == 2>(
            __fadd_rn(__fmul_rn(acc[j], sc), sh), ACT < 0 ? act : ACT));
  }
}

// A tile: np planes from plane0, nr output rows from oy0; its input span
// (count elements from src: whole planes, or the band's rows inside the
// image, from image row ry0, srows rows a plane); iy0 the image row of its
// staged row 0, rows_in its staged rows.
struct Tile {
  int plane0, oy0, np, nr, iy0, rows_in, ry0, srows, count;
  const void* src;
};

template <int K, int S>
__device__ __forceinline__ Tile tile_of(const Args a, int t, int esize) {
  Tile q;
  if (a.bands == 1) {
    q.plane0 = t * a.P;
    q.oy0 = 0;
    q.np = min(a.P, a.planes_total - q.plane0);
    q.nr = a.Ho;
  } else {
    q.plane0 = t / a.bands;
    q.oy0 = (t - q.plane0 * a.bands) * a.R;
    q.np = 1;
    q.nr = min(a.R, a.Ho - q.oy0);
  }
  q.iy0 = q.oy0 * S - a.top;
  q.rows_in = (q.nr - 1) * S + K;
  const int ylo = max(q.iy0, 0), yhi = min(q.iy0 + q.rows_in, a.H);
  q.ry0 = a.bands == 1 ? 0 : ylo;
  q.srows = a.bands == 1 ? a.H : max(yhi - ylo, 0);
  q.count = q.np * q.srows * a.W;
  q.src = static_cast<const unsigned char*>(a.x) +
          ((static_cast<size_t>(q.plane0) * a.H + q.ry0) * a.W) * esize;
  return q;
}

// The tile's input span, in the aligned 16-byte vectors around it, copied
// as it lies into `raw` (cp.async, one commit group).
__device__ __forceinline__ void copy_span(const Tile& q, unsigned char* raw,
                                          int esize) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(q.src);
  const uintptr_t c0 = a0 & ~static_cast<uintptr_t>(15);
  const int nchunks = (static_cast<int>(a0 - c0) + q.count * esize + 15) / 16;
  for (int ch = threadIdx.x; ch < nchunks; ch += blockDim.x)
    pcv::cp_async16(raw + 16 * ch,
                    reinterpret_cast<const void*>(c0 + 16 * ch), 16);
}

// One tile a block: its span's copy overlaps the layout's zeros and the
// weights; the span is laid out, the strips computed into the output
// staging (which the span's buffer becomes), and the outputs written.
template <typename T, int K, int S, int V>
__global__ void __launch_bounds__(kMaxThreads)
    dwconv_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Geom g = a.g;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int H = a.H, W = a.W, Wo = a.Wo;
  constexpr int ES = sizeof(T);
  float* xs = smem;
  float* ws = smem + g.w_off;
  float* scs = ws + a.P * K * K;
  float* shs = scs + a.P;
  unsigned char* const bytes = reinterpret_cast<unsigned char*>(smem);
  const int pw = S == 1 ? g.row_pitch : 2 * g.half;
  const Tile q = tile_of<K, S>(a, blockIdx.x, ES);
  copy_span(q, bytes + g.out_off, ES);
  pcv::cp_async_commit();

  // Zeros: the pad columns of rows inside the image, whole rows outside.
  const int right0 = min(a.left + W, pw);
  for (int i = tid; i < q.np * q.rows_in; i += nth) {
    const int pl = i / q.rows_in, sr = i - pl * q.rows_in;
    float* row = xs + pl * g.plane_pitch + sr * g.row_pitch;
    const int iy = q.iy0 + sr;
    const bool inside = iy >= 0 && iy < H;
    const int lo = inside ? min(a.left, pw) : pw;
    for (int pc = 0; pc < lo; ++pc)
      row[S == 1 ? pc : (pc & 1) * g.half + (pc >> 1)] = 0.f;
    for (int pc = inside ? right0 : 0; pc < (inside ? pw : 0); ++pc)
      row[S == 1 ? pc : (pc & 1) * g.half + (pc >> 1)] = 0.f;
  }
  // The planes' weights, scales and shifts.
  for (int i = tid; i < q.np * K * K; i += nth) {
    const int pl = i / (K * K);
    const int c = (q.plane0 + pl) % a.C;
    ws[i] = to_f32(static_cast<const T*>(a.w)[c * K * K + (i - pl * K * K)]);
  }
  for (int i = tid; i < q.np; i += nth) {
    const int c = (q.plane0 + i) % a.C;
    scs[i] = a.scale[c];
    shs[i] = a.shift[c];
  }
  pcv::cp_async_wait<0>();
  __syncthreads();

  // The span laid out as f32 so that a warp's stores fall in consecutive
  // words: rows of 32 or more a warp each (lanes on columns), else
  // consecutive threads on consecutive elements (rows and planes by
  // multiply and shift).
  const T* span = reinterpret_cast<const T*>(bytes + g.out_off) +
                  (reinterpret_cast<uintptr_t>(q.src) & 15) / ES;
  if (W >= 32) {
    const int lane = tid & 31, nwarps = nth >> 5;
    for (int row = tid >> 5; row < q.np * q.srows; row += nwarps) {
      int pl = 0, r = row;
      if (a.bands == 1) {
        pl = divide(row, a.div_h);
        r = row - pl * H;
      }
      const int sr = r + q.ry0 - q.iy0;
      if (static_cast<unsigned>(sr) >= static_cast<unsigned>(q.rows_in))
        continue;
      float* out_row = xs + pl * g.plane_pitch + sr * g.row_pitch;
      const T* in_row = span + row * W;
      for (int ix = lane; ix < W; ix += 32) {
        const int pc = ix + a.left;
        if (pc < pw)
          out_row[S == 1 ? pc : (pc & 1) * g.half + (pc >> 1)] =
              to_f32(in_row[ix]);
      }
    }
  } else {
    for (int e = tid; e < q.count; e += nth) {
      const int row = divide(e, a.div_w);     // rows from the span's first
      const int ix = e - row * W;
      int pl = 0, r = row;
      if (a.bands == 1) {
        pl = divide(row, a.div_h);
        r = row - pl * H;
      }
      const int sr = r + q.ry0 - q.iy0, pc = ix + a.left;
      if (static_cast<unsigned>(sr) < static_cast<unsigned>(q.rows_in) &&
          pc < pw)
        xs[pl * g.plane_pitch + sr * g.row_pitch +
           (S == 1 ? pc : (pc & 1) * g.half + (pc >> 1))] = to_f32(span[e]);
    }
  }
  __syncthreads();

  // Strips of V outputs, staged at the phase of their global address.
  T* dst = static_cast<T*>(a.out) +
           (static_cast<size_t>(q.plane0) * a.Ho + q.oy0) * Wo;
  const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  T* ost = reinterpret_cast<T*>(bytes + g.out_off + phase);
  const int per_plane = q.nr * g.spr;
  const Div div_plane{((1ULL << 40) + per_plane - 1) / per_plane};
  // Swish (EfficientNet's) instantiated apart, with no switch an output:
  // faster on B0's stride-1 calls (kernels/dwconv_parts.py, "one strip
  // loop").
  if (a.act == 5)
    strips_of<T, K, S, V, 5>(xs, ws, scs, shs, ost, g, a.div_spr, div_plane,
                             q.np * per_plane, q.nr, Wo, a.act);
  else
    strips_of<T, K, S, V, -1>(xs, ws, scs, shs, ost, g, a.div_spr, div_plane,
                              q.np * per_plane, q.nr, Wo, a.act);
  __syncthreads();

  // The output span: 16-byte vectors between its unaligned ends.
  constexpr int E = 16 / ES;
  const int total = q.np * q.nr * Wo;
  const int head = min(total, ((16 - phase) & 15) / ES);
  const int body = (total - head) / E;
  const int tail0 = head + body * E;
  for (int i = tid; i < head; i += nth) dst[i] = ost[i];
  for (int i = tid; i < body; i += nth)
    reinterpret_cast<uint4*>(dst + head)[i] =
        reinterpret_cast<const uint4*>(ost + head)[i];
  for (int i = tail0 + tid; i < total; i += nth) dst[i] = ost[i];
}

using Kernel = void (*)(const Args);

template <typename T, int K, int S>
Kernel pick_v(int v) {
  switch (v) {
    case 4: return dwconv_kernel<T, K, S, 4>;
    case 7: return dwconv_kernel<T, K, S, 7>;
    default: return nullptr;
  }
}

template <typename T, int K>
Kernel pick_s(int stride, int v) {
  return stride == 1 ? pick_v<T, K, 1>(v)
                     : stride == 2 ? pick_v<T, K, 2>(v) : nullptr;
}

template <typename T>
Kernel pick_k(int k, int stride, int v) {
  switch (k) {
    case 3: return pick_s<T, 3>(stride, v);
    case 5: return pick_s<T, 5>(stride, v);
    case 7: return pick_s<T, 7>(stride, v);
    default: return nullptr;
  }
}

Kernel instance(int k, int stride, int v, int bf16) {
  return bf16 ? pick_k<__nv_bfloat16>(k, stride, v)
              : pick_k<float>(k, stride, v);
}

}  // namespace

// x (N, C, H, W) and w (C, 1, k, k) in x's type (bf16 when bf16 != 0, else
// f32), scale and shift f32 (C,), out (N, C, Ho, Wo) in x's type. The plan:
// v outputs a strip (4 or 7), `planes` planes a tile of whole planes
// (rows == Ho) or bands of `rows` rows of one plane (planes == 1), `threads`
// threads a block (a multiple of 32, at most 256), and the layout's
// row_pitch, half and plane_pitch (checked by `layout`).
extern "C" int pcv_dwconv(const void* x, const void* w, const void* scale,
                          const void* shift, void* out, int N, int C, int H,
                          int W, int Ho, int Wo, int k, int stride, int top,
                          int left, int act, int bf16, int v, int planes,
                          int rows, int threads, int row_pitch, int half,
                          int plane_pitch, void* stream) {
  const Kernel kernel = instance(k, stride, v, bf16);
  Args a;
  if (kernel == nullptr || planes < 1 || rows < 1 || rows > Ho ||
      (rows < Ho && planes != 1) || threads < 32 || threads % 32 != 0 ||
      threads > kMaxThreads ||
      !layout(H, W, Ho, Wo, k, stride, v, planes, rows, bf16 ? 2 : 4,
              row_pitch, half, plane_pitch, &a.g))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = x; a.w = w;
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.out = out;
  a.planes_total = N * C; a.C = C; a.H = H; a.W = W; a.Ho = Ho; a.Wo = Wo;
  a.top = top; a.left = left; a.act = act;
  a.P = planes; a.R = rows;
  a.bands = (Ho + rows - 1) / rows;
  a.div_w = make_div(W);
  a.div_h = make_div(H);
  a.div_spr = make_div(a.g.spr);
  const long long tiles = a.bands == 1
                              ? (a.planes_total + planes - 1) / planes
                              : static_cast<long long>(a.planes_total) *
                                    a.bands;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), threads, a.g.smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes, static shared bytes and the
// dynamic shared bytes of the k x k / stride instance with v outputs a
// strip, at `planes` planes x `rows` rows a tile of an (h, w) -> (ho, wo)
// map under the given pitches (0 where they do not hold the tile).
extern "C" int pcv_dwconv_info(int k, int stride, int v, int bf16, int h,
                               int w, int ho, int wo, int planes, int rows,
                               int row_pitch, int half, int plane_pitch,
                               int* out) {
  const Kernel kernel = instance(k, stride, v, bf16);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geom g;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = layout(h, w, ho, wo, k, stride, v, planes, rows, bf16 ? 2 : 4,
                  row_pitch, half, plane_pitch, &g)
               ? g.smem
               : 0;
  return 0;
}
