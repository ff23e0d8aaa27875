// K12: int8 NHWC depthwise 3x3 convolution with the int8 routes' fused
// epilogue (folded BN, ReLU or ReLU6, requantization to int8).
//
// Replaces: no Pallas kernel. The JAX package computes this conv in XLA
//   (pytorchcv_tpu/quant/mobilenet_int8.py:_conv_i8, :61-69, a
//   conv_general_dilated with feature_group_count = C and int32 sums), then
//   _cell6's (:72-97) or _forward_v1's cell_relu's (:219-226) elementwise
//   epilogue: y = f32(acc) * A + B, clip(y, 0, 6) or max(y, 0), and
//   clip(rint(y * q), +-127). PyTorch's CUDA convolutions take no int8, so
//   the port needs a kernel of its own, as for K2, K3 and maxpool_i8.
//
// Exactness: |x|, |w| <= 127 and 9 taps, so a sum is below 9 * 127^2 <
//   2^22 in magnitude and the int32 sum is exact; the epilogue spells each
//   step with __fmul_rn / __fadd_rn in _cell6's f32 order, so the kernel,
//   its plain version and the JAX cell agree bit for bit. Two exact float
//   tricks save the conversions (a quarter-rate pipe): the sums start at
//   the bits of 1.5 * 2^23, so acc's bits are the float 1.5 * 2^23 + sum
//   and one exact subtraction gives f32(sum); after the clip, adding 1.5 *
//   2^23 rounds to the nearest even integer as rint does, and the int8 is
//   the low byte of the float's bits (clip then rint equals rint then clip
//   at the integer bounds +-127). The activation folds into that clip for
//   every finite q (see epilogue), 7 float operations an output in all.
//
// Bound on the H100: bytes. An output is 9 multiply-adds against at least
//   one input byte read and one output byte written (stride 1; four input
//   bytes a stride-2 output); MobileNetV2's 17 depthwise convs at batch 128
//   move 0.774 GB (0.231 ms at 3.35 TB/s) for 2.65 G multiply-adds.
// Design (the second; the first took a 16-byte channel vector down 2
//   output rows and multiplied byte by byte, ~3 instructions a
//   multiply-add, re-reading every tap's vector from L1 for each row):
//   - Issue: a thread owns CPT channels (a 32-bit word of 4, or 1 where C
//     or the pointers' alignment forbid words) of a strip of kV = 4 output
//     columns. Each input row of the strip (3 * S + 3 columns, with
//     the 2-column halo) is read once, one word a column, and turned
//     channel-major by a 4x4 byte transpose (8 __byte_perm a 4 x 4 block).
//     One funnel (__byte_perm, a shift, or nothing where the window is
//     word-aligned) forms a channel's 3-column window, and one __dp4a
//     against the weight word (w0, w1, w2, 0) sums a kernel row: 3
//     multiply-adds in ~2 instructions.
//   - Reuse: the thread walks down R output rows keeping the last 3
//     channel-major input rows in registers, so an input word is read once
//     a thread (plus the halo and the band's 2 extra rows); the loads of
//     the next 3 iterations' rows (1 at stride 2, which takes 2 rows an
//     iteration) are in flight while a row's sums run. The rows live in a
//     ring of 3 slots and the loaded rows in a ring of 3 (or 1), and the
//     walk takes 3 rows a pass, so no register is copied.
//   - Weights (3 dp4a words a channel), gains and biases go into
//     registers once a thread. Neighbouring threads take neighbouring
//     channel words of one pixel, so a warp's loads and stores are whole
//     32-byte sectors. dwconv_i8_plan (kernels/dwconv_i8.py) picks CPT
//     and R per call: enough threads to fill the card, as few extra rows
//     as that allows. Strips of 8 and 16 columns were no faster, and 64
//     threads a block no different from 128 (PERF.md, K12). All indices
//     are 32-bit: the wrapper bounds the maps below 2^31 bytes.
#include "common.cuh"

namespace {

constexpr float kMagic = 12582912.f;          // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;        // its bits
constexpr int kV = 4;                         // output columns a strip
constexpr int kThreads = 128;                 // threads a block

struct Args {
  const int8_t* x;
  const int8_t* wt;
  const float* gain_a;
  const float* bias_b;
  float q, lo, hi;    // q; the clip's bounds (see epilogue)
  int8_t* out;
  int B, H, W, Ho, Wo, C, strips, rows, bands;
};

template <int S>
struct Geo {
  static constexpr int kCols = (kV - 1) * S + 3;  // input columns a strip
  static constexpr int kWords = (kCols + 3) / 4;  // channel words a row
  static constexpr int kKeep = 3 - S;             // rows carried on
  static constexpr int kAhead = S == 1 ? 3 : 1;   // iterations loaded ahead
};

// Input row ih of the strip: one word (CPT 4) or byte (CPT 1) a column,
// zero outside the map.
template <int CPT, int S>
__device__ __forceinline__ void load_row(
    unsigned (&raw)[4 * Geo<S>::kWords], const int8_t* img, int ih,
    const Args& a, int iw0, unsigned col_ok) {
  const bool row_ok = static_cast<unsigned>(ih) < static_cast<unsigned>(a.H);
  const int8_t* p = img + (ih * a.W + iw0) * a.C;
#pragma unroll
  for (int i = 0; i < 4 * Geo<S>::kWords; ++i) {
    raw[i] = 0u;
    if (i < Geo<S>::kCols && row_ok && ((col_ok >> i) & 1u)) {
      if constexpr (CPT == 4)
        raw[i] = __ldg(reinterpret_cast<const unsigned*>(p + i * a.C));
      else
        raw[i] = static_cast<unsigned char>(__ldg(p + i * a.C));
    }
  }
}

// Pixel-major columns -> channel-major words: row[c][k] holds channel c
// of columns 4k .. 4k + 3, column 4k in its low byte.
template <int CPT, int S>
__device__ __forceinline__ void to_channels(
    const unsigned (&raw)[4 * Geo<S>::kWords],
    unsigned (&row)[CPT][Geo<S>::kWords]) {
#pragma unroll
  for (int k = 0; k < Geo<S>::kWords; ++k) {
    const unsigned p0 = raw[4 * k], p1 = raw[4 * k + 1],
                   p2 = raw[4 * k + 2], p3 = raw[4 * k + 3];
    if constexpr (CPT == 4) {
      const unsigned t0 = __byte_perm(p0, p1, 0x5140);
      const unsigned t1 = __byte_perm(p0, p1, 0x7362);
      const unsigned t2 = __byte_perm(p2, p3, 0x5140);
      const unsigned t3 = __byte_perm(p2, p3, 0x7362);
      row[0][k] = __byte_perm(t0, t2, 0x5410);
      row[1][k] = __byte_perm(t0, t2, 0x7632);
      row[2][k] = __byte_perm(t1, t3, 0x5410);
      row[3][k] = __byte_perm(t1, t3, 0x7632);
    } else {
      row[0][k] = __byte_perm(__byte_perm(p0, p1, 0x0040),
                              __byte_perm(p2, p3, 0x0040), 0x5410);
    }
  }
}

// The 3-column window of one channel starting at column O (its 4th byte
// meets the weight word's 0).
template <int O, int N>
__device__ __forceinline__ unsigned window(const unsigned (&w)[N]) {
  constexpr int k = O / 4, r = O % 4;
  if constexpr (r == 0) return w[k];
  else if constexpr (r == 1) return w[k] >> 8;
  else if constexpr (r == 2) return __byte_perm(w[k], w[k + 1], 0x5432);
  else return __byte_perm(w[k], w[k + 1], 0x6543);
}

// _cell6's epilogue on acc's bits (1.5 * 2^23 + sum); returns a float's
// bits whose low byte is the int8. The activation folds into the clip:
// for a finite q, y -> f32(y * q) is monotone (non-decreasing for q >= 0,
// non-increasing for q < 0), so clip(f32(act(y) * q), +-127) is
// clip(f32(y * q), lo, hi) bit for bit, with the bounds that
// pcv_dwconv_i8 sets from act and the sign of q.
__device__ __forceinline__ unsigned epilogue(int acc, float ga, float bb,
                                             const Args& a) {
  const float v = __fsub_rn(__int_as_float(acc), kMagic);
  const float y = __fadd_rn(__fmul_rn(v, ga), bb);
  const float z = fminf(fmaxf(__fmul_rn(y, a.q), a.lo), a.hi);
  return __float_as_uint(__fadd_rn(z, kMagic));
}

// Output column J.. of the strip's row (those below `left`): per channel
// 3 windows and dp4a's, the epilogue, one word (or byte) stored. The
// input rows lie in a ring of 3 slots, the top one in slot R0.
template <int CPT, int S, int R0, int J = 0>
__device__ __forceinline__ void columns(
    unsigned (&rows)[3][CPT][Geo<S>::kWords], unsigned (&wrow)[CPT][3],
    const float (&ga)[CPT], const float (&bb)[CPT], const Args& a,
    int8_t* dst, int left) {
  if constexpr (J < kV) {
    if (J >= left) return;
    unsigned e[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      int acc = kMagicBits;
#pragma unroll
      for (int di = 0; di < 3; ++di)
        acc = __dp4a(static_cast<int>(window<J * S>(rows[(R0 + di) % 3][c])),
                     static_cast<int>(wrow[c][di]), acc);
      e[c] = epilogue(acc, ga[c], bb[c], a);
    }
    if constexpr (CPT == 4)
      *reinterpret_cast<unsigned*>(dst + J * a.C) =
          __byte_perm(__byte_perm(e[0], e[1], 0x0040),
                      __byte_perm(e[2], e[3], 0x0040), 0x5410);
    else
      dst[J * a.C] = static_cast<int8_t>(e[0] & 0xffu);
    columns<CPT, S, R0, J + 1>(rows, wrow, ga, bb, a, dst, left);
  }
}

// Output row oh, iteration P (mod 3) of the band: its new input rows
// from ahead[] into the ring, the loads of iteration oh + kAhead into the
// ahead slot just freed, then the row's outputs.
template <int CPT, int S, int P>
__device__ __forceinline__ void step(
    unsigned (&rows)[3][CPT][Geo<S>::kWords],
    unsigned (&ahead)[Geo<S>::kAhead][S][4 * Geo<S>::kWords],
    unsigned (&wrow)[CPT][3], const float (&ga)[CPT], const float (&bb)[CPT],
    const Args& a, const int8_t* img, int iw0, unsigned col_ok, int oh,
    int oh1, int b, int ow0, int c0) {
  using G = Geo<S>;
  constexpr int slot = P % G::kAhead;
#pragma unroll
  for (int k = 0; k < S; ++k)
    to_channels<CPT, S>(ahead[slot][k], rows[(P * S + G::kKeep + k) % 3]);
  if (oh + G::kAhead < oh1) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      load_row<CPT, S>(ahead[slot][k], img,
                       (oh + G::kAhead) * S - 1 + G::kKeep + k, a, iw0,
                       col_ok);
  }
  columns<CPT, S, (P * S) % 3>(
      rows, wrow, ga, bb, a, a.out + ((b * a.Ho + oh) * a.Wo + ow0) * a.C + c0,
      a.Wo - ow0);
}

template <int CPT, int S>
__global__ void __launch_bounds__(kThreads) dwconv_i8_kernel(const Args a) {
  using G = Geo<S>;
  constexpr int NW = G::kWords;
  const int ncw = a.C / CPT;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.B * a.bands * a.strips * ncw) return;
  const int cw = idx % ncw;
  idx /= ncw;
  const int st = idx % a.strips;
  idx /= a.strips;
  const int band = idx % a.bands;
  const int b = idx / a.bands;
  const int c0 = cw * CPT, ow0 = st * kV, iw0 = ow0 * S - 1;
  const int oh0 = band * a.rows, oh1 = min(oh0 + a.rows, a.Ho);

  // weights as dp4a words (w[di][0], w[di][1], w[di][2], 0) a channel
  unsigned wrow[CPT][3];
  float ga[CPT], bb[CPT];
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int8_t* wp = a.wt + 3 * di * a.C + c0;
    if constexpr (CPT == 4) {
      const unsigned w0 = __ldg(reinterpret_cast<const unsigned*>(wp));
      const unsigned w1 = __ldg(reinterpret_cast<const unsigned*>(wp + a.C));
      const unsigned w2 =
          __ldg(reinterpret_cast<const unsigned*>(wp + 2 * a.C));
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wrow[c][di] = __byte_perm(__byte_perm(w0, w1, c | ((c + 4) << 4)),
                                  w2, 0x0010 | ((c + 4) << 8)) &
                      0x00ffffffu;
    } else {
      wrow[0][di] = static_cast<unsigned char>(__ldg(wp)) |
                    static_cast<unsigned>(static_cast<unsigned char>(
                        __ldg(wp + a.C))) << 8 |
                    static_cast<unsigned>(static_cast<unsigned char>(
                        __ldg(wp + 2 * a.C))) << 16;
    }
  }
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    ga[c] = __ldg(a.gain_a + c0 + c);
    bb[c] = __ldg(a.bias_b + c0 + c);
  }

  unsigned col_ok = 0u;
#pragma unroll
  for (int i = 0; i < G::kCols; ++i)
    if (static_cast<unsigned>(iw0 + i) < static_cast<unsigned>(a.W))
      col_ok |= 1u << i;

  const int8_t* img = a.x + b * a.H * a.W * a.C + c0;
  // input row ih0 + i lives in slot i % 3 of the ring; iteration i's new
  // rows, loaded kAhead iterations before, in ahead[i % kAhead]
  unsigned rows[3][CPT][NW];
  unsigned ahead[G::kAhead][S][4 * NW];
  const int ih0 = oh0 * S - 1;
#pragma unroll
  for (int k = 0; k < G::kKeep; ++k) {
    load_row<CPT, S>(ahead[0][0], img, ih0 + k, a, iw0, col_ok);
    to_channels<CPT, S>(ahead[0][0], rows[k]);
  }
#pragma unroll
  for (int d = 0; d < G::kAhead; ++d)
    if (oh0 + d < oh1) {
#pragma unroll
      for (int k = 0; k < S; ++k)
        load_row<CPT, S>(ahead[d][k], img, ih0 + d * S + G::kKeep + k, a,
                         iw0, col_ok);
    }
  // three iterations a pass, so that every slot is known at compile time
  for (int oh = oh0; oh < oh1; oh += 3) {
    step<CPT, S, 0>(rows, ahead, wrow, ga, bb, a, img, iw0, col_ok, oh, oh1,
                    b, ow0, c0);
    if (oh + 1 < oh1)
      step<CPT, S, 1>(rows, ahead, wrow, ga, bb, a, img, iw0, col_ok, oh + 1,
                      oh1, b, ow0, c0);
    if (oh + 2 < oh1)
      step<CPT, S, 2>(rows, ahead, wrow, ga, bb, a, img, iw0, col_ok, oh + 2,
                      oh1, b, ow0, c0);
  }
}

using Kernel = void (*)(const Args);

// The instances: 4-channel words or single channels, stride 1 or 2.
Kernel instance(int cpt, int stride) {
  if (cpt == 4 && stride == 1) return dwconv_i8_kernel<4, 1>;
  if (cpt == 4 && stride == 2) return dwconv_i8_kernel<4, 2>;
  if (cpt == 1 && stride == 1) return dwconv_i8_kernel<1, 1>;
  if (cpt == 1 && stride == 2) return dwconv_i8_kernel<1, 2>;
  return nullptr;
}

}  // namespace

// The conv of x (B, H, W, C) int8 with wt (3, 3, C) int8, stride 1 or 2,
// pad 1, into out (B, Ho, Wo, C) int8: cpt channels a thread (C % cpt ==
// 0; x, wt and out cpt-aligned), `rows` output rows a thread; act 0 none,
// 1 ReLU, 2 ReLU6; q finite.
extern "C" int pcv_dwconv_i8(const void* x, const void* wt, const void* gain_a,
                             const void* bias_b, float q, int act, void* out,
                             int B, int H, int W, int Ho, int Wo, int C,
                             int stride, int cpt, int rows, void* stream) {
  const Kernel kernel = instance(cpt, stride);
  if (kernel == nullptr || act < 0 || act > 2 ||
      !(fabsf(q) <= 3.402823466e38f) || C % cpt != 0 || rows < 1 ||
      reinterpret_cast<uintptr_t>(x) % cpt != 0 ||
      reinterpret_cast<uintptr_t>(wt) % cpt != 0 ||
      reinterpret_cast<uintptr_t>(out) % cpt != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The clip's bounds: +-127 without an activation; ReLU's act(y) * q
  // runs from 0 towards the sign of q, ReLU6's from 0 to f32(6 q); each
  // range cut to +-127 (q = 0 gives 0 at either bound).
  float lo = -127.f, hi = 127.f;
  if (act != 0 && q >= 0.f) {
    lo = 0.f;
    if (act == 2) hi = fminf(6.f * q, 127.f);
  } else if (act != 0) {
    hi = 0.f;
    if (act == 2) lo = fmaxf(6.f * q, -127.f);
  }
  Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
         static_cast<const float*>(gain_a), static_cast<const float*>(bias_b),
         q, lo, hi, static_cast<int8_t*>(out), B, H, W, Ho, Wo, C,
         (Wo + kV - 1) / kV, rows, (Ho + rows - 1) / rows};
  const long long total =
      static_cast<long long>(B) * a.bands * a.strips * (C / cpt);
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads,
           0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes of an instance.
extern "C" int pcv_dwconv_i8_info(int cpt, int stride, int* out) {
  const Kernel kernel = instance(cpt, stride);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
