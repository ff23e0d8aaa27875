// K3: the serving stem of the int8 pipelines, and their int8 max-pool.
//
// Replaces: XLA's bf16 stride-2 conv (f32 accumulation), bias, ReLU, _quant
//   and int8 reduce_window max-pool of the two serving stems:
//   - 7x7/s2 pad 3 + pool, the planar ResNet stem of
//     pytorchcv_tpu/quant/resnet_int8.py:_forward (:252-264). Its role is
//     that of the Pallas kernel pytorchcv_tpu/kernels/stem_conv.py:_kernel,
//     which computes an int8-input variant that serving does not run;
//   - 3x3/s2 pad 1, conv1 of the SENet deep stem of
//     pytorchcv_tpu/quant/seg_backbone_int8.py:_forward (:85-93), which
//     pools (_maxpool_i8) after its int8 conv2 and conv3;
//   - 3x3/s2 pad 1 with ReLU (MobileNet v1) or clip(0, 6) (MobileNetV2)
//     and no pool, the stems of pytorchcv_tpu/quant/mobilenet_int8.py
//     (:117-122, :211-217).
//   Both pools run as a launch of their own, pcv_maxpool_i8.
//
// Bound on the H100: with 3 input channels the conv is 27 or 147 MACs per
//   output value: small for the card (30 GFLOP at ResNet-50's batch 128,
//   0.03 ms at the bf16 tensor-core peak), so the limit is moving the
//   planar bf16 image in and the int8 map out (0.042 ms).
// Design (kernel 1, templated on the kernel size): an implicit GEMM on the
//   bf16 tensor cores, mma.sync m16n8k16 with f32 accumulation: M = output
//   pixels, N = Cout (<= 64), K = the 3 k k taps, laid out as 3 k rows
//   (plane, kernel row) of SP = 8 (7x7) or 4 (3x3) taps, each row starting
//   one column left of the kernel's (that tap's weight is 0) and the tail
//   zero, so K = 176 or 48. A bf16 x bf16 product is exact in f32, as the
//   old kernel's FMAs were; only the order of the f32 sums moves (16 taps a
//   step), which the gate allows. Persistent blocks (two an SM) stage the
//   padded kernel once, as ldmatrix's B operand ([Cout][K], rows padded by
//   16 bytes so 8 rows read 8 bank groups), then walk tiles of R output
//   rows of one image (the host's plan). A tile's window, 3 planes x (2 R +
//   k - 2) input rows, zero padded, arrives by cp.async (16 bytes where W %
//   8 == 0) into one of two buffers while the block computes the tile
//   before. Each warp takes 32 pixels at a time and gathers its A fragments
//   from the window (im2col in registers): a K pair (s, s + 1) of one row
//   is 4 aligned bytes (the one-column shift makes every pair start at an
//   even column), and the mma row g holds pixel 4 g (+ 1, + 2, + 3 for the
//   other rows of the two m16 tiles), so the 32 lanes' 32-bit loads fall
//   in 32 different banks. The epilogue is the old one: the f32 bias,
//   ReLU and quant_i8, staged per warp in shared memory and written as
//   16-byte (8-byte where Cout % 16 != 0) stores of the warp's contiguous
//   32 x Cout bytes. Kernel 2 max-pools an int8 NHWC map 3x3/s2 with pad
//   value -128. It is bound by bytes (the map read once, a quarter of it
//   written: 0.038 ms at ResNet-50's batch 128): a thread takes a 16-byte
//   channel vector of one output column down a run of output rows, so
//   every access is a vector and each input row shared by two output rows
//   is read once. Fusing the pool into kernel 1 (halo rows) is left for
//   later: it would take the pool's launch off the routes.
#include "common.cuh"

namespace {

using pcv::cp_async16;
using pcv::cp_async_commit;
using pcv::cp_async_wait;
using pcv::ldmatrix_x4;
using pcv::mma_bf16;

constexpr int kMaxCout = 64;
constexpr int kThreads = 256;                // 8 warps
constexpr int kStagePitch = kMaxCout + 16;   // bytes a staged pixel

// K layout of a KS x KS stem: 3 KS rows of SP taps (tap 0 one column left
// of the kernel), K padded to whole k16 steps.
template <int KS>
struct Geom {
  static constexpr int kPad = KS / 2;
  static constexpr int SP = KS == 7 ? 8 : 4;
  static constexpr int kLogSP = KS == 7 ? 3 : 2;
  static constexpr int kRows = 3 * KS;
  static constexpr int KP = (kRows * SP + 15) / 16 * 16;   // 176 or 48
  static constexpr int KC = KP / 16;
  static constexpr int kWPitch = KP * 2 + 16;   // bytes a weight row
  static constexpr int kKoffBytes = (KP / 2 * 4 + 15) / 16 * 16;
  static constexpr int kFixed = kMaxCout * kWPitch + kMaxCout * 4 +
                                kKoffBytes + 8 * 32 * kStagePitch;
};

// A window row's bf16 elements: 8 zero columns, the image row, >= 8 zeros.
__host__ __device__ constexpr int window_pitch(int w) {
  return (w + 16 + 7) / 8 * 8;
}

// Dynamic shared bytes: the weights, bias, K-pair offsets, the warps'
// output staging and two windows of 3 (2 rows + KS - 2) rows.
template <int KS>
__host__ __device__ constexpr int stem_smem(int rows, int w) {
  return Geom<KS>::kFixed + 2 * 3 * (2 * rows + KS - 2) * window_pitch(w) * 2;
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// KS x KS conv, stride 2, pad KS / 2, in tiles of R output rows.
template <int KS, bool VEC16>
__global__ void __launch_bounds__(kThreads, 2) stem_conv_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, float q, int act,
    int8_t* __restrict__ y, int B, int H, int W, int Ho, int Wo, int Cout,
    int R) {
  using G = Geom<KS>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;
  float* s_bias = reinterpret_cast<float*>(s_w + kMaxCout * G::kWPitch);
  int* s_koff = reinterpret_cast<int*>(s_bias + kMaxCout);
  unsigned char* s_stage =
      reinterpret_cast<unsigned char*>(s_koff) + G::kKoffBytes;
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(
      s_stage + 8 * 32 * kStagePitch);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int pitch = window_pitch(W);
  const int wrows = 2 * R + KS - 2;
  const int win_elems = 3 * wrows * pitch;
  const int per_img = (Ho + R - 1) / R;
  const int tiles = B * per_img;

  // The padded kernel, [n][k]; the bias; each K pair's window offset.
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < kMaxCout * G::KP; i += kThreads) {
    const int n = i % kMaxCout, k = i / kMaxCout;   // kf's reads coalesce
    const int row = k >> G::kLogSP, sp = k & (G::SP - 1);
    __nv_bfloat16 v = zero;
    if (n < Cout && row < G::kRows && sp >= 1 && sp <= KS)
      v = wt[(row * KS + sp - 1) * Cout + n];
    reinterpret_cast<__nv_bfloat16*>(s_w + n * G::kWPitch)[k] = v;
  }
  for (int i = tid; i < kMaxCout; i += kThreads)
    s_bias[i] = i < Cout ? bias[i] : 0.f;
  for (int i = tid; i < G::KP / 2; i += kThreads) {
    const int row = (2 * i) >> G::kLogSP, sp = (2 * i) & (G::SP - 1);
    // Pairs past the taps meet zero weights: any finite element will do.
    s_koff[i] = row < G::kRows
                    ? ((row / KS) * wrows + row % KS) * pitch + sp
                    : 0;
  }
  // The windows' pad columns stay zero; copies write columns 8 .. 8 + W.
  const int pads = pitch - W;
  for (int i = tid; i < 2 * 3 * wrows * pads; i += kThreads) {
    const int row = i / pads, col = i - row * pads;
    win[row * pitch + (col < 8 ? col : W + col)] = zero;
  }

  auto load_window = [&](int ti, __nv_bfloat16* buf) {
    const int img = ti / per_img;
    const int ih0 = 2 * (ti % per_img) * R - G::kPad;
    if (VEC16) {
      const int cw = W / 8;
      for (int i = tid; i < 3 * wrows * cw; i += kThreads) {
        const int rr = i / cw, col = i - rr * cw;     // rr: plane x row
        const int ih = ih0 + rr % wrows;
        const bool in = static_cast<unsigned>(ih) < static_cast<unsigned>(H);
        cp_async16(buf + rr * pitch + 8 + col * 8,
                   in ? x + ((static_cast<size_t>(img) * 3 + rr / wrows) * H +
                             ih) * W + col * 8
                      : x,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < 3 * wrows * W; i += kThreads) {
        const int rr = i / W, col = i - rr * W;
        const int ih = ih0 + rr % wrows;
        buf[rr * pitch + 8 + col] =
            static_cast<unsigned>(ih) < static_cast<unsigned>(H)
                ? x[((static_cast<size_t>(img) * 3 + rr / wrows) * H + ih) *
                        W + col]
                : zero;
      }
    }
  };

  const int mi = lane >> 3;
  const int brow = ((mi >> 1) * 8 + (lane & 7)) * G::kWPitch + (mi & 1) * 16;
  unsigned char* stage = s_stage + warp * 32 * kStagePitch;
  int ti = blockIdx.x;
  if (ti < tiles) load_window(ti, win);
  cp_async_commit();
  for (int it = 0; ti < tiles; ++it, ti += gridDim.x) {
    const __nv_bfloat16* cur = win + (it & 1) * win_elems;
    if (ti + gridDim.x < tiles)
      load_window(ti + gridDim.x, win + ((it + 1) & 1) * win_elems);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int img = ti / per_img, oh0 = (ti % per_img) * R;
    const int P = min(R, Ho - oh0) * Wo;
    int8_t* out = y + (static_cast<size_t>(img) * Ho + oh0) * Wo * Cout;
    for (int p0 = warp * 32; p0 < P; p0 += 8 * 32) {
      // Rows g and g + 8 of m-tile mt: pixels p0 + 4 g + 2 mt (+ 1).
      int base[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = min(p0 + 4 * g + 2 * mt + h, P - 1);
          const int ohl = p / Wo, ow = p - ohl * Wo;
          base[mt][h] = 2 * ohl * pitch + 2 * ow + 7 - G::kPad;
        }
      float acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < G::KC; ++kc) {
        const int k0 = s_koff[8 * kc + t], k1 = s_koff[8 * kc + t + 4];
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[mt][0] = lds32(cur + base[mt][0] + k0);
          a[mt][1] = lds32(cur + base[mt][1] + k0);
          a[mt][2] = lds32(cur + base[mt][0] + k1);
          a[mt][3] = lds32(cur + base[mt][1] + k1);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (16 * jj >= Cout) break;
          uint32_t v[4];
          ldmatrix_x4(v, s_w + brow + 16 * jj * G::kWPitch + kc * 32);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * jj], a[mt], v[0], v[1]);
            if (16 * jj + 8 < Cout)
              mma_bf16(acc[mt][2 * jj + 1], a[mt], v[2], v[3]);
          }
        }
      }
      // Bias, ReLU (ReLU6: act 2), quant to the warp's staging: pixel
      // 4 g + 2 mt + h at
      // row g + 8 (2 mt + h), so the 8 g's stores hit 8 bank groups.
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + 2 * t;
        if (n >= Cout) break;
        const float b0 = s_bias[n], b1 = s_bias[n + 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int8_t o0 = pcv::quant_i8(
                pcv::activate_i8(__fadd_rn(acc[mt][nt][2 * h], b0), act), q);
            const int8_t o1 = pcv::quant_i8(
                pcv::activate_i8(__fadd_rn(acc[mt][nt][2 * h + 1], b1), act),
                q);
            *reinterpret_cast<char2*>(
                stage + (g + 8 * (2 * mt + h)) * kStagePitch + n) =
                make_char2(o0, o1);
          }
      }
      __syncwarp();
      // The warp's pixels p0 .. p0 + 31 are 32 x Cout contiguous bytes.
      const int np = min(32, P - p0);
      const int vb = Cout % 16 == 0 ? 16 : 8, per = Cout / vb;
      for (int i = lane; i < np * per; i += 32) {
        const int pl = i / per, c = i - pl * per;
        const unsigned char* src =
            stage + (8 * (pl & 3) + (pl >> 2)) * kStagePitch + c * vb;
        int8_t* dst = out + static_cast<size_t>(p0 + pl) * Cout + c * vb;
        if (vb == 16)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      }
      __syncwarp();
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int KS>
auto pick(bool vec16) {
  return vec16 ? stem_conv_kernel<KS, true> : stem_conv_kernel<KS, false>;
}

using StemKernel = decltype(pick<7>(true));

bool stem_instance(int ksize, bool vec16, int rows, int w, StemKernel* kernel,
                   int* smem) {
  if (ksize == 7) {
    *kernel = pick<7>(vec16);
    *smem = stem_smem<7>(rows, w);
  } else if (ksize == 3) {
    *kernel = pick<3>(vec16);
    *smem = stem_smem<3>(rows, w);
  } else {
    return false;
  }
  return true;
}

// 3x3 / stride 2 / pad 1 max-pool of an int8 NHWC map, pad value -128.
// A thread owns one VB-byte channel vector of one output column and walks a
// run of output rows: output row ph takes the rows' column maxima of input
// rows 2 ph - 1, 2 ph and 2 ph + 1, and row 2 ph + 1's is kept in registers
// for output row ph + 1 (whose first row it is). Bytes are maxed four to a
// word with __vmaxs4; -128 (0x80 a byte) is the identity for an absent row
// or column. VB is 16, 8, 4 or 1 (the widest that divides C and the two
// pointers' alignment, the host's choice); a 1-byte vector is the word's
// low byte. All indices are 32-bit (the wrapper bounds the maps below
// 2^31 bytes).
template <int VB>
struct Bytes {
  static constexpr int kWords = VB >= 4 ? VB / 4 : 1;
  unsigned w[kWords];
};

template <int VB>
__device__ __forceinline__ Bytes<VB> load_bytes(const int8_t* p) {
  Bytes<VB> b;
  if constexpr (VB == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    b.w[0] = v.x; b.w[1] = v.y; b.w[2] = v.z; b.w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    b.w[0] = v.x; b.w[1] = v.y;
  } else if constexpr (VB == 4) {
    b.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    b.w[0] = static_cast<unsigned char>(__ldg(p));
  }
  return b;
}

template <int VB>
__device__ __forceinline__ void store_bytes(int8_t* p, const Bytes<VB>& b) {
  if constexpr (VB == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(b.w[0], b.w[1], b.w[2], b.w[3]);
  else if constexpr (VB == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(b.w[0], b.w[1]);
  else if constexpr (VB == 4)
    *reinterpret_cast<unsigned*>(p) = b.w[0];
  else
    *p = static_cast<int8_t>(b.w[0] & 0xff);
}

template <int VB>
__device__ __forceinline__ void vmax(Bytes<VB>& m, const Bytes<VB>& v) {
#pragma unroll
  for (int i = 0; i < Bytes<VB>::kWords; ++i) m.w[i] = __vmaxs4(m.w[i], v.w[i]);
}

template <int VB>
__device__ __forceinline__ Bytes<VB> pad_bytes() {
  Bytes<VB> b;
#pragma unroll
  for (int i = 0; i < Bytes<VB>::kWords; ++i) b.w[i] = 0x80808080u;
  return b;
}

// The max of input row ih over columns iw0 .. iw0 + 2 (those inside the map)
// of the vector at byte offset cb; -128 where the row is outside.
template <int VB>
__device__ __forceinline__ Bytes<VB> row_max(const int8_t* __restrict__ src,
                                             int img_base, int ih, int Hi,
                                             int Wi, int C, int iw0, int cb) {
  Bytes<VB> m = pad_bytes<VB>();
  if (ih < 0 || ih >= Hi) return m;
  const int8_t* row = src + img_base + ih * Wi * C + cb;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int iw = iw0 + dx;
    if (iw >= 0 && iw < Wi) vmax(m, load_bytes<VB>(row + iw * C));
  }
  return m;
}

template <int VB>
__global__ void __launch_bounds__(256)
    maxpool_i8_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                      int B, int Hi, int Wi, int Hp, int Wp, int C, int run,
                      int runs) {
  const int nv = C / VB;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * runs * Wp * nv) return;
  const int cv = idx % nv;
  idx /= nv;
  const int pw = idx % Wp;
  idx /= Wp;
  const int rr = idx % runs;
  const int b = idx / runs;
  const int ph0 = rr * run, ph1 = min(ph0 + run, Hp);
  const int cb = cv * VB, iw0 = 2 * pw - 1;
  const int img_in = b * Hi * Wi * C;
  int8_t* out = dst + ((b * Hp + ph0) * Wp + pw) * C + cb;
  Bytes<VB> prev = row_max<VB>(src, img_in, 2 * ph0 - 1, Hi, Wi, C, iw0, cb);
  for (int ph = ph0; ph < ph1; ++ph, out += Wp * C) {
    Bytes<VB> m = row_max<VB>(src, img_in, 2 * ph, Hi, Wi, C, iw0, cb);
    const Bytes<VB> next =
        row_max<VB>(src, img_in, 2 * ph + 1, Hi, Wi, C, iw0, cb);
    vmax(m, prev);
    vmax(m, next);
    store_bytes<VB>(out, m);
    prev = next;
  }
}

using PoolKernel = void (*)(const int8_t*, int8_t*, int, int, int, int, int,
                            int, int, int);

PoolKernel pool_instance(int vb) {
  switch (vb) {
    case 16: return maxpool_i8_kernel<16>;
    case 8: return maxpool_i8_kernel<8>;
    case 4: return maxpool_i8_kernel<4>;
    case 1: return maxpool_i8_kernel<1>;
    default: return nullptr;
  }
}

}  // namespace

// The stem over x (B, 3, H, W) in tiles of `rows` output rows (the host's
// plan), two persistent blocks an SM; window copies are 16 bytes where W %
// 8 == 0 and x is 16-byte aligned. act: 1 ReLU, 2 ReLU6 (MobileNetV2).
extern "C" int pcv_stem(const void* x, const void* wt, const void* bias,
                        float q, int act, int ksize, void* conv_out, int B,
                        int H, int W, int Ho, int Wo, int Cout, int rows,
                        void* stream) {
  const bool vec16 =
      W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  StemKernel kernel;
  int smem;
  if (Cout % 8 != 0 || Cout > kMaxCout || rows < 1 || act < 1 || act > 2 ||
      !stem_instance(ksize, vec16, rows, W, &kernel, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  static int sms_of[64] = {};  // SMs of each device, asked once
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sms_of[dev],
                                    cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const int sms = sms_of[dev];
  const int tiles = B * ((Ho + rows - 1) / rows);
  const int grid = tiles < 2 * sms ? tiles : 2 * sms;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const float*>(bias),
      q, act, static_cast<int8_t*>(conv_out), B, H, W, Ho, Wo, Cout, rows);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes, static and dynamic shared
// bytes of the k x k instance (16-byte or element window copies) at `rows`
// output rows a tile of an image W wide.
extern "C" int pcv_stem_info(int ksize, int vec16, int rows, int w,
                             int* out) {
  StemKernel kernel;
  int smem;
  if (!stem_instance(ksize, vec16 != 0, rows, w, &kernel, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = smem;
  return 0;
}

// The pool of src (B, Hi, Wi, C) into dst (B, Hp, Wp, C): vb-byte channel
// vectors (C % vb == 0 and both pointers vb-aligned), `run` output rows a
// thread.
extern "C" int pcv_maxpool_i8(const void* src, void* dst, int B, int Hi,
                              int Wi, int Hp, int Wp, int C, int vb, int run,
                              void* stream) {
  const PoolKernel kernel = pool_instance(vb);
  if (kernel == nullptr || C % vb != 0 || run < 1 ||
      reinterpret_cast<uintptr_t>(src) % vb != 0 ||
      reinterpret_cast<uintptr_t>(dst) % vb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int runs = (Hp + run - 1) / run;
  const long long threads_total =
      static_cast<long long>(B) * runs * Wp * (C / vb);
  if (threads_total >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  kernel<<<static_cast<unsigned>((threads_total + threads - 1) / threads),
           threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(src), static_cast<int8_t*>(dst), B, Hi, Wi,
      Hp, Wp, C, run, runs);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes of the vb-byte instance.
extern "C" int pcv_maxpool_i8_info(int vb, int* out) {
  const PoolKernel kernel = pool_instance(vb);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
