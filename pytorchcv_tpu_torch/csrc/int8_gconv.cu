// K2 grouped: int8 NHWC grouped convolution with K2's fused epilogue.
//
// Replaces: the XLA grouped conv_general_dilated of
//   pytorchcv_tpu/quant/resnet_int8.py:_conv_i8 (feature_group_count, :57-62)
//   and the block-diagonal merge of _merge_grouped_weights (:144), with the
//   _cell epilogue. It serves ResNeXt's, SE-ResNeXt's and SENet's grouped
//   3x3 (per-group input widths cg = Cin / groups in {2, 4, 8, 16, 32},
//   og = Cout / groups any even width: cg or 2 cg on those paths), stride 1
//   and 2, any odd k and dilation.
//
// Bound on the H100: the 16 grouped convs of ResNeXt-50 at batch 128 move
//   0.84 GB (0.25 ms at 3.35 TB/s) for 60 G useful int8 operations (0.03 ms
//   at the int8 peak): bytes.
// Design: an implicit GEMM on the int8 tensor cores (mma.sync m16n8k32 s8 x
//   s8 -> s32, exact sums) over block-diagonal tiles. A block owns BN output
//   channels (a channel tile) and walks spatial tiles of imgs images x th
//   output rows x tw output columns (<= BM pixels; the host's plan,
//   kernels/int8_conv.py:gconv_plan), persistent over a grid the SMs hold.
//   Each n8 tile of 8 output channels meets only the window of input
//   channels of its own groups (wb = 8-32 bytes from a 4-channel boundary;
//   runs of U n8 tiles in one group share it). Per spatial tile the block
//   copies the input halo into shared memory window-major: one slab per
//   window, wb bytes a halo pixel (cp.async of 8 or 16 bytes, zeros at the
//   image border), so every tap reads shared memory and a tap's window at a
//   pixel is 8-byte pieces.
//   K is not taps x Cin: an n8 tile's K sequence is (tap, 8-byte piece of
//   its window), 4 pieces to a k32 chunk, lane t of the mma holding piece t
//   of the chunk as its two A (and B) words, so A is one 64-bit shared load
//   a row. At cg 4 (wb 8) 9 taps are 3 chunks, not 9 chunks of 32 channels;
//   only those (n8, k32) pairs are issued. The block builds, once, from its
//   rows of the compact (Cout, k, k, cg) weights: B fragments of every (n8
//   tile, chunk) in mma register order, zero off the groups' diagonal, and
//   each piece's offset into the halo.
//   Products issued over useful: 8 / 3 at cg 4 (1.33 x the padding of 9
//   taps to 12), 4 / 3 at cg 8, 10 / 9 at cg 16, 1 at cg 32.
//   The epilogue stages the int32 tile over the halo and runs the dense
//   kernel's (int8_epilogue.cuh) 8 channels a thread, step for step, so the
//   output is bit-exact against the plain version.
#include <algorithm>

#include "int8_epilogue.cuh"

namespace {

using pcv::cp_async16;
using pcv::cp_async4;
using pcv::cp_async_commit;
using pcv::cp_async_wait;
using pcv::mma_s8;
using pcv::smem_addr;

constexpr int kThreads = 256;  // 8 warps

// 8 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

struct GArgs {
  const int8_t* x;
  const int8_t* w;
  const float* gain_a;
  const float* bias_b;
  const void* res;
  void* out;
  __nv_bfloat16* out_bf16;
  float res_scale, q;
  int res_mode, act, out_mode, vec_out;
  int N, H, W, Cin, Ho, Wo, Cout, KS, stride, pad, dil, cg, og;
  // the plan: a spatial tile, the halo's copy width (16, 8, 4 or 1 bytes)
  // and window bytes a pixel
  int imgs, th, tw, vec, wb;
  // derived: halo rows and columns, its slabs' stride, k32 chunks, tile
  // counts, grid stride, the region's bytes
  int HR, HC, slab, CH, n_ct, n_tw, n_th, n_sp, g_sp, region;
};

// Warps over the block: 128 x 128 -> 2 x 4 warps of 64 x 32; 128 x 64 and
// 64 x 64 -> 4 x 2 of 32 x 32 and 16 x 32; 64 x 128 -> 2 x 4 of 32 x 32.
// Every warp owns 4 n8 tiles.
template <int BM, int BN>
struct Layout {
  static constexpr int WARPS_N = BN == 128 ? 4 : 2;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int MT = BM / WARPS_M / 16;
  static constexpr int NT = BN / WARPS_N / 8;
};

// Dynamic shared bytes: the tables (per n8 tile and chunk: 4 piece offsets,
// 32 B-fragment pairs), the region (the block's weight rows, then each
// tile's halo, then its int32 output tile), A and B per channel, a row
// table (16 bytes a pixel row of the block tile).
__host__ __device__ constexpr int tables_bytes(int bn, int ch) {
  return bn * ch * 34;
}

// A halo slab's stride: its pixels' windows, padded to 16 bytes past a
// multiple of 128, so that the slabs' copies of one pixel spread over the
// banks and every 16-byte copy stays aligned.
__host__ __device__ constexpr int slab_bytes(int pixels, int wb) {
  return (pixels * wb + 111) / 128 * 128 + 16;
}

// The 4 bytes of a weight row (k*k taps of cg bytes) at tap and input
// channels ch0..ch0+3, zero off the row's group (its first channel base).
__device__ __forceinline__ uint32_t weight_word(const int8_t* row, int tap,
                                               int ch0, int base, int cg) {
  row += tap * cg;
  if (cg % 4 == 0)   // a word lies wholly in or out of the group
    return ch0 >= base && ch0 < base + cg
               ? *reinterpret_cast<const uint32_t*>(row + ch0 - base)
               : 0u;
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int c = ch0 + b - base;
    if (c >= 0 && c < cg)
      word |= static_cast<uint32_t>(static_cast<uint8_t>(row[c])) << (8 * b);
  }
  return word;
}

template <int BM, int BN, int U>
__global__ void __launch_bounds__(kThreads, 2)
    int8_gconv_kernel(const GArgs p) {
  using L = Layout<BM, BN>;
  constexpr int MT = L::MT, NT = L::NT, NB = BN / 8, NW = NB / U;
  constexpr int SP = BN + 8;          // output tile's row pitch (int32)
  static_assert(NT % U == 0, "runs of U n8 tiles");
  extern __shared__ __align__(128) int8_t smem[];
  const int CH = p.CH, KK = p.KS * p.KS;
  int* s_off = reinterpret_cast<int*>(smem);
  uint2* s_bt = reinterpret_cast<uint2*>(smem + BN * CH * 2);
  int8_t* region = smem + tables_bytes(BN, CH);
  float* s_a = reinterpret_cast<float*>(region + p.region);
  float* s_b = s_a + BN;
  int4* s_rows = reinterpret_cast<int4*>(s_b + BN);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x % p.n_ct * BN;
  const int per_tile = p.imgs * p.th * p.tw;
  for (int i = tid; i < BN; i += kThreads) {
    const int n = n0 + i;
    s_a[i] = n < p.Cout ? p.gain_a[n] : 0.f;
    s_b[i] = n < p.Cout ? p.bias_b[n] : 0.f;
  }
  // Every tile's rows alike: pixel offset (im * Ho + ohl) * Wo + owl from
  // the tile's first, image, row and column; rows past the tile never
  // valid.
  for (int r = tid; r < BM; r += kThreads) {
    const int im = r / (p.th * p.tw), rem = r % (p.th * p.tw);
    const int ohl = rem / p.tw, owl = rem % p.tw;
    s_rows[r] = r < per_tile ? make_int4((im * p.Ho + ohl) * p.Wo + owl, im,
                                         ohl, owl)
                             : make_int4(0, 1 << 28, 0, 0);
  }

  // ---- the block's weight rows (contiguous in w; n0 * k*k*cg is a
  // multiple of 16), each output's group base and each piece's (tap, half)
  // with its offset in a slab, then the tables.
  const int rowb = KK * p.cg, ppt = p.wb / 8;
  int2* s_piece = reinterpret_cast<int2*>(region + (BN * rowb + 15) / 16 * 16);
  int* s_base = reinterpret_cast<int*>(s_piece + 4 * CH);
  {
    const int bytes = min(BN, p.Cout - n0) * rowb;
    const int8_t* src = p.w + static_cast<size_t>(n0) * rowb;
    for (int i = tid; i < bytes / 16; i += kThreads)
      cp_async16(region + 16 * i, src + 16 * i, 16);
    cp_async_commit();
    for (int i = bytes / 16 * 16 + tid; i < bytes; i += kThreads)
      region[i] = src[i];
    for (int e = tid; e < 4 * CH; e += kThreads) {
      const int tap = e / ppt, half = e % ppt;
      s_piece[e] = tap < KK ? make_int2((tap / p.KS * p.HC + tap % p.KS) *
                                            p.dil * p.wb + 8 * half,
                                        tap << 8 | half)
                            : make_int2(0, -1);    // padding: B zero
    }
    for (int i = tid; i < BN; i += kThreads)
      s_base[i] = n0 + i < p.Cout ? (n0 + i) / p.og * p.cg : 0;
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int jc = warp; jc < NB * CH; jc += kThreads / 32) {
    const int j = jc / CH, c = jc - j * CH;
    const int jr = j / U, n = n0 + 8 * j + g;
    // the run's window: from its first group's channel, down to 4
    const int lo = n0 + 8 * jr * U < p.Cout ? s_base[8 * jr * U] & ~3 : 0;
    const int2 pc = s_piece[c * 4 + t];
    uint32_t bw[2] = {0u, 0u};
    if (pc.y >= 0 && n < p.Cout) {
      const int8_t* row = region + (n - n0) * rowb;
      const int ch0 = lo + 8 * (pc.y & 255), tap = pc.y >> 8;
      bw[0] = weight_word(row, tap, ch0, s_base[n - n0], p.cg);
      bw[1] = weight_word(row, tap, ch0 + 4, s_base[n - n0], p.cg);
    }
    s_bt[jc * 32 + lane] = make_uint2(bw[0], bw[1]);
    if (g == 0) s_off[jc * 4 + t] = jr * p.slab + pc.x;
  }

  // Each lane's two rows (g, g + 8) of its m16 tiles: their halo pixel at
  // tap (0, 0) in a slab, alike in every tile; rows past the tile read
  // pixel 0 and are dropped.
  const int wm = warp / L::WARPS_N, wn = warp % L::WARPS_N;
  int rb[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + mt) * 16 + g + 8 * h;
      const int im = r / (p.th * p.tw), rem = r % (p.th * p.tw);
      rb[mt][h] = r < per_tile ? ((im * p.HR + rem / p.tw * p.stride) * p.HC +
                                  rem % p.tw * p.stride) * p.wb
                               : 0;
    }
  // The halo's copies: thread tid takes copy `piece` of window jw of pixels
  // px0, px0 + pstep, ... (pieces fastest, then windows: a pixel's channels
  // in order); its first pixel's column, row and image, decoded once.
  const int ppw = p.wb / p.vec, group = NW * ppw;   // a power of 2
  const int piece = tid % ppw, jw = tid / ppw % NW;
  const int px0 = tid / group, pstep = kThreads / group;
  const int HP = p.imgs * p.HR * p.HC;
  const int hc0 = px0 % p.HC, hr0 = px0 / p.HC % p.HR;
  const int im0 = px0 / p.HC / p.HR;
  const int c_in = (n0 + 8 * jw * U < p.Cout ? s_base[8 * jw * U] & ~3 : 0) +
                   piece * p.vec;
  int8_t* const dst0 = region + jw * p.slab + piece * p.vec;
  // This thread's 8 epilogue channels, alike in every item (256 is a
  // multiple of NB).
  const int cb = tid % NB;
  __syncthreads();

  for (int sp = blockIdx.x / p.n_ct; sp < p.n_sp; sp += p.g_sp) {
    const int ctw = sp % p.n_tw, rest = sp / p.n_tw;
    const int img0 = rest / p.n_th * p.imgs;
    const int oh0 = rest % p.n_th * p.th, ow0 = ctw * p.tw;
    const int ih0 = oh0 * p.stride - p.pad, iw0 = ow0 * p.stride - p.pad;

    // ---- the halo: NW slabs of imgs x HR x HC pixels' windows, zeros
    // outside the images and past Cin.
    {
      // The row of the current pixel: whether it lies in an image, and
      // its first pixel in x; recomputed only when the row changes.
      int hc = hc0, hr = hr0, im = im0;
      bool row_in;
      const int8_t* row;
      auto at_row = [&]() {
        const int img = img0 + im, ih = ih0 + hr;
        row_in = img < p.N &&
                 static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                 c_in < p.Cin;
        row = p.x + ((static_cast<size_t>(row_in ? img : 0) * p.H +
                      (row_in ? ih : 0)) * p.W + iw0) * p.Cin + c_in;
      };
      at_row();
      int8_t* dst = dst0 + px0 * p.wb;
      for (int px = px0; px < HP; px += pstep, dst += pstep * p.wb) {
        const bool in = row_in && static_cast<unsigned>(iw0 + hc) <
                                      static_cast<unsigned>(p.W);
        const int8_t* src = in ? row + hc * p.Cin : p.x;
        if (p.vec == 16)
          cp_async16(dst, src, in ? 16 : 0);
        else if (p.vec == 8)
          cp_async8(dst, src, in ? 8 : 0);
        else if (p.vec == 4)
          cp_async4(dst, src, in ? 4 : 0);
        else
          *dst = in ? *src : 0;
        hc += pstep;
        if (hc >= p.HC) {
          do {
            hc -= p.HC;
            if (++hr == p.HR) {
              hr = 0;
              ++im;
            }
          } while (hc >= p.HC);
          at_row();
        }
      }
    }
    cp_async_commit();
    int acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    cp_async_wait<0>();
    __syncthreads();

    // ---- the products: per k32 chunk and run of U n8 tiles (one window),
    // the offset of piece t and the U B fragments, then per m16 tile two
    // 64-bit loads of A (rows g and g + 8) and U mma.
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int v = 0; v < NT / U; ++v) {
        const int j = wn * NT + v * U;
        const int off = s_off[(j * CH + c) * 4 + t];
        uint2 bb[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          bb[u] = s_bt[((j + u) * CH + c) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if ((wm * MT + mt) * 16 >= per_tile) continue;
          const uint2 lo =
              *reinterpret_cast<const uint2*>(region + rb[mt][0] + off);
          const uint2 hi =
              *reinterpret_cast<const uint2*>(region + rb[mt][1] + off);
          const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
          for (int u = 0; u < U; ++u)
            mma_s8(acc[mt][v * U + u], a, bb[u].x, bb[u].y);
        }
      }
    }
    __syncthreads();

    // ---- the epilogue: the int32 tile over the halo, then row by row, 8
    // channels a thread (the dense kernel's).
    int* tile = reinterpret_cast<int*>(region);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = (wm * MT + mt) * 16 + g;
        const int cc = (wn * NT + nt) * 8 + 2 * t;
        *reinterpret_cast<int2*>(tile + r * SP + cc) =
            make_int2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<int2*>(tile + (r + 8) * SP + cc) =
            make_int2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    __syncthreads();
    const float4 a0 = reinterpret_cast<const float4*>(s_a + cb * 8)[0];
    const float4 a1 = reinterpret_cast<const float4*>(s_a + cb * 8)[1];
    const float4 b0 = reinterpret_cast<const float4*>(s_b + cb * 8)[0];
    const float4 b1 = reinterpret_cast<const float4*>(s_b + cb * 8)[1];
    const int n = n0 + cb * 8, cnt = min(8, p.Cout - n);
    const size_t mbase = (static_cast<size_t>(img0) * p.Ho + oh0) * p.Wo + ow0;
    const int sw = (cb >> 2) & 1;
    for (int r = tid / NB; r < BM; r += kThreads / NB) {
      const int4 row = s_rows[r];
      if (img0 + row.y >= p.N || oh0 + row.z >= p.Ho ||
          ow0 + row.w >= p.Wo || n >= p.Cout)
        continue;
      const size_t idx = (mbase + row.x) * p.Cout + n;
      const int4* src = reinterpret_cast<const int4*>(tile + r * SP + cb * 8);
      const int4 h0 = src[sw], h1 = src[sw ^ 1];
      pcv::epilogue8(sw ? h1 : h0, sw ? h0 : h1, a0, a1, b0, b1, nullptr,
                     idx, cnt, p.vec_out && cnt == 8, p.res, p.res_scale,
                     p.res_mode, p.act, p.q, p.out_mode, p.out, p.out_bf16);
    }
    __syncthreads();
  }
}

using GKernel = void (*)(const GArgs);

template <int BM, int BN>
GKernel pick_u(int u) {
  if (u == 1) return int8_gconv_kernel<BM, BN, 1>;
  if (u == 2) return int8_gconv_kernel<BM, BN, 2>;
  if (u == 4) return int8_gconv_kernel<BM, BN, 4>;
  return nullptr;
}

// The instance of a block tile and a run length (nullptr if none).
GKernel instance(int bm, int bn, int u) {
  if (bm == 128 && bn == 128) return pick_u<128, 128>(u);
  if (bm == 128 && bn == 64) return pick_u<128, 64>(u);
  if (bm == 64 && bn == 128) return pick_u<64, 128>(u);
  if (bm == 64 && bn == 64) return pick_u<64, 64>(u);
  return nullptr;
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace

// One grouped conv (groups > 1) under the host's plan (bm x bn block tile,
// runs of u n8 tiles sharing a window, spatial tile imgs x th x tw, copy
// width vec, window bytes wb). Checks that every n8 tile's groups lie in
// its run's window, the copies fit, and the block fits in shared memory;
// x and w 16-byte aligned.
extern "C" int pcv_int8_gconv(
    const void* x, const void* w, const void* gain_a, const void* bias_b,
    const void* res, float res_scale, int res_mode, int act, float q,
    int out_mode, void* out, void* out_bf16, int N, int H, int W, int Cin,
    int Ho, int Wo, int Cout, int KS, int stride, int pad, int dilation,
    int groups, int bm, int bn, int u, int imgs, int th, int tw, int vec,
    int wb, void* stream) {
  const GKernel kernel = instance(bm, bn, u);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (kernel == nullptr || groups < 2 || Cin % groups || Cout % groups ||
      !aligned(x, 16) || !aligned(w, 16) || imgs < 1 || th < 1 || tw < 1 ||
      imgs * th * tw > bm || (imgs > 1 && (th < Ho || tw < Wo)) ||
      !(vec == 16 || vec == 8 || vec == 4 || vec == 1) ||
      (vec > 1 && Cin % vec) || wb < 8 || wb % 8 || wb % vec || wb > 2040)
    return bad;
  const int nw = bn / 8 / u, group = nw * (wb / vec);
  if (group > kThreads || kThreads % group) return bad;
  GArgs p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.gain_a = static_cast<const float*>(gain_a);
  p.bias_b = static_cast<const float*>(bias_b);
  p.res = res;
  p.out = out;
  p.out_bf16 = static_cast<__nv_bfloat16*>(out_bf16);
  p.res_scale = res_scale;
  p.q = q;
  p.res_mode = res_mode;
  p.act = act;
  p.out_mode = out_mode;
  p.vec_out = Cout % 8 == 0 && aligned(out, 16) &&
              (res == nullptr || aligned(res, 16)) &&
              (out_bf16 == nullptr || aligned(out_bf16, 16));
  p.N = N; p.H = H; p.W = W; p.Cin = Cin; p.Ho = Ho; p.Wo = Wo;
  p.Cout = Cout; p.KS = KS; p.stride = stride; p.pad = pad;
  p.dil = dilation; p.cg = Cin / groups; p.og = Cout / groups;
  p.imgs = imgs; p.th = th; p.tw = tw; p.vec = vec; p.wb = wb;
  // every n8 tile's groups inside its run's window, each window's copies
  // aligned
  for (int n0 = 0; n0 < Cout; n0 += bn)
    for (int nj = n0; nj < n0 + bn && nj < Cout; nj += 8) {
      const int run = n0 + (nj - n0) / (8 * u) * 8 * u;
      const int lo = run / p.og * p.cg & ~3;
      const int hi = ((min(nj + 8, Cout) - 1) / p.og + 1) * p.cg;
      if (nj / p.og * p.cg < lo || hi > lo + wb || (vec > 1 && lo % vec))
        return bad;
    }
  p.HR = (th - 1) * stride + (KS - 1) * dilation + 1;
  p.HC = (tw - 1) * stride + (KS - 1) * dilation + 1;
  p.slab = slab_bytes(imgs * p.HR * p.HC, wb);
  p.CH = (KS * KS * (wb / 8) + 3) / 4;
  p.n_ct = (Cout + bn - 1) / bn;
  p.n_tw = (Wo + tw - 1) / tw;
  p.n_th = (Ho + th - 1) / th;
  p.n_sp = (N + imgs - 1) / imgs * p.n_th * p.n_tw;
  const long halo = static_cast<long>(nw) * p.slab;
  // the weight rows, then each piece's tap and each output's group
  const long wrows = (static_cast<long>(bn) * KS * KS * p.cg + 15) / 16 * 16 +
                     32 * p.CH + 4 * bn;
  const long otile = static_cast<long>(bm) * (bn + 8) * 4;
  const long region = (std::max(std::max(halo, wrows), otile) + 15) / 16 * 16;
  const long smem = tables_bytes(bn, p.CH) + region + 8 * bn + 16 * bm;
  if (smem > 227 * 1024) return bad;
  p.region = static_cast<int>(region);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return bad;
  p.g_sp = std::max(1, std::min(p.n_sp, per_sm * sm_count() / p.n_ct));
  kernel<<<p.n_ct * p.g_sp, kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes, static shared bytes of the
// instance (bm, bn, u), and the blocks an SM holds at `smem` dynamic bytes.
extern "C" int pcv_int8_gconv_info(int bm, int bn, int u, int smem,
                                   int* out) {
  const GKernel kernel = instance(bm, bn, u);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = per_sm;
  return 0;
}
