// K13: the pre-activation stream step of the int8 PreResNet pipeline.
//
// Replaces: no Pallas kernel. On the TPU, XLA fused these elementwise
//   steps of pytorchcv_tpu/quant/preresnet_int8.py:_forward: the SE gate's
//   product (:171-173, resnet_int8.py:_se_gate's cast), the bf16 stream
//   add r' = bf16(t + id) (:181), and the next unit's pre-activation,
//   pre = quant(max(f32(r') * g + b, 0)) (:157, _pre_quant). The port needs
//   a kernel of its own for them: plain PyTorch would take six passes over
//   the map where this takes one.
//
// Computes, per element of t (B, H, W, C), f32 or bf16:
//   v = f32(t); with the gate (B, C) f32: v = bf16(f32(bf16(v)) * gate);
//   with an identity (bf16 or f32, t's shape): r = bf16(v + f32(id)),
//   written; without one, r = v (t is then the bf16 stream itself, the
//   stem's pooled map into unit 1); with (g, b): pre = clip(rint(max(r * g
//   + b, 0) * q), +-127), written as int8 (not after the last unit). Each
//   step is one f32 rounding spelled __fmul_rn / __fadd_rn / rintf in the
//   JAX op order, so the kernel is bit-exact against its plain version.
//
// Bound on the H100: bytes. Per element t's 4 or 2 bytes and the
//   identity's 2 or 4 are read, r's 2 and pre's 1 written, against at most
//   6 f32 operations: a call's bound is its bytes over 3.35 TB/s.
// Design: one pass, a thread takes 8 channels of one pixel: 16- or 32-byte
//   loads of t and of the identity, the 8 gate values and the 8 g and b
//   from L1 (they are B x C and C floats), a 16-byte store of r and an
//   8-byte store of pre; grid-stride over the tensor. Where C % 8 != 0 or
//   a pointer is not 16-byte aligned, a thread takes one element.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// What an identity operand is.
enum IdMode { kIdNone = 0, kIdBf16 = 1, kIdF32 = 2 };

struct Args {
  const void* t;
  int t_bf16;
  const float* gate;
  const void* id;
  int id_mode;
  const float* g;
  const float* b;
  float q;
  __nv_bfloat16* r_out;
  int8_t* pre_out;
  size_t total;
  int C;
  size_t HWC;
};

__device__ __forceinline__ float bf16_bits(uint32_t w, int hi) {
  return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}

// The step of one element: its t, gate, identity; returns r and writes
// nothing.
__device__ __forceinline__ float step(float v, float gv, float idv,
                                        const Args& a) {
  if (a.gate != nullptr)
    v = pcv::round_bf16(__fmul_rn(pcv::round_bf16(v), gv));
  if (a.id_mode != kIdNone) v = pcv::round_bf16(__fadd_rn(v, idv));
  return v;
}

__device__ __forceinline__ int8_t pre_of(float r, float g, float b, float q) {
  return pcv::quant_i8(fmaxf(__fadd_rn(__fmul_rn(r, g), b), 0.f), q);
}

// One element a thread.
__global__ void __launch_bounds__(kThreads) preact_scalar_kernel(Args a) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < a.total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % a.C);
    const float v = a.t_bf16
                        ? __bfloat162float(
                              static_cast<const __nv_bfloat16*>(a.t)[i])
                        : static_cast<const float*>(a.t)[i];
    const float gv = a.gate != nullptr ? a.gate[i / a.HWC * a.C + c] : 0.f;
    float idv = 0.f;
    if (a.id_mode == kIdBf16)
      idv = __bfloat162float(static_cast<const __nv_bfloat16*>(a.id)[i]);
    else if (a.id_mode == kIdF32)
      idv = static_cast<const float*>(a.id)[i];
    const float r = step(v, gv, idv, a);
    if (a.r_out != nullptr) a.r_out[i] = __float2bfloat16_rn(r);
    if (a.pre_out != nullptr) a.pre_out[i] = pre_of(r, a.g[c], a.b[c], a.q);
  }
}

// 8 f32 values from 8 bf16 (16 bytes) or 8 f32 (32 bytes).
__device__ __forceinline__ void load8(const void* base, size_t i, int bf16,
                                      float (&v)[8]) {
  if (bf16) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = bf16_bits(w[k / 2], k & 1);
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + i);
    const float4 lo = p[0], hi = p[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
}

__device__ __forceinline__ void load8f(const float* p, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// 8 channels a thread (C % 8 == 0, every pointer 16-byte aligned).
__global__ void __launch_bounds__(kThreads) preact_vec8_kernel(Args a) {
  const size_t vecs = a.total / 8;
  for (size_t vi = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       vi < vecs; vi += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t i = vi * 8;
    const int c = static_cast<int>(i % a.C);
    float v[8], gv[8], idv[8];
    load8(a.t, i, a.t_bf16, v);
    if (a.gate != nullptr) load8f(a.gate + i / a.HWC * a.C + c, gv);
    if (a.id_mode != kIdNone) load8(a.id, i, a.id_mode == kIdBf16, idv);
    float r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      r[k] = step(v[k], a.gate != nullptr ? gv[k] : 0.f,
                  a.id_mode != kIdNone ? idv[k] : 0.f, a);
    if (a.r_out != nullptr) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 p2 =
            __floats2bfloat162_rn(r[2 * k], r[2 * k + 1]);
        w[k] = *reinterpret_cast<const uint32_t*>(&p2);
      }
      *reinterpret_cast<uint4*>(a.r_out + i) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (a.pre_out != nullptr) {
      float g[8], b[8];
      load8f(a.g + c, g);
      load8f(a.b + c, b);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                        pre_of(r[k], g[k], b[k], a.q))) << (8 * (k & 3));
      *reinterpret_cast<uint2*>(a.pre_out + i) = make_uint2(w[0], w[1]);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// t (B, H, W, C) f32 or bf16 (t_bf16); gate null or (B, C) f32; id null
// (id_mode 0), bf16 (1) or f32 (2) of t's shape; g, b null or f32 (C,);
// r_out null or bf16 of t's shape; pre_out null or int8 of t's shape.
extern "C" int pcv_preact(const void* t, int t_bf16, const void* gate,
                          const void* id, int id_mode, const void* g,
                          const void* b, float q, void* r_out, void* pre_out,
                          int B, int HW, int C, void* stream) {
  if (id_mode < kIdNone || id_mode > kIdF32 || B <= 0 || HW <= 0 || C <= 0 ||
      (id_mode == kIdNone) != (id == nullptr) ||
      (pre_out != nullptr && (g == nullptr || b == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.t = t;
  a.t_bf16 = t_bf16;
  a.gate = static_cast<const float*>(gate);
  a.id = id;
  a.id_mode = id_mode;
  a.g = static_cast<const float*>(g);
  a.b = static_cast<const float*>(b);
  a.q = q;
  a.r_out = static_cast<__nv_bfloat16*>(r_out);
  a.pre_out = static_cast<int8_t*>(pre_out);
  a.HWC = static_cast<size_t>(HW) * C;
  a.total = static_cast<size_t>(B) * a.HWC;
  a.C = C;
  const void* ptrs[] = {t, gate, id, g, b, r_out, pre_out};
  bool vec = C % 8 == 0;
  for (const void* p : ptrs) vec = vec && (p == nullptr || aligned16(p));
  const size_t work = vec ? a.total / 8 : a.total;
  const unsigned blocks = static_cast<unsigned>(
      work < static_cast<size_t>(132) * 16 * kThreads
          ? (work + kThreads - 1) / kThreads
          : static_cast<size_t>(132) * 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    preact_vec8_kernel<<<blocks, kThreads, 0, s>>>(a);
  else
    preact_scalar_kernel<<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread and local (spill) bytes of the vector (vec) or
// scalar instance.
extern "C" int pcv_preact_info(int vec, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = vec
      ? cudaFuncGetAttributes(&attr, preact_vec8_kernel)
      : cudaFuncGetAttributes(&attr, preact_scalar_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
