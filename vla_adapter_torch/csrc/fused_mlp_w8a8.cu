// Fused w8a8 transformer MLP for Hopper (sm_90a): the whole MLP in one
// kernel, the (M, F) intermediate never written to device memory.
//
// Replaces vla_adapter_tpu/ops/pallas_fused_mlp.py:w8a8_gated_mlp_stacked
// (kernel B2) and :w8a8_mlp_stacked (kernel B3), which share the body
// _mlp_kernel_body. Same arithmetic:
//
//   xq, rs = quantize_rows(x)                   once per token
//   for each block_f-wide panel of F:
//     g  = float(xq @ W1_panel^T) * rs * s1 (+ b1)
//     h  = act(g)                  or act(g) * (float(xq @ Wu^T) * rs * su)
//     h  = 0 in columns >= F       (the ragged tail panel)
//     hq, hs = quantize_rows(h)    per (token, panel)
//     acc += float(hq @ W2_panel^T) * hs      float32, panels in order
//   out = acc * s2 (+ b2)
//
// block_f = 512 is part of the numerics (h is re-quantized per panel), not
// a tile size. The TPU kernel walks the panels as a sequential grid axis
// with the accumulator in VMEM scratch; here one CTA owns 16 rows and walks
// the panels in a loop, with the (16, D) float32 accumulator in shared
// memory. There is no reduction across CTAs.
//
// Design. One CTA of 8 warps owns 16 rows: it quantizes its rows of x into
// shared memory once, then walks the panels in order (w8a8_mlp.cuh, the
// panel walk shared with kernel B6), its float32 accumulator (16, D) in
// shared memory; the CTA needs ~60-105 KB at the flagship shapes (16 rows x
// K int8 + 16 x D float32 + the int8 panel of h).
//
// Numerics. expf/tanhf are the CUDA math library's: they can differ from
// another implementation by an ulp, which can flip one int8 rounding of h,
// so this kernel is held to a stated tolerance against its plain version,
// not to bit-exactness.
//
// Bound on this card: the Qwen2 MLP at B=1 (M = 640) moves ~13 MB of int8
// weights and does 16.7 GOP: ~8.5 us of int8 peak against ~4 us of HBM,
// operations bound. This first version runs only ceil(M / 16) CTAs (40 at
// M = 640 on 132 SMs), each re-reading every weight from L2, with mma.sync
// and no asynchronous copies: the simple form, not the fast one.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "w8a8_mlp.cuh"

namespace {

using namespace vla_w8a8;

template <typename T, int ACT, bool GATED>
__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs = p.kpad + 64;  // xq row stride in bytes (kpad % 64 == 0)
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem);
  int8_t* hq_s = xq_s + kBM * xs;
  float* acc_s = reinterpret_cast<float*>(hq_s + kBM * kHqStride);
  float* rs_s = acc_s + kBM * p.d;
  float* hs_s = rs_s + kBM;
  float* red_s = hs_s + kBM;  // (kWarps, kBM) partial row absmax

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kBM;

  // --- quantize this CTA's rows of x once; zero the accumulator ---
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = m0 + r;
    int8_t* dst = xq_s + r * xs;
    if (row < p.m) {
      const T* xr = static_cast<const T*>(p.x) + (long long)row * p.k;
      const float scale =
          quantize_row([&](int c) { return to_float(xr[c]); }, p.k, p.kpad, dst);
      if (lane == 0) rs_s[r] = scale;
    } else {  // rows past M: zeros, never stored
      for (int c = lane; c < p.kpad; c += 32) dst[c] = 0;
      if (lane == 0) rs_s[r] = 1.0f;
    }
  }
  for (int i = threadIdx.x; i < kBM * p.d; i += kThreads) acc_s[i] = 0.0f;
  __syncthreads();

  mlp_panels<ACT, GATED>(p, xq_s, xs, rs_s, hq_s, acc_s, hs_s, red_s);

  // --- out = acc * s2 (+ b2) ---
  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < kBM * p.d; i += kThreads) {
    const int r = i / p.d;
    const int c = i % p.d;
    const int row = m0 + r;
    if (row >= p.m) continue;
    float v = __fmul_rn(acc_s[i], p.s2[c]);
    if (p.b2 != nullptr) v = __fadd_rn(v, p.b2[c]);
    from_float(out + (long long)row * p.d + c, v);
  }
}

template <typename T, int ACT, bool GATED>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = fused_mlp_kernel<T, ACT, GATED>;
  // Once per instantiation, at its first (uncaptured) launch, to the most
  // a block may use: every smaller size is then admitted, and later
  // launches, inside a CUDA graph capture too, make no attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<(p.m + kBM - 1) / kBM, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool GATED>
cudaError_t dispatch_act(const Params& p, int act, size_t smem, cudaStream_t s) {
  switch (act) {
    case kSilu: return launch<T, kSilu, GATED>(p, smem, s);
    case kGelu: return launch<T, kGelu, GATED>(p, smem, s);
    case kGeluTanh: return launch<T, kGeluTanh, GATED>(p, smem, s);
    case kQuickGelu: return launch<T, kQuickGelu, GATED>(p, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int act, size_t smem, cudaStream_t s) {
  return p.wu != nullptr ? dispatch_act<T, true>(p, act, smem, s)
                         : dispatch_act<T, false>(p, act, smem, s);
}

}  // namespace

// x (M, K) and out (M, D) in one type: bf16 (dtype 0) or f32 (1). w1/wu
// (F, K), w2 (D, F) int8; s1/su (F), s2 (D), b1 (F), b2 (D) f32; wu/su null
// for the plain MLP, b1/b2 null when absent. act: 0 silu, 1 gelu (A&S erf),
// 2 gelu_tanh, 3 quick_gelu. K % 16 == 0, F % 16 == 0, block_f a multiple of
// 64 up to 512, pointers 16-byte aligned. Returns a cudaError_t.
extern "C" int vla_fused_mlp_w8a8(
    const void* x, const void* w1, const void* s1, const void* wu,
    const void* su, const void* b1, const void* w2, const void* s2,
    const void* b2, void* out, int m, int k, int f, int d, int block_f,
    int act, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || f <= 0 || d <= 0 || k % 16 || f % 16 ||
      block_f <= 0 || block_f % 64 || block_f > kMaxPanel)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w1 = static_cast<const int8_t*>(w1);
  p.s1 = static_cast<const float*>(s1);
  p.wu = static_cast<const int8_t*>(wu);
  p.su = static_cast<const float*>(su);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.out = out;
  p.m = m;
  p.k = k;
  p.f = f;
  p.d = d;
  p.block_f = block_f;
  p.kpad = (k + 63) / 64 * 64;
  const size_t smem = static_cast<size_t>(kBM) * (p.kpad + 64) +
                      static_cast<size_t>(kBM) * kHqStride +
                      sizeof(float) * (static_cast<size_t>(kBM) * d + 2 * kBM + kWarps * kBM);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<__nv_bfloat16>(p, act, smem, s);
    case 1: return dispatch<float>(p, act, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
