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
// Design. 8 warps. Weights are int8 in the PyTorch (out, in) layout: W1/Wu
// (F, K), W2 (D, F), so both mma.sync.m16n8k32 operands are K-contiguous.
// The CTA quantizes its 16 rows of x into shared memory once. Up phase:
// warp w owns panel columns [64w, 64w + 64), eight n8 tiles, and reads its
// weight fragments straight from global memory (each is used by exactly one
// mma in the CTA, so staging them through shared memory would buy nothing),
// 16 contiguous bytes per thread per 64 k. It dequantizes, applies the
// activation and keeps its 16 x 64 slice of h in registers; the row absmax
// of the panel is reduced across warps through shared memory, then each
// warp writes its int8 slice of hq to shared memory. Down phase: the warps
// split D into n8 tiles, accumulate the panel's int32 product over the
// panel's k, and add float(part) * hs to the accumulator. A (16 x 512)
// float32 panel of h would need 32 KB of shared memory; holding it in
// registers and staging only the int8 hq (9 KB) keeps the CTA at ~60-105 KB
// at the flagship shapes (16 rows x K int8 + 16 x D float32 + hq).
//
// Numerics. __fmul_rn / __fadd_rn / __fdiv_rn keep every product, sum and
// quotient a separate rounding (nvcc would contract a*b + c into an FMA),
// rintf rounds half to even like jnp.round, and "gelu" is the A&S 7.1.26
// erf polynomial of the TPU kernel (_erf), not erff. expf/tanhf are the
// CUDA math library's: they can differ from another implementation by an
// ulp, which can flip one int8 rounding of h, so this kernel is held to a
// stated tolerance against its plain version, not to bit-exactness.
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

namespace {

constexpr int kBM = 16;       // rows per CTA (one m16 tile)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPanel = 512;
constexpr int kHqStride = kMaxPanel + 64;  // bytes per hq row in shared memory
constexpr int kMaxSmem = 232448;            // shared memory a block may use

enum Act { kSilu = 0, kGelu = 1, kGeluTanh = 2, kQuickGelu = 3 };

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two k32 products over 64 bytes of k: thread (g, t) holds bytes
// [16t, 16t + 16) of rows g / g + 8 (a_lo / a_hi) and of column g (b).
__device__ __forceinline__ void mma_k64(int (&c)[4], const uint4& a_lo,
                                        const uint4& a_hi, const uint4& b) {
  mma_s8(c, a_lo.x, a_hi.x, a_lo.y, a_hi.y, b.x, b.y);
  mma_s8(c, a_lo.z, a_hi.z, a_lo.w, a_hi.w, b.z, b.w);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float* o, float v) { *o = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// clip(round_half_even(v / scale), -127, 127)
__device__ __forceinline__ int8_t quant(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// max(absmax, 1e-8) / 127
__device__ __forceinline__ float row_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-8f), 127.0f);
}

// 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// erf by Abramowitz & Stegun 7.1.26, the TPU kernel's _erf, op for op.
__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float a = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, a)));
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fadd_rn(0.254829592f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  return __fmul_rn(s, __fsub_rn(1.0f, __fmul_rn(poly, expf(__fmul_rn(-a, a)))));
}

template <int ACT>
__device__ __forceinline__ float activation(float x) {
  if (ACT == kSilu) return __fmul_rn(x, sigmoid(x));
  if (ACT == kGelu)  // 0.5 x (1 + erf(x 2^-0.5))
    return __fmul_rn(__fmul_rn(0.5f, x),
                     __fadd_rn(1.0f, erf_as(__fmul_rn(x, 0.70710678118654752f))));
  if (ACT == kGeluTanh) {  // x (0.5 (1 + tanh(c (x + 0.044715 x^3))))
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float inner = __fmul_rn(0.79788456080286536f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
    return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
  }
  return __fmul_rn(x, sigmoid(__fmul_rn(1.702f, x)));  // quick_gelu
}

struct Params {
  const void* x;      // (M, K) T
  const int8_t* w1;   // (F, K)  gate or fc1
  const float* s1;    // (F)
  const int8_t* wu;   // (F, K)  up, gated only
  const float* su;    // (F)
  const float* b1;    // (F) or null
  const int8_t* w2;   // (D, F)  down or fc2
  const float* s2;    // (D)
  const float* b2;    // (D) or null
  void* out;          // (M, D) T
  int m, k, f, d, block_f, kpad;
};

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
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = blockIdx.x * kBM;

  // --- quantize this CTA's rows of x once; zero the accumulator ---
  for (int r = warp; r < kBM; r += kWarps) {
    const int row = m0 + r;
    int8_t* dst = xq_s + r * xs;
    if (row < p.m) {
      const T* xr = static_cast<const T*>(p.x) + (long long)row * p.k;
      float amax = 0.0f;
      for (int c = lane; c < p.k; c += 32) amax = fmaxf(amax, fabsf(to_float(xr[c])));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float scale = row_scale(amax);
      for (int c = lane; c < p.kpad; c += 32)
        dst[c] = c < p.k ? quant(to_float(xr[c]), scale) : int8_t(0);
      if (lane == 0) rs_s[r] = scale;
    } else {  // rows past M: zeros, never stored
      for (int c = lane; c < p.kpad; c += 32) dst[c] = 0;
      if (lane == 0) rs_s[r] = 1.0f;
    }
  }
  for (int i = threadIdx.x; i < kBM * p.d; i += kThreads) acc_s[i] = 0.0f;
  __syncthreads();

  const float rs_lo = rs_s[g], rs_hi = rs_s[g + 8];
  const int8_t* xa_lo = xq_s + g * xs + 16 * t;
  const int8_t* xa_hi = xq_s + (g + 8) * xs + 16 * t;
  const int ntiles = (p.d + 7) / 8;

  for (int f0 = 0; f0 < p.f; f0 += p.block_f) {
    // --- up phase: h for this warp's 64 panel columns ---
    float h[8][4];
    float am_lo = 0.0f, am_hi = 0.0f;
    const bool active = warp * 64 < p.block_f;
    if (active) {
      const int nb = f0 + warp * 64;
      int ag[8][4], au[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) ag[j][i] = au[j][i] = 0;
      for (int k0 = 0; k0 < p.k; k0 += 64) {
        const uint4 a_lo = *reinterpret_cast<const uint4*>(xa_lo + k0);
        const uint4 a_hi = *reinterpret_cast<const uint4*>(xa_hi + k0);
        const bool kin = k0 + 16 * t < p.k;  // K % 16 == 0: whole chunks
        uint4 bg[8], bu[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = nb + 8 * j + g;
          const bool ok = kin && n < p.f;
          const long long off = (long long)n * p.k + k0 + 16 * t;
          bg[j] = ok ? *reinterpret_cast<const uint4*>(p.w1 + off) : make_uint4(0, 0, 0, 0);
          if (GATED)
            bu[j] = ok ? *reinterpret_cast<const uint4*>(p.wu + off) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mma_k64(ag[j], a_lo, a_hi, bg[j]);
          if (GATED) mma_k64(au[j], a_lo, a_hi, bu[j]);
        }
      }
      // dequantize, bias, activation (* up); columns >= F are exact zeros
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = nb + 8 * j + 2 * t + (i & 1);
          const float rs = (i < 2) ? rs_lo : rs_hi;
          float v = 0.0f;
          if (c < p.f) {
            float gv = __fmul_rn(__fmul_rn(__int2float_rn(ag[j][i]), rs), p.s1[c]);
            if (p.b1 != nullptr) gv = __fadd_rn(gv, p.b1[c]);
            v = activation<ACT>(gv);
            if (GATED)
              v = __fmul_rn(v, __fmul_rn(__fmul_rn(__int2float_rn(au[j][i]), rs), p.su[c]));
          }
          h[j][i] = v;
          if (i < 2) am_lo = fmaxf(am_lo, fabsf(v));
          else am_hi = fmaxf(am_hi, fabsf(v));
        }
      }
    }
    // --- the panel's row absmax across the warps -> hs; hq to shared ---
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      am_lo = fmaxf(am_lo, __shfl_xor_sync(0xffffffffu, am_lo, off));
      am_hi = fmaxf(am_hi, __shfl_xor_sync(0xffffffffu, am_hi, off));
    }
    if (t == 0) {
      red_s[warp * kBM + g] = am_lo;
      red_s[warp * kBM + g + 8] = am_hi;
    }
    __syncthreads();
    float amax_lo = 0.0f, amax_hi = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      amax_lo = fmaxf(amax_lo, red_s[w * kBM + g]);
      amax_hi = fmaxf(amax_hi, red_s[w * kBM + g + 8]);
    }
    const float hs_lo = row_scale(amax_lo), hs_hi = row_scale(amax_hi);
    if (warp == 0 && t == 0) {
      hs_s[g] = hs_lo;
      hs_s[g + 8] = hs_hi;
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = g + ((i < 2) ? 0 : 8);
          const int c = warp * 64 + 8 * j + 2 * t + (i & 1);
          hq_s[r * kHqStride + c] = quant(h[j][i], (i < 2) ? hs_lo : hs_hi);
        }
      }
    }
    __syncthreads();

    // --- down phase: acc += float(hq @ W2_panel^T) * hs ---
    const int8_t* ha_lo = hq_s + g * kHqStride + 16 * t;
    const int8_t* ha_hi = hq_s + (g + 8) * kHqStride + 16 * t;
    // warp w owns n8 tiles w, w + 8, w + 16, ..., eight at a time
    for (int tb = warp; tb < ntiles; tb += 8 * kWarps) {
      int pa[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) pa[j][0] = pa[j][1] = pa[j][2] = pa[j][3] = 0;
      for (int kk = 0; kk < p.block_f; kk += 64) {
        const uint4 a_lo = *reinterpret_cast<const uint4*>(ha_lo + kk);
        const uint4 a_hi = *reinterpret_cast<const uint4*>(ha_hi + kk);
        const int fk = f0 + kk + 16 * t;
        uint4 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = (tb + kWarps * j) * 8 + g;
          b[j] = (n < p.d && fk < p.f)
                     ? *reinterpret_cast<const uint4*>(p.w2 + (long long)n * p.f + fk)
                     : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_k64(pa[j], a_lo, a_hi, b[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = g + ((i < 2) ? 0 : 8);
          const int c = (tb + kWarps * j) * 8 + 2 * t + (i & 1);
          if (c < p.d) {
            float* a = acc_s + r * p.d + c;
            *a = __fadd_rn(*a, __fmul_rn(__int2float_rn(pa[j][i]), hs_s[r]));
          }
        }
      }
    }
    __syncthreads();  // hq_s, hs_s and red_s are rewritten by the next panel
  }

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
