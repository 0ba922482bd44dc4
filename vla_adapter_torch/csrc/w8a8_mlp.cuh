// The w8a8 MLP panel walk of one 16-row CTA: the device code shared by
// fused_mlp_w8a8.cu (kernels B2/B3) and megalayer_w8a8.cu (kernel B6).
//
//   for each block_f-wide panel of F:
//     g  = float(xq @ W1_panel^T) * rs * s1 (+ b1)
//     h  = act(g)                  or act(g) * (float(xq @ Wu^T) * rs * su)
//     h  = 0 in columns >= F       (the ragged tail panel)
//     hq, hs = quantize_rows(h)    per (token, panel)
//     acc += float(hq @ W2_panel^T) * hs      float32, panels in order
//
// block_f = 512 is part of the numerics (h is re-quantized per panel), not
// a tile size. One CTA of 8 warps owns 16 rows and walks the panels in a
// loop, with the (16, D) float32 accumulator in shared memory; there is no
// reduction across CTAs.
//
// Weights are int8 in the PyTorch (out, in) layout: W1/Wu (F, K), W2 (D, F),
// so both mma.sync.m16n8k32 operands are K-contiguous. Up phase: warp w owns
// panel columns [64w, 64w + 64), eight n8 tiles, and reads its weight
// fragments straight from global memory (each is used by exactly one mma in
// the CTA, so staging them through shared memory would buy nothing), 16
// contiguous bytes per thread per 64 k. It dequantizes, applies the
// activation and keeps its 16 x 64 slice of h in registers; the row absmax
// of the panel is reduced across warps through shared memory, then each
// warp writes its int8 slice of hq to shared memory. Down phase
// (rows_times_wt): the warps split D into n8 tiles and accumulate the
// panel's int32 product over the panel's k. A (16 x 512) float32 panel of h
// would need 32 KB of shared memory; holding it in registers and staging
// only the int8 hq (9 KB) keeps the shared memory small.
//
// Numerics. __fmul_rn / __fadd_rn / __fdiv_rn keep every product, sum and
// quotient a separate rounding (nvcc would contract a*b + c into an FMA),
// rintf rounds half to even like jnp.round, and "gelu" is the A&S 7.1.26
// erf polynomial of the TPU kernel (_erf), not erff. expf/tanhf are the
// CUDA math library's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vla_w8a8 {

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

// One warp quantizes one row: value(c) for c < n into dst[c], zeros in
// [n, npad), with the row's scale max(absmax, 1e-8) / 127, which it
// returns to every lane.
template <typename Value>
__device__ __forceinline__ float quantize_row(Value value, int n, int npad,
                                              int8_t* dst) {
  const int lane = threadIdx.x % 32;
  float amax = 0.0f;
  for (int c = lane; c < n; c += 32) amax = fmaxf(amax, fabsf(value(c)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = row_scale(amax);
  for (int c = lane; c < npad; c += 32) dst[c] = c < n ? quant(value(c), scale) : int8_t(0);
  return scale;
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

// The int32 products of the CTA's 16 int8 rows a_s (row stride `as` bytes)
// with rows [0, n) of w (row stride ldw bytes) over the k window
// [k0, k0 + klen): a_s holds the window's klen bytes from its start, klen
// is a multiple of 64, and weight bytes at k >= kend read as zero. Calls
// epi(r, c, product) for every row r < 16 and column c < n. The warps split
// n into n8 tiles, eight at a time.
template <typename Epi>
__device__ __forceinline__ void rows_times_wt(const int8_t* a_s, int as,
                                              const int8_t* w, long long ldw,
                                              int k0, int klen, int kend,
                                              int n, Epi epi) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int8_t* a_lo = a_s + g * as + 16 * t;
  const int8_t* a_hi = a_s + (g + 8) * as + 16 * t;
  const int ntiles = (n + 7) / 8;
  // warp w owns n8 tiles w, w + 8, w + 16, ..., eight at a time
  for (int tb = warp; tb < ntiles; tb += 8 * kWarps) {
    int pa[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) pa[j][0] = pa[j][1] = pa[j][2] = pa[j][3] = 0;
    for (int kk = 0; kk < klen; kk += 64) {
      const uint4 av_lo = *reinterpret_cast<const uint4*>(a_lo + kk);
      const uint4 av_hi = *reinterpret_cast<const uint4*>(a_hi + kk);
      const int fk = k0 + kk + 16 * t;
      uint4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nn = (tb + kWarps * j) * 8 + g;
        b[j] = (nn < n && fk < kend)
                   ? *reinterpret_cast<const uint4*>(w + (long long)nn * ldw + fk)
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_k64(pa[j], av_lo, av_hi, b[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + ((i < 2) ? 0 : 8);
        const int c = (tb + kWarps * j) * 8 + 2 * t + (i & 1);
        if (c < n) epi(r, c, pa[j][i]);
      }
    }
  }
}

// The panel walk: acc_s (16, p.d) float32, zeroed by the caller, gains the
// MLP's down product before the per-channel scale. xq_s (16 rows, stride
// xs bytes, zero from p.k up to a multiple of 64) and rs_s (16) hold the
// quantized input rows and their scales. hq_s (16 x kHqStride bytes), hs_s
// (16) and red_s (kWarps x 16) are scratch. Every thread of the CTA calls
// it; it ends with a __syncthreads.
template <int ACT, bool GATED>
__device__ __forceinline__ void mlp_panels(const Params& p, const int8_t* xq_s,
                                           int xs, const float* rs_s,
                                           int8_t* hq_s, float* acc_s,
                                           float* hs_s, float* red_s) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float rs_lo = rs_s[g], rs_hi = rs_s[g + 8];
  const int8_t* xa_lo = xq_s + g * xs + 16 * t;
  const int8_t* xa_hi = xq_s + (g + 8) * xs + 16 * t;

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
    rows_times_wt(hq_s, kHqStride, p.w2, p.f, f0, p.block_f, p.f, p.d,
                  [&](int r, int c, int part) {
                    float* a = acc_s + r * p.d + c;
                    *a = __fadd_rn(*a, __fmul_rn(__int2float_rn(part), hs_s[r]));
                  });
    __syncthreads();  // hq_s, hs_s and red_s are rewritten by the next panel
  }
}

}  // namespace vla_w8a8
