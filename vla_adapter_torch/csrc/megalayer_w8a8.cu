// One batch-1 Qwen2 decoder layer, from the attention core on, as one
// kernel for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces vla_adapter_tpu/ops/pallas_megalayer.py:w8a8_qwen2_layer_stacked
// (kernel B6, the Pallas kernel _megalayer_kernel). Same arithmetic, per
// token row of x (M, D) with roped q (M, H, Dh) and k, v (M, Hkv, Dh):
//
//   ctx   = bf16(attention(q, k, v, valid))     B1's recipe: additive 0 / -2e9
//                                               key bias, p rounded to bf16,
//                                               fp32 p @ v divided by l
//   cq, s = quantize_rows(ctx)                  over the token's H*Dh row
//   o     = (float(cq @ Wo^T) * s) * so         one exact int32 sum (the TPU
//                                               sums 14 exact per-head partials)
//   xa    = bf16(x + o)                         the residual, rounded once
//   h2    = xa * rsqrt(mean(xa^2) + eps) * n2   float32, NOT rounded
//   out   = bf16(xa + gated_mlp(h2) * sd)       B2's per-(token, 512-panel)
//                                               w8a8 MLP from quantize_rows(h2)
//
// Design. The TPU grid is a sequential walk (all attention steps, then the
// o-projection and norm, then the MLP panels) carrying VMEM scratch across
// steps. On the card every stage after attention is local to a token row,
// and attention needs only the rows' q and all of K and V, which are
// inputs. So one ordinary launch of ceil(M / 16) CTAs of 8 warps runs the
// whole layer for 16 rows each, with no synchronisation across CTAs:
//
// 1. attention (attention_core.cuh, B1's two-pass softmax): for each kv
//    head, warp w takes query head kvh * G + w of the group (G = H / Hkv,
//    warps beyond G idle through the pass), K/V tiles staged through shared
//    memory once for the whole group; the 16 x H*Dh ctx tile stays in
//    shared memory in bf16;
// 2. per-row absmax and int8 quantization of ctx into shared memory;
// 3. the o-projection (mma.sync s8 against the (D, H*Dh) weight read from
//    L2) with the residual and its rounding in the epilogue;
// 4. RMSNorm2 and the quantization of h2 into shared memory;
// 5. B2's panel walk (w8a8_mlp.cuh);
// 6. the output with the second residual.
// About 155 KB of shared memory at the Qwen2.5-0.5B shape (D = 896, 14 / 2
// heads of 64, F = 4864).
//
// Numerics. __fmul_rn / __fadd_rn / __fdiv_rn keep every product, sum and
// quotient a separate rounding, rintf rounds half to even and __frsqrt_rn is
// the correctly rounded 1/sqrt. The kernel sums the attention and the norm
// in another order than its plain version and takes expf from the CUDA
// math library, so a bf16 ulp of ctx or a float ulp of h2 can flip one int8
// rounding downstream: it is held to a stated tolerance against its plain
// version, not to bit-exactness.
//
// Bound on this card, at M = 640: 1.47 GFLOP of bf16 attention and 17.8 GOP
// of int8 products, ~10.5 us at the tensor-core peaks, against ~17.7 MB of
// weights and activations, ~5.3 us of HBM: operations bound. Like B2 this
// first version runs only ceil(M / 16) CTAs (40 at M = 640 on 132 SMs), each
// re-reading K, V and every weight from L2 with mma.sync and synchronous
// loads: the simple form, not the fast one.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"
#include "w8a8_mlp.cuh"

namespace {

using namespace vla_w8a8;
using vla_attention::Tiles;

struct LayerParams {
  const __nv_bfloat16* x;   // (M, D)
  const __nv_bfloat16* q;   // (M, H, Dh), strides q_ss, q_sh
  const __nv_bfloat16* k;   // (M, Hkv, Dh), strides k_ss, k_sh
  const __nv_bfloat16* v;   // (M, Hkv, Dh), strides v_ss, v_sh
  const int32_t* valid;     // (M) or null
  const float* n2;          // (D)
  const int8_t* oq;         // (D, H*Dh)
  const float* os;          // (D)
  Params mlp;               // gate (w1), up (wu), down (w2, s2): K = D
  __nv_bfloat16* out;       // (M, D)
  int m, d, heads, kv_heads, dim, hd, xs;
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float sm_scale, eps;
};

__host__ __device__ constexpr int round64(int n) { return (n + 63) / 64 * 64; }

// Shared memory of one CTA, in bytes, in the kernel's order.
template <int DP>
size_t smem_bytes(int d, int hd, int xs) {
  return sizeof(Tiles<DP>)                              // K / V^T tiles
         + static_cast<size_t>(kBM) * hd * 2            // ctx, bf16
         + static_cast<size_t>(kBM) * xs                // cq, then hq
         + static_cast<size_t>(kBM) * d * 2             // x + attention, bf16
         + static_cast<size_t>(kBM) * kHqStride         // a panel of int8 h
         + sizeof(float) * (static_cast<size_t>(kBM) * d  // MLP accumulator
                            + 2 * kBM + kWarps * kBM);    // scales, absmax
}

template <int DP>
__global__ void __launch_bounds__(kThreads) megalayer_kernel(const LayerParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles<DP>& tiles = *reinterpret_cast<Tiles<DP>*>(smem);
  __nv_bfloat16* ctx_s = reinterpret_cast<__nv_bfloat16*>(smem + sizeof(Tiles<DP>));
  int8_t* xq_s = reinterpret_cast<int8_t*>(ctx_s + kBM * p.hd);
  __nv_bfloat16* xa_s = reinterpret_cast<__nv_bfloat16*>(xq_s + kBM * p.xs);
  int8_t* hq_s = reinterpret_cast<int8_t*>(xa_s + kBM * p.d);
  float* acc_s = reinterpret_cast<float*>(hq_s + kBM * kHqStride);
  float* rs_s = acc_s + kBM * p.d;
  float* hs_s = rs_s + kBM;
  float* red_s = hs_s + kBM;  // (kWarps, kBM)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m0 = blockIdx.x * kBM;
  const int r_lo = m0 + g;
  const int r_hi = m0 + g + 8;
  const int groups = p.heads / p.kv_heads;

  // --- 1. attention: ctx (16, H*Dh) in bf16 ---
  for (int kvh = 0; kvh < p.kv_heads; ++kvh) {
    vla_attention::Keys keys;
    keys.k = p.k + kvh * p.k_sh;
    keys.v = p.v + kvh * p.v_sh;
    keys.valid = p.valid;
    keys.k_ss = p.k_ss;
    keys.v_ss = p.v_ss;
    keys.seq = p.m;
    keys.dim = p.dim;
    keys.sm_scale = p.sm_scale;
    keys.causal = 0;
    for (int hb = 0; hb < groups; hb += kWarps) {
      const bool active = hb + warp < groups;
      const int h = kvh * groups + (active ? hb + warp : 0);
      uint32_t qa[DP / 16][4];
      // an idle warp attends with zero queries and stores nothing
      vla_attention::load_q<DP>(qa, p.q + h * p.q_sh, p.q_ss, r_lo, r_hi,
                                active ? p.m : 0, p.dim);
      float acc[DP / 8][4];
      float l_lo, l_hi;
      vla_attention::attend<DP>(keys, tiles, qa, r_lo, r_hi, acc, l_lo, l_hi);
      if (active) {
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          const int dd = 8 * n + 2 * t;
          if (dd >= p.dim) continue;
          __nv_bfloat16* lo = ctx_s + g * p.hd + h * p.dim + dd;
          __nv_bfloat16* hi = lo + 8 * p.hd;
          *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(
              __fdiv_rn(acc[n][0], l_lo), __fdiv_rn(acc[n][1], l_lo));
          *reinterpret_cast<__nv_bfloat162*>(hi) = __floats2bfloat162_rn(
              __fdiv_rn(acc[n][2], l_hi), __fdiv_rn(acc[n][3], l_hi));
        }
      }
    }
  }
  __syncthreads();

  // --- 2. quantize each ctx row over its H*Dh features ---
  const int hdpad = round64(p.hd);
  for (int r = warp; r < kBM; r += kWarps) {
    const __nv_bfloat16* cr = ctx_s + r * p.hd;
    const float scale = quantize_row(
        [&](int c) { return __bfloat162float(cr[c]); }, p.hd, hdpad, xq_s + r * p.xs);
    if (lane == 0) rs_s[r] = scale;
  }
  __syncthreads();

  // --- 3. o-projection, the residual rounded once: xa = bf16(x + o) ---
  rows_times_wt(xq_s, p.xs, p.oq, p.hd, 0, hdpad, p.hd, p.d,
                [&](int r, int c, int part) {
                  // |part| <= H*Dh*127^2 < 2^24 (the wrapper checks): exact
                  const float o = __fmul_rn(__fmul_rn(__int2float_rn(part), rs_s[r]), p.os[c]);
                  const int row = m0 + r;
                  const float xv = row < p.m
                      ? __bfloat162float(p.x[(long long)row * p.d + c]) : 0.0f;
                  xa_s[r * p.d + c] = __float2bfloat16_rn(__fadd_rn(xv, o));
                });
  __syncthreads();

  // --- 4. RMSNorm2 in float32, then quantize h2 per row for the MLP ---
  const int dpad = round64(p.d);
  for (int r = warp; r < kBM; r += kWarps) {
    int8_t* dst = xq_s + r * p.xs;
    if (m0 + r >= p.m) {  // rows past M: zeros, never stored
      for (int c = lane; c < dpad; c += 32) dst[c] = 0;
      if (lane == 0) rs_s[r] = 1.0f;
      continue;
    }
    const __nv_bfloat16* xr = xa_s + r * p.d;
    float ss = 0.0f;
    for (int c = lane; c < p.d; c += 32) {
      const float xf = __bfloat162float(xr[c]);
      ss = __fadd_rn(ss, __fmul_rn(xf, xf));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(p.d)), p.eps));
    const float scale = quantize_row(
        [&](int c) { return __fmul_rn(__fmul_rn(__bfloat162float(xr[c]), inv), p.n2[c]); },
        p.d, dpad, dst);
    if (lane == 0) rs_s[r] = scale;
  }
  for (int i = threadIdx.x; i < kBM * p.d; i += kThreads) acc_s[i] = 0.0f;
  __syncthreads();

  // --- 5. the gated MLP, panel by panel ---
  mlp_panels<kSilu, true>(p.mlp, xq_s, p.xs, rs_s, hq_s, acc_s, hs_s, red_s);

  // --- 6. out = bf16(xa + acc * sd) ---
  for (int i = threadIdx.x; i < kBM * p.d; i += kThreads) {
    const int r = i / p.d;
    const int c = i % p.d;
    const int row = m0 + r;
    if (row >= p.m) continue;
    p.out[(long long)row * p.d + c] = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(xa_s[i]), __fmul_rn(acc_s[i], p.mlp.s2[c])));
  }
}

template <int DP>
cudaError_t launch(const LayerParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>(p.d, p.hd, p.xs);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = megalayer_kernel<DP>;
  // Once per instantiation, at its first (uncaptured) launch, to the most
  // a block may use: every smaller size is then admitted, and later
  // launches, inside a CUDA graph capture too, make no attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<(p.m + kBM - 1) / kBM, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (M, D), out (M, D) bf16 contiguous; q (M, H, Dh), k/v (M, Hkv, Dh) bf16
// with element strides per position (*_ss) and head (*_sh), the head dim
// contiguous, strides multiples of 8 and pointers 16-byte aligned; valid
// (M) int32 or null; n2 (D) f32; oq (D, H*Dh), gq/uq (F, D), dq (D, F)
// int8 and their f32 scales os (D), gs/us (F), ds (D). Dh in {16, 32, 64,
// 128}, D % 16 == 0, F % 16 == 0, H*Dh*127^2 < 2^24, block_f a multiple of
// 64 up to 512 (the wrapper checks). Returns a cudaError_t.
extern "C" int vla_w8a8_qwen2_layer(
    const void* x, const void* q, const void* k, const void* v,
    const void* valid, const void* n2, const void* oq, const void* os,
    const void* gq, const void* gs, const void* uq, const void* us,
    const void* dq, const void* ds, void* out,
    int m, int d, int heads, int kv_heads, int dim, int f, int block_f,
    long long q_ss, long long q_sh, long long k_ss, long long k_sh,
    long long v_ss, long long v_sh, float sm_scale, float eps, void* stream) {
  const int hd = heads * dim;
  if (m <= 0 || d <= 0 || f <= 0 || kv_heads <= 0 || heads % kv_heads ||
      d % 16 || f % 16 || hd % 16 || block_f <= 0 || block_f % 64 ||
      block_f > kMaxPanel || static_cast<long long>(hd) * 127 * 127 >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  LayerParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.valid = static_cast<const int32_t*>(valid);
  p.n2 = static_cast<const float*>(n2);
  p.oq = static_cast<const int8_t*>(oq);
  p.os = static_cast<const float*>(os);
  p.mlp.x = nullptr;
  p.mlp.w1 = static_cast<const int8_t*>(gq);
  p.mlp.s1 = static_cast<const float*>(gs);
  p.mlp.wu = static_cast<const int8_t*>(uq);
  p.mlp.su = static_cast<const float*>(us);
  p.mlp.b1 = nullptr;
  p.mlp.w2 = static_cast<const int8_t*>(dq);
  p.mlp.s2 = static_cast<const float*>(ds);
  p.mlp.b2 = nullptr;
  p.mlp.out = nullptr;
  p.mlp.m = m;
  p.mlp.k = d;
  p.mlp.f = f;
  p.mlp.d = d;
  p.mlp.block_f = block_f;
  p.mlp.kpad = round64(d);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = m;
  p.d = d;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.dim = dim;
  p.hd = hd;
  // cq (H*Dh) and then hq (D) share one row buffer; +64 bytes as in B2
  p.xs = (round64(hd) > round64(d) ? round64(hd) : round64(d)) + 64;
  p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_ss = v_ss; p.v_sh = v_sh;
  p.sm_scale = sm_scale;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 16: return static_cast<int>(launch<16>(p, s));
    case 32: return static_cast<int>(launch<32>(p, s));
    case 64: return static_cast<int>(launch<64>(p, s));
    case 128: return static_cast<int>(launch<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
