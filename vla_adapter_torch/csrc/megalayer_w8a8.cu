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
// steps. Here one launch of a persistent grid of 8-warp CTAs (one per SM,
// ops/megalayer.py:megalayer_plan) takes work items from an atomic ticket,
// in dependency order, each waiting only on items with earlier tickets
// (w8a8_mlp.cuh: why that cannot deadlock):
// 1. attention (kv head, `att_warps` units of 16 rows x one query head;
//    attention_core.cuh, B1's one-pass recipe): the units of a kv head's
//    query heads share its K/V ring; ctx goes to a bf16 scratch (M, H*Dh);
// 2. o-projection (32-row tile, 128 columns of D): waits for the tile's
//    ctx, quantizes it per row into shared memory, runs the int8 product
//    against its 128 rows of Wo (D, H*Dh) through the ring, with the
//    residual and its rounding in the epilogue: xa to a bf16 scratch;
// 3. norm (32-row tile): RMSNorm2 of the tile's xa rows and the
//    quantization of h2 (xq, rs to a scratch);
// 4. up (32-row tile, panel) and 5. down (64-row tile, 128 columns): the
//    panel walk of kernel B2 (w8a8_mlp.cuh), the up items reading xq from
//    the scratch, the down items adding the residual: bf16(xa + acc * sd).
// At the Qwen2.5-0.5B shape (M = 640, D = 896, 14 / 2 heads of 64, F =
// 4864): 112 attention items of 5 warps, 140 o-projection, 20 norm, 200 up
// and 70 down items on 132 CTAs, where the first design ran 40 CTAs each
// running the whole layer for 16 rows; 224 KB of shared memory, the
// attention stage's scores the most. Every scratch is L2-resident (~6 MB).
//
// Numerics. __fmul_rn / __fadd_rn / __fdiv_rn keep every product, sum and
// quotient a separate rounding, the quantizations round half to even and
// __frsqrt_rn is the correctly rounded 1/sqrt. The kernel sums the attention and the norm
// in another order than its plain version and takes expf from the CUDA
// math library, so a bf16 ulp of ctx or a float ulp of h2 can flip one int8
// rounding downstream: it is held to a stated tolerance against its plain
// version, not to bit-exactness.
//
// Bound on this card, at M = 640: 1.47 GFLOP of bf16 attention and 17.8 GOP
// of int8 products, ~10.5 us at the tensor-core peaks, against ~17.7 MB of
// weights and activations, ~5.3 us of HBM: operations bound. What holds it
// above that: the MLP walk's (w8a8_mlp.cuh), and the chain of stages, each
// of whose first items waits for the last items of the stage before on
// its rows (attention, then o-projection, then norm, then the panels).
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

struct LayerParams {
  const __nv_bfloat16* x;   // (M, D)
  const __nv_bfloat16* q;   // (M, H, Dh), strides q_ss, q_sh
  const __nv_bfloat16* k;   // (M, Hkv, Dh), strides k_ss, k_sh
  const __nv_bfloat16* v;   // (M, Hkv, Dh), strides v_ss, v_sh
  const int32_t* valid;     // (M) or null
  const float* n2;          // (D)
  const int8_t* oq;         // (D, H*Dh)
  const float* os;          // (D)
  Mlp mlp;                  // gate (w1), up (wu), down (w2, s2): K = D
  __nv_bfloat16* out;       // (M, D)
  __nv_bfloat16* ctx;       // scratch (M, H*Dh)
  __nv_bfloat16* xa;        // scratch (M, D): x + o, rounded
  int8_t* xq;               // scratch (M, kpad_d): quantized h2
  float* rs;                // scratch (M): its row scales
  int* counters;            // ticket, exits, then per 32-row tile the ready
                            // counts of hq, xq, ctx and xa
  int m, d, heads, kv_heads, dim, hd, kpad_hd, att_warps;
  int row_tiles, down_tiles, col_tiles;
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float sm_scale, eps;
};

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Shared memory: the attention stage and the MLP stages share one region.
__host__ __device__ inline int widest_a(const LayerParams& p) {
  return p.kpad_hd > p.mlp.kpad ? p.kpad_hd : p.mlp.kpad;
}
template <int DP>
__host__ __device__ size_t region_bytes(const LayerParams& p) {
  const size_t att = vla_attention::smem_bytes<DP>(p.att_warps, p.m);
  const size_t mlp = mlp_smem_bytes(widest_a(p), p.mlp.panels, true);
  return att > mlp ? att : mlp;
}

// Attention item: units i * att_warps + w of kv head kvh, a unit being 16
// rows (row block u / G) of query head kvh * G + u % G.
template <int DP>
__device__ void attention_item(const LayerParams& p, unsigned char* smem, int kvh, int i,
                               int* ready_ctx) {
  const int warp = threadIdx.x / 32;
  const int groups = p.heads / p.kv_heads;
  const int units = groups * ((p.m + 15) / 16);
  const int u = i * p.att_warps + warp;
  const bool active = warp < p.att_warps && u < units;
  const int h = kvh * groups + (active ? u % groups : 0);
  vla_attention::Keys keys;
  keys.k = p.k + kvh * p.k_sh;
  keys.v = p.v + kvh * p.v_sh;
  keys.valid = p.valid;
  keys.k_ss = p.k_ss;
  keys.v_ss = p.v_ss;
  keys.seq = p.m;
  keys.dim = p.dim;
  keys.sm_scale = p.sm_scale;
  vla_attention::attend<DP>(keys, smem, active, p.q + h * p.q_sh, p.q_ss,
                            active ? 16 * (u / groups) : 0, p.ctx + h * p.dim, p.hd);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    for (int w = 0; w < p.att_warps; ++w) {
      const int uw = i * p.att_warps + w;
      if (uw < units) atomicAdd(ready_ctx + (uw / groups) * 16 / kBM, 1);
    }
  }
}

// O-projection item (32-row tile rt, 128 columns ct of D): quantizes the
// tile's ctx rows over their H*Dh features into shared memory (every
// column item of a tile quantizes them again, the same bits), then xa =
// bf16(x + o) for its columns into the scratch.
__device__ void oproj_item(const LayerParams& p, const MlpSmem& s, int rt, int ct,
                           const int* ready_ctx, int* ready_xa) {
  constexpr int MT = kBM / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = rt * kBM;
  const int blocks = min(kBM / 16, (p.m + 15) / 16 - rt * (kBM / 16));
  const int steps = p.kpad_hd / kStep;
  const uint32_t ring = smem_u32(s.ring);
  constexpr int kRing = ring_depth(true);

  auto load = [&](int st) {
    if (st < steps)
      stage_w(ring + (st % kRing) * s.slot, p.oq, p.hd, kTileN * ct, p.d, st * kStep, kStep,
              p.hd);
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) load(st);

  // --- quantize each ctx row over its H*Dh features: a warp per four ---
  wait_count(ready_ctx + rt, p.heads * blocks);
#pragma unroll 1
  for (int r0 = warp; r0 < kBM; r0 += 4 * kWarps) {
    int live = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) live |= (row0 + r0 + kWarps * i < p.m) << i;
    float scale[4];
    quantize_rows4(
        live, p.hd, p.kpad_hd,
        [&](int i, int c, float (&f)[4]) {
          load4_cg(p.ctx + (long long)(row0 + r0 + kWarps * i) * p.hd + c, f);
        },
        [&](int i, int c, uint32_t packed) {  // rows past M: zeros, never stored
          *reinterpret_cast<uint32_t*>(s.xq + a_at(r0 + kWarps * i, c)) = packed;
        },
        scale);
    if (lane == 0)
      for (int i = 0; i < 4; ++i) s.rs[r0 + kWarps * i] = live & (1 << i) ? scale[i] : 1.0f;
  }

  // --- o-projection, the residual rounded once: xa = bf16(x + o) ---
  int acc[1][MT][2][4];
  zero(acc);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    load(st + kRing - 1);
    const uint32_t w[1] = {ring + (st % kRing) * s.slot};
    step_mma<1, MT>(smem_u32(s.xq) + st * (kBM * kStep), w, 16 * warp, acc);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = 16 * mt + 8 * hi + g;
      const int row = row0 + r;
      if (row >= p.m) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = kTileN * ct + 16 * warp + 8 * nt + 2 * t;
        if (col >= p.d) continue;
        // |part| <= H*Dh*127^2 < 2^24 (the wrapper checks): exact
        float xo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float o = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[0][mt][nt][2 * hi + e]), s.rs[r]), p.os[col + e]);
          xo[e] = __fadd_rn(__bfloat162float(p.x[(long long)row * p.d + col + e]), o);
        }
        store_pair(p.xa + (long long)row * p.d + col, xo[0], xo[1]);
      }
    }
  signal(ready_xa + rt);
}

// Norm item (32-row tile rt): RMSNorm2 of the tile's xa rows in float32,
// h2 quantized per row into the scratch the up items read; a warp per four
// rows at once.
__device__ void norm_item(const LayerParams& p, int rt, const int* ready_xa, int* ready_x) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  wait_count(ready_xa + rt, p.col_tiles);
  const int kpad_d = p.mlp.kpad;
#pragma unroll 1
  for (int row0 = rt * kBM + warp; row0 < (rt + 1) * kBM; row0 += 4 * kWarps) {
    int live = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) live |= (row0 + kWarps * i < p.m) << i;
    auto xa_row = [&](int i) { return p.xa + (long long)(row0 + kWarps * i) * p.d; };
    float ss[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int c = 4 * lane; c < p.d; c += 128) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!(live & (1 << i))) continue;
        float f[4];
        load4_cg(xa_row(i) + c, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) ss[i] = __fadd_rn(ss[i], __fmul_rn(f[e], f[e]));
      }
    }
    float inv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ss[i] = __fadd_rn(ss[i], __shfl_xor_sync(0xffffffffu, ss[i], off));
      inv[i] = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss[i], static_cast<float>(p.d)), p.eps));
    }
    float scale[4];
    quantize_rows4(
        live, p.d, kpad_d,
        [&](int i, int c, float (&f)[4]) {
          load4_cg(xa_row(i) + c, f);
#pragma unroll
          for (int e = 0; e < 4; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], inv[i]), p.n2[c + e]);
        },
        [&](int i, int c, uint32_t packed) {
          if (live & (1 << i))
            *reinterpret_cast<uint32_t*>(p.xq + (long long)(row0 + kWarps * i) * kpad_d + c) =
                packed;
        },
        scale);
    if (lane == 0)
      for (int i = 0; i < 4; ++i)
        if (live & (1 << i)) p.rs[row0 + kWarps * i] = scale[i];
  }
  signal(ready_x + rt);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) megalayer_kernel(const LayerParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Mlp& mlp = p.mlp;
  const MlpSmem s = carve_mlp(smem, widest_a(p), mlp.panels, true);
  int* ticket_s = reinterpret_cast<int*>(smem + region_bytes<DP>(p));
  int* ready_ctx = p.counters + 2 + 2 * p.row_tiles;  // after ready_h, ready_x
  int* ready_xa = ready_ctx + p.row_tiles;
  const int groups = p.heads / p.kv_heads;
  const int units = groups * ((p.m + 15) / 16);
  const int atts = p.kv_heads * ((units + p.att_warps - 1) / p.att_warps);
  const int oprojs = atts + p.row_tiles * p.col_tiles;
  const int norms = oprojs + p.row_tiles;
  const int ups = norms + p.row_tiles * mlp.panels;
  const int items = ups + p.down_tiles * p.col_tiles;

  for (int it = next_ticket(p.counters, ticket_s); it < items;
       it = next_ticket(p.counters, ticket_s)) {
    if (it < atts) {
      attention_item<DP>(p, smem, it % p.kv_heads, it / p.kv_heads, ready_ctx);
    } else if (it < oprojs) {
      const int o = it - atts;
      oproj_item(p, s, o / p.col_tiles, o % p.col_tiles, ready_ctx, ready_xa);
    } else if (it < norms) {
      norm_item(p, it - oprojs, ready_xa, mlp.ready_x);
    } else if (it < ups) {
      up_item<kSilu, true>(mlp, s, (it - norms) / mlp.panels, (it - norms) % mlp.panels);
    } else {
      const int d = it - ups;
      down_item<true>(mlp, s, d / p.col_tiles, d % p.col_tiles,
                [&](int row, int col, float a0, float a1) {
                  // out = bf16(xa + acc * sd)
                  const __nv_bfloat16* xr = p.xa + (long long)row * p.d + col;
                  store_pair(p.out + (long long)row * p.d + col,
                             __fadd_rn(bf16_at(xr), __fmul_rn(a0, mlp.s2[col])),
                             __fadd_rn(bf16_at(xr + 1), __fmul_rn(a1, mlp.s2[col + 1])));
                });
    }
  }
  leave(p.counters, 4 * p.row_tiles);
}

template <int DP>
cudaError_t launch(const LayerParams& p, int ctas, cudaStream_t stream) {
  const size_t smem = region_bytes<DP>(p) + 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = megalayer_kernel<DP>;
  // Once per instantiation, at its first (uncaptured) launch, to the most
  // a block may use: every smaller size is then admitted, and later
  // launches, inside a CUDA graph capture too, make no attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<ctas, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (M, D), out (M, D) bf16 contiguous; q (M, H, Dh), k/v (M, Hkv, Dh) bf16
// with element strides per position (*_ss) and head (*_sh), the head dim
// contiguous, strides multiples of 8 and pointers 16-byte aligned; valid
// (M) int32 or null; n2 (D) f32; oq (D, H*Dh), gq/uq (F, D), dq (D, F)
// int8 and their f32 scales os (D), gs/us (F), ds (D). Scratch, with P =
// ceil(F / block_f): ctx (M, H*Dh) and xa (M, D) bf16, xq (M, round128(D))
// int8, rs (M) f32, hq (M, P * round128(block_f)) int8, hs (M, P) f32;
// counters (2 + 4 ceil(M / 32) int32, zero, left zero). Dh in {16,
// 32, 64, 128}, D % 16 == 0, F % 16 == 0, H*Dh*127^2 < 2^24, block_f a
// multiple of 64 up to 512; att_warps (1..8) and ctas from megalayer_plan
// (the wrapper checks). Returns a cudaError_t.
extern "C" int vla_w8a8_qwen2_layer(
    const void* x, const void* q, const void* k, const void* v,
    const void* valid, const void* n2, const void* oq, const void* os,
    const void* gq, const void* gs, const void* uq, const void* us,
    const void* dq, const void* ds, void* out, void* ctx, void* xa, void* xq,
    void* rs, void* hq, void* hs, void* counters,
    int m, int d, int heads, int kv_heads, int dim, int f, int block_f,
    long long q_ss, long long q_sh, long long k_ss, long long k_sh,
    long long v_ss, long long v_sh, float sm_scale, float eps, int att_warps,
    int ctas, void* stream) {
  const int hd = heads * dim;
  if (m <= 0 || d <= 0 || f <= 0 || kv_heads <= 0 || heads % kv_heads ||
      d % 16 || f % 16 || hd % 16 || block_f <= 0 || block_f % 64 ||
      block_f > kMaxPanel || static_cast<long long>(hd) * 127 * 127 >= (1 << 24) ||
      att_warps < 1 || att_warps > kWarps || ctas <= 0)
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
  Mlp& mlp = p.mlp;
  mlp.w1 = static_cast<const int8_t*>(gq);
  mlp.s1 = static_cast<const float*>(gs);
  mlp.wu = static_cast<const int8_t*>(uq);
  mlp.su = static_cast<const float*>(us);
  mlp.b1 = nullptr;
  mlp.w2 = static_cast<const int8_t*>(dq);
  mlp.s2 = static_cast<const float*>(ds);
  mlp.b2 = nullptr;
  mlp.hq = static_cast<int8_t*>(hq);
  mlp.hs = static_cast<float*>(hs);
  mlp.m = m;
  mlp.k = d;
  mlp.f = f;
  mlp.d = d;
  mlp.block_f = block_f;
  mlp.kpad = round_up(d, kStep);
  mlp.panels = (f + block_f - 1) / block_f;
  mlp.pw = round_up(block_f, kStep);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ctx = static_cast<__nv_bfloat16*>(ctx);
  p.xa = static_cast<__nv_bfloat16*>(xa);
  p.xq = static_cast<int8_t*>(xq);
  p.rs = static_cast<float*>(rs);
  p.counters = static_cast<int*>(counters);
  p.m = m;
  p.d = d;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.dim = dim;
  p.hd = hd;
  p.kpad_hd = round_up(hd, kStep);
  p.att_warps = att_warps;
  p.row_tiles = (m + kBM - 1) / kBM;
  p.down_tiles = (m + kBMd - 1) / kBMd;
  p.col_tiles = (d + kTileN - 1) / kTileN;
  mlp.xq = p.xq;
  mlp.rs = p.rs;
  mlp.ready_h = p.counters + 2;
  mlp.ready_x = mlp.ready_h + p.row_tiles;
  p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_ss = v_ss; p.v_sh = v_sh;
  p.sm_scale = sm_scale;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 16: return static_cast<int>(launch<16>(p, ctas, s));
    case 32: return static_cast<int>(launch<32>(p, ctas, s));
    case 64: return static_cast<int>(launch<64>(p, ctas, s));
    case 128: return static_cast<int>(launch<128>(p, ctas, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
