// Fused softmax attention for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces vla_adapter_tpu/ops/pallas_attention.py:fused_attention (the
// Pallas kernel _attn_kernel). Same arithmetic, re-tiled for the card:
//
//   s   = (q . k) * sm_scale + bias      fp32, bias = 0 / -2e9 from `valid`
//   s   = -2e9 where key > query         (causal only)
//   m   = max_k s
//   p   = bf16(exp(s - m))               unnormalised, rounded before p @ v
//   l   = sum_k float(p)                 sum of the ROUNDED probabilities
//   out = bf16((p @ v) / l)              fp32 accumulation, deferred 1/l
//
// Design. One CTA of 4 warps owns 64 query rows of one (batch, head); each
// warp owns 16 rows and runs mma.sync m16n8k16 (bf16 in, fp32 accumulate).
// GQA reads kv head h / (H / Hkv); the CTAs of one group re-read K/V from L2.
// The TPU kernel kept the whole (rows, S) score block in VMEM; a Hopper SM
// cannot hold that in registers, so the softmax is two passes over 64-key
// tiles (attention_core.cuh, shared with kernel B6): pass 1 finds the exact
// row max, pass 2 recomputes the same scores, rounds p to bf16 with the
// final max, and accumulates l and p @ v. That keeps the Pallas numerics
// (p rounded against the final max, not a running one) at the cost of one
// extra q.k product.
//
// Bound on this card: the work is 4*H*S^2*D flops. The Qwen2 call (S=640,
// 14 q / 2 kv heads, D=64) does ~530 flop per byte of q/k/v/o, above the
// H100's ~295 flop/byte ridge: operations bound. The ViT calls (S~256,
// no GQA) do ~130 flop/byte: bytes bound. This first version uses mma.sync
// (not wgmma/TMA) and synchronous tile loads; it is the simple correct
// form, not the fast one.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // 64 query rows

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* valid;  // (B, S) with row stride valid_sb; null = all valid
  __nv_bfloat16* o;
  int heads, kv_heads, seq, dim;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long valid_sb;
  float sm_scale;
  int causal;
};

// DP: head dim padded to a multiple of 16 (the mma k-depth).
template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
fused_attention_kernel(const Params p) {
  __shared__ __align__(16) vla_attention::Tiles<DP> tiles;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // mma group: rows g and g + 8 of the warp's tile
  const int t = lane % 4;  // thread in group: column pairs 2t, 2t + 1
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (p.heads / p.kv_heads);
  const int row0 = blockIdx.x * kRowsPerCta + warp * kRowsPerWarp;
  const int r_lo = row0 + g;
  const int r_hi = row0 + g + 8;

  vla_attention::Keys keys;
  keys.k = p.k + b * p.k_sb + hk * p.k_sh;
  keys.v = p.v + b * p.v_sb + hk * p.v_sh;
  keys.valid = p.valid ? p.valid + b * p.valid_sb : nullptr;
  keys.k_ss = p.k_ss;
  keys.v_ss = p.v_ss;
  keys.seq = p.seq;
  keys.dim = p.dim;
  keys.sm_scale = p.sm_scale;
  keys.causal = p.causal;

  uint32_t qa[DP / 16][4];
  vla_attention::load_q<DP>(qa, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, r_lo,
                            r_hi, p.seq, p.dim);
  float acc[DP / 8][4];
  float l_lo, l_hi;
  vla_attention::attend<DP>(keys, tiles, qa, r_lo, r_hi, acc, l_lo, l_hi);

  __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= p.dim) continue;
    if (r_lo < p.seq) {
      *reinterpret_cast<__nv_bfloat162*>(o + r_lo * p.o_ss + d) =
          __floats2bfloat162_rn(acc[n][0] / l_lo, acc[n][1] / l_lo);
    }
    if (r_hi < p.seq) {
      *reinterpret_cast<__nv_bfloat162*>(o + r_hi * p.o_ss + d) =
          __floats2bfloat162_rn(acc[n][2] / l_hi, acc[n][3] / l_hi);
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  dim3 grid((p.seq + kRowsPerCta - 1) / kRowsPerCta, p.heads, batch);
  fused_attention_kernel<DP><<<grid, kWarps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, S, D), k/v (B, Hkv, S, D), o (B, H, S, D): bf16, element strides
// per (batch, head, position), the head dim contiguous. D % 8 == 0, D <= 128,
// every stride a multiple of 8 and the pointers 16-byte aligned (the wrapper
// checks). valid: (B, S) int32 or null. Returns a cudaError_t.
extern "C" int vla_fused_attention_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    int batch, int heads, int kv_heads, int seq, int dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long valid_sb, float sm_scale, int causal, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.valid = static_cast<const int32_t*>(valid);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seq = seq;
  p.dim = dim;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.valid_sb = valid_sb;
  p.sm_scale = sm_scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((dim + 15) / 16 * 16) {
    case 16: return launch<16>(p, batch, s);
    case 32: return launch<32>(p, batch, s);
    case 48: return launch<48>(p, batch, s);
    case 64: return launch<64>(p, batch, s);
    case 80: return launch<80>(p, batch, s);
    case 96: return launch<96>(p, batch, s);
    case 112: return launch<112>(p, batch, s);
    case 128: return launch<128>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
