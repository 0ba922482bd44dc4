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
// tiles: pass 1 computes scores and the exact row max, pass 2 recomputes the
// same scores (bitwise the same: same mma order), rounds p to bf16 with the
// final max, and accumulates l and p @ v. That keeps the Pallas numerics
// (p rounded against the final max, not a running one) at the cost of one
// extra q.k product. K and V tiles are staged through shared memory; V is
// stored transposed so the p @ v B-fragments are 32-bit loads.
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

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 16;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;  // 64 query rows
constexpr int kKeyTile = 64;
constexpr float kNegInf = -2.0e9f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// DP: head dim padded to a multiple of 16 (the mma k-depth); columns
// [dim, DP) are zero in shared memory and in the q fragments.
template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
fused_attention_kernel(const Params p) {
  constexpr int kKStride = DP + 8;        // bf16 elements per K row in smem
  constexpr int kVStride = kKeyTile + 8;  // bf16 elements per V^T row in smem
  __shared__ __align__(16) __nv_bfloat16 k_s[kKeyTile * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt_s[DP * kVStride];
  __shared__ float bias_s[kKeyTile];

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

  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + hk * p.v_sh;
  const int32_t* valid = p.valid ? p.valid + b * p.valid_sb : nullptr;

  // q A-fragments for all DP/16 k-chunks, straight from device memory.
  constexpr int kChunks = DP / 16;
  uint32_t qa[kChunks][4];
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? r_hi : r_lo;
      const int d = c * 16 + 2 * t + ((i & 2) ? 8 : 0);
      __nv_bfloat16 x0 = zero, x1 = zero;
      if (r < p.seq && d < p.dim) {  // dim % 8 == 0: d + 1 < dim as well
        const __nv_bfloat16* src = q + r * p.q_ss + d;
        x0 = src[0];
        x1 = src[1];
      }
      qa[c][i] = pack_bf16(x0, x1);
    }
  }

  // Stage keys [key0, key0 + 64) of K (and V^T) into shared memory, zero
  // beyond seq and dim; bias row: 0 valid, -2e9 invalid, -inf out of range.
  auto load_tile = [&](int key0, bool with_v) {
    constexpr int kVecPerRow = DP / 8;
    for (int idx = threadIdx.x; idx < kKeyTile * kVecPerRow; idx += blockDim.x) {
      const int r = idx / kVecPerRow;
      const int c = (idx % kVecPerRow) * 8;
      const int key = key0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < p.seq && c < p.dim) {
        kv = *reinterpret_cast<const uint4*>(k + key * p.k_ss + c);
        if (with_v) vv = *reinterpret_cast<const uint4*>(v + key * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&k_s[r * kKStride + c]) = kv;
      if (with_v) {
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int j = 0; j < 8; ++j) vt_s[(c + j) * kVStride + r] = ve[j];
      }
    }
    for (int r = threadIdx.x; r < kKeyTile; r += blockDim.x) {
      const int key = key0 + r;
      float bias = -INFINITY;
      if (key < p.seq) bias = (valid == nullptr || valid[key] > 0) ? 0.0f : kNegInf;
      bias_s[r] = bias;
    }
  };

  // Scores of this warp's 16 rows against the staged 64 keys; sc[j] holds
  // keys 8j + 2t, 8j + 2t + 1 for rows r_lo (0, 1) and r_hi (2, 3).
  auto scores = [&](int key0, float (&sc)[kKeyTile / 8][4]) {
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
      const __nv_bfloat16* krow = &k_s[(8 * j + g) * kKStride + 2 * t];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + c * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + c * 16 + 8);
        mma_bf16(sc[j], qa[c], b0, b1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = 8 * j + 2 * t + (i & 1);
        const int key = key0 + kl;
        const int row = (i & 2) ? r_hi : r_lo;
        float s = sc[j][i] * p.sm_scale + bias_s[kl];
        if (p.causal && key > row && key < p.seq) s = kNegInf;
        sc[j][i] = s;
      }
    }
  };

  // Pass 1: exact row maxima.
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int key0 = 0; key0 < p.seq; key0 += kKeyTile) {
    __syncthreads();
    load_tile(key0, false);
    __syncthreads();
    float sc[kKeyTile / 8][4];
    scores(key0, sc);
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      m_lo = fmaxf(m_lo, fmaxf(sc[j][0], sc[j][1]));
      m_hi = fmaxf(m_hi, fmaxf(sc[j][2], sc[j][3]));
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
  }

  // Pass 2: p = bf16(exp(s - m)), l = sum(p), acc = p @ v.
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float l_lo = 0.0f, l_hi = 0.0f;
  for (int key0 = 0; key0 < p.seq; key0 += kKeyTile) {
    __syncthreads();
    load_tile(key0, true);
    __syncthreads();
    float sc[kKeyTile / 8][4];
    scores(key0, sc);
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
        __nv_bfloat16 e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[i] = __float2bfloat16(expf(sc[j][i] - ((i & 2) ? m_hi : m_lo)));
        }
        l_lo += __bfloat162float(e[0]) + __bfloat162float(e[1]);
        l_hi += __bfloat162float(e[2]) + __bfloat162float(e[3]);
        pa[2 * half + 0] = pack_bf16(e[0], e[1]);  // row g,     keys 2t, 2t+1
        pa[2 * half + 1] = pack_bf16(e[2], e[3]);  // row g + 8, keys 2t, 2t+1
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const __nv_bfloat16* vrow = &vt_s[(8 * n + g) * kVStride + kk * 16 + 2 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }

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
