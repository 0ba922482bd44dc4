// Two-pass softmax attention of one warp's 16 query rows against every key
// of one kv head: the attention loop of megalayer_w8a8.cu (kernel B6; B1,
// fused_attention.cu, has its own one-pass design), which keeps the Pallas
// numerics
//
//   s   = (q . k) * sm_scale + bias      fp32, bias = 0 / -2e9 from `valid`
//   s   = -2e9 where key > query         (causal only)
//   m   = max_k s
//   p   = bf16(exp(s - m))               unnormalised, rounded before p @ v
//   l   = sum_k float(p)                 sum of the ROUNDED probabilities
//   acc = p @ v                          fp32 accumulation; the caller divides
//
// A Hopper SM cannot hold a (rows, S) fp32 score block in registers, so the
// softmax is two passes over 64-key tiles: pass 1 computes scores and the
// exact row max, pass 2 recomputes the same scores (bitwise the same: same
// mma order), rounds p to bf16 with the final max, and accumulates l and
// p @ v. An online softmax would round p against a running max instead.
// K and V tiles are staged through shared memory by every thread of the
// block; V is stored transposed so the p @ v B-fragments are 32-bit loads.
// Each warp runs mma.sync m16n8k16 (bf16 in, fp32 accumulate).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace vla_attention {

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

// The block's shared memory: one tile of keys of K, the same keys of V
// transposed, and their bias. DP is the head dim padded to a multiple of 16
// (the mma k-depth); columns [dim, DP) are zero.
template <int DP>
struct Tiles {
  static constexpr int kKStride = DP + 8;        // bf16 elements per K row
  static constexpr int kVStride = kKeyTile + 8;  // bf16 elements per V^T row
  __nv_bfloat16 k[kKeyTile * kKStride];
  __nv_bfloat16 vt[DP * kVStride];
  float bias[kKeyTile];
};

// The keys and values of one (batch, kv head): element strides per
// position, the head dim contiguous, rows 16-byte aligned.
struct Keys {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* valid;  // (seq), nonzero = real key; null = all valid
  long long k_ss, v_ss;
  int seq, dim;
  float sm_scale;
  int causal;
};

// q A-fragments of rows r_lo / r_hi of q (row stride q_ss) for all DP / 16
// k-chunks, straight from device memory; rows >= seq and dims >= dim are
// zero. dim % 8 == 0, so d < dim implies d + 1 < dim.
template <int DP>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DP / 16][4],
                                       const __nv_bfloat16* q, long long q_ss,
                                       int r_lo, int r_hi, int seq, int dim) {
  const int t = threadIdx.x % 4;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? r_hi : r_lo;
      const int d = c * 16 + 2 * t + ((i & 2) ? 8 : 0);
      __nv_bfloat16 x0 = zero, x1 = zero;
      if (r < seq && d < dim) {
        const __nv_bfloat16* src = q + r * q_ss + d;
        x0 = src[0];
        x1 = src[1];
      }
      qa[c][i] = pack_bf16(x0, x1);
    }
  }
}

// The warp's rows r_lo = row0 + g and r_hi = row0 + g + 8 (g = lane / 4)
// against every key of `a`: acc (the unnormalised p @ v; thread (g, t)
// holds columns 8n + 2t, 8n + 2t + 1 of rows r_lo (0, 1) and r_hi (2, 3))
// and l per row, reduced across the quad. Every thread of the block must
// call it: the tiles are staged by all of them between __syncthreads.
template <int DP>
__device__ __forceinline__ void attend(const Keys& a, Tiles<DP>& s,
                                       const uint32_t (&qa)[DP / 16][4],
                                       int r_lo, int r_hi,
                                       float (&acc)[DP / 8][4], float& l_lo,
                                       float& l_hi) {
  constexpr int kKStride = Tiles<DP>::kKStride;
  constexpr int kVStride = Tiles<DP>::kVStride;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // Stage keys [key0, key0 + 64) of K (and V^T) into shared memory, zero
  // beyond seq and dim; bias row: 0 valid, -2e9 invalid, -inf out of range.
  auto load_tile = [&](int key0, bool with_v) {
    constexpr int kVecPerRow = DP / 8;
    for (int idx = threadIdx.x; idx < kKeyTile * kVecPerRow; idx += blockDim.x) {
      const int r = idx / kVecPerRow;
      const int c = (idx % kVecPerRow) * 8;
      const int key = key0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < a.seq && c < a.dim) {
        kv = *reinterpret_cast<const uint4*>(a.k + key * a.k_ss + c);
        if (with_v) vv = *reinterpret_cast<const uint4*>(a.v + key * a.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&s.k[r * kKStride + c]) = kv;
      if (with_v) {
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int j = 0; j < 8; ++j) s.vt[(c + j) * kVStride + r] = ve[j];
      }
    }
    for (int r = threadIdx.x; r < kKeyTile; r += blockDim.x) {
      const int key = key0 + r;
      float bias = -INFINITY;
      if (key < a.seq) bias = (a.valid == nullptr || a.valid[key] > 0) ? 0.0f : kNegInf;
      s.bias[r] = bias;
    }
  };

  // Scores of this warp's 16 rows against the staged 64 keys; sc[j] holds
  // keys 8j + 2t, 8j + 2t + 1 for rows r_lo (0, 1) and r_hi (2, 3).
  auto scores = [&](int key0, float (&sc)[kKeyTile / 8][4]) {
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
      const __nv_bfloat16* krow = &s.k[(8 * j + g) * kKStride + 2 * t];
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + c * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + c * 16 + 8);
        mma_bf16(sc[j], qa[c], b0, b1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = 8 * j + 2 * t + (i & 1);
        const int key = key0 + kl;
        const int row = (i & 2) ? r_hi : r_lo;
        float v = sc[j][i] * a.sm_scale + s.bias[kl];
        if (a.causal && key > row && key < a.seq) v = kNegInf;
        sc[j][i] = v;
      }
    }
  };

  // Pass 1: exact row maxima.
  float m_lo = -INFINITY, m_hi = -INFINITY;
  for (int key0 = 0; key0 < a.seq; key0 += kKeyTile) {
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
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  l_lo = 0.0f;
  l_hi = 0.0f;
  for (int key0 = 0; key0 < a.seq; key0 += kKeyTile) {
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
        const __nv_bfloat16* vrow = &s.vt[(8 * n + g) * kVStride + kk * 16 + 2 * t];
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
}

}  // namespace vla_attention
