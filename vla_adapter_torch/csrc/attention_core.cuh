// One-pass softmax attention of a CTA's warps against every key of one kv
// head: the attention stage of megalayer_w8a8.cu (kernel B6), B1's recipe
// (fused_attention.cu) for a CTA that runs other stages between its
// attention items. Same numerics as the Pallas kernel:
//
//   s   = (q . k) * sm_scale + bias      fp32, bias = 0 / -2e9 from `valid`
//   m   = max_k s
//   p   = bf16(exp(s - m))               unnormalised, rounded before p @ v
//   l   = sum_k float(p)                 sum of the ROUNDED probabilities
//   out = bf16((p @ v) / l)              fp32 accumulation
//
// The unit of work is one warp: 16 query rows of one head, mma.sync
// m16n8k16 (bf16 in, fp32 accumulate). Every warp of the CTA attends
// against the same kv head, so the query heads of a GQA group share its
// K/V tiles, which stream through a two-slot ring fed by cp.async (K tiles
// with their valid flags, then V tiles) and are read with ldmatrix (V with
// ldmatrix.trans). Each working warp keeps its 16 x S fp32 scores in
// shared memory in mma fragment order: pass 1 over the K tiles computes s
// once and takes the exact row max; pass 2 over the V tiles rounds
// p = bf16(exp(s - m)) against that final max and accumulates l and p @ v.
// That takes 4 KB per warp per 64 keys (40 KB at S = 640).

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace vla_attention {

constexpr int kKeyTile = 64;
constexpr float kNegInf = -2.0e9f;  // the Pallas kernel's NEG_INF

// A ring slot: a tile of 64 keys (K, or V in pass 2) in rows of DP + 8
// bf16 (conflict-free ldmatrix), then the tile's 64 valid flags. DP is the
// head dim padded to a multiple of 16; columns [dim, DP) are zero.
template <int DP>
struct Ring {
  static constexpr int kStride = DP + 8;
  static constexpr int kTileBytes = kKeyTile * kStride * 2;
  static constexpr int kSlot = kTileBytes + kKeyTile * 4;
};

// Shared memory of `warps` working warps at `seq` keys: two slots, then
// each warp's 16 x (64 tiles) fp32 scores.
template <int DP>
__host__ __device__ inline size_t smem_bytes(int warps, int seq) {
  const int tiles = (seq + kKeyTile - 1) / kKeyTile;
  return 2 * static_cast<size_t>(Ring<DP>::kSlot) +
         static_cast<size_t>(warps) * tiles * kKeyTile * 16 * 4;
}

// The keys and values of one kv head: element strides per position, the
// head dim contiguous, rows 16-byte aligned.
struct Keys {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* valid;  // (seq), nonzero = real key; null = all valid
  long long k_ss, v_ss;
  int seq, dim;
  float sm_scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared, asynchronously; zeros where !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
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

// Start copying keys [key0, key0 + 64) of `src` (row stride ss) into a
// tile of shared memory: zeros past seq and past dim.
template <int DP>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ss, int key0, int seq, int dim) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kKeyTile * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool in = key0 + r < seq && c < dim;  // dim % 8 == 0: whole chunks
    cp_async16(dst + r * Ring<DP>::kStride + c, in ? src + (key0 + r) * ss + c : src, in);
  }
}

// Every thread of the CTA calls it (the ring is staged by all of them
// between __syncthreads). A warp with `active` attends query rows
// row0 .. row0 + 15 of q (row stride q_ss; rows >= seq read as zero)
// against every key of `a` and writes bf16((p @ v) / l) of its rows < seq
// to out (row stride o_ss); warp w's scores live at
// smem + 2 * kSlot + w * tiles * 4 KB.
template <int DP>
__device__ __forceinline__ void attend(const Keys& a, unsigned char* smem, bool active,
                                       const __nv_bfloat16* q, long long q_ss, int row0,
                                       __nv_bfloat16* out, long long o_ss) {
  constexpr int kStride = Ring<DP>::kStride;
  constexpr int kSlot = Ring<DP>::kSlot;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r_lo = row0 + g;
  const int r_hi = row0 + g + 8;
  const int tiles = (a.seq + kKeyTile - 1) / kKeyTile;
  float4* scores = reinterpret_cast<float4*>(smem + 2 * kSlot) +
                   warp * tiles * (kKeyTile / 8) * 32;

  // Item i of the stream: K tile i (i < tiles) with its valid flags, then
  // V tile i - tiles.
  auto issue = [&](int item) {
    unsigned char* slot = smem + (item & 1) * kSlot;
    __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(slot);
    int32_t* vs = reinterpret_cast<int32_t*>(slot + kSlot - kKeyTile * 4);
    if (item >= tiles) {
      stage_tile<DP>(kt, a.v, a.v_ss, (item - tiles) * kKeyTile, a.seq, a.dim);
    } else {
      const int key0 = item * kKeyTile;
      stage_tile<DP>(kt, a.k, a.k_ss, key0, a.seq, a.dim);
      if (a.valid != nullptr) {
        for (int i = threadIdx.x; i < kKeyTile; i += blockDim.x) {
          const int key = key0 + i;
          cp_async4(vs + i, key < a.seq ? a.valid + key : a.valid, key < a.seq);
        }
      }
    }
    cp_async_commit();
  };

  // q A-fragments of rows r_lo / r_hi; dim % 8 == 0, so d < dim implies
  // d + 1 < dim.
  uint32_t qa[DP / 16][4];
  {
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (i & 1) ? r_hi : r_lo;
        const int d = c * 16 + 2 * t + ((i & 2) ? 8 : 0);
        __nv_bfloat16 x0 = zero, x1 = zero;
        if (active && r < a.seq && d < a.dim) {
          const __nv_bfloat16* src = q + r * q_ss + d;
          x0 = src[0];
          x1 = src[1];
        }
        qa[c][i] = pack_bf16(x0, x1);
      }
    }
  }

  float m_lo = -INFINITY, m_hi = -INFINITY;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float l_lo = 0.0f, l_hi = 0.0f;

  issue(0);
  for (int item = 0; item < 2 * tiles; ++item) {
    cp_async_wait_all();  // this thread's copies of `item` have landed
    __syncthreads();      // everyone's have, and `item - 1`'s slot is free
    if (item + 1 < 2 * tiles) issue(item + 1);
    if (!active) continue;
    const unsigned char* slot = smem + (item & 1) * kSlot;
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(slot);

    if (item < tiles) {
      // --- pass 1: scores once, the exact row max ---
      const int32_t* vs = reinterpret_cast<const int32_t*>(slot + kSlot - kKeyTile * 4);
      const int key0 = item * kKeyTile;
      float sc[kKeyTile / 8][4];
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
      // ldmatrix.x4 over keys 16jj..16jj+15 and dims 16c..16c+15: matrices
      // (keys +0, d +0), (keys +0, d +8), (keys +8, d +0), (keys +8, d +8)
      const int mi = lane / 8;
      const __nv_bfloat16* base = kt + ((mi >> 1) * 8 + lane % 8) * kStride + (mi & 1) * 8;
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        uint32_t kb[kKeyTile / 16][4];
#pragma unroll
        for (int jj = 0; jj < kKeyTile / 16; ++jj)
          ldmatrix_x4(kb[jj], base + jj * 16 * kStride + c * 16);
#pragma unroll
        for (int jj = 0; jj < kKeyTile / 16; ++jj) {
          mma_bf16(sc[2 * jj], qa[c], kb[jj][0], kb[jj][1]);
          mma_bf16(sc[2 * jj + 1], qa[c], kb[jj][2], kb[jj][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = 8 * j + 2 * t + e;
          const int flag = vs[kl];  // loaded whether or not `valid` is given
          float bias = (a.valid == nullptr || flag > 0) ? 0.0f : kNegInf;
          bias = key0 + kl < a.seq ? bias : -INFINITY;
          sc[j][e] = sc[j][e] * a.sm_scale + bias;
          sc[j][2 + e] = sc[j][2 + e] * a.sm_scale + bias;
        }
        m_lo = fmaxf(m_lo, fmaxf(sc[j][0], sc[j][1]));
        m_hi = fmaxf(m_hi, fmaxf(sc[j][2], sc[j][3]));
        scores[(item * (kKeyTile / 8) + j) * 32 + lane] =
            make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
      }
      if (item == tiles - 1) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
          m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
        }
      }
      continue;
    }

    // --- pass 2: p = bf16(exp(s - m)), l = sum(p), acc += p @ v ---
    const int tile = item - tiles;
    float sc[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
      const float4 s4 = scores[(tile * (kKeyTile / 8) + j) * 32 + lane];
      sc[j][0] = s4.x;
      sc[j][1] = s4.y;
      sc[j][2] = s4.z;
      sc[j][3] = s4.w;
    }
    // ldmatrix.x4.trans over keys 16kk..16kk+15 and dims 16n2..16n2+15:
    // matrices (keys +0, d +0), (keys +8, d +0), (keys +0, d +8), (keys +8, d +8)
    const int mi = lane / 8;
    const __nv_bfloat16* vbase = kt + ((mi & 1) * 8 + lane % 8) * kStride + (mi >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      uint32_t vb[DP / 16][4];
#pragma unroll
      for (int n2 = 0; n2 < DP / 16; ++n2)
        ldmatrix_x4_trans(vb[n2], vbase + kk * 16 * kStride + n2 * 16);
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
        // row g (keys 2t, 2t+1), then row g + 8, each pair rounded to bf16
        // by one packed conversion; l sums the rounded values
        const __nv_bfloat162 lo = __floats2bfloat162_rn(expf(sc[j][0] - m_lo),
                                                        expf(sc[j][1] - m_lo));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(expf(sc[j][2] - m_hi),
                                                        expf(sc[j][3] - m_hi));
        const float2 lof = __bfloat1622float2(lo), hif = __bfloat1622float2(hi);
        l_lo += lof.x + lof.y;
        l_hi += hif.x + hif.y;
        pa[2 * half + 0] = *reinterpret_cast<const uint32_t*>(&lo);
        pa[2 * half + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
#pragma unroll
      for (int n2 = 0; n2 < DP / 16; ++n2) {
        mma_bf16(acc[2 * n2], pa, vb[n2][0], vb[n2][1]);
        mma_bf16(acc[2 * n2 + 1], pa, vb[n2][2], vb[n2][3]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= a.dim) continue;
    if (r_lo < a.seq)
      *reinterpret_cast<__nv_bfloat162*>(out + r_lo * o_ss + d) = __floats2bfloat162_rn(
          __fdiv_rn(acc[n][0], l_lo), __fdiv_rn(acc[n][1], l_lo));
    if (r_hi < a.seq)
      *reinterpret_cast<__nv_bfloat162*>(out + r_hi * o_ss + d) = __floats2bfloat162_rn(
          __fdiv_rn(acc[n][2], l_hi), __fdiv_rn(acc[n][3], l_hi));
  }
}

}  // namespace vla_attention
