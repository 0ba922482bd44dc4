// The backward of softmax attention for Hopper (sm_90a), bf16 in / bf16
// out: dq, dk and dv of B1's attention from q, k, v, the key validity and
// the output's gradient dO.
//
// Replaces the JAX package's backward of the Pallas attention,
// vla_adapter_tpu/ops/attention.py:_attention_bwd, which is
// jax.vjp(xla_attention) in XLA (the TPU package has no backward kernel).
// It computes what that vjp computes:
//
//   s   = (q . k) * sm_scale, masked to -2e9 (fp32)  masked: invalid key,
//                                                     or key > query (causal)
//   p   = softmax(s)                                  fp32, exact row max
//   dv  = bf16(p)^T . dO
//   dp  = bf16(dO . v^T)                              rounded as in the vjp
//   ds  = p * (dp - rowsum(dp * p)), 0 where masked, times sm_scale
//   dq  = ds . k        dk = ds^T . q                 (bf16 ds into the mma)
//
// with the dk and dv of the query heads of a GQA group summed over the
// group. A row with no valid key has p = 1/S over all S keys, as
// xla_attention gives it, and ds = 0. Unlike B1's forward, p is the exact
// fp32 softmax (normalized, not rounded) everywhere but the dv product.
//
// Design: two kernels on the caller's stream, no atomics (a rerun gives
// the same bits), mma.sync m16n8k16 bf16 tiles, cp.async rings and the
// ldmatrix fragment code of B1 (attention_core.cuh).
//
// 1. Rows (`attn_bwd_dq_kernel`), one warp per 16 query rows of one head,
//    the CTA's warps on one kv head: three passes over the 64-key tiles.
//    Pass 1 (K tiles) computes s once, keeps it in shared memory (fp32, in
//    mma fragment order, as B1's one-pass branch) and takes the exact row
//    max; then l = sum exp(s - m). Pass 2 (V tiles) computes dp, rounds
//    it to bf16, replaces s by p = exp(s - m) / l and keeps bf16(dp) beside
//    it, and sums D = rowsum(dp * p). Pass 3 (K tiles again) forms ds from
//    the kept p and dp and accumulates dq. It writes dq and each row's m,
//    l and D (fp32) for kernel 2. Three products; 6 KB of shared memory per
//    warp per 64 keys (60 KB at S = 640), so at most 3 warps a CTA there.
// 2. Columns (`attn_bwd_dkdv_kernel`), one warp per 16 keys of one kv
//    head, 4 warps a CTA: the warp's k and v rows stay in registers as
//    mma A fragments, and the q and dO tiles of every head of the group
//    stream past (64 query rows per item, with their m, l and D). For
//    each 16 queries it recomputes s^T = k . q^T and dp^T = v . dO^T,
//    forms p from m and l, and accumulates dv += bf16(p)^T . dO and
//    dk += bf16(ds)^T . q in registers: the GQA sum costs nothing. Four
//    products.
//
// Bound on this card: five products of 2 B H S^2 D operations are the
// least work (the recomputed q.k^T, dv, dp, dq, dk), bf16 tensor-core
// bound at the training shapes (the LLM's S = 640 does ~1000 operations
// per byte of q, k, v, dO, dq, dk, dv). The design does seven (q.k^T and
// dO.v^T once more in kernel 2) to keep every sum in one CTA without
// atomics, and keeps s, p and dp out of device memory: XLA's backward
// writes and reads the fp32 (B, H, S, S) scores, probabilities and their
// gradient. Making it fast (wgmma, TMA, warp-specialized pipelines) is
// left to a later change.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace {

using vla_attention::Ring;
using vla_attention::cp_async16;
using vla_attention::cp_async4;
using vla_attention::cp_async_commit;
using vla_attention::cp_async_wait_all;
using vla_attention::kKeyTile;
using vla_attention::kNegInf;
using vla_attention::ldmatrix_x4;
using vla_attention::ldmatrix_x4_trans;
using vla_attention::mma_bf16;
using vla_attention::pack_bf16;
using vla_attention::stage_tile;

constexpr int kRowWarpsMax = 4;  // kernel 1: warps (16 query rows each) per CTA
constexpr int kColWarps = 4;     // kernel 2: warps (16 keys each) per CTA
constexpr int kMaxSmem = 232448;
// kernel 1's shared memory per warp per 64-key tile: p (fp32) and bf16(dp)
constexpr int kRowBytesPerTile = kKeyTile * 16 * (4 + 2);

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const int32_t* valid;  // (B, S) with row stride valid_sb; null = all valid
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stats;  // (3, B, H, S) contiguous: row max m, row sum l, D
  int batch, heads, kv_heads, seq, dim;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  long long valid_sb;
  float sm_scale;
  int causal;
  int row_warps;   // kernel 1 warps per CTA
  int row_blocks;  // ceil(seq / 16)
};

template <int DP>
size_t row_smem_bytes(int warps, int seq) {
  const int tiles = (seq + kKeyTile - 1) / kKeyTile;
  return 2 * static_cast<size_t>(Ring<DP>::kSlot) +
         static_cast<size_t>(warps) * tiles * kRowBytesPerTile;
}

template <int DP>
__host__ __device__ constexpr int col_slot_bytes() {  // a q tile, a dO tile, 64 rows' m, l, D
  return 2 * Ring<DP>::kTileBytes + 3 * kKeyTile * 4;
}

// The mma A fragments of rows r_lo = row0 + g and r_hi = row0 + g + 8 of
// `src` (row stride ss): zero past seq, past dim and when !active.
// dim % 8 == 0, so d < dim implies d + 1 < dim.
template <int DP>
__device__ __forceinline__ void load_rows(uint32_t (&a)[DP / 16][4],
                                          const __nv_bfloat16* src, long long ss,
                                          int r_lo, int r_hi, int t, int seq,
                                          int dim, bool active) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? r_hi : r_lo;
      const int d = c * 16 + 2 * t + ((i & 2) ? 8 : 0);
      __nv_bfloat16 x0 = zero, x1 = zero;
      if (active && r < seq && d < dim) {
        const __nv_bfloat16* p = src + r * ss + d;
        x0 = p[0];
        x1 = p[1];
      }
      a[c][i] = pack_bf16(x0, x1);
    }
  }
}

// The warp's 16 rows (A fragments a) against rows 16kk .. 16kk + 15 of a
// shared-memory tile (rows of DP + 8 bf16), contracted over the head dim:
// sc[h] holds tile rows 16kk + 8h + 2t, + 1 of the warp's rows g (0, 1)
// and g + 8 (2, 3).
template <int DP>
__device__ __forceinline__ void pair_products(float (&sc)[2][4],
                                              const uint32_t (&a)[DP / 16][4],
                                              const __nv_bfloat16* tile, int kk,
                                              int lane) {
  constexpr int kStride = Ring<DP>::kStride;
#pragma unroll
  for (int h = 0; h < 2; ++h) sc[h][0] = sc[h][1] = sc[h][2] = sc[h][3] = 0.0f;
  // ldmatrix.x4 over tile rows 16kk..16kk+15 and dims 16c..16c+15:
  // matrices (rows +0, d +0), (rows +0, d +8), (rows +8, d +0), (rows +8, d +8)
  const int mi = lane / 8;
  const __nv_bfloat16* base =
      tile + (kk * 16 + (mi >> 1) * 8 + lane % 8) * kStride + (mi & 1) * 8;
#pragma unroll
  for (int c = 0; c < DP / 16; ++c) {
    uint32_t b[4];
    ldmatrix_x4(b, base + c * 16);
    mma_bf16(sc[0], a[c], b[0], b[1]);
    mma_bf16(sc[1], a[c], b[2], b[3]);
  }
}

// acc (the warp's 16 rows x DP) += pa (16 rows x tile rows 16kk..16kk+15,
// an A fragment) . those tile rows (16 x DP).
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4],
                                           const uint32_t (&pa)[4],
                                           const __nv_bfloat16* tile, int kk,
                                           int lane) {
  constexpr int kStride = Ring<DP>::kStride;
  // ldmatrix.x4.trans over tile rows 16kk..16kk+15 and dims 16n2..16n2+15:
  // matrices (rows +0, d +0), (rows +8, d +0), (rows +0, d +8), (rows +8, d +8)
  const int mi = lane / 8;
  const __nv_bfloat16* base =
      tile + (kk * 16 + (mi & 1) * 8 + lane % 8) * kStride + (mi >> 1) * 8;
#pragma unroll
  for (int n2 = 0; n2 < DP / 16; ++n2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, base + n2 * 16);
    mma_bf16(acc[2 * n2], pa, b[0], b[1]);
    mma_bf16(acc[2 * n2 + 1], pa, b[2], b[3]);
  }
}

// Rows r_lo / r_hi of acc (C fragments) to dst (row stride ss) in bf16,
// rows < seq and dims < dim.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4],
                                           __nv_bfloat16* dst, long long ss,
                                           int r_lo, int r_hi, int t, int seq,
                                           int dim) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= dim) continue;
    if (r_lo < seq)
      *reinterpret_cast<__nv_bfloat162*>(dst + r_lo * ss + d) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (r_hi < seq)
      *reinterpret_cast<__nv_bfloat162*>(dst + r_hi * ss + d) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---------------------------------------------------------------------------
// Kernel 1: dq and the row statistics.
template <int DP>
__global__ void __launch_bounds__(kRowWarpsMax * 32)
attn_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSlot = Ring<DP>::kSlot;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int groups = p.heads / p.kv_heads;
  const int unit = blockIdx.x * p.row_warps + warp;
  const bool active = unit < groups * p.row_blocks;
  const int h = hk * groups + (active ? unit / p.row_blocks : 0);
  const int row0 = (unit % p.row_blocks) * 16;
  const int r_lo = row0 + g;
  const int r_hi = row0 + g + 8;
  const int tiles = (p.seq + kKeyTile - 1) / kKeyTile;

  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  const int32_t* valid = p.valid ? p.valid + b * p.valid_sb : nullptr;
  // the warp's p (float4 per lane per 8 keys) and bf16(dp) (uint2 likewise)
  float4* pbuf = reinterpret_cast<float4*>(smem + 2 * kSlot) + warp * tiles * 8 * 32;
  uint2* dbuf = reinterpret_cast<uint2*>(smem + 2 * kSlot +
                                         p.row_warps * tiles * 8 * 32 * 16) +
                warp * tiles * 8 * 32;

  // Item i of the stream: K tile i % tiles (passes 0 and 2, with its valid
  // flags) or V tile (pass 1).
  auto issue = [&](int item) {
    unsigned char* slot = smem + (item & 1) * kSlot;
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(slot);
    int32_t* vs = reinterpret_cast<int32_t*>(slot + kSlot - kKeyTile * 4);
    const int key0 = (item % tiles) * kKeyTile;
    if (item / tiles == 1) {
      stage_tile<DP>(tile, vg, p.v_ss, key0, p.seq, p.dim);
    } else {
      stage_tile<DP>(tile, kg, p.k_ss, key0, p.seq, p.dim);
      if (valid != nullptr) {
        for (int i = threadIdx.x; i < kKeyTile; i += blockDim.x) {
          const int key = key0 + i;
          cp_async4(vs + i, key < p.seq ? valid + key : valid, key < p.seq);
        }
      }
    }
    cp_async_commit();
  };

  uint32_t qa[DP / 16][4], oa[DP / 16][4];
  load_rows<DP>(qa, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, r_lo, r_hi, t,
                p.seq, p.dim, active);
  load_rows<DP>(oa, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, r_lo, r_hi, t,
                p.seq, p.dim, active);

  // whether key (local kl of the tile at key0) is a real key row `row` sees
  auto allowed = [&](const int32_t* vs, int key0, int kl, int row) {
    const int key = key0 + kl;
    bool ok = key < p.seq && (valid == nullptr || vs[kl] > 0);
    if (p.causal) ok = ok && key <= row;
    return ok;
  };

  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.0f, l_hi = 0.0f, d_lo = 0.0f, d_hi = 0.0f;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  issue(0);
  for (int item = 0; item < 3 * tiles; ++item) {
    cp_async_wait_all();  // this thread's copies of `item` have landed
    __syncthreads();      // everyone's have, and `item - 1`'s slot is free
    if (item + 1 < 3 * tiles) issue(item + 1);
    if (!active) continue;
    const unsigned char* slot = smem + (item & 1) * kSlot;
    const __nv_bfloat16* tile = reinterpret_cast<const __nv_bfloat16*>(slot);
    const int32_t* vs = reinterpret_cast<const int32_t*>(slot + kSlot - kKeyTile * 4);
    const int pass = item / tiles;
    const int tl = item % tiles;
    const int key0 = tl * kKeyTile;

    if (pass == 0) {
      // --- pass 1: s once (masked by a select, as xla_attention), row max ---
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        float sc[2][4];
        pair_products<DP>(sc, qa, tile, kk, lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kl = 16 * kk + 8 * hh + 2 * t + (i & 1);
            const int row = (i & 2) ? r_hi : r_lo;
            float s = allowed(vs, key0, kl, row) ? sc[hh][i] * p.sm_scale : kNegInf;
            if (key0 + kl >= p.seq) s = -INFINITY;  // not a key at all
            sc[hh][i] = s;
          }
          m_lo = fmaxf(m_lo, fmaxf(sc[hh][0], sc[hh][1]));
          m_hi = fmaxf(m_hi, fmaxf(sc[hh][2], sc[hh][3]));
          pbuf[(tl * 8 + 2 * kk + hh) * 32 + lane] =
              make_float4(sc[hh][0], sc[hh][1], sc[hh][2], sc[hh][3]);
        }
      }
      if (tl == tiles - 1) {
        m_lo = quad_max(m_lo);
        m_hi = quad_max(m_hi);
        for (int j = 0; j < tiles * 8; ++j) {
          const float4 s4 = pbuf[j * 32 + lane];
          l_lo += expf(s4.x - m_lo) + expf(s4.y - m_lo);
          l_hi += expf(s4.z - m_hi) + expf(s4.w - m_hi);
        }
        l_lo = quad_sum(l_lo);
        l_hi = quad_sum(l_hi);
      }
    } else if (pass == 1) {
      // --- pass 2: dp = bf16(dO . v^T); p = exp(s - m) / l; D += p dp ---
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        float dp[2][4];
        pair_products<DP>(dp, oa, tile, kk, lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = (tl * 8 + 2 * kk + hh) * 32 + lane;
          const float4 s4 = pbuf[j];
          const float4 p4 = make_float4(expf(s4.x - m_lo) / l_lo, expf(s4.y - m_lo) / l_lo,
                                        expf(s4.z - m_hi) / l_hi, expf(s4.w - m_hi) / l_hi);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(dp[hh][0], dp[hh][1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(dp[hh][2], dp[hh][3]);
          const float2 lof = __bfloat1622float2(lo), hif = __bfloat1622float2(hi);
          d_lo += p4.x * lof.x + p4.y * lof.y;
          d_hi += p4.z * hif.x + p4.w * hif.y;
          pbuf[j] = p4;
          dbuf[j] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                               *reinterpret_cast<const uint32_t*>(&hi));
        }
      }
      if (tl == tiles - 1) {
        d_lo = quad_sum(d_lo);
        d_hi = quad_sum(d_hi);
      }
    } else {
      // --- pass 3: ds = p (dp - D) * sm_scale where allowed; dq += ds . k ---
#pragma unroll
      for (int kk = 0; kk < kKeyTile / 16; ++kk) {
        uint32_t da[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = (tl * 8 + 2 * kk + hh) * 32 + lane;
          const float4 p4 = pbuf[j];
          const uint2 d2 = dbuf[j];
          const float2 lof = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d2.x));
          const float2 hif = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&d2.y));
          const int kl = 16 * kk + 8 * hh + 2 * t;
          const float s = p.sm_scale;
          const float ds0 = allowed(vs, key0, kl, r_lo) ? p4.x * (lof.x - d_lo) * s : 0.0f;
          const float ds1 = allowed(vs, key0, kl + 1, r_lo) ? p4.y * (lof.y - d_lo) * s : 0.0f;
          const float ds2 = allowed(vs, key0, kl, r_hi) ? p4.z * (hif.x - d_hi) * s : 0.0f;
          const float ds3 = allowed(vs, key0, kl + 1, r_hi) ? p4.w * (hif.y - d_hi) * s : 0.0f;
          const __nv_bfloat162 lo = __floats2bfloat162_rn(ds0, ds1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(ds2, ds3);
          da[2 * hh + 0] = *reinterpret_cast<const uint32_t*>(&lo);
          da[2 * hh + 1] = *reinterpret_cast<const uint32_t*>(&hi);
        }
        accumulate<DP>(acc, da, tile, kk, lane);
      }
    }
  }
  if (!active) return;
  store_rows<DP>(acc, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, r_lo, r_hi, t,
                 p.seq, p.dim);
  if (t == 0) {
    const long long plane = static_cast<long long>(p.batch) * p.heads * p.seq;
    float* st = p.stats + (static_cast<long long>(b) * p.heads + h) * p.seq;
    if (r_lo < p.seq) {
      st[r_lo] = m_lo;
      st[plane + r_lo] = l_lo;
      st[2 * plane + r_lo] = d_lo;
    }
    if (r_hi < p.seq) {
      st[r_hi] = m_hi;
      st[plane + r_hi] = l_hi;
      st[2 * plane + r_hi] = d_hi;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: dk and dv, summed over the query heads of each kv head.
template <int DP>
__global__ void __launch_bounds__(kColWarps * 32)
attn_bwd_dkdv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTileBytes = Ring<DP>::kTileBytes;
  constexpr int kSlot = col_slot_bytes<DP>();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int groups = p.heads / p.kv_heads;
  const int j0 = (blockIdx.x * kColWarps + warp) * 16;
  const bool active = j0 < p.seq;
  const int key_lo = j0 + g;
  const int key_hi = j0 + g + 8;
  const int qtiles = (p.seq + kKeyTile - 1) / kKeyTile;
  const int items = groups * qtiles;
  const long long plane = static_cast<long long>(p.batch) * p.heads * p.seq;

  // Item i: the q and dO tiles of query rows 64 (i % qtiles) .. + 63 of
  // head hk * groups + i / qtiles, with those rows' m, l and D.
  auto issue = [&](int item) {
    unsigned char* slot = smem + (item & 1) * kSlot;
    const int hq = hk * groups + item / qtiles;
    const int q0 = (item % qtiles) * kKeyTile;
    __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(slot);
    stage_tile<DP>(qt, p.q + b * p.q_sb + hq * p.q_sh, p.q_ss, q0, p.seq, p.dim);
    stage_tile<DP>(qt + kTileBytes / 2, p.dout + b * p.do_sb + hq * p.do_sh,
                   p.do_ss, q0, p.seq, p.dim);
    float* st = reinterpret_cast<float*>(slot + 2 * kTileBytes);
    const float* src = p.stats + (static_cast<long long>(b) * p.heads + hq) * p.seq;
    for (int i = threadIdx.x; i < 3 * kKeyTile; i += blockDim.x) {
      const int row = q0 + i % kKeyTile;
      const bool in = row < p.seq;
      cp_async4(st + i, in ? src + (i / kKeyTile) * plane + row : src, in);
    }
    cp_async_commit();
  };

  uint32_t ka[DP / 16][4], va[DP / 16][4];
  load_rows<DP>(ka, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, key_lo, key_hi, t,
                p.seq, p.dim, active);
  load_rows<DP>(va, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, key_lo, key_hi, t,
                p.seq, p.dim, active);
  const int32_t* valid = p.valid ? p.valid + b * p.valid_sb : nullptr;
  const bool ok_lo = key_lo < p.seq && (valid == nullptr || valid[key_lo] > 0);
  const bool ok_hi = key_hi < p.seq && (valid == nullptr || valid[key_hi] > 0);

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
  }

  issue(0);
  for (int item = 0; item < items; ++item) {
    cp_async_wait_all();
    __syncthreads();
    if (item + 1 < items) issue(item + 1);
    if (!active) continue;
    const unsigned char* slot = smem + (item & 1) * kSlot;
    const __nv_bfloat16* qt = reinterpret_cast<const __nv_bfloat16*>(slot);
    const __nv_bfloat16* ot = qt + kTileBytes / 2;
    const float* st = reinterpret_cast<const float*>(slot + 2 * kTileBytes);
    const int q0 = (item % qtiles) * kKeyTile;
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      float sc[2][4], dp[2][4];
      pair_products<DP>(sc, ka, qt, kk, lane);  // s^T: keys x 16 queries
      pair_products<DP>(dp, va, ot, kk, lane);  // dp^T
      uint32_t pa[4], da[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pv[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 16 * kk + 8 * hh + 2 * t + (i & 1);  // query in tile
          const int query = q0 + col;
          const bool hi = i & 2;
          const int key = hi ? key_hi : key_lo;
          const bool in = query < p.seq;
          const bool ok = in && (hi ? ok_hi : ok_lo) && (!p.causal || key <= query);
          const float s = ok ? sc[hh][i] * p.sm_scale : kNegInf;
          const float pr = in ? expf(s - st[col]) / st[kKeyTile + col] : 0.0f;
          const float dpb = __bfloat162float(__float2bfloat16_rn(dp[hh][i]));
          pv[i] = pr;
          ds[i] = ok ? pr * (dpb - st[2 * kKeyTile + col]) * p.sm_scale : 0.0f;
        }
        const __nv_bfloat162 plo = __floats2bfloat162_rn(pv[0], pv[1]);
        const __nv_bfloat162 phi = __floats2bfloat162_rn(pv[2], pv[3]);
        const __nv_bfloat162 dlo = __floats2bfloat162_rn(ds[0], ds[1]);
        const __nv_bfloat162 dhi = __floats2bfloat162_rn(ds[2], ds[3]);
        pa[2 * hh + 0] = *reinterpret_cast<const uint32_t*>(&plo);
        pa[2 * hh + 1] = *reinterpret_cast<const uint32_t*>(&phi);
        da[2 * hh + 0] = *reinterpret_cast<const uint32_t*>(&dlo);
        da[2 * hh + 1] = *reinterpret_cast<const uint32_t*>(&dhi);
      }
      accumulate<DP>(dv, pa, ot, kk, lane);
      accumulate<DP>(dk, da, qt, kk, lane);
    }
  }
  if (!active) return;
  store_rows<DP>(dk, p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, key_lo, key_hi,
                 t, p.seq, p.dim);
  store_rows<DP>(dv, p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, key_lo, key_hi,
                 t, p.seq, p.dim);
}

template <int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto rows = attn_bwd_dq_kernel<DP>;
  auto cols = attn_bwd_dkdv_kernel<DP>;
  const size_t row_smem = row_smem_bytes<DP>(p.row_warps, p.seq);
  if (row_smem > kMaxSmem) return cudaErrorInvalidValue;
  // Once per instantiation, at its first launch, to the most a block may
  // use: later launches make no attribute call.
  static const cudaError_t attr_rows = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  static const cudaError_t attr_cols = cudaFuncSetAttribute(
      cols, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr_rows != cudaSuccess) return attr_rows;
  if (attr_cols != cudaSuccess) return attr_cols;
  const int units = (p.heads / p.kv_heads) * p.row_blocks;
  dim3 row_grid((units + p.row_warps - 1) / p.row_warps, p.kv_heads, p.batch);
  rows<<<row_grid, p.row_warps * 32, row_smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 col_grid((p.seq + 16 * kColWarps - 1) / (16 * kColWarps), p.kv_heads, p.batch);
  cols<<<col_grid, kColWarps * 32, 2 * col_slot_bytes<DP>(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq (B, H, S, D); k, v, dk, dv (B, Hkv, S, D): bf16, element
// strides per (batch, head, position), the head dim contiguous. D % 8 == 0,
// D <= 128, strides multiples of 8, pointers 16-byte aligned (the wrapper
// checks). valid: (B, S) int32 or null. stats: (3, B, H, S) float32
// scratch. row_warps (1..4) comes from attention_bwd_plan. Returns a
// cudaError_t.
extern "C" int vla_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* valid, void* dq, void* dk, void* dv, void* stats,
    int batch, int heads, int kv_heads, int seq, int dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    long long valid_sb, float sm_scale, int causal, int row_warps,
    void* stream) {
  if (row_warps < 1 || row_warps > kRowWarpsMax || seq < 1 || batch < 1 ||
      kv_heads < 1 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.valid = static_cast<const int32_t*>(valid);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.stats = static_cast<float*>(stats);
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seq = seq;
  p.dim = dim;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.valid_sb = valid_sb;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.row_warps = row_warps;
  p.row_blocks = (seq + 15) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((dim + 15) / 16 * 16) {
    case 16: return launch<16>(p, s);
    case 32: return launch<32>(p, s);
    case 48: return launch<48>(p, s);
    case 64: return launch<64>(p, s);
    case 80: return launch<80>(p, s);
    case 96: return launch<96>(p, s);
    case 112: return launch<112>(p, s);
    case 128: return launch<128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
