// Fused softmax attention for Hopper (sm_90a), bf16 in / bf16 out: one
// score product, K/V streamed through a cp.async ring.
//
// Replaces vla_adapter_tpu/ops/pallas_attention.py:fused_attention (the
// Pallas kernel _attn_kernel). Same arithmetic:
//
//   s   = (q . k) * sm_scale + bias      fp32, bias = 0 / -2e9 from `valid`
//   s   = -2e9 where key > query         (causal only)
//   m   = max_k s
//   p   = bf16(exp(s - m))               unnormalised, rounded before p @ v
//   l   = sum_k float(p)                 sum of the ROUNDED probabilities
//   out = bf16((p @ v) / l)              fp32 accumulation, deferred 1/l
//
// When training (a non-null `lse`), it also writes each row's log-sum-exp
// lse = m + log(sum_k exp(s - m)), fp32, the sum over the UNROUNDED
// exponentials, so that the backward's exp(s - lse) is the exact softmax
// (attention_bwd.cu). A null pointer leaves every other output bit as it
// was: the extra sum feeds nothing else.
//
// Design. The unit of work is one warp: 16 query rows of one head against
// every key, with mma.sync m16n8k16 (bf16 in, fp32 accumulate). A CTA holds
// `warps` units (1..8) of one (batch, kv head), so the query heads of a
// GQA group share its K/V tiles. K tiles, then V tiles, stream through a
// two-slot ring in shared memory fed by cp.async (16-byte copies,
// zero-filled past seq and dim): the next tile is in flight while the
// tensor cores work on this one. (More slots, where the shared memory
// beside the scores had room for them, gained at most 3% on an H100.) Fragments come from shared memory with
// ldmatrix; V stays in its natural (key, d) layout and is read with
// ldmatrix.trans.
//
// One score product ("one-pass" branch). As the TPU kernel keeps the whole
// (rows, S) score block in VMEM, each warp keeps its 16 x S fp32 scores in
// shared memory (in mma fragment order, so every thread reads back its
// own values): pass 1 over the K tiles computes s once, stores it and
// takes the exact row max; pass 2 over the V tiles rounds
// p = bf16(exp(s - m)) against that final max and accumulates l and p @ v.
// No q.k is computed twice and p is never rounded against a running max.
// That needs 4 KB per warp per 64 keys (40 KB at S = 640). Where not even
// one warp's block fits (S > ~3000, chosen by S alone), the "two-pass"
// branch of the same kernel streams K twice and recomputes s in pass 2
// (bitwise the same: same mma order), with K and V of a tile in one slot.
//
// The grid. ops/attention_kernel.py:attention_plan picks `warps` per shape:
// among the CTA sizes whose score block fits in 227 KB, the one with the
// fewest rounds of CTAs on the busiest SM, then the fewest warps run there,
// then the most warps (fewer K/V re-reads from L2). At the serving shapes
// (132 SMs) that gives:
//   Qwen2 B=1 (14/2 heads, S=640, D=64): 5 warps, 112 CTAs, 1 per SM,
//     one wave (64-row CTAs would be 140 of 4 warps: 1.06 waves);
//   Qwen2 B=2: 5 warps, 224 CTAs, 1 per SM, 1.7 waves;
//   DINOv2 B=1 (2 images, 16 heads, S=261, D=64): 5 warps, 128 CTAs;
//   so400m B=1 (S=256, D=72): 4 warps, 128 CTAs, 2 fit per SM.
// chip_smoke.py prints the plan of every serving shape.
//
// Bound on this card: the work is 4*H*S^2*D flops. The Qwen2 call (S=640,
// 14 q / 2 kv heads, D=64) does ~530 flop per byte of q/k/v/o, above the
// H100's ~295 flop/byte ridge: operations bound, so the design removes the
// second q.k product (a third of a two-pass kernel's tensor-core work) and keeps the
// mma pipe fed from an asynchronous ring. The ViT calls (S~256, no GQA) do
// ~130 flop/byte: bytes bound; each K/V tile is read once per CTA of up to
// 128 query rows. D = 72 (so400m) pads to 80 in the fragments and in
// shared memory (rows of 88 bf16: conflict-free ldmatrix), with mma.sync
// throughout: wgmma's 128-byte swizzle rows do not fit an 80-wide tile.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKeyTile = 64;
constexpr int kMaxWarps = 8;
constexpr float kNegInf = -2.0e9f;   // the Pallas kernel's NEG_INF
constexpr int kMaxSmem = 232448;     // shared memory a block may use

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* valid;  // (B, S) with row stride valid_sb; null = all valid
  __nv_bfloat16* o;
  float* lse;  // (B, H, S) with strides lse_sb, lse_sh; null when serving
  int heads, kv_heads, seq, dim;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long valid_sb;
  long long lse_sb, lse_sh;
  float sm_scale;
  int causal;
  int warps;       // units (16 query rows of one head) per CTA
  int row_blocks;  // ceil(seq / 16)
};

// Shared memory of one ring slot: a tile of 64 keys (K, or V in the
// one-pass branch's pass 2), a second tile for V in the two-pass branch,
// and the tile's 64 `valid` flags. DP is the head dim padded to a multiple
// of 16; rows of DP + 8 bf16 keep ldmatrix free of bank conflicts.
template <int DP>
struct Ring {
  static constexpr int kStride = DP + 8;
  static constexpr int kTileBytes = kKeyTile * kStride * 2;
  __host__ __device__ static constexpr int slot_bytes(bool one_pass) {
    return (one_pass ? 1 : 2) * kTileBytes + kKeyTile * 4;
  }
};

template <int DP>
size_t smem_bytes(bool one_pass, int warps, int tiles) {
  // two ring slots, then (one-pass) each warp's 16 x (64 tiles) fp32 scores
  return 2 * static_cast<size_t>(Ring<DP>::slot_bytes(one_pass)) +
         (one_pass ? static_cast<size_t>(warps) * tiles * kKeyTile * 16 * 4 : 0);
}

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
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ss, int key0, int seq,
                                           int dim) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kKeyTile * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool in = key0 + r < seq && c < dim;  // dim % 8 == 0: whole chunks
    cp_async16(dst + r * Ring<DP>::kStride + c,
               in ? src + (key0 + r) * ss + c : src, in);
  }
}

template <int DP, bool ONE_PASS>
__global__ void __launch_bounds__(kMaxWarps * 32)
fused_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStride = Ring<DP>::kStride;
  constexpr int kSlot = Ring<DP>::slot_bytes(ONE_PASS);
  constexpr int kTileElems = kKeyTile * kStride;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // mma group: rows g and g + 8 of the warp's tile
  const int t = lane % 4;  // thread in group: column pairs 2t, 2t + 1
  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int groups = p.heads / p.kv_heads;
  const int unit = blockIdx.x * p.warps + warp;
  const bool active = unit < groups * p.row_blocks;
  const int h = hk * groups + (active ? unit / p.row_blocks : 0);
  const int row0 = (unit % p.row_blocks) * 16;
  const int r_lo = row0 + g;
  const int r_hi = row0 + g + 8;
  const int tiles = (p.seq + kKeyTile - 1) / kKeyTile;

  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  const int32_t* valid = p.valid ? p.valid + b * p.valid_sb : nullptr;
  float4* scores = reinterpret_cast<float4*>(smem + 2 * kSlot) +
                   warp * tiles * (kKeyTile / 8) * 32;

  // Item i of the stream: K tile i (i < tiles) with its valid flags, then
  // tile i - tiles of V (one-pass) or of K and V with the flags (two-pass).
  auto issue = [&](int item) {
    unsigned char* slot = smem + (item & 1) * kSlot;
    __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(slot);
    int32_t* vs = reinterpret_cast<int32_t*>(slot + kSlot - kKeyTile * 4);
    const bool second = item >= tiles;
    const int key0 = (second ? item - tiles : item) * kKeyTile;
    if (second && ONE_PASS) {
      stage_tile<DP>(kt, vg, p.v_ss, key0, p.seq, p.dim);
    } else {
      stage_tile<DP>(kt, kg, p.k_ss, key0, p.seq, p.dim);
      if (second) stage_tile<DP>(kt + kTileElems, vg, p.v_ss, key0, p.seq, p.dim);
      if (valid != nullptr) {
        for (int i = threadIdx.x; i < kKeyTile; i += blockDim.x) {
          const int key = key0 + i;
          cp_async4(vs + i, key < p.seq ? valid + key : valid, key < p.seq);
        }
      }
    }
    cp_async_commit();
  };

  // q A-fragments of rows r_lo / r_hi, straight from device memory; rows
  // >= seq and dims >= dim are zero. dim % 8 == 0, so d < dim implies
  // d + 1 < dim.
  uint32_t qa[DP / 16][4];
  {
    const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (i & 1) ? r_hi : r_lo;
        const int d = c * 16 + 2 * t + ((i & 2) ? 8 : 0);
        __nv_bfloat16 x0 = zero, x1 = zero;
        if (active && r < p.seq && d < p.dim) {
          const __nv_bfloat16* src = q + r * p.q_ss + d;
          x0 = src[0];
          x1 = src[1];
        }
        qa[c][i] = pack_bf16(x0, x1);
      }
    }
  }

  // Scores of the warp's 16 rows against the 64 keys of tile `kt`; sc[j]
  // holds keys 8j + 2t, 8j + 2t + 1 of rows r_lo (0, 1) and r_hi (2, 3).
  // Straight-line code: each dim chunk's K fragments are loaded first, then
  // eight independent mma; the bias is computed once per key, by selects.
  auto tile_scores = [&](const __nv_bfloat16* kt, const int32_t* vs, int key0,
                         float (&sc)[kKeyTile / 8][4]) {
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
        float bias = (valid == nullptr || flag > 0) ? 0.0f : kNegInf;
        bias = key0 + kl < p.seq ? bias : -INFINITY;
        sc[j][e] = sc[j][e] * p.sm_scale + bias;
        sc[j][2 + e] = sc[j][2 + e] * p.sm_scale + bias;
      }
    }
    if (p.causal) {  // uniform: the whole grid takes it or skips it
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = key0 + 8 * j + 2 * t + (i & 1);
          const int row = (i & 2) ? r_hi : r_lo;
          if (key > row && key < p.seq) sc[j][i] = kNegInf;
        }
      }
    }
  };

  float m_lo = -INFINITY, m_hi = -INFINITY;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float l_lo = 0.0f, l_hi = 0.0f;
  float e_lo = 0.0f, e_hi = 0.0f;  // sums of the unrounded exp(s - m)

  issue(0);
  for (int item = 0; item < 2 * tiles; ++item) {
    cp_async_wait_all();  // this thread's copies of `item` have landed
    __syncthreads();      // everyone's have, and `item - 1`'s slot is free
    if (item + 1 < 2 * tiles) issue(item + 1);
    if (!active) continue;
    const unsigned char* slot = smem + (item & 1) * kSlot;
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(slot);
    const int32_t* vs = reinterpret_cast<const int32_t*>(slot + kSlot - kKeyTile * 4);

    if (item < tiles) {
      // --- pass 1: scores once, the exact row max ---
      float sc[kKeyTile / 8][4];
      tile_scores(kt, vs, item * kKeyTile, sc);
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        m_lo = fmaxf(m_lo, fmaxf(sc[j][0], sc[j][1]));
        m_hi = fmaxf(m_hi, fmaxf(sc[j][2], sc[j][3]));
        if (ONE_PASS)
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
    if (ONE_PASS) {
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        const float4 s4 = scores[(tile * (kKeyTile / 8) + j) * 32 + lane];
        sc[j][0] = s4.x;
        sc[j][1] = s4.y;
        sc[j][2] = s4.z;
        sc[j][3] = s4.w;
      }
    } else {
      tile_scores(kt, vs, tile * kKeyTile, sc);
    }
    const __nv_bfloat16* vt = ONE_PASS ? kt : kt + kTileElems;
    // ldmatrix.x4.trans over keys 16kk..16kk+15 and dims 16n2..16n2+15:
    // matrices (keys +0, d +0), (keys +8, d +0), (keys +0, d +8), (keys +8, d +8)
    const int mi = lane / 8;
    const __nv_bfloat16* vbase = vt + ((mi & 1) * 8 + lane % 8) * kStride + (mi >> 1) * 8;
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
        const float x0 = expf(sc[j][0] - m_lo), x1 = expf(sc[j][1] - m_lo);
        const float x2 = expf(sc[j][2] - m_hi), x3 = expf(sc[j][3] - m_hi);
        e_lo += x0 + x1;
        e_hi += x2 + x3;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(x0, x1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x2, x3);
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
  if (p.lse != nullptr) {  // uniform: the whole grid takes it or skips it
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      e_lo += __shfl_xor_sync(0xffffffffu, e_lo, off);
      e_hi += __shfl_xor_sync(0xffffffffu, e_hi, off);
    }
    float* lse = p.lse + b * p.lse_sb + h * p.lse_sh;
    if (t == 0 && r_lo < p.seq) lse[r_lo] = m_lo + logf(e_lo);
    if (t == 0 && r_hi < p.seq) lse[r_hi] = m_hi + logf(e_hi);
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

template <int DP, bool ONE_PASS>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  auto kernel = fused_attention_kernel<DP, ONE_PASS>;
  const int tiles = (p.seq + kKeyTile - 1) / kKeyTile;
  const size_t smem = smem_bytes<DP>(ONE_PASS, p.warps, tiles);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // Once per instantiation, at its first (uncaptured) launch, to the most
  // a block may use: every smaller size is then admitted, and later
  // launches, inside a CUDA graph capture too, make no attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int units = (p.heads / p.kv_heads) * p.row_blocks;
  dim3 grid((units + p.warps - 1) / p.warps, p.kv_heads, batch);
  kernel<<<grid, p.warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_branch(const Params& p, int batch, int one_pass, cudaStream_t s) {
  return one_pass ? launch<DP, true>(p, batch, s) : launch<DP, false>(p, batch, s);
}

}  // namespace

// q (B, H, S, D), k/v (B, Hkv, S, D), o (B, H, S, D): bf16, element strides
// per (batch, head, position), the head dim contiguous. D % 8 == 0, D <= 128,
// every stride a multiple of 8 and the pointers 16-byte aligned (the wrapper
// checks). valid: (B, S) int32 or null. lse: (B, H, S) float32 (row stride
// 1) or null. warps (1..8, units of 16 query rows per CTA) and one_pass come
// from attention_plan. Returns a cudaError_t.
extern "C" int vla_fused_attention_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* o, void* lse,
    int batch, int heads, int kv_heads, int seq, int dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long valid_sb, long long lse_sb, long long lse_sh, float sm_scale, int causal,
    int warps, int one_pass, void* stream) {
  if (warps < 1 || warps > kMaxWarps || seq < 1 || kv_heads < 1 ||
      heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.valid = static_cast<const int32_t*>(valid);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seq = seq;
  p.dim = dim;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.valid_sb = valid_sb;
  p.lse_sb = lse_sb;
  p.lse_sh = lse_sh;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.warps = warps;
  p.row_blocks = (seq + 15) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((dim + 15) / 16 * 16) {
    case 16: return launch_branch<16>(p, batch, one_pass, s);
    case 32: return launch_branch<32>(p, batch, one_pass, s);
    case 48: return launch_branch<48>(p, batch, one_pass, s);
    case 64: return launch_branch<64>(p, batch, one_pass, s);
    case 80: return launch_branch<80>(p, batch, one_pass, s);
    case 96: return launch_branch<96>(p, batch, one_pass, s);
    case 112: return launch_branch<112>(p, batch, one_pass, s);
    case 128: return launch_branch<128>(p, batch, one_pass, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
