// The backward of softmax attention for Hopper (sm_90a), bf16 in / bf16
// out: dq, dk and dv of B1's attention from q, k, v, the key validity, the
// output's gradient dO and each row's log-sum-exp `lse`, which B1's
// forward (fused_attention.cu) writes when training.
//
// Replaces the JAX package's backward of the Pallas attention,
// vla_adapter_tpu/ops/attention.py:_attention_bwd, which is
// jax.vjp(xla_attention) in XLA (the TPU package has no backward kernel).
// It computes what that vjp computes:
//
//   s   = (q . k) * sm_scale, masked to -2e9 (fp32)  masked: invalid key,
//                                                     or key > query (causal)
//   p   = softmax(s) = exp(s - lse)                   fp32, unrounded
//   dv  = bf16(p)^T . dO
//   dp  = bf16(dO . v^T)                              rounded as in the vjp
//   D   = rowsum(p * dp)
//   ds  = p * (dp - D), 0 where masked, times sm_scale
//   dq  = ds . k        dk = ds^T . q                 (bf16 ds into the product)
//
// with the dk and dv of the query heads of a GQA group summed over the
// group. A row with no valid key has p = 1/S over all S keys, as
// xla_attention gives it, and ds = 0; its lse is about -2e9 (m = -2e9
// swallows log S in fp32), so a row whose lse is below -1e9 takes p = 1/S
// instead of exp(s - lse).
//
// D as the vjp forms it, not FlashAttention's rowsum(dO * out): that
// identity (with B1's bf16 out) missed the bound (dq 0.0117 of plain's
// largest at S = 37, causal) and gave dq and dk of rows with one valid key
// a rounding's worth where the vjp gives exactly 0 (S = 1). Kernel 1 sums
// D over the row's keys with its own running max m, so a row with one key
// gets 2^(s - m) = 1 and D = bf16(dp) exactly, and ds = 0 exactly.
//
// What bounds it on this card. Five products of 2 B H S^2 D operations are
// the least work (the recomputed q.k^T, dv, dp, dq, dk): at the LLM's
// training shape (16 x 14/2 heads, S = 640, D = 64) that is 59 GFLOP
// against 66 MB of q, k, v, dO, dq, dk, dv, so it is operations bound
// (~900 flop per byte, the H100's ridge is ~295). The towers' calls
// (S ~ 256, no GQA) do ~185 flop per byte: bytes bound; at S = 261 the
// 64-row tiles are a third padding (320^2 against 261^2). The design does
// nine products (q.k^T and dO.v^T in each of the three kernels) so that
// every sum stays in one CTA: no atomics, and a rerun gives the same bits.
// What holds it back is the softmax terms between the products (an exp, a
// bf16 rounding and a few flops per score, on 2 warps per SM sub-partition)
// more than the tensor cores.
//
// Design: three kernels on the caller's stream, each a CTA of one producer
// warpgroup (one thread issues TMA copies; setmaxnreg gives its registers
// to the others) and two consumer warpgroups of 64 rows, fed by a 4-stage
// ring of TMA copies paced by mbarriers (`full` counts the bytes, `empty`
// the consumer warps done with a stage). Products are wgmma: the score
// products with both operands in shared memory, the dq/dk/dv products with
// A in registers (the previous product's fp32 accumulator rounded to bf16:
// its layout is the A fragment's, as in FlashAttention-3). The two
// warpgroups take turns to issue their score products (named barriers), so
// one's softmax terms run under the other's products.
// 1. D (`attn_bwd_rows_kernel<DP, true>`): per 64 query rows of one head
//    (the two warpgroups on one kv head share each K/V tile), stream the
//    K/V tiles, s = q.k^T and dp = dO.v^T, and the running-max sums of
//    2^(s - m) and 2^(s - m) * bf16(dp); writes D and lse (times log2 e)
//    into a (2, B, H, S64) scratch padded to whole tiles (lse = +inf and
//    D = 0 past S: a padded query gets p = 0 without a test). Two products.
// 2. dq (`attn_bwd_rows_kernel<DP, false>`): the same walk; p = 2^(s c -
//    lse), ds = p (bf16(dp) - D), dq += ds.k, each tile's dq product
//    finishing under the next tile's score products. Three products, no
//    per-row score storage at any S.
// 3. dk/dv (`attn_bwd_dkdv_kernel`): per 64 keys of one kv head, k and v
//    resident; the producer streams the q and dO tiles (with their lse and
//    D) of every head of the group: s^T = k.q^T, dp^T = v.dO^T, then
//    dv += bf16(p^T).dO and dk += bf16(ds^T).q: the GQA sum costs nothing.
//    Four products. Two key blocks a CTA, or, for a long stream (the LLM's
//    70 items), one key block with the items split between the warpgroups
//    and their sums added in shared memory in a fixed order: twice the
//    CTAs for a grid that otherwise fills 1.2 waves.
//
// Layouts: attention_wgmma.cuh's 64-row tiles in swizzled TMA column
// chunks, read K-major by the products that contract over the head dim and
// MN-major (the transpose bit) by dv, dk and dq, which contract over rows.
// Keys and queries past S are zero-filled by TMA.
//
// Traps met: (a) wgmma on tiles swizzled by hand read wrong data with two
// CTAs per SM in an earlier attempt; here only TMA writes the tiles that
// wgmma reads.
// (b) ptxas serializes every wgmma of a kernel (a wait after each, 1.3-2x
// slower here) when a product chain's operand registers are reused before
// it completes, or when it must wait on a wgmma in a branch it cannot
// prove uniform: each chain is one asm statement, and no product sits in a
// branch that depends on the warpgroup (causal tiles past the diagonal run
// masked instead of skipped). (c) lse of a row with no valid key (above).
// (d) a wait that never ends traps after ~4 s instead of hanging the card.
//
// The mbarrier, TMA, wgmma-descriptor and tensor-map helpers are
// hopper.cuh's, shared with B4's Hopper branch (w8a8_matmul.cu); the tiles,
// product chains and fragment conversions attention_wgmma.cuh's, shared
// with B1's forward (fused_attention.cu).
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns the first error of cudaGetLastError() after
// each launch, or of building the TMA descriptors.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

using namespace vla_attention;

constexpr int kWarpgroups = 2;     // consumer warpgroups per CTA
constexpr int kThreads = (kWarpgroups + 1) * 128;  // and a producer warpgroup
constexpr int kProducerRegs = 24;  // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 240;
constexpr float kDeadLse = -1.0e9f;  // lse below: a row with no valid key

struct Params {
  const float* lse;           // (B, H, S): the forward's row log-sum-exp
  const int32_t* valid;       // (B, S) with row stride valid_sb; null = all
  float* stats;               // (2, B, H, S64): lse * log2(e), D; padded
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int batch, heads, kv_heads, seq, dim;
  int seq_pad;    // S64: seq rounded up to whole tiles
  long long lse_sb, lse_sh;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  long long valid_sb;
  float sm_scale;
  int causal;
  int split;      // dk/dv: both warpgroups on one key block, items split
};

// Shared memory of the three kernels (from a 1024-aligned base): two
// resident tiles per consumer warpgroup (q and dO, or k and v), the ring's
// stages (K and V tiles, or q and dO tiles with 64 rows' lse and D), then
// the barriers and the batch row's key mask (S64 / 8 bytes, sized at
// launch).
template <int DP>
struct Smem {
  static constexpr int kStages = 4;
  static constexpr int kResident = 2 * kWarpgroups * Tile<DP>::kBytes;
  static constexpr int kStage = 2 * Tile<DP>::kBytes + 1024;
  static constexpr int kBarriers = kResident + kStages * kStage;
  static constexpr int kMask = kBarriers + 8 * (2 * kStages + 1);
  // and 1024 bytes of alignment slack
  static constexpr int kBytes = kMask + 1024;
};

// Rows r_lo / r_hi of a 64 x DP accumulator times `scale` to dst (row
// stride ss) in bf16, rows < seq and dims < dim. Element 4n + e: row r_lo
// (e < 2) or r_hi, column 8n + 2t + (e & 1).
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2], float scale,
                                           __nv_bfloat16* dst, long long ss, int r_lo,
                                           int r_hi, int t, int seq, int dim) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= dim) continue;
    if (r_lo < seq)
      *reinterpret_cast<__nv_bfloat162*>(dst + r_lo * ss + d) =
          __floats2bfloat162_rn(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    if (r_hi < seq)
      *reinterpret_cast<__nv_bfloat162*>(dst + r_hi * ss + d) =
          __floats2bfloat162_rn(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
  }
}

// The key validity of batch row b as bits (word w: keys 32w .. 32w + 31; a
// key past S is not valid), into shared memory by every thread of the CTA.
__device__ __forceinline__ void build_key_mask(const Params& p, int b, uint32_t* mask) {
  const int32_t* valid = p.valid ? p.valid + b * p.valid_sb : nullptr;
  const int lane = threadIdx.x % 32;
  for (int w = threadIdx.x / 32; w < p.seq_pad / 32; w += kThreads / 32) {
    const int key = 32 * w + lane;
    bool ok = key < p.seq;
    if (ok && valid != nullptr) ok = valid[key] > 0;
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) mask[w] = bits;
  }
}

// ---------------------------------------------------------------------------
// Kernels 1 and 2, over query rows: D (kDelta) or dq. CTA (unit pair, kv
// head, batch); a unit is 64 query rows of one head of the kv head's group,
// one per consumer warpgroup, so the two share each K/V tile.
template <int DP, bool kDelta>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_rows_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const Params p) {
  using T = Tile<DP>;
  using L = Smem<DP>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + L::kBarriers;  // full[kStages], empty[kStages], resident
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t resident_bar = bars + 16 * kStages;
  uint32_t* key_mask = reinterpret_cast<uint32_t*>(base_ptr + L::kMask);

  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int groups = p.heads / p.kv_heads;
  const int row_tiles = p.seq_pad / kTile;
  const int units = groups * row_tiles;
  const int unit0 = blockIdx.x * kWarpgroups;
  const int active = min(kWarpgroups, units - unit0);
  // key tiles streamed: all, or (causal) up to the later unit's row tile
  int tiles = row_tiles;
  if (p.causal) {
    tiles = 0;
    for (int w = 0; w < active; ++w) tiles = max(tiles, (unit0 + w) % row_tiles + 1);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * active);  // every warp of every active warpgroup
    }
    mbar_init(resident_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  build_key_mask(p, b, key_mask);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 4 * kWarpgroups) {
    // ---- producer warpgroup: one thread issues every copy ----
    set_max_regs_dec<kProducerRegs>();
    if (warp == 4 * kWarpgroups && lane == 0) {
      mbar_expect_tx(resident_bar, 2 * active * T::kBytes);
      for (int w = 0; w < active; ++w) {
        const int unit = unit0 + w;
        const int h = hk * groups + unit / row_tiles;
        const int row0 = (unit % row_tiles) * kTile;
        tma_tile<DP>(base + w * T::kBytes, &tq, row0, h, b, resident_bar);
        tma_tile<DP>(base + (kWarpgroups + w) * T::kBytes, &tdo, row0, h, b, resident_bar);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::kBytes);
        const uint32_t stage = base + L::kResident + s * L::kStage;
        tma_tile<DP>(stage, &tk, it * kTile, hk, b, full(s));
        tma_tile<DP>(stage + T::kBytes, &tv, it * kTile, hk, b, full(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, its unit's 64 query rows ----
  set_max_regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  if (wg >= active) return;
  const bool turns = active == kWarpgroups;
  const int wi = warp % 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int unit = unit0 + wg;
  const int h = hk * groups + unit / row_tiles;
  const int rtile = unit % row_tiles;
  const int row_min = rtile * kTile + 16 * wi;  // the warp's first row
  const int r_lo = row_min + g;
  const int r_hi = r_lo + 8;
  const uint32_t q_tile = base + wg * T::kBytes;
  const uint32_t o_tile = base + (kWarpgroups + wg) * T::kBytes;
  const long long plane = static_cast<long long>(p.batch) * p.heads * p.seq_pad;
  float* st = p.stats + (static_cast<long long>(b) * p.heads + h) * p.seq_pad;
  // dq: each row's lse (times log2 e) and D from kernel 1
  float lse_lo = 0.0f, lse_hi = 0.0f, d_lo = 0.0f, d_hi = 0.0f;
  if (!kDelta) {
    lse_lo = st[r_lo];
    lse_hi = st[r_hi];
    d_lo = st[plane + r_lo];
    d_hi = st[plane + r_hi];
  }
  const float c2 = p.sm_scale * kLog2e;  // scores to base-2 exponents

  float acc[DP / 2];  // dq
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  // D: the row's running max of the allowed base-2 scores, and the sums of
  // 2^(s - max) and 2^(s - max) * bf16(dp) over this thread's columns
  float m_lo = -INFINITY, m_hi = -INFINITY;
  float l_lo = 0.0f, l_hi = 0.0f, n_lo = 0.0f, n_hi = 0.0f;
  uint32_t da[4][4];   // ds of the tile in flight, as A fragments

  if (turns && wg == 1) turn_pass(1);  // warpgroup 0 issues first
  mbar_wait(resident_bar, 0);
  for (int it = 0; it < tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    __syncwarp();  // converged again for the .aligned wgmma instructions
    // No branch around a product (ptxas serializes every wgmma of a kernel
    // that waits on one in a path it cannot prove uniform): tiles past a
    // unit's diagonal (causal) run masked.
    const uint32_t k_tile = base + L::kResident + s * L::kStage;
    const uint32_t v_tile = k_tile + T::kBytes;
    uint64_t qd[DP / 16], kd[DP / 16], od[DP / 16], vd[DP / 16];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      qd[kk] = desc_k<DP>(q_tile, kk);
      kd[kk] = desc_k<DP>(k_tile, kk);
      od[kk] = desc_k<DP>(o_tile, kk);
      vd[kk] = desc_k<DP>(v_tile, kk);
    }
    float sc[32], dp[32];
    if (turns) turn_wait(wg);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    WgmmaSS<DP / 16>::run(sc, qd, kd);
    WgmmaSS<DP / 16>::run(dp, od, vd);
    wgmma_commit();
    if (turns && !(wg == 1 && it == tiles - 1)) turn_pass(wg);
    if (!kDelta) {  // the previous tile's dq product: done, its stage free
      wgmma_wait<1>();
      fence_regs(acc);
      fence_frags(da);
      if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // the tile's key bits from column 2t on: bit 8n + e is column 8n + 2t + e
    const int key0 = it * kTile;
    const uint64_t bits = (static_cast<uint64_t>(key_mask[2 * it + 1]) << 32) | key_mask[2 * it];
    const uint64_t mt = bits >> (2 * t);
    // every key of the tile allowed for every row of the warp: no masks
    const bool open = bits == ~0ull && (!p.causal || key0 + kTile - 1 <= row_min);
    auto allowed = [&](int n, int e) {  // column 8n + 2t + (e & 1), row lo / hi
      bool ok = (mt >> (8 * n + (e & 1))) & 1;
      if (p.causal) ok = ok && key0 + 8 * n + 2 * t + (e & 1) <= ((e & 2) ? r_hi : r_lo);
      return ok;
    };

    if (kDelta) {
      // online softmax of the allowed scores (base 2), masked ones -inf
      auto d_terms = [&](auto masked) {
        constexpr bool kMasked = decltype(masked)::value;
        float x_lo = -INFINITY, x_hi = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = sc[4 * n + e] * c2;
            if (kMasked) v = allowed(n, e) ? v : -INFINITY;
            sc[4 * n + e] = v;
            if (e & 2) x_hi = fmaxf(x_hi, v);
            else x_lo = fmaxf(x_lo, v);
          }
        }
        x_lo = fmaxf(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, 1));
        x_hi = fmaxf(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, 1));
        x_lo = fmaxf(fmaxf(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, 2)), m_lo);
        x_hi = fmaxf(fmaxf(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, 2)), m_hi);
        // no allowed key yet: offset 0, so that 2^(-inf - 0) = 0
        const float u_lo = x_lo == -INFINITY ? 0.0f : x_lo;
        const float u_hi = x_hi == -INFINITY ? 0.0f : x_hi;
        const float a_lo = ex2(m_lo - u_lo), a_hi = ex2(m_hi - u_hi);
        l_lo *= a_lo;
        n_lo *= a_lo;
        l_hi *= a_hi;
        n_hi *= a_hi;
        m_lo = x_lo;
        m_hi = x_hi;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const float u = (e & 2) ? u_hi : u_lo;
            const float e0 = ex2(sc[4 * n + e] - u), e1 = ex2(sc[4 * n + e + 1] - u);
            const float2 d = round_bf16x2(dp[4 * n + e], dp[4 * n + e + 1]);
            if (e & 2) {
              l_hi += e0 + e1;
              n_hi = fmaf(e1, d.y, fmaf(e0, d.x, n_hi));
            } else {
              l_lo += e0 + e1;
              n_lo = fmaf(e1, d.y, fmaf(e0, d.x, n_lo));
            }
          }
        }
      };
      if (open) d_terms(Open());
      else d_terms(Masked());
      if (lane == 0) mbar_arrive(empty(s));
      continue;
    }

    // ds = p (bf16(dp) - D) where allowed (sm_scale at the store),
    // p = 2^(s c2 - lse log2 e)
    auto ds_terms = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float lse = (e & 2) ? lse_hi : lse_lo;
          const float dd = (e & 2) ? d_hi : d_lo;
          const float2 d = round_bf16x2(dp[4 * n + e], dp[4 * n + e + 1]);
          float v0 = ex2(fmaf(sc[4 * n + e], c2, -lse)) * (d.x - dd);
          float v1 = ex2(fmaf(sc[4 * n + e + 1], c2, -lse)) * (d.y - dd);
          if (kMasked) {
            v0 = allowed(n, e) ? v0 : 0.0f;
            v1 = allowed(n, e + 1) ? v1 : 0.0f;
          }
          sc[4 * n + e] = v0;
          sc[4 * n + e + 1] = v1;
        }
      }
    };
    if (open) ds_terms(Open());
    else ds_terms(Masked());
    to_a_frags(da, sc);
    uint64_t kb[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) kb[kk] = desc_mn<DP>(k_tile, kk);
    fence_regs(acc);
    wgmma_fence();
    WgmmaRS<DP>::run(acc, da, kb);
    wgmma_commit();
  }
  if (!kDelta) {
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(da);
    if (lane == 0) mbar_arrive(empty((tiles - 1) % kStages));
  }
  if (kDelta) {
    // D = sum 2^(s - m) bf16(dp) / sum 2^(s - m) over the row (0 for a
    // row with no valid key: its ds is 0), and the forward's lse (times
    // log2 e) beside it; rows past S: lse = +inf (p = 0), D = 0
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      n_lo += __shfl_xor_sync(0xffffffffu, n_lo, off);
      n_hi += __shfl_xor_sync(0xffffffffu, n_hi, off);
    }
    if (t == 0) {
      const float* lse = p.lse + b * p.lse_sb + h * p.lse_sh;
      st[r_lo] = r_lo < p.seq ? lse[r_lo] * kLog2e : INFINITY;
      st[r_hi] = r_hi < p.seq ? lse[r_hi] * kLog2e : INFINITY;
      st[plane + r_lo] = (r_lo < p.seq && l_lo > 0.0f) ? n_lo / l_lo : 0.0f;
      st[plane + r_hi] = (r_hi < p.seq && l_hi > 0.0f) ? n_hi / l_hi : 0.0f;
    }
    return;
  }
  store_rows<DP>(acc, p.sm_scale, p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, r_lo, r_hi, t,
                 p.seq, p.dim);
}

// ---------------------------------------------------------------------------
// Kernel 3: dk and dv, summed over the query heads of each kv head. CTA
// (key block pair, kv head, batch): a key block of 64 keys per consumer
// warpgroup, the two sharing each item (the q and dO tiles of a query
// tile of a head of the group); or (p.split, for long item streams) one
// key block for both, each warpgroup taking every other item and the two
// sums added in shared memory at the end.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const Params p) {
  using T = Tile<DP>;
  using L = Smem<DP>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + L::kBarriers;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t resident_bar = bars + 16 * kStages;
  uint32_t* key_mask = reinterpret_cast<uint32_t*>(base_ptr + L::kMask);
  const int words = p.seq_pad / 32;

  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int groups = p.heads / p.kv_heads;
  const int row_tiles = p.seq_pad / kTile;
  const int kb0 = p.split ? blockIdx.x : blockIdx.x * kWarpgroups;
  const int active = p.split ? kWarpgroups : min(kWarpgroups, row_tiles - kb0);
  const int owners = p.split ? 1 : active;  // key blocks in the CTA

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), p.split ? 4 : 4 * active);  // the warps that use a stage
    }
    mbar_init(resident_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  build_key_mask(p, b, key_mask);
  __syncthreads();
  // Causal: the first valid key (seq if none). The rows before it have no
  // valid key and p = 1/S over every key, past the diagonal too; without
  // such rows the query tiles before the first key block are skipped.
  int first = p.seq;
  for (int w = 0; p.causal && w < words; ++w) {
    if (key_mask[w] != 0) {
      first = 32 * w + __ffs(key_mask[w]) - 1;
      break;
    }
  }
  const int qt0 = (p.causal && first == 0) ? kb0 : 0;
  const int per_head = row_tiles - qt0;
  const int items = groups * per_head;
  const long long plane = static_cast<long long>(p.batch) * p.heads * p.seq_pad;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 4 * kWarpgroups) {
    // ---- producer warpgroup ----
    set_max_regs_dec<kProducerRegs>();
    if (warp == 4 * kWarpgroups && lane == 0) {
      mbar_expect_tx(resident_bar, 2 * owners * T::kBytes);
      for (int w = 0; w < owners; ++w) {
        tma_tile<DP>(base + w * T::kBytes, &tk, (kb0 + w) * kTile, hk, b, resident_bar);
        tma_tile<DP>(base + (kWarpgroups + w) * T::kBytes, &tv, (kb0 + w) * kTile, hk, b,
                     resident_bar);
      }
      for (int it = 0; it < items; ++it) {
        const int s = it % kStages;
        const int hq = hk * groups + it / per_head;
        const int q0 = (qt0 + it % per_head) * kTile;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::kBytes + 2 * kTile * 4);
        const uint32_t stage = base + L::kResident + s * L::kStage;
        tma_tile<DP>(stage, &tq, q0, hq, b, full(s));
        tma_tile<DP>(stage + T::kBytes, &tdo, q0, hq, b, full(s));
        const float* st = p.stats + (static_cast<long long>(b) * p.heads + hq) * p.seq_pad + q0;
        bulk_copy(stage + 2 * T::kBytes, st, kTile * 4, full(s));
        bulk_copy(stage + 2 * T::kBytes + kTile * 4, st + plane, kTile * 4, full(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, the keys of its key block ----
  set_max_regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  if (wg >= active) return;
  const bool turns = active == kWarpgroups;
  const int own = p.split ? 0 : wg;  // the key block, its tiles and mask
  const int wi = warp % 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int key_min = (kb0 + own) * kTile + 16 * wi;  // the warp's first key
  const int key_lo = key_min + g;
  const int key_hi = key_lo + 8;
  const uint32_t k_tile = base + own * T::kBytes;
  const uint32_t v_tile = base + (kWarpgroups + own) * T::kBytes;
  const bool in_lo = key_lo < p.seq, in_hi = key_hi < p.seq;
  const bool ok_lo = (key_mask[key_lo / 32] >> (key_lo % 32)) & 1;
  const bool ok_hi = (key_mask[key_hi / 32] >> (key_hi % 32)) & 1;
  // every key of the warp valid: no key masks (the causal one aside)
  const bool warp_ok = __all_sync(0xffffffffu, ok_lo && ok_hi);
  const float inv_seq = 1.0f / static_cast<float>(p.seq);
  const float c2 = p.sm_scale * kLog2e;
  // this warpgroup's items: all, or (split) every other one
  const int step = p.split ? 2 : 1;
  const int mine = p.split ? (items - wg + 1) / 2 : items;
  const int theirs = p.split ? (items - (1 - wg) + 1) / 2 : items;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;
  uint32_t pa[4][4], da[4][4];  // p and ds of the item in flight

  if (turns && wg == 1) turn_pass(1);  // warpgroup 0 issues first
  mbar_wait(resident_bar, 0);
  for (int j = 0; j < mine; ++j) {
    const int it = (p.split ? wg : 0) + j * step;
    const int s = it % kStages;
    const int qt = qt0 + it % per_head;
    mbar_wait(full(s), (it / kStages) & 1);
    __syncwarp();  // converged again for the .aligned wgmma instructions
    // No branch around a product (as in the rows kernel): items before
    // the diagonal (causal) run masked.
    const uint32_t q_tile = base + L::kResident + s * L::kStage;
    const uint32_t o_tile = q_tile + T::kBytes;
    uint64_t kd[DP / 16], qd[DP / 16], vd[DP / 16], od[DP / 16];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      kd[kk] = desc_k<DP>(k_tile, kk);
      qd[kk] = desc_k<DP>(q_tile, kk);
      vd[kk] = desc_k<DP>(v_tile, kk);
      od[kk] = desc_k<DP>(o_tile, kk);
    }
    float sc[32], dp[32];
    if (turns) turn_wait(wg);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    WgmmaSS<DP / 16>::run(sc, kd, qd);
    WgmmaSS<DP / 16>::run(dp, vd, od);
    wgmma_commit();
    // pass the turn while the other warpgroup has products left to issue
    if (turns && (wg == 0 ? j < theirs : j + 1 < theirs)) turn_pass(wg);
    // the previous item's products: done, its stage free
    wgmma_wait<1>();
    fence_regs(dk);
    fence_regs(dv);
    fence_frags(pa);
    fence_frags(da);
    if (j > 0 && lane == 0) mbar_arrive(empty((it - step) % kStages));
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // rows: keys key_lo / key_hi; columns: queries q0 + 8n + 2t + (e & 1)
    const float* st = reinterpret_cast<const float*>(base_ptr + L::kResident + s * L::kStage +
                                                     2 * T::kBytes);
    const int q0 = qt * kTile;
    const bool open = warp_ok && (!p.causal || key_min + 15 <= q0);
    auto terms = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 lse2 = *reinterpret_cast<const float2*>(st + 8 * n + 2 * t);
        const float2 dd2 = *reinterpret_cast<const float2*>(st + kTile + 8 * n + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float2 d = round_bf16x2(dp[4 * n + e], dp[4 * n + e + 1]);
          float p0 = ex2(fmaf(sc[4 * n + e], c2, -lse2.x));
          float p1 = ex2(fmaf(sc[4 * n + e + 1], c2, -lse2.y));
          float s0 = p0 * (d.x - dd2.x), s1 = p1 * (d.y - dd2.y);
          if constexpr (decltype(masked)::value) {
            const int key = (e & 2) ? key_hi : key_lo;
            const bool ok = (e & 2) ? ok_hi : ok_lo;
            const bool in = (e & 2) ? in_hi : in_lo;
            const int query = q0 + 8 * n + 2 * t;
            const bool ok0 = ok && (!p.causal || key <= query);
            const bool ok1 = ok && (!p.causal || key <= query + 1);
            // a row with no valid key (lse about -2e9): p = 1/S, ds = 0
            p0 = ok0 ? p0 : (lse2.x < kDeadLse && in ? inv_seq : 0.0f);
            p1 = ok1 ? p1 : (lse2.y < kDeadLse && in ? inv_seq : 0.0f);
            s0 = ok0 ? s0 : 0.0f;
            s1 = ok1 ? s1 : 0.0f;
          }
          sc[4 * n + e] = p0;
          sc[4 * n + e + 1] = p1;
          dp[4 * n + e] = s0;
          dp[4 * n + e + 1] = s1;
        }
      }
    };
    if (open) terms(Open());
    else terms(Masked());
    to_a_frags(pa, sc);
    to_a_frags(da, dp);
    uint64_t ob[4], qb[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ob[kk] = desc_mn<DP>(o_tile, kk);
      qb[kk] = desc_mn<DP>(q_tile, kk);
    }
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    WgmmaRS<DP>::run(dv, pa, ob);
    WgmmaRS<DP>::run(dk, da, qb);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  fence_frags(pa);
  fence_frags(da);
  if (mine > 0 && lane == 0)
    mbar_arrive(empty(((p.split ? wg : 0) + (mine - 1) * step) % kStages));
  if (p.split) {
    // warpgroup 1's sums into the ring (every item consumed), then added
    // to warpgroup 0's in a fixed order: the same bits on every run
    float* red = reinterpret_cast<float*>(base_ptr + L::kResident);
    const int i = threadIdx.x % 128;
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < DP / 2; ++r) {
        red[r * 128 + i] = dk[r];
        red[(DP / 2 + r) * 128 + i] = dv[r];
      }
    }
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    if (wg == 1) return;
#pragma unroll
    for (int r = 0; r < DP / 2; ++r) {
      dk[r] += red[r * 128 + i];
      dv[r] += red[(DP / 2 + r) * 128 + i];
    }
  }
  store_rows<DP>(dk, p.sm_scale, p.dk + b * p.dk_sb + hk * p.dk_sh, p.dk_ss, key_lo, key_hi,
                 t, p.seq, p.dim);
  store_rows<DP>(dv, 1.0f, p.dv + b * p.dv_sb + hk * p.dv_sh, p.dv_ss, key_lo, key_hi, t,
                 p.seq, p.dim);
}

// ---------------------------------------------------------------------------
// Host side

struct Operands {
  const void *q, *k, *v, *dout;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
};

// kernels: a mask of the kernels to launch (1 D, 2 dq, 4 dk/dv), all but
// to time one alone on the statistics of an earlier call.
template <int DP>
cudaError_t launch(const Params& p, const Operands& x, int kernels, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map<DP>(&tq, x.q, p.batch, p.heads, p.seq, p.dim, x.q_sb, x.q_sh,
                          x.q_ss)) != cudaSuccess ||
      (err = make_map<DP>(&tk, x.k, p.batch, p.kv_heads, p.seq, p.dim, x.k_sb, x.k_sh,
                          x.k_ss)) != cudaSuccess ||
      (err = make_map<DP>(&tv, x.v, p.batch, p.kv_heads, p.seq, p.dim, x.v_sb, x.v_sh,
                          x.v_ss)) != cudaSuccess ||
      (err = make_map<DP>(&tdo, x.dout, p.batch, p.heads, p.seq, p.dim, x.do_sb, x.do_sh,
                          x.do_ss)) != cudaSuccess)
    return err;
  auto d_kernel = attn_bwd_rows_kernel<DP, true>;
  auto dq_kernel = attn_bwd_rows_kernel<DP, false>;
  auto dkdv_kernel = attn_bwd_dkdv_kernel<DP>;
  const size_t smem = Smem<DP>::kBytes + p.seq_pad / 8;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // Once per instantiation, at its first launch: later launches make no
  // attribute call.
  static const cudaError_t attr_d = cudaFuncSetAttribute(
      d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  static const cudaError_t attr_dkdv = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr_d != cudaSuccess) return attr_d;
  if (attr_dq != cudaSuccess) return attr_dq;
  if (attr_dkdv != cudaSuccess) return attr_dkdv;

  const int row_tiles = p.seq_pad / kTile;
  const int units = (p.heads / p.kv_heads) * row_tiles;  // per kv head
  const dim3 dq_grid((units + kWarpgroups - 1) / kWarpgroups, p.kv_heads, p.batch);
  if (kernels & 1) {
    d_kernel<<<dq_grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (kernels & 2) {
    dq_kernel<<<dq_grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 dkdv_grid(p.split ? row_tiles : (row_tiles + kWarpgroups - 1) / kWarpgroups,
                       p.kv_heads, p.batch);
  if (kernels & 4) {
    dkdv_kernel<<<dkdv_grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// q, dout, dq (B, H, S, D); k, v, dk, dv (B, Hkv, S, D): bf16, element
// strides per (batch, head, position), the head dim contiguous. D % 8 == 0,
// D <= 128, strides multiples of 8, pointers 16-byte aligned (the wrapper
// checks). lse: (B, H, S) float32 from the forward. valid: (B, S) int32 or
// null. stats: (2, B, H, S64) float32 scratch, S64 = S rounded up to a
// multiple of 64. Launches the D, dq and dk/dv kernels (those of the mask
// `kernels`: 1, 2, 4). Returns a cudaError_t.
extern "C" int vla_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* valid, void* dq, void* dk, void* dv, void* stats,
    int batch, int heads, int kv_heads, int seq, int dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long lse_sb, long long lse_sh,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    long long valid_sb, float sm_scale, int causal, int split, int kernels, void* stream) {
  if (seq < 1 || batch < 1 || kv_heads < 1 || heads % kv_heads || dim < 8 || dim % 8 ||
      dim > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.valid = static_cast<const int32_t*>(valid);
  p.stats = static_cast<float*>(stats);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seq = seq;
  p.dim = dim;
  p.seq_pad = (seq + kTile - 1) / kTile * kTile;
  p.lse_sb = lse_sb; p.lse_sh = lse_sh;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.valid_sb = valid_sb;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.split = split;
  Operands x{q, k, v, dout, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
             do_sb, do_sh, do_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((dim + 15) / 16 * 16) {
    case 16: return launch<16>(p, x, kernels, s);
    case 32: return launch<32>(p, x, kernels, s);
    case 48: return launch<48>(p, x, kernels, s);
    case 64: return launch<64>(p, x, kernels, s);
    case 80: return launch<80>(p, x, kernels, s);
    case 96: return launch<96>(p, x, kernels, s);
    case 112: return launch<112>(p, x, kernels, s);
    case 128: return launch<128>(p, x, kernels, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
