// Fused softmax attention for Hopper (sm_90a), bf16 in / bf16 out: TMA
// copies paced by mbarriers, bf16 wgmma, the softmax in registers.
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
// Keys past S take -inf (they are not keys); a row with no valid key
// therefore averages V over the S keys, as the plain version does.
// When training (a non-null `lse`), it also writes each row's log-sum-exp
// lse = m + log(sum_k exp(s - m)), fp32, the sum over the UNROUNDED
// exponentials, so that the backward's exp(s - lse) is the exact softmax
// (attention_bwd.cu). The unrounded sum is kept whether or not it is
// written, so a null pointer leaves every output bit as it was.
//
// Numerics: the TPU kernel's. p is rounded against the row's FINAL max, as
// the TPU kernel and the plain version round it: a max pass over the K
// tiles (q.k^T and a running max, no exponential) comes before the main
// pass. The online form (a running max, the sums rescaled when it rises)
// rounds the terms of every tile before the max's tile against another
// max: each differs by a rounding (a relative 2^-9), but all of those
// terms do, not the rare ones a summation order flips. It held every
// kernel-vs-plain bound, but moved the step-0 loss of the 0.5B full-train
// recipe by 1e-3 from the parent kernel's and ended its 6-step run above
// its start (chip_smoke.py phase 21: 0.918 against 0.814; the parent's
// kernel 0.729 against 0.813), where the max pass keeps the TPU kernel's
// arithmetic; it costs one more q.k^T product a tile (PERF.md). The
// exponentials are base 2 (ex2 of s * sm_scale * log2 e - m), the lse
// converted back by ln 2, the output acc times the rounded 1 / l. Held
// against the plain version within 2e-2 (bf16 out) and 1e-6 (lse) on the
// card (tests/test_torch_attention_cuda.py, chip_smoke.py phase 2).
//
// What bounds it on this card: 4 H S^2 D operations. The Qwen2 call (S =
// 640, 14 q / 2 kv heads, D = 64) does ~530 flop per byte of q/k/v/o,
// above the H100's ~295 ridge: operations bound; the ViT calls (S ~ 256,
// no GQA) ~130: bytes bound. At D = 64 the softmax terms (an exp, a bf16
// rounding and a few flops per score) cost as much issue time as the two
// products, so the design overlaps them with the products.
//
// Design: a CTA of one producer warpgroup (one thread issues every TMA
// copy; setmaxnreg gives its registers to the others) and NWG = 1 to 3
// consumer warpgroups of 64 query rows each. As the Pallas kernel folds the
// query heads of a kv group into its rows, a CTA's units (64 query rows of
// one head) are taken in order over (head of the group, row tile) of one kv
// head, so the warpgroups of a CTA share every K/V tile. The Q tiles are
// loaded once by TMA; the K tiles (the max pass), then the K and V tiles
// (the main pass) of 64 or 128 keys stream through a ring of 2-4 stages
// (`full` mbarriers count the bytes, `empty` the consumer warps done with
// a stage). The max pass: s = q.k^T (wgmma, both operands in shared
// memory, K-major), masked, into each row's max. Then per key tile, each
// consumer warpgroup
//   1. issues s = q.k^T again;
//   2. waits for the previous tile's p @ v (which ran under step 1), frees
//      its stage, then for s;
//   3. masks s, forms p = 2^(s - m) and rounds it to bf16 in registers;
//   4. issues acc += p @ v with p as wgmma's register A operand and the V
//      tile read MN-major (the transpose bit), and goes on to the next tile.
// With turns, the warpgroups of a CTA issue their score products in turn
// (a ring of named barriers), so one's softmax terms run under the
// others' products. No score is stored: one code path serves every S.
// attention_plan (ops/attention_kernel.py) picks per shape the CTA's
// warpgroups and how many CTAs an SM holds (which sets the registers),
// the keys a tile, the stages and turns, from the times of every variant
// on an H100 (b1_compare.py --variants). One
// warpgroup and three CTAs an SM serve the large grids at D <= 64: a
// CTA's fixed cost (barriers, the Q tile's first load from device memory,
// ~2 us of a 7 us CTA at S = 256) runs under the others' products.
//
// Causal: a CTA streams the key tiles up to its last unit's diagonal, or
// all of them if a row of its units has no valid key at or before itself
// (such a row averages V over every key, past its diagonal too). Tiles past
// a warpgroup's own diagonal run masked, not skipped: ptxas serializes
// every wgmma of a kernel that waits on one in a branch it cannot prove
// uniform (attention_bwd.cu, trap (b)), so every loop bound is the CTA's.
//
// Layouts and product chains: attention_wgmma.cuh (shared with B1-bwd):
// 64-row tiles of the head dim padded to DP in TMA column chunks of 64, 32
// or 16 bf16 with the matching swizzle, so D = 72 (so400m, padded to 80)
// and D = 80 (Phi-2) take 16-wide chunks. TMA zero-fills rows past S and
// dims past D.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns the error of building the tensor maps or
// cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

using namespace vla_attention;

constexpr float kNegInf = -2.0e9f;            // the Pallas kernel's NEG_INF
constexpr float kNegInf2 = kNegInf * kLog2e;  // in base-2 units
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kProducerRegs = 24;  // registers a producer thread after setmaxnreg
constexpr int kMaxStages = 4;

// A CTA of NWG consumer warpgroups and a producer warpgroup, PER_SM of them
// resident on an SM: registers a thread at launch (the __launch_bounds__)
// and a consumer thread's after setmaxnreg (the producer keeps 24).
//   NWG 1, PER_SM 2: 128 at launch, 232 a consumer;
//   NWG 1, PER_SM 3:  80, 136 (padded head dims up to 96);
//   NWG 2, PER_SM 1: 168, 240;
//   NWG 3, PER_SM 1: 128, 160.
template <int NWG, int PER_SM>
struct Cta {
  static constexpr int kThreads = (NWG + 1) * 128;
  static constexpr int kConsumerRegs =
      NWG == 1 ? (PER_SM == 3 ? 136 : 232) : NWG == 2 ? 240 : 160;
};

// With turns, the consumer warpgroups issue their score products in turn,
// around a ring of named barriers (1 + wg: warpgroup wg's turn; 256
// threads, the waiter's and the passer's), so one's softmax terms run
// under the others' products.
__device__ __forceinline__ void ring_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void ring_pass(int wg, int nwg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + (wg + 1) % nwg) : "memory");
}

struct Params {
  const int32_t* valid;  // (B, S) with row stride valid_sb; null = all valid
  __nv_bfloat16* o;
  float* lse;            // (B, H, S) with strides lse_sb, lse_sh; null when serving
  int heads, kv_heads, seq, dim;
  int seq_pad;           // seq rounded up to whole 64-row query tiles
  int key_pad;           // seq rounded up to whole key tiles
  int stages;            // ring stages (2..kMaxStages)
  long long o_sb, o_sh, o_ss;
  long long valid_sb;
  long long lse_sb, lse_sh;
  float sm_scale;
  int causal;
  int turns;             // the consumer warpgroups issue their score products in turn
};

// Shared memory (from a 1024-aligned base): the Q tiles of the NWG units,
// the ring's stages (KH 64-key tiles of K, then KH of V), the barriers
// (full[stages], empty[stages], the Q tiles'), the batch row's key mask
// (key_pad / 8 bytes), and 1024 bytes of alignment slack.
template <int DP, int NWG, int KH>
size_t smem_bytes(int stages, int key_pad) {
  return static_cast<size_t>(NWG + 2 * KH * stages) * Tile<DP>::kBytes +
         8 * (2 * stages + 1) + key_pad / 8 + 1024;
}

// The kernel. DP: the head dim padded to a multiple of 16; NWG: consumer
// warpgroups a CTA; PER_SM: CTAs an SM holds; KH: 64-key halves of a key
// tile (a tile of 64 KH keys).
template <int DP, int NWG, int PER_SM, int KH>
__global__ void __launch_bounds__(Cta<NWG, PER_SM>::kThreads, PER_SM)
fused_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tile<DP>;
  constexpr int kThreads = Cta<NWG, PER_SM>::kThreads;
  constexpr int kKeys = kTile * KH;  // keys per key tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const int stages = p.stages;
  const uint32_t ring = base + NWG * T::kBytes;
  constexpr int kStage = 2 * KH * T::kBytes;  // K halves, then V halves
  const uint32_t bars = ring + stages * kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };
  const uint32_t q_bar = bars + 16 * stages;
  uint32_t* key_mask =
      reinterpret_cast<uint32_t*>(base_ptr + (q_bar + 8 - base));

  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int groups = p.heads / p.kv_heads;
  const int row_tiles = p.seq_pad / kTile;
  const int units = groups * row_tiles;
  const int unit0 = blockIdx.x * NWG;
  const int active = min(NWG, units - unit0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * active);  // every warp of every active warpgroup
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the key validity of batch row b as bits (word w: keys 32w .. 32w + 31;
  // a key past S is not valid), by every thread of the CTA
  {
    const int32_t* valid = p.valid ? p.valid + b * p.valid_sb : nullptr;
    const int lane = threadIdx.x % 32;
    for (int w = threadIdx.x / 32; w < p.key_pad / 32; w += kThreads / 32) {
      const int key = 32 * w + lane;
      bool ok = key < p.seq;
      if (ok && valid != nullptr) ok = valid[key] > 0;
      const uint32_t bits = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) key_mask[w] = bits;
    }
  }
  __syncthreads();

  // Key tiles streamed: all; causal, up to the CTA's last diagonal, unless
  // a row of its units comes before the first valid key (no valid key at
  // or before it: it averages V over all S keys).
  int tiles = p.key_pad / kKeys;
  if (p.causal) {
    int first = p.seq;
    for (int w = 0; w < p.key_pad / 32; ++w) {
      if (key_mask[w] != 0) {
        first = 32 * w + __ffs(key_mask[w]) - 1;
        break;
      }
    }
    int last = 0, lowest = p.seq_pad;
    for (int w = 0; w < active; ++w) {
      const int rt = (unit0 + w) % row_tiles;
      last = max(last, ((rt + 1) * kTile + kKeys - 1) / kKeys);
      lowest = min(lowest, rt * kTile);
    }
    if (lowest >= first) tiles = min(tiles, last);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 4 * NWG) {
    // ---- producer warpgroup: one thread issues every copy ----
    set_max_regs_dec<kProducerRegs>();
    if (warp == 4 * NWG && lane == 0) {
      mbar_expect_tx(q_bar, active * T::kBytes);
      for (int w = 0; w < active; ++w) {
        const int unit = unit0 + w;
        tma_tile<DP>(base + w * T::kBytes, &tq, (unit % row_tiles) * kTile,
                     hk * groups + unit / row_tiles, b, q_bar);
      }
      // the K tiles (the max pass), then the K and V tiles (the main pass)
      int s = 0, phase = 0;
      for (int step = 0; step < 2 * tiles; ++step) {
        const bool main_pass = step >= tiles;
        const int it = main_pass ? step - tiles : step;
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), main_pass ? kStage : kStage / 2);
        const uint32_t stage = ring + s * kStage;
#pragma unroll
        for (int kh = 0; kh < KH; ++kh) {
          tma_tile<DP>(stage + kh * T::kBytes, &tk, it * kKeys + kh * kTile, hk, b, full(s));
          if (main_pass)
            tma_tile<DP>(stage + (KH + kh) * T::kBytes, &tv, it * kKeys + kh * kTile, hk, b,
                         full(s));
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, its unit's 64 query rows ----
  set_max_regs_inc<Cta<NWG, PER_SM>::kConsumerRegs>();
  const int wg = warp / 4;
  if (wg >= active) return;
  const bool turns = NWG > 1 && active == NWG && p.turns;
  const int wi = warp % 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int unit = unit0 + wg;
  const int h = hk * groups + unit / row_tiles;
  const int row_min = (unit % row_tiles) * kTile + 16 * wi;  // the warp's first row
  const int r_lo = row_min + g;
  const int r_hi = r_lo + 8;
  const uint32_t q_tile = base + wg * T::kBytes;
  const float c2 = p.sm_scale * kLog2e;  // scores to base-2 exponents

  uint64_t qd[DP / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) qd[kk] = desc_k<DP>(q_tile, kk);
  // Element 4n + e of acc and of a 64-key half's scores: row r_lo (e < 2)
  // or r_hi, column 8n + 2t + (e & 1).
  int s = 0, phase = 0;  // ring stage and its parity, over both passes
  auto advance = [&]() {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  };
  // s = q.k^T of key tile `it` from the stage `s` into sc: wgmma from
  // shared memory, in turn with the other warpgroups
  auto score_product = [&](float (&sc)[KH][32], bool pass_on) {
    const uint32_t k_tile = ring + s * kStage;
    if (turns) ring_wait(wg);
#pragma unroll
    for (int kh = 0; kh < KH; ++kh) fence_regs(sc[kh]);
    wgmma_fence();
#pragma unroll
    for (int kh = 0; kh < KH; ++kh) {
      uint64_t kd[DP / 16];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) kd[kk] = desc_k<DP>(k_tile + kh * T::kBytes, kk);
      WgmmaSS<DP / 16>::run(sc[kh], qd, kd);
    }
    wgmma_commit();
    if (turns && pass_on) ring_pass(wg, NWG);
  };
  // The scores of key tile `it` in base-2 units, masked: keys past S -inf,
  // invalid keys + bias, causal keys past the row -2e9 (before the bias
  // is in, as the plain version's select). Open tiles (every key valid
  // and allowed for every row of the warp) keep their raw scores: sm_scale
  // > 0 keeps their order, and the main pass scales them inside its fma.
  auto mask_scores = [&](float (&sc)[KH][32], int it) {
    const int key0 = it * kKeys;
#pragma unroll
    for (int kh = 0; kh < KH; ++kh) {
      const uint64_t bits = ((static_cast<uint64_t>(key_mask[2 * (KH * it + kh) + 1]) << 32) |
                             key_mask[2 * (KH * it + kh)]) >>
                            (2 * t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[kh][4 * n + e] * c2;
          const int key = key0 + kh * kTile + 8 * n + 2 * t + (e & 1);
          if (key >= p.seq) {
            x = -INFINITY;  // not a key
          } else {
            if (!((bits >> (8 * n + (e & 1))) & 1)) x += kNegInf2;
            if (p.causal && key > ((e & 2) ? r_hi : r_lo)) x = kNegInf2;
          }
          sc[kh][4 * n + e] = x;
        }
      }
    }
  };
  auto is_open = [&](int it) {
    bool all_valid = true;
#pragma unroll
    for (int w = 0; w < 2 * KH; ++w) all_valid = all_valid && key_mask[2 * KH * it + w] == ~0u;
    return all_valid && (!p.causal || it * kKeys + kKeys - 1 <= row_min);
  };

  if (turns && wg == NWG - 1) ring_pass(wg, NWG);  // warpgroup 0 issues first
  mbar_wait(q_bar, 0);

  // ---- the max pass: each row's max over all its keys, as the TPU kernel
  // takes it before it rounds any p ----
  float mx[2][4] = {{-INFINITY, -INFINITY, -INFINITY, -INFINITY},
                    {-INFINITY, -INFINITY, -INFINITY, -INFINITY}};  // scaled
  float mr[2][4] = {{-INFINITY, -INFINITY, -INFINITY, -INFINITY},
                    {-INFINITY, -INFINITY, -INFINITY, -INFINITY}};  // raw, open tiles
  for (int it = 0; it < tiles; ++it) {
    mbar_wait(full(s), phase);
    __syncwarp();  // converged again for the .aligned wgmma instructions
    float sc[KH][32];
    score_product(sc, true);
    wgmma_wait<0>();
#pragma unroll
    for (int kh = 0; kh < KH; ++kh) fence_regs(sc[kh]);
    if (lane == 0) mbar_arrive(empty(s));  // the K tile is read
    // four partial maxima a row: short dependency chains
    auto max_into = [&](float (&m)[2][4]) {
#pragma unroll
      for (int kh = 0; kh < KH; ++kh) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& m4 = m[e >> 1][(n & 1) * 2 + (e & 1)];
            m4 = fmaxf(m4, sc[kh][4 * n + e]);
          }
        }
      }
    };
    if (is_open(it)) {
      max_into(mr);
    } else {
      mask_scores(sc, it);
      max_into(mx);
    }
    advance();
  }
  float m_lo = fmaxf(fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3])),
                     c2 * fmaxf(fmaxf(mr[0][0], mr[0][1]), fmaxf(mr[0][2], mr[0][3])));
  float m_hi = fmaxf(fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3])),
                     c2 * fmaxf(fmaxf(mr[1][0], mr[1][1]), fmaxf(mr[1][2], mr[1][3])));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
  }
  // key 0 is a key of every row, so the max is finite

  // ---- the main pass: p = bf16(2^(s - m)), l = sum(p), acc += p @ v ----
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float l_lo = 0.0f, l_hi = 0.0f;  // sums of the rounded p (this thread's columns)
  float e_lo = 0.0f, e_hi = 0.0f;  // and of the unrounded
  uint32_t pa[KH][4][4];           // p of the tile in flight, as A fragments
  int prev = 0;                    // the stage of the p @ v in flight
  for (int it = 0; it < tiles; ++it) {
    mbar_wait(full(s), phase);
    __syncwarp();
    const uint32_t v_tile = ring + s * kStage + KH * T::kBytes;
    float sc[KH][32];
    score_product(sc, !(wg == NWG - 1 && it == tiles - 1));
    // the previous tile's p @ v: done, its stage free
    wgmma_wait<1>();
    fence_regs(acc);
#pragma unroll
    for (int kh = 0; kh < KH; ++kh) fence_frags(pa[kh]);
    if (it > 0 && lane == 0) mbar_arrive(empty(prev));
    wgmma_wait<0>();
#pragma unroll
    for (int kh = 0; kh < KH; ++kh) fence_regs(sc[kh]);

    auto softmax_terms = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      if (kMasked) mask_scores(sc, it);
      // this tile's sums, two partial sums a row, added at its end
      float ts[2][2][2] = {};  // [lo / hi][unrounded / rounded][partial]
#pragma unroll
      for (int kh = 0; kh < KH; ++kh) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const float m = (e & 2) ? m_hi : m_lo;
            const float x0 = sc[kh][4 * n + e], x1 = sc[kh][4 * n + e + 1];
            // p = 2^(s c2 - m): one fma on the raw score where no mask applies
            const float p0 = kMasked ? ex2(x0 - m) : ex2(fmaf(x0, c2, -m));
            const float p1 = kMasked ? ex2(x1 - m) : ex2(fmaf(x1, c2, -m));
            const __nv_bfloat162 r = __floats2bfloat162_rn(p0, p1);
            const float2 rf = __bfloat1622float2(r);
            ts[e >> 1][0][n & 1] += p0 + p1;
            ts[e >> 1][1][n & 1] += rf.x + rf.y;
            pa[kh][n >> 1][(n & 1) * 2 + (e >> 1)] = *reinterpret_cast<const uint32_t*>(&r);
          }
        }
      }
      e_lo += ts[0][0][0] + ts[0][0][1];
      l_lo += ts[0][1][0] + ts[0][1][1];
      e_hi += ts[1][0][0] + ts[1][0][1];
      l_hi += ts[1][1][0] + ts[1][1][1];
    };
    if (is_open(it)) softmax_terms(Open());
    else softmax_terms(Masked());

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kh = 0; kh < KH; ++kh) {
      uint64_t vb[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) vb[kk] = desc_mn<DP>(v_tile + kh * T::kBytes, kk);
      WgmmaRS<DP>::run(acc, pa[kh], vb);
    }
    wgmma_commit();
    prev = s;
    advance();
  }
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int kh = 0; kh < KH; ++kh) fence_frags(pa[kh]);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    e_lo += __shfl_xor_sync(0xffffffffu, e_lo, off);
    e_hi += __shfl_xor_sync(0xffffffffu, e_hi, off);
  }
  if (p.lse != nullptr && t == 0) {  // uniform: the whole grid takes it or skips it
    float* lse = p.lse + b * p.lse_sb + h * p.lse_sh;
    if (r_lo < p.seq) lse[r_lo] = (m_lo + log2f(e_lo)) * kLn2;
    if (r_hi < p.seq) lse[r_hi] = (m_hi + log2f(e_hi)) * kLn2;
  }
  // out = acc / l, as acc times the correctly rounded 1 / l (one rounding
  // more than the quotient: far inside the bf16 output's)
  const float i_lo = __frcp_rn(l_lo), i_hi = __frcp_rn(l_hi);
  __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (d >= p.dim) continue;
    if (r_lo < p.seq)
      *reinterpret_cast<__nv_bfloat162*>(o + r_lo * p.o_ss + d) =
          __floats2bfloat162_rn(acc[4 * n] * i_lo, acc[4 * n + 1] * i_lo);
    if (r_hi < p.seq)
      *reinterpret_cast<__nv_bfloat162*>(o + r_hi * p.o_ss + d) =
          __floats2bfloat162_rn(acc[4 * n + 2] * i_hi, acc[4 * n + 3] * i_hi);
  }
}

struct Operands {
  const void *q, *k, *v;
  int batch;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
};

template <int DP, int NWG, int PER_SM, int KH>
cudaError_t launch(Params p, const Operands& x, cudaStream_t stream) {
  auto kernel = fused_attention_kernel<DP, NWG, PER_SM, KH>;
  p.key_pad = (p.seq + kTile * KH - 1) / (kTile * KH) * (kTile * KH);
  const size_t smem = smem_bytes<DP, NWG, KH>(p.stages, p.key_pad);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map<DP>(&tq, x.q, x.batch, p.heads, p.seq, p.dim, x.q_sb, x.q_sh,
                          x.q_ss)) != cudaSuccess ||
      (err = make_map<DP>(&tk, x.k, x.batch, p.kv_heads, p.seq, p.dim, x.k_sb, x.k_sh,
                          x.k_ss)) != cudaSuccess ||
      (err = make_map<DP>(&tv, x.v, x.batch, p.kv_heads, p.seq, p.dim, x.v_sb, x.v_sh,
                          x.v_ss)) != cudaSuccess)
    return err;
  // Once per instantiation, at its first (uncaptured) launch, to the most a
  // block may use: every smaller size is then admitted, and later launches,
  // inside a CUDA graph capture too, make no attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int units = (p.heads / p.kv_heads) * (p.seq_pad / kTile);
  const dim3 grid((units + NWG - 1) / NWG, p.kv_heads, x.batch);
  kernel<<<grid, Cta<NWG, PER_SM>::kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// The kernels attention_plan picks from, by (warpgroups, CTAs an SM, keys
// a tile): (1, 2, 64 or 128), (1, 3, 64) for padded head dims up to 96,
// (2, 1, 64), (3, 1, 64). Any other plan is refused.
template <int DP>
cudaError_t launch_plan(const Params& p, const Operands& x, int warpgroups, int per_sm,
                        int key_tile, cudaStream_t s) {
  if (warpgroups == 1 && per_sm <= 2)
    return key_tile == 128 ? launch<DP, 1, 2, 2>(p, x, s) : launch<DP, 1, 2, 1>(p, x, s);
  if (key_tile != 64) return cudaErrorInvalidValue;
  if (warpgroups == 1) {
    if constexpr (DP <= 96) return launch<DP, 1, 3, 1>(p, x, s);
    return cudaErrorInvalidValue;
  }
  return warpgroups == 2 ? launch<DP, 2, 1, 1>(p, x, s) : launch<DP, 3, 1, 1>(p, x, s);
}

}  // namespace

// q (B, H, S, D), k/v (B, Hkv, S, D), o (B, H, S, D): bf16, element strides
// per (batch, head, position), the head dim contiguous. D % 8 == 0, D <= 128,
// every stride a multiple of 8 and the pointers 16-byte aligned (the wrapper
// checks). valid: (B, S) int32 or null. lse: (B, H, S) float32 (row stride
// 1) or null. warpgroups (consumer warpgroups per CTA, 1 to 3),
// ctas_per_sm (the CTAs an SM holds, which sets the registers), stages
// (2..4), key_tile (keys per ring stage, 64 or 128) and turns come from
// attention_plan. Returns a cudaError_t.
extern "C" int vla_fused_attention_bf16(
    const void* q, const void* k, const void* v, const void* valid, void* o, void* lse,
    int batch, int heads, int kv_heads, int seq, int dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long valid_sb, long long lse_sb, long long lse_sh, float sm_scale, int causal,
    int warpgroups, int ctas_per_sm, int stages, int key_tile, int turns, void* stream) {
  if (warpgroups < 1 || warpgroups > 3 || stages < 2 || stages > kMaxStages ||
      (key_tile != 64 && key_tile != 128) || seq < 1 ||
      batch < 1 || kv_heads < 1 || heads % kv_heads || dim < 8 || dim % 8 || dim > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.valid = static_cast<const int32_t*>(valid);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.seq = seq;
  p.dim = dim;
  p.seq_pad = (seq + kTile - 1) / kTile * kTile;
  p.stages = stages;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.valid_sb = valid_sb;
  p.lse_sb = lse_sb;
  p.lse_sh = lse_sh;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.turns = turns;
  const Operands x{q, k, v, batch, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((dim + 15) / 16 * 16) {
    case 16: return launch_plan<16>(p, x, warpgroups, ctas_per_sm, key_tile, s);
    case 32: return launch_plan<32>(p, x, warpgroups, ctas_per_sm, key_tile, s);
    case 48: return launch_plan<48>(p, x, warpgroups, ctas_per_sm, key_tile, s);
    case 64: return launch_plan<64>(p, x, warpgroups, ctas_per_sm, key_tile, s);
    case 80: return launch_plan<80>(p, x, warpgroups, ctas_per_sm, key_tile, s);
    case 96: return launch_plan<96>(p, x, warpgroups, ctas_per_sm, key_tile, s);
    case 112: return launch_plan<112>(p, x, warpgroups, ctas_per_sm, key_tile, s);
    case 128: return launch_plan<128>(p, x, warpgroups, ctas_per_sm, key_tile, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
