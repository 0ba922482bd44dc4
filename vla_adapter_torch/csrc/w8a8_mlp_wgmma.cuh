// The w8a8 MLP panel walk on Hopper's TMA and int8 wgmma: the device code of
// kernels B2/B3 (fused_mlp_w8a8.cu).
//
//   xq, rs = quantize_rows(x)                   per token
//   for each block_f-wide panel of F:
//     g  = float(xq @ W1_panel^T) * rs * s1 (+ b1)
//     h  = act(g)                  or act(g) * (float(xq @ Wu^T) * rs * su)
//     h  = 0 in columns >= F       (the ragged tail panel)
//     hq, hs = quantize_rows(h)    per (token, panel)
//     acc += float(hq @ W2_panel^T) * hs      float32, panels in order
//   out = acc * s2 (+ b2)
//
// block_f = 512 is part of the numerics (h is re-quantized per panel), not a
// tile size.
//
// A CTA is two consumer warpgroups and a producer warpgroup whose one
// thread takes the work items from an atomic ticket, hands each to the
// consumers through a two-slot item ring, waits for what the item reads and
// issues its TMA copies (128 bytes of K a stage, the 128-byte swizzle) into
// an mbarrier ring; setmaxnreg gives the producer's registers to the
// consumers. The producer runs one item ahead of the consumers, so the next
// item's first stages land under the current one's epilogue. Items, in
// ticket order:
// * quant (64-row tile): the consumers quantize the tile's rows of x into
//   an xq/rs scratch, a warp per four rows at once (up to eight rows, a
//   decode step's: the whole CTA on each row, every load in flight at
//   once);
// * up (64-row tile, panel, K slice): the panel's products on wgmma
//   m64n64k32 s32.s8.s8 (the four k32 steps of a stage one asm statement),
//   the two warpgroups on alternate 64-column quarters of each 128-column
//   chunk (the whole panel is the two warpgroups' four chunks: each thread
//   keeps 128 values of h, chunk 0's in the idle hq tile, the rest in
//   registers). The panel's s1, su and b1 are staged in shared memory at
//   the item's start (zeros past F, so h there is exactly 0 without a
//   branch). One slice (M > 32): the dequantization and activation in
//   registers, the row absmax met across the two warpgroups through shared
//   memory, hq staged in shared memory and written with 16-byte stores, hs
//   beside it. Several
//   slices (decode, M <= 32): each item adds its exact int32 partial
//   products into a zeroed scratch with atomics; the last of the panel's
//   items to arrive (an atomic count, no wait) reads the sums back, zeroing
//   them, and quantizes h a warp per row;
// * down (128-row tile, 128 columns of D, panel group): per panel an int32
//   wgmma m64n128k32 accumulator over the panel's k, then acc +=
//   float(part) * hs in float32, panel by panel in order. One group (M >
//   32): out = acc * s2 (+ b2). Several groups (decode): each item writes
//   its panels' float terms float(part) * hs to a scratch and the last to
//   arrive sums all of them in panel order: the same sum, the same bits.
//
// Order. Every wait is the producer's, before it copies an item's operands,
// and on items with earlier tickets: an up item on its tile's quant item, a
// down item on the up items of each panel it reads, as it reaches the
// panel. An earlier ticket is held by a running CTA whose producer has
// issued all of that item's stages before it took its next ticket, and
// whose consumers need nothing else to finish it; so no wait can deadlock,
// whether or not every CTA is resident. The consumers never wait across
// CTAs: the split items meet by last arrival. Ready flags and counts are
// int32 in a per-device scratch that the last CTA to leave zeroes.
//
// Proxies. TMA reads through the async proxy, and xq, hq and hs are written
// in the same launch by other CTAs' threads through the generic one: each
// writer fences (fence.proxy.async.global) after its stores and before the
// release that signals them, and the producer fences again after the
// acquire that sees the signal, before its copies. Only TMA writes the
// shared tiles that wgmma reads.
//
// Products. ptxas serializes every wgmma of a kernel (a wait after each)
// when one sits in a branch it cannot prove uniform (C7518) or when a
// non-wgmma instruction writes an accumulator inside a product chain
// (C7515). So: item ids and warpgroup indices pass through __shfl_sync
// (warpgroup(), uniform()); a warpgroup whose rows all lie past M
// multiplies TMA's zeros instead of skipping its products; stores and
// reductions of per-lane rows go through a predicate, not a branch
// (store_if, red_add_if). The accumulators are still zeroed before each
// chain (whose first product overwrites them anyway): left unset, the
// kernel took 2.4x as long at Qwen2, B=1 (PERF.md, M10). A consumer
// releases a ring stage one stage later, once the next stage's products
// are issued (wgmma_wait<1>): releasing each stage as soon as its own
// products are done (wgmma_wait<0>) took 0-7% longer at seven shapes,
// the trees in turns (PERF.md, M13).
//
// Numerics. __fmul_rn / __fadd_rn keep every product and sum a separate
// rounding, "gelu" is the A&S erf and every row quantization takes the
// correctly rounded quotient (w8a8_mlp.cuh: activation, quant_bits).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "w8a8_mlp.cuh"

namespace vla_mlp_wg {

using vla_hopper::make_desc;
using vla_hopper::mbar_arrive;
using vla_hopper::mbar_expect_tx;
using vla_hopper::mbar_wait;
using vla_hopper::wgmma_commit;
using vla_hopper::wgmma_fence;
using vla_hopper::wgmma_wait;
using vla_w8a8::activation;
using vla_w8a8::load_acquire;
using vla_w8a8::low_bytes;
using vla_w8a8::quant_bits;
using vla_w8a8::row_scale;
using vla_w8a8::warp_max;

constexpr int kUpRows = 64;       // rows of a quant and an up item
constexpr int kDownRows = 128;    // rows of a down item: a warpgroup's 64 each
constexpr int kDownCols = 128;    // columns of D of a down item
constexpr int kChunk = 128;       // panel columns of an up stage
constexpr int kStep = 128;        // bytes of K a stage
constexpr int kPanel = 512;       // widest panel
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = 384;     // and the producer warpgroup
constexpr int kProducerRegs = 40; // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 232;
constexpr int kMaxSmem = 232448;  // shared memory a block may use

// A stage: an up step (64 rows of xq, 128 rows of W1 and of Wu) or a down
// step (128 rows of hq and of W2), 128 bytes of K each row.
__host__ __device__ constexpr int up_stage(bool gated) {
  return kUpRows * kStep + (gated ? 2 : 1) * kChunk * kStep;
}
constexpr int kDownStage = (kDownRows + kDownCols) * kStep;
__host__ __device__ constexpr int stage_bytes(bool gated) {
  return up_stage(gated) > kDownStage ? up_stage(gated) : kDownStage;
}
__host__ __device__ constexpr int ring_stages(bool gated) { return gated ? 4 : 5; }
constexpr int kHqTile = kUpRows * kPanel;  // an up item's hq, staged
constexpr int kVec = 3 * kPanel;           // a panel's s1, su, b1 (or s2, b2)
// 1024 bytes of alignment slack, the ring, the hq tile, the staged column
// vectors, both warpgroups' row maxima, the barriers (full and empty per
// stage, the item ring's two of each), the item ring's ids and a flag.
__host__ __device__ constexpr int smem_bytes(bool gated) {
  return 1024 + ring_stages(gated) * stage_bytes(gated) + kHqTile + 4 * kVec +
         2 * kUpRows * 4 + 8 * (2 * ring_stages(gated) + 4) + 16;
}

struct Params {
  const void* x;    // (M, K) T
  void* out;        // (M, D) T
  const float* s1;  // (F)
  const float* su;  // (F), gated only
  const float* b1;  // (F) or null
  const float* s2;  // (D)
  const float* b2;  // (D) or null
  int8_t* xq;       // (M, K) scratch
  float* rs;        // (mpad) scratch
  int8_t* hq;       // (M, panels * pw) scratch
  float* hs;        // (panels, mpad) scratch
  int* sums;        // up split: (2, M, F) int32, zero, left zero
  float* terms;     // down split: (panels, M, D)
  int* counters;    // ticket, exits, ready_x, ready_h, up counts, down counts
  int* ready_x;     // (row tiles): the tile's xq and rs are in
  int* ready_h;     // (row tiles, panels): the panel's hq and hs are in
  int* up_count;    // (row tiles, panels): split items arrived
  int* down_count;  // (down row tiles, column tiles): split items arrived
  int n_counters;   // after the first two
  int m, k, f, d, block_f;
  int pw;           // block_f rounded up to kStep
  int panels, mpad, k_steps;
  int row_tiles, down_tiles, col_tiles;
  int up_splits, up_slice;      // K slices of an up item, steps a slice
  int down_splits, down_slice;  // panel groups of a down item, panels a group
  int n_quant, n_up, n_items;
};

// The shared memory of a CTA and the state of its rings.
struct Smem {
  uint32_t ring;        // stage s at ring + s * stage bytes
  uint32_t bars;        // full[S], empty[S], item_full[2], item_empty[2]
  unsigned char* hq;    // the hq tile, 64 rows of 512 bytes, swizzled
  float* vec;           // [3][512] the item's column vectors
  float* red;           // [2][64] row maxima
  int* item;            // [2] item ids
  int* flag;
};

// This thread's warpgroup, through a shuffle so that the compiler knows it
// is the same on every lane: a branch on it (or on an item id read the same
// way) is then no divergent path, which would serialize the wgmma in it
// (ptxas C7518).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
}
__device__ __forceinline__ int uniform(int v) { return __shfl_sync(0xffffffffu, v, 0); }

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The producer thread's wait for a ready flag or count of earlier items,
// polling with a backoff from 32 to 256 ns (a down item waits at each
// panel, so a longer sleep delays every panel it reads). Bounded: a wait
// that never ends (~4 s) traps instead of hanging the card.
__device__ __forceinline__ void wait_flag(const int* c, int target) {
  unsigned ns = 32;
  uint64_t start = 0;
  while (load_acquire(c) < target) {
    __nanosleep(ns);
    if (ns < 256) {
      ns *= 2;
    } else {
      const uint64_t now = vla_hopper::global_ns();
      if (start == 0) start = now;
      else if (now - start > 4000000000ull) __trap();
    }
  }
}

// A store and an int32 reduction that a predicate guards without a branch:
// a branch on a lane's row or column around a use of wgmma results is a
// divergent path, in which ptxas would wait for the products and so
// serialize every wgmma of the kernel (C7518).
__device__ __forceinline__ void red_add_if(bool pred, int* addr, int v) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q red.global.add.s32 [%0], %1;\n}\n"
               :: "l"(addr), "r"(v), "r"(static_cast<int>(pred)) : "memory");
}
__device__ __forceinline__ void store_if(bool pred, float* addr, float v) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.f32 [%0], %1;\n}\n"
               :: "l"(addr), "f"(v), "r"(static_cast<int>(pred)) : "memory");
}

// A (128 bytes of K) x box-rows box at (k0, row0) of a 2-d int8 map.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int k0, int row0,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(bar)
      : "memory");
}

// A K-major tile of 128-byte rows under the 128-byte swizzle, at k32 step kk
// of its stage.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t tile, int kk) {
  return make_desc(tile + 32 * kk, 16, 8 * kStep, 1);
}

// Keep the compiler from moving accumulator registers across the async
// products.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 64, s32) (+)= the four k32 steps of one 128-byte stage, A[k] .
// B[k]^T from shared memory, as one asm statement (a chain split over
// statements can make ptxas serialize every wgmma: attention_bwd.cu (b)).
__device__ __forceinline__ void mma_stage_n64(int (&d)[32], const uint64_t (&a)[4],
                                              const uint64_t (&b)[4], int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %40, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %36, p;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %33, %37, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %34, %38, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %35, %39, 1;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]), "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(accumulate));
}

// d (64 x 128, s32) (+)= the four k32 steps of one 128-byte stage, A[k] .
// B[k]^T from shared memory, as one asm statement (a chain split over
// statements can make ptxas serialize every wgmma: attention_bwd.cu (b)).
__device__ __forceinline__ void mma_stage_n128(int (&d)[64], const uint64_t (&a)[4],
                                              const uint64_t (&b)[4], int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %72, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %68, p;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %65, %69, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %66, %70, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %67, %71, 1;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a[0]), "l"(a[1]), "l"(a[2]), "l"(a[3]), "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(accumulate));
}

// The ring's position, kept in step by the producer and the consumers.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ------------------------------------------------------------ item decode

struct UpItem {
  int rt, panel, split;
};
struct DownItem {
  int dt, ct, split;
};
__device__ __forceinline__ UpItem up_at(const Params& p, int it) {
  const int u = it - p.n_quant;
  const int per_panel = p.row_tiles * p.up_splits;
  const int r = u % per_panel;
  return {r / p.up_splits, u / per_panel, r % p.up_splits};
}
__device__ __forceinline__ DownItem down_at(const Params& p, int it) {
  const int u = it - p.n_quant - p.n_up;
  const int tile = u / p.down_splits;
  return {tile / p.col_tiles, tile % p.col_tiles, u % p.down_splits};
}
// Real columns of a panel, and its 128-column chunks (= down k steps).
__device__ __forceinline__ int panel_width(const Params& p, int panel) {
  return min(p.block_f, p.f - panel * p.block_f);
}
__device__ __forceinline__ int panel_chunks(const Params& p, int panel) {
  return (panel_width(p, panel) + kChunk - 1) / kChunk;
}

// --------------------------------------------------------------- producer

// The producer thread: takes every ticket of this CTA, hands it on, waits
// for what the item reads and issues its copies. Returns after handing on
// a ticket past the last item.
template <bool GATED>
__device__ void producer(const Params& p, const Smem& s, const CUtensorMap* tx,
                         const CUtensorMap* tw1, const CUtensorMap* twu, const CUtensorMap* thq,
                         const CUtensorMap* tw2) {
  constexpr int kStages = ring_stages(GATED);
  constexpr int kStageBytes = stage_bytes(GATED);
  auto full = [&](int i) { return s.bars + 8 * i; };
  auto empty = [&](int i) { return s.bars + 8 * (kStages + i); };
  auto item_full = [&](int i) { return s.bars + 8 * (2 * kStages + i); };
  auto item_empty = [&](int i) { return s.bars + 8 * (2 * kStages + 2 + i); };
  RingPos ring, items;
  for (;;) {
    const int it = atomicAdd(p.counters, 1);
    mbar_wait(item_empty(items.stage), items.phase ^ 1);  // a fresh barrier passes parity 1
    s.item[items.stage] = it;
    mbar_arrive(item_full(items.stage));
    items.advance(2);
    if (it >= p.n_items) return;
    if (it < p.n_quant) continue;
    if (it < p.n_quant + p.n_up) {
      const UpItem u = up_at(p, it);
      const int f0 = u.panel * p.block_f;
      const int chunks = panel_chunks(p, u.panel);
      const int k_lo = u.split * p.up_slice;
      const int k_hi = min(p.k_steps, k_lo + p.up_slice);
      bool first = true;
      for (int c = 0; c < chunks; ++c)
        for (int ks = k_lo; ks < k_hi; ++ks) {
          mbar_wait(empty(ring.stage), ring.phase ^ 1);
          const uint32_t bar = full(ring.stage);
          const uint32_t dst = s.ring + ring.stage * kStageBytes;
          if (first) {  // xq once its quant item has signalled
            wait_flag(p.ready_x + u.rt, 1);
            fence_proxy_global();
            first = false;
          }
          mbar_expect_tx(bar, up_stage(GATED));
          tma_2d(dst + kUpRows * kStep, tw1, ks * kStep, f0 + kChunk * c, bar);
          if (GATED) tma_2d(dst + kUpRows * kStep + kChunk * kStep, twu, ks * kStep, f0 + kChunk * c, bar);
          tma_2d(dst, tx, ks * kStep, u.rt * kUpRows, bar);
          ring.advance(kStages);
        }
    } else {
      const DownItem dn = down_at(p, it);
      const int p_lo = dn.split * p.down_slice;
      const int p_hi = min(p.panels, p_lo + p.down_slice);
      for (int panel = p_lo; panel < p_hi; ++panel) {
        const int steps = panel_chunks(p, panel);
        for (int kk = 0; kk < steps; ++kk) {
          mbar_wait(empty(ring.stage), ring.phase ^ 1);
          const uint32_t bar = full(ring.stage);
          const uint32_t dst = s.ring + ring.stage * kStageBytes;
          if (kk == 0) {  // the panel's hq and hs, from both 64-row up tiles
            for (int t = 2 * dn.dt; t < min(2 * dn.dt + 2, p.row_tiles); ++t)
              wait_flag(p.ready_h + t * p.panels + panel, 1);
            fence_proxy_global();
          }
          mbar_expect_tx(bar, kDownStage);
          tma_2d(dst + kDownRows * kStep, tw2, panel * p.block_f + kk * kStep, dn.ct * kDownCols, bar);
          tma_2d(dst, thq, panel * p.pw + kk * kStep, dn.dt * kDownRows, bar);
          ring.advance(kStages);
        }
      }
    }
  }
}

// -------------------------------------------------------------- consumers

// Sixteen bytes of x as float: 8 bf16 or 4 f32 values.
__device__ __forceinline__ void to_floats(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 q = __bfloat1622float2(h[i]);
    f[2 * i] = q.x;
    f[2 * i + 1] = q.y;
  }
}
__device__ __forceinline__ void to_floats(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// Up to eight rows of x (a decode step's) into xq and rs by the whole
// CTA, four rows at once: each thread loads 16-byte units tid, tid + 256,
// ... of each row (all of them in flight: K * sizeof(T) <= 16 KB), the
// row absmax meets across the warps in shared memory, and the values are
// quantized from the registers they were loaded into.
template <typename T>
__device__ void quant_rows_cta(const Params& p, const Smem& s, int row0, int n) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kJ = 4;
  const uint4* x = static_cast<const uint4*>(p.x);
  const int warp = threadIdx.x / 32;
  const int units = p.k / kPer;
  for (int g0 = 0; g0 < n; g0 += 4) {
    uint4 v[4][kJ];
    float amax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int u = threadIdx.x + kConsumers * j;
        v[i][j] = g0 + i < n && u < units ? __ldg(x + (long long)(row0 + g0 + i) * units + u)
                                          : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float f[kPer];
        to_floats(v[i][j], f);
#pragma unroll
        for (int e = 0; e < kPer; ++e) amax[i] = fmaxf(amax[i], fabsf(f[e]));
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      amax[i] = warp_max(amax[i]);
      if (threadIdx.x % 32 == 0) s.red[4 * warp + i] = amax[i];
    }
    consumer_sync();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = 0.0f;
#pragma unroll
      for (int w = 0; w < kConsumers / 32; ++w) m = fmaxf(m, s.red[4 * w + i]);
      const float scale = row_scale(m), inv = __frcp_rn(scale);
      if (threadIdx.x == 0 && g0 + i < n) p.rs[row0 + g0 + i] = scale;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int u = threadIdx.x + kConsumers * j;
        if (g0 + i >= n || u >= units) continue;
        float f[kPer];
        to_floats(v[i][j], f);
        uint32_t q[kPer / 4];
#pragma unroll
        for (int w = 0; w < kPer / 4; ++w)
          q[w] = low_bytes(quant_bits(f[4 * w], scale, inv), quant_bits(f[4 * w + 1], scale, inv),
                           quant_bits(f[4 * w + 2], scale, inv), quant_bits(f[4 * w + 3], scale, inv));
        int8_t* dst = p.xq + (long long)(row0 + g0 + i) * p.k + u * kPer;
        if constexpr (kPer == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
        else *reinterpret_cast<uint32_t*>(dst) = q[0];
      }
    }
    consumer_sync();  // every thread has read the maxima
  }
}

// Quant item (64-row tile rt): the tile's rows of x into xq and rs. Up to
// eight rows (a decode step) with the whole CTA on each row; otherwise
// warp w takes rows w, w + 8, ... of the tile, four at once, each lane
// 16-byte units lane, lane + 32, ... of them, four units of each row in
// flight: a pass over the rows for their absmax, then one that quantizes.
template <typename T>
__device__ void quant_item(const Params& p, const Smem& s, int rt) {
  const int n = min(kUpRows, p.m - rt * kUpRows);
  if (n <= 8 && p.k * static_cast<int>(sizeof(T)) <= 16 * 4 * kConsumers) {
    consumer_sync();  // the previous item is done with the row maxima
    quant_rows_cta<T>(p, s, rt * kUpRows, n);
    fence_proxy_global();
    consumer_sync();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(p.ready_x + rt, 1);
    }
    return;
  }
  constexpr int kPer = 16 / sizeof(T);  // values of x a unit
  constexpr int kU = 4;                 // units of a row a lane keeps in flight
  const uint4* x = static_cast<const uint4*>(p.x);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int units = p.k / kPer;         // K % 16 == 0
  const long long ld = units;           // units a row
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int r0 = rt * kUpRows + 32 * half + warp;
    if (r0 >= p.m) break;
    bool live[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) live[i] = r0 + 8 * i < p.m;
    auto load = [&](int u0, uint4 (&v)[4][kU]) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kU; ++j) {
          const int u = u0 + 32 * j;
          v[i][j] = live[i] && u < units ? __ldg(x + (r0 + 8 * i) * ld + u) : make_uint4(0, 0, 0, 0);
        }
    };
    float amax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int u0 = lane; u0 < units; u0 += 32 * kU) {
      uint4 v[4][kU];
      load(u0, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kU; ++j) {
          float f[kPer];
          to_floats(v[i][j], f);
#pragma unroll
          for (int e = 0; e < kPer; ++e) amax[i] = fmaxf(amax[i], fabsf(f[e]));
        }
    }
    float scale[4], inv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      scale[i] = row_scale(warp_max(amax[i]));
      inv[i] = __frcp_rn(scale[i]);
    }
    for (int u0 = lane; u0 < units; u0 += 32 * kU) {
      uint4 v[4][kU];
      load(u0, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kU; ++j) {
          const int u = u0 + 32 * j;
          if (!live[i] || u >= units) continue;
          float f[kPer];
          to_floats(v[i][j], f);
          uint32_t q[kPer / 4];
#pragma unroll
          for (int w = 0; w < kPer / 4; ++w)
            q[w] = low_bytes(quant_bits(f[4 * w], scale[i], inv[i]),
                             quant_bits(f[4 * w + 1], scale[i], inv[i]),
                             quant_bits(f[4 * w + 2], scale[i], inv[i]),
                             quant_bits(f[4 * w + 3], scale[i], inv[i]));
          int8_t* dst = p.xq + (long long)(r0 + 8 * i) * p.k + u * kPer;
          if constexpr (kPer == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
          else *reinterpret_cast<uint32_t*>(dst) = q[0];
        }
    }
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (live[i]) p.rs[r0 + 8 * i] = scale[i];
  }
  fence_proxy_global();
  consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(p.ready_x + rt, 1);
  }
}

// Byte offset of byte c of row r in the hq tile (rows of 512 bytes, the
// 16-byte units of a row permuted by r % 8: conflict-free pair stores).
__device__ __forceinline__ int hq_at(int r, int c) {
  return r * kPanel + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15);
}

// h of one element from its int32 products: (float(acc) * rs) * s1 (+ b1),
// the activation, and (gated) times (float(up) * rs) * su; the column's
// s1, su and b1 from the panel's staged vectors (zeros past the panel's
// real columns, where h is then exactly 0).
template <int ACT, bool GATED>
__device__ __forceinline__ float h_value(const Params& p, const float* vec, int local, float rs,
                                         int g, int u) {
  float gv = __fmul_rn(__fmul_rn(__int2float_rn(g), rs), vec[local]);
  if (p.b1 != nullptr) gv = __fadd_rn(gv, vec[2 * kPanel + local]);
  float v = activation<ACT>(gv);
  if (GATED) v = __fmul_rn(v, __fmul_rn(__fmul_rn(__int2float_rn(u), rs), vec[kPanel + local]));
  return v;
}

// The panel's s1, su and b1 into the staged vectors, zeros past its real
// columns; the caller syncs before reading them.
template <bool GATED>
__device__ __forceinline__ void stage_panel_vectors(const Params& p, const Smem& s, int f0,
                                                    int width) {
  for (int i = threadIdx.x; i < kPanel; i += kConsumers) {
    const bool in = i < width;
    s.vec[i] = in ? __ldg(p.s1 + f0 + i) : 0.0f;
    s.vec[kPanel + i] = GATED && in ? __ldg(p.su + f0 + i) : 0.0f;
    s.vec[2 * kPanel + i] = p.b1 != nullptr && in ? __ldg(p.b1 + f0 + i) : 0.0f;
  }
}

// The panel's hq (this tile's rows) and hs are in: make them visible to
// the async proxy, then signal.
__device__ __forceinline__ void signal_panel(const Params& p, int rt, int panel) {
  fence_proxy_global();
  consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(p.ready_h + rt * p.panels + panel, 1);
  }
}

// Up item (64-row tile rt, panel, K slice). Warpgroup wg computes columns
// 128 c + 64 wg .. + 63 of each chunk c of the panel for the 64 rows; its
// thread (warp w, lane 4 g + t) holds rows 16 w + g (+ 8) and columns
// 8 i + 2 t (+ 1), i < 8, of each quarter.
template <int ACT, bool GATED>
__device__ void up_item(const Params& p, const Smem& s, RingPos& ring, int rt, int panel,
                        int split) {
  constexpr int kStages = ring_stages(GATED);
  constexpr int kStageBytes = stage_bytes(GATED);
  auto full = [&](int i) { return s.bars + 8 * i; };
  auto empty = [&](int i) { return s.bars + 8 * (kStages + i); };
  const int wg = warpgroup();
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = rt * kUpRows;
  // chunk 0's h waits in the (idle) hq tile, the other three in registers
  float* stash = reinterpret_cast<float*>(s.hq);
  const int f0 = panel * p.block_f;
  const int width = panel_width(p, panel);
  const int chunks = panel_chunks(p, panel);
  const int k_lo = split * p.up_slice;
  const int k_hi = min(p.k_steps, k_lo + p.up_slice);
  const bool whole = p.up_splits == 1;
  consumer_sync();  // the previous item is done with the staged vectors
  if (whole) stage_panel_vectors<GATED>(p, s, f0, width);
  float rsr[2] = {1.0f, 1.0f};
  bool need_rs = whole;  // read once the first stage is in (after its flag)

  float h[4][32];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c > 0 && c >= chunks) {
#pragma unroll
      for (int i = 0; i < 32; ++i) h[c][i] = 0.0f;
      continue;
    }
    int ag[32], au[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) ag[i] = au[i] = 0;
    int last = 0;
    for (int ks = k_lo; ks < k_hi; ++ks) {
      mbar_wait(full(ring.stage), ring.phase);
      __syncwarp();  // converged again for the .aligned wgmma instructions
      if (need_rs) {  // (rows past M read the padding: their h is not stored)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) rsr[hh] = __ldcg(p.rs + row0 + 16 * warp + g + 8 * hh);
        need_rs = false;
      }
      const uint32_t a = s.ring + ring.stage * kStageBytes;
      const uint32_t b1 = a + kUpRows * kStep + wg * (64 * kStep);
      const uint32_t bu = b1 + kChunk * kStep;
      uint64_t da[4], d1[4], du[4];
#pragma unroll
      for (int kk = 0; kk < kStep / 32; ++kk) {
        da[kk] = desc_sw128(a, kk);
        d1[kk] = desc_sw128(b1, kk);
        du[kk] = desc_sw128(bu, kk);
      }
      fence_acc(ag);
      if (GATED) fence_acc(au);
      wgmma_fence();
      mma_stage_n64(ag, da, d1, ks > k_lo);
      if (GATED) mma_stage_n64(au, da, du, ks > k_lo);
      wgmma_commit();
      fence_acc(ag);
      if (GATED) fence_acc(au);
      wgmma_wait<1>();  // the previous stage's products are done: release it
      fence_acc(ag);
      if (GATED) fence_acc(au);
      if (ks > k_lo) mbar_arrive(empty(last));
      last = ring.stage;
      ring.advance(kStages);
    }
    wgmma_wait<0>();
    fence_acc(ag);
    if (GATED) fence_acc(au);
    if (k_hi > k_lo) mbar_arrive(empty(last));
    if (c == 0 && whole) consumer_sync();  // the staged vectors are in

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * i + 2 * hh + e;
          const int local = kChunk * c + 64 * wg + 8 * i + 2 * t + e;
          const int col = f0 + local;
          const int row = row0 + 16 * warp + g + 8 * hh;
          if (whole) {
            const float v = h_value<ACT, GATED>(p, s.vec, local, rsr[hh], ag[idx], au[idx]);
            if (c == 0) stash[idx * kConsumers + threadIdx.x] = v;
            else h[c][idx] = v;
          } else {  // the slice's exact partials
            const bool in = local < width && row < p.m;
            red_add_if(in, p.sums + (long long)row * p.f + col, ag[idx]);
            if (GATED) red_add_if(in, p.sums + ((long long)p.m + row) * p.f + col, au[idx]);
          }
        }
  }

  if (!whole) {
    // the last of the panel's slices to arrive quantizes h, a warp per row
    __threadfence();
    consumer_sync();
    if (threadIdx.x == 0)
      *s.flag = atomicAdd(p.up_count + rt * p.panels + panel, 1) == p.up_splits - 1;
    consumer_sync();
    if (!uniform(*s.flag)) return;
    __threadfence();
    stage_panel_vectors<GATED>(p, s, f0, width);
    consumer_sync();
    const long long ld = (long long)p.panels * p.pw;
    const bool in = 16 * lane < width;  // the lane's 16 columns (F % 16 == 0)
    for (int r = threadIdx.x / 32; r < min(kUpRows, p.m - row0); r += kConsumers / 32) {
      const int row = row0 + r;
      const float rs = __ldcg(p.rs + row);
      int4 gs[4], us[4];
      int4* gp = reinterpret_cast<int4*>(p.sums + (long long)row * p.f + f0 + 16 * lane);
      int4* up = reinterpret_cast<int4*>(p.sums + ((long long)p.m + row) * p.f + f0 + 16 * lane);
      if (in) {  // read the sums back, then leave them zero
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          gs[w] = __ldcg(gp + w);
          us[w] = GATED ? __ldcg(up + w) : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          gp[w] = make_int4(0, 0, 0, 0);
          if (GATED) up[w] = make_int4(0, 0, 0, 0);
        }
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) gs[w] = us[w] = make_int4(0, 0, 0, 0);
      }
      float v[16];
      float mx = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int gw[4] = {gs[w].x, gs[w].y, gs[w].z, gs[w].w};
        const int uw[4] = {us[w].x, us[w].y, us[w].z, us[w].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[4 * w + e] = h_value<ACT, GATED>(p, s.vec, 16 * lane + 4 * w + e, rs, gw[e], uw[e]);
          mx = fmaxf(mx, fabsf(v[4 * w + e]));
        }
      }
      const float hs = row_scale(warp_max(mx));
      const float inv = __frcp_rn(hs);
      if (16 * lane < p.pw) {
        uint32_t q[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          q[w] = low_bytes(quant_bits(v[4 * w], hs, inv), quant_bits(v[4 * w + 1], hs, inv),
                           quant_bits(v[4 * w + 2], hs, inv), quant_bits(v[4 * w + 3], hs, inv));
        *reinterpret_cast<uint4*>(p.hq + row * ld + panel * p.pw + 16 * lane) =
            make_uint4(q[0], q[1], q[2], q[3]);
      }
      if (lane == 0) p.hs[(long long)panel * p.mpad + row] = hs;
    }
    signal_panel(p, rt, panel);
    return;
  }

  // --- the panel's row absmax, met across the two warpgroups ---
#pragma unroll
  for (int i = 0; i < 32; ++i) h[0][i] = stash[i * kConsumers + threadIdx.x];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float m = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        m = fmaxf(m, fmaxf(fabsf(h[c][4 * i + 2 * hh]), fabsf(h[c][4 * i + 2 * hh + 1])));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    if (t == 0) s.red[wg * kUpRows + 16 * warp + g + 8 * hh] = m;
  }
  consumer_sync();  // every maximum is in, every stashed h read back
  float hs[2], hinv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    hs[hh] = row_scale(fmaxf(s.red[r], s.red[kUpRows + r]));
    hinv[hh] = __frcp_rn(hs[hh]);
    if (wg == 0 && t == 0 && row0 + r < p.m) p.hs[(long long)panel * p.mpad + row0 + r] = hs[hh];
  }
  // --- hq: pairs into the staged tile, then 16-byte stores ---
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + g + 8 * hh;
        const uint32_t q = low_bytes(quant_bits(h[c][4 * i + 2 * hh], hs[hh], hinv[hh]),
                                     quant_bits(h[c][4 * i + 2 * hh + 1], hs[hh], hinv[hh]), 0u,
                                     0u);
        *reinterpret_cast<uint16_t*>(s.hq + hq_at(r, kChunk * c + 64 * wg + 8 * i + 2 * t)) =
            static_cast<uint16_t>(q);
      }
  consumer_sync();
  const int units = p.pw / 16;
  const long long ld = (long long)p.panels * p.pw;
  for (int u = threadIdx.x; u < kUpRows * units; u += kConsumers) {
    const int r = u / units;
    const int c = u % units;
    if (row0 + r < p.m)
      *reinterpret_cast<uint4*>(p.hq + (row0 + r) * ld + panel * p.pw + 16 * c) =
          *reinterpret_cast<const uint4*>(s.hq + hq_at(r, 16 * c));
  }
  signal_panel(p, rt, panel);
}

// Down item (128-row tile dt, column tile ct, panel group). Warpgroup wg
// takes rows 64 wg .. + 63; its thread holds rows 16 w + g (+ 8) and
// columns 8 i + 2 t (+ 1), i < 16.
template <typename T, bool GATED>
__device__ void down_item(const Params& p, const Smem& s, RingPos& ring, int dt, int ct,
                          int split) {
  constexpr int kStages = ring_stages(GATED);
  constexpr int kStageBytes = stage_bytes(GATED);
  auto full = [&](int i) { return s.bars + 8 * i; };
  auto empty = [&](int i) { return s.bars + 8 * (kStages + i); };
  const int wg = warpgroup();
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = dt * kDownRows;
  const int col0 = ct * kDownCols;
  const bool whole = p.down_splits == 1;
  const int p_lo = split * p.down_slice;
  const int p_hi = min(p.panels, p_lo + p.down_slice);
  int rows[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) rows[hh] = row0 + 64 * wg + 16 * warp + g + 8 * hh;

  consumer_sync();  // the previous item is done with the staged vectors
  for (int i = threadIdx.x; i < kDownCols; i += kConsumers) {
    const bool in = col0 + i < p.d;
    s.vec[i] = in ? __ldg(p.s2 + col0 + i) : 0.0f;
    s.vec[kDownCols + i] = in && p.b2 != nullptr ? __ldg(p.b2 + col0 + i) : 0.0f;
  }
  consumer_sync();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int panel = p_lo; panel < p_hi; ++panel) {
    const int steps = panel_chunks(p, panel);
    int part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0;
    float hsr[2] = {0.0f, 0.0f};
    int last = 0;
    for (int kk = 0; kk < steps; ++kk) {
      mbar_wait(full(ring.stage), ring.phase);
      __syncwarp();  // converged again for the .aligned wgmma instructions
      if (kk == 0) {  // hs came with the flags the producer waited for
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)  // (rows past M: the padding)
          hsr[hh] = __ldcg(p.hs + (long long)panel * p.mpad + rows[hh]);
      }
      // (a warpgroup whose rows all lie past M multiplies TMA's zeros: no
      // branch around a product, see red_add_if)
      const uint32_t a = s.ring + ring.stage * kStageBytes + wg * (64 * kStep);
      const uint32_t b = s.ring + ring.stage * kStageBytes + kDownRows * kStep;
      uint64_t da[4], db[4];
#pragma unroll
      for (int k4 = 0; k4 < kStep / 32; ++k4) {
        da[k4] = desc_sw128(a, k4);
        db[k4] = desc_sw128(b, k4);
      }
      fence_acc(part);
      wgmma_fence();
      mma_stage_n128(part, da, db, kk > 0);
      wgmma_commit();
      fence_acc(part);
      wgmma_wait<1>();  // the previous stage's products are done: release it
      fence_acc(part);
      if (kk > 0) mbar_arrive(empty(last));
      last = ring.stage;
      ring.advance(kStages);
    }
    wgmma_wait<0>();
    fence_acc(part);
    if (steps > 0) mbar_arrive(empty(last));
    // acc += float(part) * hs, panel by panel; or the panel's term
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * i + 2 * hh + e;
          const float term = __fmul_rn(__int2float_rn(part[idx]), hsr[hh]);
          if (whole) {
            acc[idx] = __fadd_rn(acc[idx], term);
          } else {
            const int col = col0 + 8 * i + 2 * t + e;
            store_if(rows[hh] < p.m && col < p.d,
                     p.terms + ((long long)panel * p.m + rows[hh]) * p.d + col, term);
          }
        }
  }

  T* out = static_cast<T*>(p.out);
  auto store = [&](int row, int col, float a0, float a1) {
    // out = acc * s2 (+ b2), s2 and b2 from the staged vectors
    float v0 = __fmul_rn(a0, s.vec[col - col0]);
    float v1 = __fmul_rn(a1, s.vec[col - col0 + 1]);
    if (p.b2 != nullptr) {
      v0 = __fadd_rn(v0, s.vec[kDownCols + col - col0]);
      v1 = __fadd_rn(v1, s.vec[kDownCols + col - col0 + 1]);
    }
    vla_w8a8::store_pair(out + (long long)row * p.d + col, v0, v1);
  };
  if (whole) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = col0 + 8 * i + 2 * t;
        if (rows[hh] < p.m && col < p.d) store(rows[hh], col, acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
      }
    return;
  }
  // the last of the tile's groups to arrive sums every panel's term in order
  __threadfence();
  consumer_sync();
  if (threadIdx.x == 0)
    *s.flag = atomicAdd(p.down_count + dt * p.col_tiles + ct, 1) == p.down_splits - 1;
  consumer_sync();
  if (!uniform(*s.flag)) return;
  __threadfence();
  const int n_rows = min(kDownRows, p.m - row0);
  const int pairs = min(kDownCols, p.d - col0) / 2;
  for (int u = threadIdx.x; u < n_rows * pairs; u += kConsumers) {
    const int row = row0 + u / pairs;
    const int col = col0 + 2 * (u % pairs);
    const float2* term = reinterpret_cast<const float2*>(p.terms + (long long)row * p.d + col);
    const long long stride = (long long)p.m * p.d / 2;  // a panel's terms, in float2
    float a0 = 0.0f, a1 = 0.0f;
    int panel = 0;
    for (; panel + 8 <= p.panels; panel += 8) {  // eight loads in flight, summed in order
      float2 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __ldcg(term + (panel + j) * stride);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a0 = __fadd_rn(a0, v[j].x);
        a1 = __fadd_rn(a1, v[j].y);
      }
    }
    for (; panel < p.panels; ++panel) {
      const float2 v = __ldcg(term + panel * stride);
      a0 = __fadd_rn(a0, v.x);
      a1 = __fadd_rn(a1, v.y);
    }
    store(row, col, a0, a1);
  }
}

// Called by every consumer thread once the CTA has no more items: the last
// CTA to leave zeroes the ticket, the exit count and the other counters for
// the next launch.
__device__ __forceinline__ void leave(const Params& p, const Smem& s) {
  consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    *s.flag = atomicAdd(p.counters + 1, 1) == static_cast<int>(gridDim.x) - 1;
  }
  consumer_sync();
  if (!uniform(*s.flag)) return;
  for (int i = threadIdx.x; i < p.n_counters; i += kConsumers) p.counters[2 + i] = 0;
  consumer_sync();
  if (threadIdx.x == 0) {
    p.counters[0] = 0;
    p.counters[1] = 0;
    __threadfence();
  }
}

// A 2-d int8 map of `rows` rows of `cols` bytes (cols % 16 == 0, 16-byte
// aligned), boxes of 128 bytes x box_rows, the 128-byte swizzle, zeros out
// of bounds (past the last column and row).
inline cudaError_t make_map_s8(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                               int box_rows) {
  const vla_hopper::EncodeTiled encode = vla_hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kStep), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace vla_mlp_wg
