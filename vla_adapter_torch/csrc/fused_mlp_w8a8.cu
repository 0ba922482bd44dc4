// Fused w8a8 transformer MLP for Hopper (sm_90a): the whole MLP in one
// launch, on TMA and int8 wgmma, the (M, F) intermediate kept as int8 in an
// L2-resident scratch.
//
// Replaces vla_adapter_tpu/ops/pallas_fused_mlp.py:w8a8_gated_mlp_stacked
// (kernel B2) and :w8a8_mlp_stacked (kernel B3), which share the body
// _mlp_kernel_body. Same arithmetic:
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
// block_f = 512 is part of the numerics (h is re-quantized per panel), not
// a tile size. The TPU kernel walks the panels as a sequential grid axis
// with the accumulator in VMEM scratch.
//
// Design (w8a8_mlp_wgmma.cuh): one launch of a persistent grid, one CTA of
// a producer warpgroup (TMA into an mbarrier ring) and two consumer
// warpgroups (int8 wgmma) per SM, taking work items from an atomic ticket:
// quant (64-row tile), up (64-row tile, panel, K slice), down (128-row
// tile, 128 columns of D, panel group). ops/fused_mlp.py:mlp_plan picks
// the slices, the groups and the grid per shape: above 32 rows one slice
// and one group; at 32 rows and below (a decode step) the up items split
// K and the down items split the panels, so that every SM streams its
// share of the weights. Every K (B2 at 7B and 13B, K = 4096-5120; B3 at
// every tower and projector) takes the same path: both operands stream
// through the ring.
//
// How h is met (the per-panel quantization needs each row's absmax over
// 512 columns before any hq is written): (a) the two consumer warpgroups
// split the panel's columns, each thread keeps its 128 values of h (chunk
// 0's in the idle hq tile, three chunks in registers), and the two meet the
// row absmax through shared memory. The other way, (b) float h and each
// chunk's row maxima to an L2 scratch and the quantization in items of its
// own, was not built, so (a) was taken without the measurement that would
// compare them: (b) writes and reads back 4 bytes of h per element (12.5
// MB at Qwen2, B=1), where (a) reads each weight from L2 once per 64 rows
// instead of once per 128.
//
// Bound on this card: Qwen2's MLP at B=1 (M = 640) does 16.7 GOP on ~13 MB
// of int8 weights: ~8.5 us of int8 peak against ~4 us of HBM, operations
// bound; a decode step (M = 1-4) only streams the weights: 13 MB, ~3.9 us
// at 0.5B, 135 MB, ~40 us at 7B, bytes bound. What holds the kernel above
// that, from %globaltimer stamps per item (probe runs M2-M7, PERF.md, on
// an H100 80GB HBM3 at 700 W): a ring stage takes 1.1-1.8 us whether 35 or
// 100 SMs are streaming, ~23-29 GB/s an SM (B4's Hopper tiles stream at
// about the same rate), so an up item of Qwen2 at B=1 (28 stages, 1.15 MB)
// takes ~50 us and the 100 of them one wave; the 35 down items then run on
// 35 SMs after the last panel is in (~45 us), and the quantization of x
// comes first (6-15 us an item). Variants timed (mlp_compare.py
// --variants, M2-M7): no split of K or panels at a decode row 1.8x slower;
// the down items split into panel groups at B=1 1.3-1.8x slower (their
// float terms go through L2); fences removed (unsafe) no faster (M4); each
// ring stage released as soon as its products are done, 0-7% slower than
// one stage later (M13, source variants in turns). The build spills: 56-116
// bytes a thread in the plain MLP's instances, 332-380 in the gated ones
// (ptxas -v, M13).
//
// Numerics. expf/tanhf are the CUDA math library's: they can differ from
// another implementation by an ulp, which can flip one int8 rounding of h,
// so this kernel is held to a stated tolerance against its plain version,
// not to bit-exactness (on the H100 it has matched bit for bit).
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() after the launch, or the
// error of a refused map encode.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w8a8_mlp_wgmma.cuh"

namespace {

using namespace vla_mlp_wg;
using vla_hopper::smem_u32;

template <typename T, int ACT, bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
                 const __grid_constant__ CUtensorMap twu, const __grid_constant__ CUtensorMap thq,
                 const __grid_constant__ CUtensorMap tw2, const Params p) {
  constexpr int kStages = ring_stages(GATED);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const int ring_bytes = kStages * stage_bytes(GATED);
  Smem s;
  s.ring = base;
  s.hq = base_ptr + ring_bytes;
  s.vec = reinterpret_cast<float*>(s.hq + kHqTile);
  s.red = s.vec + kVec;
  const int bars = ring_bytes + kHqTile + 4 * kVec + 2 * kUpRows * 4;
  s.bars = base + bars;
  s.item = reinterpret_cast<int*>(base_ptr + bars + 8 * (2 * kStages + 4));
  s.flag = s.item + 2;
  auto item_full = [&](int i) { return s.bars + 8 * (2 * kStages + i); };
  auto item_empty = [&](int i) { return s.bars + 8 * (2 * kStages + 2 + i); };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      vla_hopper::mbar_init(s.bars + 8 * i, 1);                    // full: the producer's
      vla_hopper::mbar_init(s.bars + 8 * (kStages + i), kConsumers);  // empty: every consumer
    }
    for (int i = 0; i < 2; ++i) {
      vla_hopper::mbar_init(item_full(i), 1);
      vla_hopper::mbar_init(item_empty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    vla_hopper::set_max_regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) producer<GATED>(p, s, &tx, &tw1, &twu, &thq, &tw2);
    return;
  }
  vla_hopper::set_max_regs_inc<kConsumerRegs>();
  RingPos ring, items;
  for (;;) {
    mbar_wait(item_full(items.stage), items.phase);
    const int it = __shfl_sync(0xffffffffu, s.item[items.stage], 0);  // uniform: see warpgroup()
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(item_empty(items.stage));
    items.advance(2);
    if (it >= p.n_items) break;
    if (it < p.n_quant) {
      quant_item<T>(p, s, it);
    } else if (it < p.n_quant + p.n_up) {
      const UpItem u = up_at(p, it);
      up_item<ACT, GATED>(p, s, ring, u.rt, u.panel, u.split);
    } else {
      const DownItem dn = down_at(p, it);
      down_item<T, GATED>(p, s, ring, dn.dt, dn.ct, dn.split);
    }
  }
  leave(p, s);
}

struct Operands {
  const void *w1, *wu, *w2;
};

template <typename T, int ACT, bool GATED>
cudaError_t launch(const Params& p, const Operands& o, int ctas, cudaStream_t stream) {
  auto kernel = fused_mlp_kernel<T, ACT, GATED>;
  CUtensorMap tx, tw1, twu, thq, tw2;
  cudaError_t err;
  if ((err = make_map_s8(&tx, p.xq, p.m, p.k, kUpRows)) != cudaSuccess ||
      (err = make_map_s8(&tw1, o.w1, p.f, p.k, kChunk)) != cudaSuccess ||
      (err = make_map_s8(&twu, GATED ? o.wu : o.w1, p.f, p.k, kChunk)) != cudaSuccess ||
      (err = make_map_s8(&thq, p.hq, p.m, static_cast<long long>(p.panels) * p.pw, kDownRows)) !=
          cudaSuccess ||
      (err = make_map_s8(&tw2, o.w2, p.d, p.f, kDownCols)) != cudaSuccess)
    return err;
  constexpr int smem = smem_bytes(GATED);
  static_assert(smem <= kMaxSmem, "the ring does not fit a block");
  // Once per instantiation, at its first (uncaptured) launch: later
  // launches, inside a CUDA graph capture too, make no attribute call.
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<ctas, kThreads, smem, stream>>>(tx, tw1, twu, thq, tw2, p);
  return cudaGetLastError();
}

template <typename T, bool GATED>
cudaError_t dispatch_act(const Params& p, const Operands& o, int act, int ctas, cudaStream_t s) {
  switch (act) {
    case vla_w8a8::kSilu: return launch<T, vla_w8a8::kSilu, GATED>(p, o, ctas, s);
    case vla_w8a8::kGelu: return launch<T, vla_w8a8::kGelu, GATED>(p, o, ctas, s);
    case vla_w8a8::kGeluTanh: return launch<T, vla_w8a8::kGeluTanh, GATED>(p, o, ctas, s);
    case vla_w8a8::kQuickGelu: return launch<T, vla_w8a8::kQuickGelu, GATED>(p, o, ctas, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, const Operands& o, int act, int ctas, cudaStream_t s) {
  return o.wu != nullptr ? dispatch_act<T, true>(p, o, act, ctas, s)
                         : dispatch_act<T, false>(p, o, act, ctas, s);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// x (M, K) and out (M, D) in one type: bf16 (dtype 0) or f32 (1). w1/wu
// (F, K), w2 (D, F) int8; s1/su (F), s2 (D), b1 (F), b2 (D) f32; wu/su null
// for the plain MLP, b1/b2 null when absent. act: 0 silu, 1 gelu (A&S erf),
// 2 gelu_tanh, 3 quick_gelu. Scratch, with P = ceil(F / block_f), pw =
// round128(block_f), mpad = round128(M): xq (M, K) int8, rs (mpad) f32, hq
// (M, P * pw) int8, hs (P, mpad) f32; sums (2, M, F) int32, zero and left
// zero, when up_slice < ceil(K / 128) (else unread, may be null); terms (P,
// M, D) f32 when down_slice < P (else may be null); counters (2 + ceil(M /
// 64) (1 + 2 P) + ceil(M / 128) ceil(D / 128) int32, zero, left zero).
// ctas: the persistent grid; up_slice: 128-byte K steps of an up item;
// down_slice: panels of a down item (ops/fused_mlp.py:mlp_plan). K % 16 ==
// 0, F % 16 == 0, D even, block_f a multiple of 64 up to 512, pointers
// 16-byte aligned. Returns a cudaError_t.
extern "C" int vla_fused_mlp_w8a8(
    const void* x, const void* w1, const void* s1, const void* wu,
    const void* su, const void* b1, const void* w2, const void* s2,
    const void* b2, void* out, void* xq, void* rs, void* hq, void* hs,
    void* sums, void* terms, void* counters, int m, int k, int f, int d,
    int block_f, int act, int dtype, int ctas, int up_slice, int down_slice,
    void* stream) {
  if (m <= 0 || k <= 0 || f <= 0 || d <= 0 || k % 16 || f % 16 || d % 2 ||
      block_f <= 0 || block_f % 64 || block_f > kPanel || ctas <= 0 || up_slice <= 0 ||
      down_slice <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.out = out;
  p.s1 = static_cast<const float*>(s1);
  p.su = static_cast<const float*>(su);
  p.b1 = static_cast<const float*>(b1);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.xq = static_cast<int8_t*>(xq);
  p.rs = static_cast<float*>(rs);
  p.hq = static_cast<int8_t*>(hq);
  p.hs = static_cast<float*>(hs);
  p.sums = static_cast<int*>(sums);
  p.terms = static_cast<float*>(terms);
  p.counters = static_cast<int*>(counters);
  p.m = m;
  p.k = k;
  p.f = f;
  p.d = d;
  p.block_f = block_f;
  p.pw = ceil_div(block_f, kStep) * kStep;
  p.panels = ceil_div(f, block_f);
  p.mpad = ceil_div(m, kDownRows) * kDownRows;
  p.k_steps = ceil_div(k, kStep);
  p.row_tiles = ceil_div(m, kUpRows);
  p.down_tiles = ceil_div(m, kDownRows);
  p.col_tiles = ceil_div(d, kDownCols);
  p.up_slice = up_slice;
  p.up_splits = ceil_div(p.k_steps, up_slice);
  p.down_slice = down_slice;
  p.down_splits = ceil_div(p.panels, down_slice);
  if ((p.up_splits > 1 && sums == nullptr) || (p.down_splits > 1 && terms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_quant = p.row_tiles;
  p.n_up = p.panels * p.row_tiles * p.up_splits;
  p.n_items = p.n_quant + p.n_up + p.down_tiles * p.col_tiles * p.down_splits;
  p.ready_x = p.counters + 2;
  p.ready_h = p.ready_x + p.row_tiles;
  p.up_count = p.ready_h + p.row_tiles * p.panels;
  p.down_count = p.up_count + p.row_tiles * p.panels;
  p.n_counters = p.row_tiles * (1 + 2 * p.panels) + p.down_tiles * p.col_tiles;
  const Operands o{w1, wu, w2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch<__nv_bfloat16>(p, o, act, ctas, s));
    case 1: return static_cast<int>(dispatch<float>(p, o, act, ctas, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
