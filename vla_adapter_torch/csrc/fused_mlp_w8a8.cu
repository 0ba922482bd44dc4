// Fused w8a8 transformer MLP for Hopper (sm_90a): the whole MLP in one
// launch, the (M, F) intermediate kept as int8 in an L2-resident scratch.
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
// Design (w8a8_mlp.cuh, the walk shared with kernel B6). One launch of a
// persistent grid of 8-warp CTAs (ops/fused_mlp.py:mlp_plan: one per SM at
// every serving shape) takes work items from an atomic ticket:
//   quant (32-row tile)       quantizes the tile's rows of x into a
//                             scratch, a warp per four rows at once;
//   up (32-row tile, panel)   the panel's up product(s), hq and hs to the
//                             scratch;
//   down (64-row tile, 128 columns of D)
//                             waits for the tile's panels and sums them in
//                             order, then out = acc * s2 (+ b2).
// Where the up item's 32 rows of xq cannot stay resident beside the ring
// (K = 4096-5120, the 7B and 13B LLMs) it streams them through the ring
// (w8a8_mlp.cuh, "streamed"): the same items, products and bits.
// At B=1: Qwen2 (M = 640) 20 + 200 + 70 items on 132 CTAs, DINOv2 (M =
// 522) 17 + 136 + 72 on 225, so400m (M = 512) 16 + 144 + 72 on 232, the
// projector (M = 512) 16 + 272 + 56 on 132, where the first design ran
// ceil(M / 16) = 32-40 CTAs, each re-reading every weight from L2 for its
// 16 rows. The plain MLP's CTAs fit two to an SM below K ~ 1200. Every weight byte
// is now read once per 32 rows (W1, Wu) or 64 rows (W2), through a
// cp.async ring.
//
// Numerics. expf/tanhf are the CUDA math library's: they can differ from
// another implementation by an ulp, which can flip one int8 rounding of h,
// so this kernel is held to a stated tolerance against its plain version,
// not to bit-exactness (on the H100 it has matched bit for bit).
//
// Bound on this card: the Qwen2 MLP at B=1 (M = 640) moves ~13 MB of int8
// weights and does 16.7 GOP: ~8.5 us of int8 peak against ~4 us of HBM,
// operations bound. What holds the kernel above that: w8a8_mlp.cuh.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "w8a8_mlp.cuh"

namespace {

using namespace vla_w8a8;

struct Params {
  Mlp mlp;
  const void* x;  // (M, K) T
  void* out;      // (M, D) T
  int8_t* xq;     // the scratch behind mlp.xq
  float* rs;      // the scratch behind mlp.rs
  int* counters;  // ticket, exits, then ready_h and ready_x per row tile
  int row_tiles, down_tiles, col_tiles;
};

// Quantization item (32-row tile rt): the tile's rows of x into the
// scratch, a warp per four rows (warp, warp + 8, ...) at once.
template <typename T>
__device__ void quant_item(const Params& p, int rt) {
  const Mlp& mlp = p.mlp;
  const T* x = static_cast<const T*>(p.x);
  const int r0 = rt * kBM + threadIdx.x / 32;
  int live = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) live |= (r0 + kWarps * i < mlp.m) << i;
  float scale[4];
  quantize_rows4(
      live, mlp.k, mlp.kpad,
      [&](int i, int c, float (&f)[4]) {
        load4(x + (long long)(r0 + kWarps * i) * mlp.k + c, f);
      },
      [&](int i, int c, uint32_t packed) {
        if (live & (1 << i))
          *reinterpret_cast<uint32_t*>(p.xq + (long long)(r0 + kWarps * i) * mlp.kpad + c) =
              packed;
      },
      scale);
  if (threadIdx.x % 32 == 0)
    for (int i = 0; i < 4; ++i)
      if (live & (1 << i)) p.rs[r0 + kWarps * i] = scale[i];
  signal(mlp.ready_x + rt);
}

template <typename T, int ACT, bool GATED, bool STREAM>
__global__ void __launch_bounds__(kThreads, GATED ? 1 : 2) fused_mlp_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Mlp& mlp = p.mlp;
  const MlpSmem s = carve_mlp(smem, mlp.kpad, mlp.panels, GATED, STREAM);
  int* ticket_s = reinterpret_cast<int*>(s.rs + kBM);
  const int quants = p.row_tiles;
  const int ups = quants + p.row_tiles * mlp.panels;
  const int items = ups + p.down_tiles * p.col_tiles;

  for (int it = next_ticket(p.counters, ticket_s); it < items;
       it = next_ticket(p.counters, ticket_s)) {
    if (it < quants) {
      quant_item<T>(p, it);
    } else if (it < ups) {
      up_item<ACT, GATED, STREAM>(mlp, s, (it - quants) / mlp.panels, (it - quants) % mlp.panels);
    } else {
      const int d = it - ups;
      T* out = static_cast<T*>(p.out);
      down_item<GATED>(mlp, s, d / p.col_tiles, d % p.col_tiles,
                [&](int row, int col, float a0, float a1) {
                  // out = acc * s2 (+ b2)
                  float v0 = __fmul_rn(a0, mlp.s2[col]);
                  float v1 = __fmul_rn(a1, mlp.s2[col + 1]);
                  if (mlp.b2 != nullptr) {
                    v0 = __fadd_rn(v0, mlp.b2[col]);
                    v1 = __fadd_rn(v1, mlp.b2[col + 1]);
                  }
                  store_pair(out + (long long)row * mlp.d + col, v0, v1);
                });
    }
  }
  leave(p.counters, 2 * p.row_tiles);
}

template <typename T, int ACT, bool GATED, bool STREAM>
cudaError_t launch(const Params& p, int ctas, cudaStream_t stream) {
  auto kernel = fused_mlp_kernel<T, ACT, GATED, STREAM>;
  const size_t smem = mlp_smem_bytes(p.mlp.kpad, p.mlp.panels, GATED, STREAM) + 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // Once per instantiation, at its first (uncaptured) launch, to the most
  // a block may use: every smaller size is then admitted, and later
  // launches, inside a CUDA graph capture too, make no attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<ctas, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool GATED, bool STREAM>
cudaError_t dispatch_act(const Params& p, int act, int ctas, cudaStream_t s) {
  switch (act) {
    case kSilu: return launch<T, kSilu, GATED, STREAM>(p, ctas, s);
    case kGelu: return launch<T, kGelu, GATED, STREAM>(p, ctas, s);
    case kGeluTanh: return launch<T, kGeluTanh, GATED, STREAM>(p, ctas, s);
    case kQuickGelu: return launch<T, kQuickGelu, GATED, STREAM>(p, ctas, s);
    default: return cudaErrorInvalidValue;
  }
}

// The resident form wherever it fits (every flagship shape), else, for the
// gated MLP, the streamed one (ops/fused_mlp.py:mlp_plan's "branch"); no
// plain MLP of a registered model needs it (the widest, Phi-2's, fits), so
// it is not built for them and the wrapper refuses such a shape.
template <typename T, bool GATED>
cudaError_t dispatch_branch(const Params& p, int act, int ctas, cudaStream_t s) {
  if constexpr (GATED) {
    if (mlp_streams_x(p.mlp.kpad, p.mlp.panels, true))
      return dispatch_act<T, true, true>(p, act, ctas, s);
  }
  return dispatch_act<T, GATED, false>(p, act, ctas, s);
}

template <typename T>
cudaError_t dispatch(const Params& p, int act, int ctas, cudaStream_t s) {
  return p.mlp.wu != nullptr ? dispatch_branch<T, true>(p, act, ctas, s)
                             : dispatch_branch<T, false>(p, act, ctas, s);
}

}  // namespace

// x (M, K) and out (M, D) in one type: bf16 (dtype 0) or f32 (1). w1/wu
// (F, K), w2 (D, F) int8; s1/su (F), s2 (D), b1 (F), b2 (D) f32; wu/su null
// for the plain MLP, b1/b2 null when absent. act: 0 silu, 1 gelu (A&S erf),
// 2 gelu_tanh, 3 quick_gelu. Scratch, with P = ceil(F / block_f): xq (M,
// round128(K)) int8, rs (M) f32, hq (M, P * round128(block_f)) int8, hs
// (M, P) f32; counters (2 + 2 ceil(M / 32) int32, zero, left zero). ctas: the persistent grid. K % 16
// == 0, F % 16 == 0, D even, block_f a multiple of 64 up to 512,
// pointers 16-byte aligned. Returns a cudaError_t.
extern "C" int vla_fused_mlp_w8a8(
    const void* x, const void* w1, const void* s1, const void* wu,
    const void* su, const void* b1, const void* w2, const void* s2,
    const void* b2, void* out, void* xq, void* rs, void* hq, void* hs,
    void* counters, int m,
    int k, int f, int d, int block_f, int act, int dtype, int ctas,
    void* stream) {
  if (m <= 0 || k <= 0 || f <= 0 || d <= 0 || k % 16 || f % 16 || d % 2 ||
      block_f <= 0 || block_f % 64 || block_f > kMaxPanel || ctas <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  Mlp& mlp = p.mlp;
  mlp.w1 = static_cast<const int8_t*>(w1);
  mlp.s1 = static_cast<const float*>(s1);
  mlp.wu = static_cast<const int8_t*>(wu);
  mlp.su = static_cast<const float*>(su);
  mlp.b1 = static_cast<const float*>(b1);
  mlp.w2 = static_cast<const int8_t*>(w2);
  mlp.s2 = static_cast<const float*>(s2);
  mlp.b2 = static_cast<const float*>(b2);
  mlp.hq = static_cast<int8_t*>(hq);
  mlp.hs = static_cast<float*>(hs);
  mlp.m = m;
  mlp.k = k;
  mlp.f = f;
  mlp.d = d;
  mlp.block_f = block_f;
  mlp.kpad = round_up(k, kStep);
  mlp.panels = (f + block_f - 1) / block_f;
  mlp.pw = round_up(block_f, kStep);
  p.x = x;
  p.out = out;
  p.xq = static_cast<int8_t*>(xq);
  p.rs = static_cast<float*>(rs);
  mlp.xq = p.xq;
  mlp.rs = p.rs;
  p.counters = static_cast<int*>(counters);
  p.row_tiles = (m + kBM - 1) / kBM;
  p.down_tiles = (m + kBMd - 1) / kBMd;
  p.col_tiles = (d + kTileN - 1) / kTileN;
  mlp.ready_h = p.counters + 2;
  mlp.ready_x = mlp.ready_h + p.row_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<__nv_bfloat16>(p, act, ctas, s);
    case 1: return dispatch<float>(p, act, ctas, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
