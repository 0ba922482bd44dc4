// W8A8 matmul for Hopper (sm_90a): the per-row int8 quantization of x, the
// int8 x int8 -> int32 product on the tensor cores and the rank-1
// dequantization.
//
// Replaces vla_adapter_tpu/ops/pallas_matmul.py:w8a8_matmul (kernel B4,
// _w8a8_kernel) and :w8a8_matmul_stacked (kernel B5), together with the
// quantization the JAX Dense computes before them in the same XLA
// computation (vla_adapter_tpu/models/layers.py:_w8a8_fwd_math):
//
//   rs  = max(absmax_k |x|, 1e-8) / 127      per row of x (float)
//   xq  = clip(round_half_even(x / rs), -127, 127)
//   acc = xq @ W^T                           int32, exact
//   y   = out(float(acc) * rs * ws)           two float32 products in that
//                                             order, one rounding
//
// With x_dtype int8 the kernel takes xq and rs as given (the JAX B4/B5
// signature). W (N, K) int8 is in the PyTorch (out, in) layout, ws (N) f32.
// Layer z of a launch: x/out layer z (x stride 0: one x for every layer)
// against weight layer layer0 + z: a flat weight (B4), one layer of an
// (L, N, K) stack (B5) and the action head's BatchedDense.
//
// Quantization, bit for bit. The scale is w8a8_mlp.cuh's row_scale (the
// B2/B3 helper) of the row's absmax over the whole K; each value is the
// correctly rounded quotient x / rs, computed without a division
// (quant_bits), rounded half to even. The int32 sum is exact in any order
// over k.
//
// Split K (the "tensor" mesh axis): with xq given, the kernel can write the
// int32 accumulator itself (out_dtype 2, no dequant). A rank's partial over
// its slice of K is then exact, the ranks' partials add exactly in int32,
// and the dequant runs once after that sum, so a row-split projection (or
// a column split's straight-through dx) equals the unsplit one bit for bit.
// A shard's K need not be a multiple of 16 (so400m's MLP at tensor 2: 2152;
// at 4: 1076): the caller zero-pads the weight shard once to 16 * ceil(K /
// 16) and writes xq into a zeroed tail as it quantizes, so the kernel keeps
// its 16-byte rows and int8 zeros add nothing.
//
// Two branches; ops/w8a8_matmul.py:w8a8_plan picks one per shape (cached)
// and passes it in as `plan`:
// * "hopper" (M > 32: the serving shapes from B=1 up, every "dense" and
//   server matmul, the finetune's forward and dx, the split K's int32
//   partials, the 7B zoo; and a narrow split that cannot be resident):
//   128 x 128 output tiles of int8 wgmma. One producer thread issues TMA
//   copies of xq (128 rows) and W (128 rows), 128 bytes of K each with the
//   128-byte swizzle, into a ring of 7 stages (230 KB) paced by mbarriers
//   (`full` counts the bytes, `empty` the 8 consumer warps done with a
//   stage); K past its end arrives as zeros (K = 1088, 2160 padded from
//   2152), and so do rows past M or N. Two consumer warpgroups, 64 rows
//   each, run wgmma m64n128k32 s32.s8.s8 on the same W tile with both
//   operands by descriptor, one product group in flight while the next
//   stage lands. The grid is persistent (at most one CTA per SM, tiles
//   blockIdx.x, + gridDim.x, ...), so the producer fills the next tile's
//   stages under the consumers' epilogue; tiles go in bands of 8 row tiles,
//   row tile fastest, so the CTAs in flight share W and xq in L2. The
//   epilogue dequantizes in fp32 in the order above and writes bf16, f32
//   or the raw int32; bf16 pairs go round each quad first so that every
//   store fills a 32-byte sector (4-byte stores fill half of one: with
//   them Qwen2 q/o at B=16, (10240, 896^2), took 65.1 us, with the quad
//   exchange 50.4).
//   Only TMA writes the tiles that wgmma reads: an earlier wgmma version
//   of this kernel stored hand-swizzled xq tiles and was right with one CTA
//   on an SM and wrong with two (B1-bwd met the same trap,
//   attention_bwd.cu). So float
//   x is quantized by a pre-pass kernel (w8a8_quantize_kernel, a warp per
//   row: the absmax, then quant_bits) into an xq/rs scratch that the
//   product then copies by TMA: a second launch per call, counted as
//   w8a8_quantize (option (a) at every shape). The other way, A from
//   registers quantized per k-step against row scales from a first absmax
//   pass, was not built: it quantizes each element of x once per column
//   tile (38 times at Qwen2's gate/up, N = 4864) in the warps that issue
//   the products, where the pre-pass quantizes each element once and
//   writes 1 byte for it that the product reads back. What it costs
//   (chip_smoke.py on an H100 80GB HBM3 at 700 W): at B=1, Qwen2
//   q/o (640, 896^2) takes 11.2 us with it and 8.8 on xq given; at the
//   finetune's shapes it takes 7.1-9.0 us on bf16 x of K 896-1152 (the
//   calls 39-188 us), 59.5-121.6 at K 4096-8704, and 108-226 on the f32
//   dy * ws of the dx calls at K 4096-8704: twice the bound of its bytes,
//   as it reads each row twice (its absmax, then its quantization).
//   Column tile 128, not 256: the bf16-output instance with 256 columns
//   needed 168 registers and spilled 208 bytes; it took 245.2 us at
//   Qwen2's gate/up at B=16 (10240, 896 -> 4864) against 185.4 with 128.
// * "narrow" (M <= 32: proprio, the action head at M = 8 per request and
//   B * 8 in a batch, decode rows): the weight fills the 16-row side of
//   mma.sync.m16n8k32 and the tokens its 8-wide side (1, 2 or 4 n8 tiles),
//   so little of a tile is padding. A CTA of 4 warps owns 64 weight rows
//   and a slice of K (up to 1024 bytes at M <= 8, 512 above); its weight
//   fragments go straight from device memory to registers, issued first,
//   and its slice of x beside them. Each CTA takes the absmax of its rows
//   over its own slice from those registers (one other slice it reads
//   itself). A K longer than two slices is split over CTAs (fc_in, K =
//   6272: 13 x 14 = 182 CTAs instead of 14) whose slice maxima meet in a
//   persistent scratch: each CTA publishes its own and waits for the
//   others once (all of them must be resident together: the plan routes a
//   split that could not be to the Hopper branch, and the launch checks),
//   so every row's scale comes from one read of x per launch. The CTAs add
//   their int32 partials with atomics, and the last CTA of an N tile (an
//   atomic counter) reads them back, zeroing them, and runs the dequant
//   epilogue; the last CTA to leave zeroes the maxima and the counters for
//   the next call. One launch per call, no memset.
//
// The mma.sync design that served M > 32 before (64 x 64 tiles, W through
// a cp.async ring, xq resident and quantized once per cluster) is gone:
// the Hopper branch was faster at every shape timed on an H100 80GB HBM3
// at 700 W (b4_compare.py, device us under graph replay, Hopper against
// mma.sync): Qwen2 q/o at B=1 (640, 896^2) 10.8 against 13.6; the head at
// B=8 (64, 896^2) 9.2 / 12.0; the adapter stack (24 x 65, 896^2) 17.4 /
// 45.7; Phi-2's lm_head, a narrow split that cannot be resident (1, 2560
// -> 51200), 72.2 / 116.8; Qwen2's gate/up at B=16 185.4 / 677.6.
//
// Bound on this card: at the finetune and server shapes (M ~ 10^4, N, K ~
// 10^3) the int8 operations (~90 GOP at 1979 TOP/s) and the bytes (x,
// W, out: ~150 MB at 3.35 TB/s) both take ~45 us; at B=1 (M ~ 600) the
// bytes (~1-6 MB) bound it at ~1 us and what a call waits on is latency:
// two launches, the ring's first stages, one wave of tiles.
//
// Interface: plain C functions (bound with ctypes), launched on the
// caller's stream; each returns cudaGetLastError() after its launches or
// the error of a refused map encode or plan. Nothing falls back to
// another branch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>
#include <type_traits>

#include "hopper.cuh"
#include "w8a8_mlp.cuh"

namespace {

using vla_w8a8::kMaxSmem;
using vla_w8a8::low_bytes;
using vla_w8a8::mma_s8;
using vla_w8a8::quant_bits;
using vla_w8a8::row_scale;
using namespace vla_hopper;

struct Params {
  const void* x;   // (layers, M, K) XT [layer stride x_ls, 0 = shared]
  const float* rs; // (layers, M) f32 row scales when XT is int8, else null
  const int8_t* w;
  const float* ws;
  void* out;
  int* part;       // narrow split-K: (layers, M, N) int32 partials, zeroed
  int* count;      // narrow split-K: (layers, N tiles) arrival counters
  int* sync;       // narrow split-K: (layers, kSyncInts) slice maxima and
                   // the two counters of the scale exchange, zeroed
  int m, n, k, layer0;
  int splits, slice;  // narrow: CTAs along K and bytes of K each
  long long x_ls, rs_ls, w_ls, ws_ls, o_ls;  // per-layer strides (elements)
};

// ---------------------------------------------------------------- helpers

// NG groups of four floats, group i with its row's scale and 1 / scale,
// quantized to four int8 packed in q[i] (the first value in the low byte).
template <int NG>
__device__ __forceinline__ void quant4(const float (&f)[NG][4], const float (&scale)[NG],
                                       const float (&inv)[NG], uint32_t (&q)[NG]) {
#pragma unroll
  for (int i = 0; i < NG; ++i)
    q[i] = low_bytes(quant_bits(f[i][0], scale[i], inv[i]), quant_bits(f[i][1], scale[i], inv[i]),
                     quant_bits(f[i][2], scale[i], inv[i]), quant_bits(f[i][3], scale[i], inv[i]));
}

__device__ __forceinline__ void to_floats(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void to_floats(const uint4& v, float (&f)[4]) {
  const float* src = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = src[i];
}

// The absmax of the 16 bytes `v` (8 bf16 or 4 f32).
template <typename XT>
__device__ __forceinline__ float absmax16(const uint4& v) {
  float f[16 / sizeof(XT)];
  to_floats(v, f);
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(XT)); ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ float dequant(int acc, float r, float w) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), r), w);
}
// One output: the dequantized acc, or (OutT int32) the accumulator itself.
template <typename OutT>
__device__ __forceinline__ void store_result(OutT* o, int acc, float r, const float* w) {
  if constexpr (std::is_same<OutT, int>::value) *o = acc;
  else store_out(o, dequant(acc, r, *w));
}

// ---------------------------------------------------------------- narrow
constexpr int kNarrowRows = 64;  // weight rows per narrow CTA (4 warps)
// The scale exchange of a split launch, per layer: the slice maxima of up
// to 32 rows (float bits), then the arrival and departure counters.
constexpr int kSyncInts = 64;
constexpr int kArrive = 32;
constexpr int kDepart = 33;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// TILES n8 tiles of tokens (M <= 8 TILES), STEPS 64-byte k steps per slice.
// The CTA's slice of x is loaded into registers beside its weight
// fragments, so both are one round trip: warp w holds rows w, w + 4, ...,
// lane l the 16-byte units l, l + 32, ... of each.
template <typename XT, typename OutT, int TILES, int STEPS>
__global__ void __launch_bounds__(128) w8a8_narrow_kernel(const Params p) {
  constexpr bool kQuant = !std::is_same<XT, int8_t>::value;
  constexpr int kPer = 16 / sizeof(XT);   // x elements per 16 bytes
  constexpr int kRows = 8 * TILES;
  constexpr int kRpw = kRows / 4;                           // rows per warp
  constexpr int kCpl = (64 * STEPS / kPer + 31) / 32;       // units per lane and row
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs = p.slice + 16;  // xq row stride: conflict-free 16-byte reads
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem);
  float* scale_s = reinterpret_cast<float*>(smem + kRows * xs);
  int* amax_s = reinterpret_cast<int*>(scale_s + kRows);
  int& last_s = amax_s[kRows];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int z = blockIdx.z;
  const XT* x = static_cast<const XT*>(p.x) + z * p.x_ls;
  const int8_t* w = p.w + (p.layer0 + z) * p.w_ls;
  const float* ws = p.ws + (p.layer0 + z) * p.ws_ls;
  OutT* out = static_cast<OutT*>(p.out) + z * p.o_ls;
  const int n_lo = blockIdx.x * kNarrowRows + warp * 16 + g;  // and n_lo + 8
  const int k0 = blockIdx.y * p.slice;
  const int k1 = min(p.k, k0 + p.slice);
  const int cpr = p.slice / kPer;  // x units per row of a slice

  // This warp's weight fragments for the slice: rows n_lo / n_lo + 8,
  // bytes [16t, 16t + 16) of each 64-byte step.
  uint4 wf[STEPS][2];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int kk = k0 + 64 * s + 16 * t;
    const bool kin = kk < k1;  // K % 16 == 0: whole chunks
    wf[s][0] = kin && n_lo < p.n
                   ? __ldg(reinterpret_cast<const uint4*>(w + (long long)n_lo * p.k + kk))
                   : make_uint4(0, 0, 0, 0);
    wf[s][1] = kin && n_lo + 8 < p.n
                   ? __ldg(reinterpret_cast<const uint4*>(w + (long long)(n_lo + 8) * p.k + kk))
                   : make_uint4(0, 0, 0, 0);
  }

  // --- the slice [kb, ke) of x (zeros past M and the slice) ---
  auto load_slice = [&](int kb, int ke, uint4 (&v)[kRpw][kCpl]) {
#pragma unroll
    for (int u = 0; u < kRpw; ++u)
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        const int r = warp + 4 * u;
        const int kk = kb + (lane + 32 * c) * kPer;
        v[u][c] = r < p.m && lane + 32 * c < cpr && kk < ke
                      ? __ldg(reinterpret_cast<const uint4*>(x + (long long)r * p.k + kk))
                      : make_uint4(0, 0, 0, 0);
      }
  };
  uint4 xr[kRpw][kCpl];
  load_slice(k0, k1, xr);

  // --- the row scales ---
  if constexpr (kQuant) {
    float m[kRpw];
#pragma unroll
    for (int u = 0; u < kRpw; ++u) {
      m[u] = 0.0f;
#pragma unroll
      for (int c = 0; c < kCpl; ++c) m[u] = fmaxf(m[u], absmax16<XT>(xr[u][c]));
    }
    if (p.splits == 2) {
      // one other slice: cheaper to read it here than to wait for its CTA
      const int o0 = (1 - blockIdx.y) * p.slice;
      uint4 xo[kRpw][kCpl];
      load_slice(o0, min(p.k, o0 + p.slice), xo);
#pragma unroll
      for (int u = 0; u < kRpw; ++u)
#pragma unroll
        for (int c = 0; c < kCpl; ++c) m[u] = fmaxf(m[u], absmax16<XT>(xo[u][c]));
    }
#pragma unroll
    for (int u = 0; u < kRpw; ++u) {
      m[u] = warp_max(m[u]);
      if (lane == 0) amax_s[warp + 4 * u] = __float_as_int(m[u]);  // |x| bits
    }
    __syncthreads();
    if (p.splits > 2) {
      // every CTA of this layer publishes its slice maxima and waits until
      // all have (they are all resident together: the launch checks)
      int* sync = p.sync + z * kSyncInts;
      const int total = gridDim.x * gridDim.y;
      if (threadIdx.x < p.m) {
        atomicMax(sync + threadIdx.x, amax_s[threadIdx.x]);
        __threadfence();
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        atomicAdd(sync + kArrive, 1);
        // (bounded: were the CTAs ever not all resident, the launch fails
        // instead of hanging)
        for (long long spin = 0; load_acquire(sync + kArrive) < total; ++spin)
          if (spin > (1ll << 26)) __trap();
      }
      __syncthreads();
      if (threadIdx.x < p.m) amax_s[threadIdx.x] = __ldcg(sync + threadIdx.x);
      __syncthreads();
      // the last CTA to leave zeroes the exchange for the next call
      if (threadIdx.x == 0 && atomicAdd(sync + kDepart, 1) == total - 1) {
        for (int r = 0; r < p.m; ++r) atomicExch(sync + r, 0);
        atomicExch(sync + kArrive, 0);
        atomicExch(sync + kDepart, 0);
      }
    }
    if (threadIdx.x < kRows)
      scale_s[threadIdx.x] = row_scale(__int_as_float(amax_s[threadIdx.x]));
    __syncthreads();
  } else if (threadIdx.x < kRows) {  // (no rs with an int32 output)
    scale_s[threadIdx.x] = threadIdx.x < p.m && p.rs ? p.rs[z * p.rs_ls + threadIdx.x] : 1.0f;
  }
  // --- this CTA's slice of xq into shared memory ---
#pragma unroll
  for (int u = 0; u < kRpw; ++u) {
    const int r = warp + 4 * u;
    float scale, inv;
    if constexpr (kQuant) {
      scale = scale_s[r];
      inv = __frcp_rn(scale);
    }
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      const int unit = lane + 32 * c;
      if (unit >= cpr) continue;
      int8_t* dst = xq_s + r * xs + unit * kPer;
      if constexpr (kQuant) {
        constexpr int kG = kPer / 4;
        float f[kPer];
        to_floats(xr[u][c], f);
        float fg[kG][4], sg[kG], ig[kG];
        uint32_t q[kG];
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          sg[i] = scale;
          ig[i] = inv;
#pragma unroll
          for (int e = 0; e < 4; ++e) fg[i][e] = f[4 * i + e];
        }
        quant4(fg, sg, ig, q);
        if constexpr (kG == 2) *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
        else *reinterpret_cast<uint32_t*>(dst) = q[0];
      } else {
        *reinterpret_cast<uint4*>(dst) = xr[u][c];
      }
    }
  }
  __syncthreads();

  // --- the int32 product: weight rows x tokens; the k32 halves of each
  // step go to separate sums (exact in int32), so no mma waits on the one
  // before it. Thread (g, t) holds bytes [16t, 16t + 16) of each 64-byte
  // step of both operands: the same permutation of k on both sides. ---
  int acc[TILES][4] = {};
  {
    int part[TILES][2][4] = {};
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int off = 64 * s;
      if (off < k1 - k0) {
        const uint4& a_lo = wf[s][0];
        const uint4& a_hi = wf[s][1];
#pragma unroll
        for (int nt = 0; nt < TILES; ++nt) {
          const uint4 b = *reinterpret_cast<const uint4*>(xq_s + (8 * nt + g) * xs + off + 16 * t);
          mma_s8(part[nt][0], a_lo.x, a_hi.x, a_lo.y, a_hi.y, b.x, b.y);
          mma_s8(part[nt][1], a_lo.z, a_hi.z, a_lo.w, a_hi.w, b.z, b.w);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < TILES; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = part[nt][0][i] + part[nt][1][i];
  }

  // c0, c1: weight row n_lo, tokens 8nt + 2t, 8nt + 2t + 1; c2, c3: n_lo + 8
  if (p.splits > 1) {
    int* part = p.part + (long long)z * p.m * p.n;
#pragma unroll
    for (int nt = 0; nt < TILES; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = 8 * nt + 2 * t + (i & 1);
        const int col = n_lo + ((i & 2) ? 8 : 0);
        if (tok < p.m && col < p.n) atomicAdd(part + tok * p.n + col, acc[nt][i]);
      }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      int* c = p.count + z * gridDim.x + blockIdx.x;
      last_s = atomicAdd(c, 1) == p.splits - 1;
      if (last_s) atomicExch(c, 0);
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
#pragma unroll
    for (int nt = 0; nt < TILES; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = 8 * nt + 2 * t + (i & 1);
        const int col = n_lo + ((i & 2) ? 8 : 0);
        if (tok < p.m && col < p.n) acc[nt][i] = atomicExch(part + tok * p.n + col, 0);
      }
  }
#pragma unroll
  for (int nt = 0; nt < TILES; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = 8 * nt + 2 * t + (i & 1);
      const int col = n_lo + ((i & 2) ? 8 : 0);
      if (tok < p.m && col < p.n)
        store_result(out + (long long)tok * p.n + col, acc[nt][i], scale_s[tok], ws + col);
    }
}

// ---------------------------------------------------------------- hopper
// The TMA + wgmma branch (plan branch "hopper"): xq (int8, K-major) and W
// (N, K) int8 arrive by TMA with the 128-byte swizzle, 128 bytes of K a
// stage, into a ring of `stages` paced by mbarriers; a CTA is one producer
// warpgroup (one thread issues the copies) and two consumer warpgroups of
// 64 rows each running wgmma m64nBNk32 s32.s8.s8 on the same W tile. The
// grid is persistent (one CTA per SM walks tiles blockIdx.x, + gridDim.x,
// ...), so the producer fills the next tile's stages under the consumers'
// epilogue. Tiles go in groups of `group` row tiles, row tiles fastest, so
// the CTAs in flight share their W tiles and rows of xq in L2.
constexpr int kHRows = 128;      // rows of x per tile: two warpgroups of 64
constexpr int kHCols = 128;      // columns of W per tile
constexpr int kHStep = 128;      // bytes of K per stage: one swizzle row
constexpr int kHThreads = 384;   // two consumer warpgroups and a producer
constexpr int kHConsumerWarps = 8;

struct HParams {
  const float* rs;  // (x layers, M) row scales; null for an int32 output
  const float* ws;  // weight layer layer0's column scales, layer z at z * ws_ls
  void* out;        // (layers, M, N), layer z at z * o_ls
  int m, n, k;
  int m_tiles, n_tiles, tiles;  // tiles = m_tiles * n_tiles * layers
  int group;        // row tiles walked together
  int stages;       // ring stages
  int k_steps;      // ceil(K / 128)
  int x_per_layer;  // 1: x row block z for layer z; 0: one x for all layers
  long long rs_ls, ws_ls, o_ls;
};

struct HLayout {
  static constexpr int kA = kHRows * kHStep;  // 16 KB of xq a stage
  static constexpr int kB = kHCols * kHStep;  // 16 KB of W a stage
  static constexpr int kStage = kA + kB;
  // the ring, its 2 x stages barriers and 1024 bytes of alignment slack
  static size_t smem(int stages) { return 1024 + static_cast<size_t>(stages) * (kStage + 16); }
};

// d (64 x 128, s32) += A (64 x 32) . B (128 x 32)^T, both K-major in shared
// memory; `accumulate` 0 overwrites d.
struct WgmmaS8 {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
                 "}, %64, %65, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
                   "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
                   "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
                   "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
                   "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
                   "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
                   "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
                   "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
                 : "l"(a), "l"(b), "r"(accumulate));
  }
};

// Keep the compiler from moving accumulator registers across the async
// products (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A K-major tile of 128-byte rows under the 128-byte swizzle, at k32 step
// kk (32 bytes) of its stage: SBO = 8 rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t tile, int kk) {
  return make_desc(tile + 32 * kk, 16, 8 * kHStep, 1);
}

// A (128 bytes of K) x `rows` box at (k0, row0) of a 2-d int8 map.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int k0, int row0,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(bar)
      : "memory");
}

// Tile t -> (layer z, row tile, column tile): within a layer, bands of
// `group` row tiles (the last band may be shorter), each band walked row
// tile first, then column tile.
__device__ __forceinline__ void tile_at(const HParams& p, int t, int& z, int& mt, int& nt) {
  const int per_layer = p.m_tiles * p.n_tiles;
  z = t / per_layer;
  int r = t - z * per_layer;
  const int band = r / (p.group * p.n_tiles);
  const int first = band * p.group;
  const int rows = min(p.group, p.m_tiles - first);
  r -= band * p.group * p.n_tiles;
  mt = first + r % rows;
  nt = r / rows;
}

template <typename OutT>
__global__ void __launch_bounds__(kHThreads, 1)
w8a8_hopper_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   const HParams p) {
  using L = HLayout;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + p.stages * L::kStage;
  // full[s]: the stage's bytes have landed; empty[s]: every consumer warp
  // is done with it
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (p.stages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kHConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // the producer: one thread issues every copy
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        int z, mt, nt;
        tile_at(p, t, z, mt, nt);
        const int arow = (p.x_per_layer ? z * p.m : 0) + mt * kHRows;
        const int brow = z * p.n + nt * kHCols;
        for (int ks = 0; ks < p.k_steps; ++ks) {
          mbar_wait(empty(stage), phase ^ 1);  // a fresh barrier passes parity 1
          mbar_expect_tx(full(stage), L::kStage);
          const uint32_t dst = base + stage * L::kStage;
          tma_2d(dst, &ta, ks * kHStep, arow, full(stage));
          tma_2d(dst + L::kA, &tb, ks * kHStep, brow, full(stage));
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  int acc[kHCols / 2];
#pragma unroll
  for (int i = 0; i < kHCols / 2; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int z, mt, nt;
    tile_at(p, t, z, mt, nt);
    int last = 0;
    for (int ks = 0; ks < p.k_steps; ++ks) {
      mbar_wait(full(stage), phase);
      const uint32_t a = base + stage * L::kStage + wg * (64 * kHStep);
      const uint32_t b = base + stage * L::kStage + L::kA;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHStep / 32; ++kk)
        WgmmaS8::mma(acc, desc_sw128(a, kk), desc_sw128(b, kk), ks > 0 || kk > 0);
      wgmma_commit();
      fence_acc(acc);
      // the previous stage's products are done: release it
      wgmma_wait<1>();
      fence_acc(acc);
      if (ks > 0 && lane == 0) mbar_arrive(empty(last));
      last = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty(last));

    // epilogue: d[4j + 2h + e] -> row 16 warp + lane / 4 + 8h, column
    // 8j + 2 (lane % 4) + e of this warpgroup's 64 x kHCols
    const int row0 = mt * kHRows + 64 * wg + 16 * warp + lane / 4;
    const int col0 = nt * kHCols + 2 * (lane % 4);
    OutT* out = static_cast<OutT*>(p.out) + z * p.o_ls;
    const float* ws = p.ws + z * p.ws_ls;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      float rsv = 1.0f;
      if constexpr (!std::is_same<OutT, int>::value)
        if (r < p.m) rsv = __ldg(p.rs + z * p.rs_ls + r);
      OutT* orow = out + static_cast<long long>(r) * p.n;
      if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
        // bf16: a lane's pair is 4 bytes, so a quad's store would fill
        // half a 32-byte sector. Columns 16i .. 16i + 15 of the row (n8
        // tiles 2i, 2i + 1) go round the quad instead, each lane then
        // storing 4 columns: a whole sector per quad and store.
        const int q = lane % 4;
        const int src_a = (lane & ~3) | ((2 * q) & 3), src_b = src_a | 1;
#pragma unroll
        for (int i = 0; i < kHCols / 16; ++i) {
          uint32_t v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 2 * i + e, col = col0 + 8 * j;
            float2 wv = make_float2(0.0f, 0.0f);
            if (col < p.n) wv = __ldg(reinterpret_cast<const float2*>(ws + col));
            const __nv_bfloat162 pr = __floats2bfloat162_rn(
                dequant(acc[4 * j + 2 * h], rsv, wv.x), dequant(acc[4 * j + 2 * h + 1], rsv, wv.y));
            v[e] = *reinterpret_cast<const uint32_t*>(&pr);
          }
          const uint32_t a0 = __shfl_sync(0xffffffffu, v[0], src_a);
          const uint32_t a1 = __shfl_sync(0xffffffffu, v[1], src_a);
          const uint32_t b0 = __shfl_sync(0xffffffffu, v[0], src_b);
          const uint32_t b1 = __shfl_sync(0xffffffffu, v[1], src_b);
          const int col = nt * kHCols + 16 * i + 4 * q;
          if (r >= p.m || col >= p.n) continue;
          const uint2 w2 = q < 2 ? make_uint2(a0, b0) : make_uint2(a1, b1);
          if (col + 4 <= p.n && p.n % 4 == 0)
            *reinterpret_cast<uint2*>(orow + col) = w2;
          else {  // N % 4 == 2: 4-byte stores (rows are 4-byte aligned)
            *reinterpret_cast<uint32_t*>(orow + col) = w2.x;
            if (col + 2 < p.n) *reinterpret_cast<uint32_t*>(orow + col + 2) = w2.y;
          }
        }
        continue;
      }
      if (r >= p.m) continue;
#pragma unroll
      for (int j = 0; j < kHCols / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col >= p.n) continue;  // N even: col + 1 < N as well
        const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        if constexpr (std::is_same<OutT, int>::value) {
          *reinterpret_cast<int2*>(orow + col) = make_int2(a0, a1);
        } else {
          const float2 wv = __ldg(reinterpret_cast<const float2*>(ws + col));
          store_pair(orow + col, dequant(a0, rsv, wv.x), dequant(a1, rsv, wv.y));
        }
      }
    }
  }
}

// The Hopper branch's quantization pre-pass: each row of x (bf16 or f32)
// to int8 against its own scale, bit for bit w8a8_linear_reference's
// (row_scale of the row's absmax, quant_bits' division-free quotient), a
// warp per row: xq (rows, K) and rs (rows) for the product's TMA copies.
constexpr int kQuantRows = 8;  // rows (warps) per CTA

template <typename XT>
__global__ void __launch_bounds__(32 * kQuantRows)
w8a8_quantize_kernel(const XT* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ rs,
                     int rows, int k) {
  constexpr int kU = sizeof(XT);  // 16-byte loads per 16 values
  const int row = blockIdx.x * kQuantRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * k);
  const int units = k / 16;  // K % 16 == 0
  float m = 0.0f;
  for (int u0 = lane; u0 < units; u0 += 4 * 32) {
    uint4 v[4][kU];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < kU; ++e)
        v[i][e] = u0 + 32 * i < units ? __ldg(src + (u0 + 32 * i) * kU + e) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < kU; ++e) m = fmaxf(m, absmax16<XT>(v[i][e]));
  }
  m = warp_max(m);
  const float scale = row_scale(m), inv = __frcp_rn(scale);
  uint4* dst = reinterpret_cast<uint4*>(xq + static_cast<long long>(row) * k);
  for (int u = lane; u < units; u += 32) {
    float f[4][4], sg[4], ig[4];
#pragma unroll
    for (int e = 0; e < kU; ++e) {
      float part[16 / kU];
      to_floats(__ldg(src + u * kU + e), part);
#pragma unroll
      for (int q = 0; q < 16 / kU; ++q) f[(e * (16 / kU) + q) / 4][q % 4] = part[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sg[q] = scale;
      ig[q] = inv;
    }
    uint32_t qv[4];
    quant4(f, sg, ig, qv);
    dst[u] = make_uint4(qv[0], qv[1], qv[2], qv[3]);
  }
  if (lane == 0) rs[row] = scale;
}

// A 2-d int8 map of `rows` rows of K bytes (K % 16 == 0, 16-byte aligned),
// boxes of 128 bytes x box_rows, the 128-byte swizzle, zeros out of
// bounds (past K and past the last row).
cudaError_t make_map_s8(CUtensorMap* map, const void* ptr, long long rows, int k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kHStep), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// xq (x layers x M, K) int8 and rs against w (layers x N, K) int8 from
// weight layer layer0: the plan's stages, group and CTAs.
template <typename OutT>
cudaError_t launch_hopper(const Params& p, int layers, int stages, int group, int ctas,
                          cudaStream_t s) {
  using L = HLayout;
  auto kernel = w8a8_hopper_kernel<OutT>;
  const size_t smem = L::smem(stages);
  const bool per_layer = p.x_ls != 0;
  if (stages < 2 || smem > static_cast<size_t>(kMaxSmem) || group < 1 || ctas < 1 ||
      (per_layer && p.x_ls != static_cast<long long>(p.m) * p.k) ||
      p.w_ls != static_cast<long long>(p.n) * p.k)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err;
  if ((err = make_map_s8(&ta, p.x, static_cast<long long>(per_layer ? layers : 1) * p.m, p.k,
                         kHRows)) != cudaSuccess ||
      (err = make_map_s8(&tb, p.w + static_cast<long long>(p.layer0) * p.w_ls,
                         static_cast<long long>(layers) * p.n, p.k, kHCols)) != cudaSuccess)
    return err;
  HParams h;
  h.rs = p.rs;
  h.ws = p.ws == nullptr ? nullptr : p.ws + static_cast<long long>(p.layer0) * p.ws_ls;
  h.out = p.out;
  h.m = p.m;
  h.n = p.n;
  h.k = p.k;
  h.m_tiles = (p.m + kHRows - 1) / kHRows;
  h.n_tiles = (p.n + kHCols - 1) / kHCols;
  h.tiles = h.m_tiles * h.n_tiles * layers;
  h.group = group;
  h.stages = stages;
  h.k_steps = (p.k + kHStep - 1) / kHStep;
  h.x_per_layer = per_layer;
  h.rs_ls = p.rs_ls;
  h.ws_ls = p.ws_ls;
  h.o_ls = p.o_ls;
  // Once per instantiation, at its first (uncaptured) launch.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<min(ctas, h.tiles), kHThreads, smem, s>>>(ta, tb, h);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_quantize(const Params& p, long long rows, int8_t* xq, float* rs,
                            cudaStream_t s) {
  if (xq == nullptr || rs == nullptr || reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(p.x) % 16)
    return cudaErrorInvalidValue;
  const long long ctas = (rows + kQuantRows - 1) / kQuantRows;
  w8a8_quantize_kernel<XT><<<static_cast<unsigned>(ctas), 32 * kQuantRows, 0, s>>>(
      static_cast<const XT*>(p.x), xq, rs, static_cast<int>(rows), p.k);
  return cudaGetLastError();
}

// CTAs of a narrow kernel resident on one SM at once (its shared memory at
// the largest slice).
template <typename XT, typename OutT, int TILES, int STEPS>
int narrow_per_sm() {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, w8a8_narrow_kernel<XT, OutT, TILES, STEPS>, 128,
        8 * TILES * static_cast<size_t>(64 * STEPS + 16) + (16 * TILES + 1) * 4);
    return n;
  }();
  return per_sm;
}

template <typename XT, typename OutT, int TILES, int STEPS>
cudaError_t launch_narrow(Params p, int layers, long long part_cap,
                          long long count_cap, cudaStream_t stream) {
  auto kernel = w8a8_narrow_kernel<XT, OutT, TILES, STEPS>;
  const int steps = (p.k + 63) / 64;
  const int ntiles = (p.n + kNarrowRows - 1) / kNarrowRows;
  p.splits = (steps + STEPS - 1) / STEPS;
  p.slice = min(steps, STEPS) * 64;
  const size_t smem = 8 * TILES * static_cast<size_t>(p.slice + 16) + (16 * TILES + 1) * 4;
  if (p.splits > 1) {
    // the scratch: partials, tile counters and (quantizing) the exchange
    if (p.part == nullptr ||
        static_cast<long long>(layers) * p.m * p.n > part_cap ||
        static_cast<long long>(layers) * (ntiles + kSyncInts) > count_cap)
      return cudaErrorInvalidValue;  // the wrapper's scratch covers M <= 32
    p.sync = p.count + static_cast<long long>(layers) * ntiles;
  }
  if (p.splits > 2 && !std::is_same<XT, int8_t>::value) {
    // The CTAs of a layer wait for each other once, so all of them must
    // be resident together (layers run in order: one at a time suffices).
    // The plan keeps such a split off this branch; this is its guard.
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (static_cast<long long>(ntiles) * p.splits >
        static_cast<long long>(narrow_per_sm<XT, OutT, TILES, STEPS>()) * sms)
      return cudaErrorCooperativeLaunchTooLarge;  // nothing launched
  }
  kernel<<<dim3(ntiles, p.splits, layers), 128, smem, stream>>>(p);
  return cudaGetLastError();
}

// The plan's branch (ops/w8a8_matmul.py:w8a8_plan): plan[0] 0 narrow
// (plan[1] n8 tiles of rows, plan[2] 64-byte k steps a slice), 1 hopper
// (plan[1] column tile, plan[2] stages, plan[3] group, plan[4] CTAs;
// quantizing x first where x is float).
enum Branch { kNarrow = 0, kHopper = 1 };

template <typename XT, typename OutT>
cudaError_t launch(const Params& p, int layers, const int* plan, long long part_cap,
                   long long count_cap, cudaStream_t s) {
  switch (plan[0]) {
    case kNarrow:
      if (plan[1] == 1 && plan[2] == 16)
        return launch_narrow<XT, OutT, 1, 16>(p, layers, part_cap, count_cap, s);
      if (plan[1] == 1 && plan[2] == 8)
        return launch_narrow<XT, OutT, 1, 8>(p, layers, part_cap, count_cap, s);
      if (plan[1] == 2 && plan[2] == 8)
        return launch_narrow<XT, OutT, 2, 8>(p, layers, part_cap, count_cap, s);
      if (plan[1] == 4 && plan[2] == 8)
        return launch_narrow<XT, OutT, 4, 8>(p, layers, part_cap, count_cap, s);
      return cudaErrorInvalidValue;
    case kHopper:
      if constexpr (std::is_same<XT, int8_t>::value)
        if (plan[1] == kHCols) return launch_hopper<OutT>(p, layers, plan[2], plan[3], plan[4], s);
      return cudaErrorInvalidValue;  // float x: quantized first (below)
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t dispatch_out(const Params& p, int layers, int out_dtype, const int* plan,
                         long long part_cap, long long count_cap, cudaStream_t s) {
  switch (out_dtype) {
    case 0: return launch<XT, __nv_bfloat16>(p, layers, plan, part_cap, count_cap, s);
    case 1: return launch<XT, float>(p, layers, plan, part_cap, count_cap, s);
    case 2:  // the int32 accumulator, no dequant: xq given only
      if constexpr (std::is_same<XT, int8_t>::value)
        return launch<XT, int>(p, layers, plan, part_cap, count_cap, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const void* x, const void* rs, const void* w, const void* ws, void* out,
                   int m, int n, int k, int layer0, long long x_ls, long long rs_ls,
                   long long w_ls, long long ws_ls, long long o_ls, void* part,
                   void* count) {
  Params p;
  p.x = x;
  p.rs = static_cast<const float*>(rs);
  p.w = static_cast<const int8_t*>(w);
  p.ws = static_cast<const float*>(ws);
  p.out = out;
  p.part = static_cast<int*>(part);
  p.count = static_cast<int*>(count);
  p.sync = nullptr;
  p.m = m;
  p.n = n;
  p.k = k;
  p.layer0 = layer0;
  p.splits = 1;
  p.slice = 0;
  p.x_ls = x_ls;
  p.rs_ls = rs_ls;
  p.w_ls = w_ls;
  p.ws_ls = ws_ls;
  p.o_ls = o_ls;
  return p;
}

}  // namespace

// x (layers, M, K) [layer stride x_ls, 0 = shared]: int8 (x_dtype 0, with
// rs (layers, M) f32), bf16 (1) or f32 (2), quantized per row inside;
// w (L, N, K) int8, ws (L, N) f32, out (layers, M, N) bf16 (out_dtype 0)
// or f32 (1), or (out_dtype 2, int8 x only) the int32 accumulator with no
// dequant (rs and ws unread, may be null): the exact partial product of a
// split K, summed across ranks before the dequant. part / count: a zeroed
// int32 scratch of part_cap / count_cap entries for the split over K at
// M <= 32 (left zeroed; null: no split). plan: the branch and its choices
// (Branch above), from ops/w8a8_matmul.py:w8a8_plan. xq_buf / rs_buf: for
// the Hopper branch on float x, an int8 (x layers x M, K) and a float
// (x layers x M) scratch that its quantization pre-pass fills (a second
// launch, before the product). K % 16 == 0, N even, pointers 16-byte
// aligned (the wrapper checks shapes; PyTorch allocations are aligned; a K
// not a multiple of 16 is zero-padded by the caller, once for the weight
// and inside the quantization for x). Returns a cudaError_t: nothing
// refused falls back to another branch.
extern "C" int vla_w8a8_matmul(
    const void* x, const void* rs, const void* w, const void* ws, void* out,
    int m, int n, int k, int layer0, int layers,
    long long x_ls, long long rs_ls, long long w_ls, long long ws_ls,
    long long o_ls, int x_dtype, int out_dtype, void* part, void* count,
    long long part_cap, long long count_cap, const int* plan, void* xq_buf,
    void* rs_buf, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 2 || layers <= 0 || plan == nullptr ||
      (x_dtype == 0 && rs == nullptr && out_dtype != 2) || (out_dtype == 2 && x_dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(x, rs, w, ws, out, m, n, k, layer0, x_ls, rs_ls,
                         w_ls, ws_ls, o_ls, part, count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan[0] == kHopper && x_dtype != 0) {
    // the pre-pass: x's rows (one x, or one per layer) into xq_buf, rs_buf
    const long long rows = static_cast<long long>(x_ls ? layers : 1) * m;
    cudaError_t err = x_dtype == 1
        ? launch_quantize<__nv_bfloat16>(p, rows, static_cast<int8_t*>(xq_buf),
                                         static_cast<float*>(rs_buf), s)
        : x_dtype == 2 ? launch_quantize<float>(p, rows, static_cast<int8_t*>(xq_buf),
                                                 static_cast<float*>(rs_buf), s)
                       : cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
    p.x = xq_buf;
    p.rs = static_cast<const float*>(rs_buf);
    p.rs_ls = x_ls ? m : 0;
    x_dtype = 0;
  }
  switch (x_dtype) {
    case 0: return dispatch_out<int8_t>(p, layers, out_dtype, plan, part_cap, count_cap, s);
    case 1: return dispatch_out<__nv_bfloat16>(p, layers, out_dtype, plan, part_cap, count_cap, s);
    case 2: return dispatch_out<float>(p, layers, out_dtype, plan, part_cap, count_cap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The Hopper branch's pre-pass alone: x (rows, K) bf16 (x_dtype 1) or f32
// (2) into xq (rows, K) int8 and rs (rows) f32, as vla_w8a8_matmul runs
// it before a product. Returns a cudaError_t.
extern "C" int vla_w8a8_quantize(const void* x, void* xq, void* rs, long long rows, int k,
                                 int x_dtype, void* stream) {
  if (rows <= 0 || k <= 0 || k % 16) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(x, nullptr, nullptr, nullptr, nullptr, 1, 2, k, 0, 0, 0, 0, 0,
                               0, nullptr, nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_dtype == 1 ? launch_quantize<__nv_bfloat16>(p, rows, static_cast<int8_t*>(xq),
                                                    static_cast<float*>(rs), s)
      : x_dtype == 2 ? launch_quantize<float>(p, rows, static_cast<int8_t*>(xq),
                                              static_cast<float*>(rs), s)
                     : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// CTAs of the narrow kernel (n8 tiles `tiles`, `steps` 64-byte steps a
// slice, quantizing x of x_dtype 1 or 2 into out_dtype 0 or 1) resident on
// one SM at once: a quantizing split over more than two slices needs all
// of its CTAs resident, and the plan routes by it. -1 for another kernel.
extern "C" int vla_w8a8_narrow_per_sm(int tiles, int steps, int x_dtype, int out_dtype) {
  const int key = tiles * 1000 + steps * 10 + (x_dtype - 1) * 2 + out_dtype;
  switch (key) {
#define VLA_NARROW(T, S)                                                              \
    case T * 1000 + S * 10 + 0: return narrow_per_sm<__nv_bfloat16, __nv_bfloat16, T, S>(); \
    case T * 1000 + S * 10 + 1: return narrow_per_sm<__nv_bfloat16, float, T, S>();         \
    case T * 1000 + S * 10 + 2: return narrow_per_sm<float, __nv_bfloat16, T, S>();         \
    case T * 1000 + S * 10 + 3: return narrow_per_sm<float, float, T, S>();
    VLA_NARROW(1, 16)
    VLA_NARROW(1, 8)
    VLA_NARROW(2, 8)
    VLA_NARROW(4, 8)
#undef VLA_NARROW
    default: return -1;
  }
}

// Host nanoseconds to encode the Hopper branch's two tensor maps (the
// host work a launch adds), the mean over `reps` encodes of each of an
// (m, k) x map and an (n, k) weight map at `ptr` (never read).
extern "C" double vla_w8a8_map_encode_ns(const void* ptr, int m, int n, int k, int reps) {
  CUtensorMap a, b;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (make_map_s8(&a, ptr, m, k, kHRows) != cudaSuccess ||
        make_map_s8(&b, ptr, n, k, kHCols) != cudaSuccess)
      return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / reps;
}
