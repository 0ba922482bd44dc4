// W8A8 matmul for Hopper (sm_90a): the per-row int8 quantization of x, the
// int8 x int8 -> int32 product on the tensor cores and the rank-1
// dequantization, in one kernel.
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
// blockIdx.z walks layers: x/out layer z (strides 0 for one shared x)
// against weight layer layer0 + z: a flat weight (B4), one layer of an
// (L, N, K) stack (B5) and the action head's BatchedDense.
//
// Quantization inside, bit for bit. The scale is w8a8_mlp.cuh's row_scale
// (the B2/B3 helper) of the row's absmax over the whole K; each value is
// the correctly rounded quotient x / rs, computed without a division
// (quant_bits), rounded half to even. No xq is written to device memory.
// The int32 sum is exact in any order over k.
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
// Two designs by the number of rows:
// * M > 32 ("wide": Qwen2 q/o, the ViT projections, projector fc3, the
//   head's K/V stacks, every "dense" matmul): a CTA of 4 warps owns 64 rows
//   of x and 64 columns of W, each warp 16 rows x 64 with mma.sync
//   m16n8k32. W streams through a ring of four 128-byte-k slots fed by
//   cp.async, two steps ahead of the tensor cores. Where the whole K fits
//   (bf16 x, K <= 1536: every serving shape) xq stays in shared memory for
//   the whole K. The CTAs along N that share the same 64 rows run as one
//   cluster (the largest divisor of the column tiles up to 8) and quantize
//   those rows once between them: each takes every csize-th row straight
//   from device memory (absmax and quantization in registers, a warp per
//   row) and writes the int8 row and its scale into the shared memory of
//   every CTA of the cluster (distributed shared memory). Each element of x
//   is read from L2 and quantized once per cluster instead of once per
//   column tile. With xq given (the JAX B4 signature), each warp copies its
//   rows into the same layout with cp.async. Otherwise (the "dense" MLP
//   down projections, f32 x) x rides the ring beside W, each warp takes
//   its rows' absmax in a first pass over L2 and quantizes its A fragments
//   one step ahead of the tensor cores. Shared memory rows are 128 bytes
//   with the 16-byte units swizzled by (row % 8): conflict-free ldmatrix.
//   At the B=1 serving shapes, CTAs (clusters of): Qwen2 q/o (640, 896^2)
//   140 (7), DINOv2 (522, 1024^2) 144 (8), so400m (512, 1152^2) 144 (6),
//   fc3 (512, 896^2) 112 (7); 89-105 KB of shared memory, 2 CTAs per SM,
//   so each grid is resident at once.
// * M <= 32 ("narrow": proprio, the action head at M = 8 per request and
//   B * 8 in a batch): the weight fills the 16-row side of
//   mma.sync.m16n8k32 and the tokens its 8-wide side (1, 2 or 4 n8 tiles),
//   so little of a tile is padding. A CTA of 4 warps owns 64 weight rows
//   and a slice of K (up to 1024 bytes at M <= 8, 512 above); its weight
//   fragments go straight from device memory to registers, issued first,
//   and its slice of x beside them. Each CTA takes the absmax of its rows
//   over its own slice from those registers (one other slice it reads
//   itself). A K longer than two slices is split over CTAs (fc_in, K =
//   6272: 13 x 14 = 182 CTAs instead of 14) whose slice maxima meet in a
//   persistent scratch: each CTA publishes its own and waits for the
//   others once (all of them are resident together: the launch checks),
//   so every row's scale comes from one read of x per launch. The CTAs add
//   their int32 partials with atomics, and the last CTA of an N tile (an
//   atomic counter) reads them back, zeroing them, and runs the dequant
//   epilogue; the last CTA to leave zeroes the maxima and the counters for
//   the next call. One launch per call, no memset. Where a quantizing
//   split's CTAs could not all be resident (more than two slices over
//   very many column tiles), the call takes the wide design instead.
//
// Bound on this card: at the serving shapes (M = 1 .. 2560, N, K ~ 1000)
// x, the weights and the output are ~1-6 MB per call: ~0.3-2 us at
// 3.35 TB/s, against ~0.5 us of int8 work (2MNK ~ 1 GOP at 1979 TOP/s):
// bytes bound. What the wide CTAs wait on is latency: the first rows of x
// (and, quantizing, the cluster's exchange) before the first product, and
// each W step's trip from L2. mma.sync, not wgmma: a wgmma version of the
// same loop (A from registers, W by descriptor from this swizzled layout)
// was exact with one CTA per SM and wrong with two CTAs on an SM or in a
// cluster, which every serving shape needs.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "w8a8_mlp.cuh"

namespace {

using vla_w8a8::kMaxSmem;
using vla_w8a8::low_bytes;
using vla_w8a8::mma_s8;
using vla_w8a8::quant_bits;
using vla_w8a8::row_scale;

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
  int resident;       // wide: xq held in shared memory for the whole K
  int cluster;        // wide, resident: CTAs along N sharing the quantization
  long long x_ls, rs_ls, w_ls, ws_ls, o_ls;  // per-layer strides (elements)
};

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; zeros where !pred.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

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

// Four consecutive values of x as floats: 8 bytes of bf16 or 16 of f32.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
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

// ------------------------------------------------------------------ wide
constexpr int kWideRows = 64;     // rows of x per CTA: one warpgroup
constexpr int kWideThreads = 128;
constexpr int kWideCols = 64;     // columns of W per CTA
constexpr int kStep = 128;        // k per pipeline step (bytes of int8)
constexpr int kRing = 4;          // W ring slots (x too, when streamed)

template <typename XT, int BN>
struct Wide {
  static constexpr int kSx = sizeof(XT);
  static constexpr int kXStep = kStep * kSx;         // bytes of x per row and step
  static constexpr int kWSlot = BN * kStep;          // a slot of the W ring
  static constexpr int kXSlot = kWideRows * kXStep;  // a slot of the x ring (streamed)
  static constexpr int kASlot = kWideRows * kStep;   // a step of resident xq
  // Bytes of shared memory (and 1024 of alignment slack). Resident: xq for
  // the whole K; streamed: a ring of x beside the W ring.
  static size_t smem(bool resident, int steps) {
    const size_t x = resident ? static_cast<size_t>(steps) * kASlot
                              : static_cast<size_t>(kRing) * kXSlot;
    return 1024 + kRing * static_cast<size_t>(kWSlot) + x + 2 * kWideRows * sizeof(float);
  }
};
constexpr int kShareUnits = 3;  // 16-value units per lane and row: K <= 1536

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// `p` in the shared memory of CTA `rank` of this cluster (distributed
// shared memory; cluster of one: p itself).
template <typename T>
__device__ __forceinline__ T* in_cta(T* p, int rank, int csize) {
  return csize > 1 ? cooperative_groups::this_cluster().map_shared_rank(p, rank) : p;
}

// Each warp computes its 16 rows x BN with mma.sync, its A fragments from
// xq (or quantized from x) and its B fragments by ldmatrix from the ring.
template <typename XT, typename OutT, int BN>
__global__ void __launch_bounds__(kWideThreads) w8a8_wide_kernel(const Params p) {
  using L = Wide<XT, BN>;
  constexpr bool kQuant = !std::is_same<XT, int8_t>::value;
  constexpr int kSx = L::kSx;
  constexpr int kXStep = L::kXStep;
  constexpr int kXChunks = kXStep / 16;  // 16-byte units per row and step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  const int steps = (p.k + kStep - 1) / kStep;
  const bool resident = p.resident;
  const int csize = p.cluster;  // CTAs along N that share the quantization
  const int rank = blockIdx.x % csize;
  const int mine = (kWideRows + csize - 1) / csize;  // rows this CTA quantizes
  unsigned char* w_s = smem;                         // kRing x BN x 128
  unsigned char* x_s = w_s + kRing * L::kWSlot;      // xq (resident) or the x ring
  float* scale_s = reinterpret_cast<float*>(
      x_s + (resident ? steps * L::kASlot : kRing * L::kXSlot));
  float* inv_s = scale_s + kWideRows;

  const int z = blockIdx.z;
  const XT* x = static_cast<const XT*>(p.x) + z * p.x_ls;
  const int8_t* w = p.w + (p.layer0 + z) * p.w_ls;
  const float* ws = p.ws + (p.layer0 + z) * p.ws_ls;
  OutT* out = static_cast<OutT*>(p.out) + z * p.o_ls;
  const int m0 = blockIdx.y * kWideRows;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * warp;  // this warp's rows of the tile: r0 .. r0 + 15

  // Resident xq: row r of step s at x_s + s * kASlot + r * 128, its 16-byte
  // unit c at (c ^ (r % 8)). Streamed x: the same within each ring slot.
  auto a_at = [&](int r, int s, int c) -> unsigned char* {
    return x_s + s * L::kASlot + r * kStep + ((c ^ (r & 7)) << 4);
  };
  auto x_row = [&](int r, int s) -> unsigned char* {
    return x_s + (s % kRing) * L::kXSlot + r * kXStep;
  };
  // Streamed: this warp copies its own 16 rows of x, so only it reads them.
  auto load_x = [&](int s) {
#pragma unroll
    for (int u = 0; u < 16 * kXChunks / 32; ++u) {
      const int id = lane + 32 * u;
      const int r = r0 + id / kXChunks;
      const int c = id % kXChunks;
      const int kk = s * kStep + c * (16 / kSx);
      const bool ok = m0 + r < p.m && kk < p.k;
      const XT* src = ok ? x + (long long)(m0 + r) * p.k + kk : x;
      cp_async16(smem_addr(x_row(r, s)) + ((c ^ (r & 7)) << 4), src, ok);
    }
  };
  // Resident, xq given: this warp's 16 rows for the whole K.
  auto load_a = [&]() {
    for (int s = 0; s < steps; ++s)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int id = lane + 32 * u;
        const int r = r0 + id / 8;
        const int c = id % 8;
        const int kk = s * kStep + 16 * c;
        const bool ok = m0 + r < p.m && kk < p.k;
        const XT* src = ok ? x + (long long)(m0 + r) * p.k + kk : x;
        cp_async16(smem_addr(a_at(r, s, c)), src, ok);
      }
  };
  auto load_w = [&](int s) {
    const uint32_t slot = smem_addr(w_s + (s % kRing) * L::kWSlot);
#pragma unroll
    for (int u = 0; u < BN * 8 / kWideThreads; ++u) {
      const int id = threadIdx.x + kWideThreads * u;
      const int r = id / 8;
      const int c = id % 8;
      const int kk = s * kStep + 16 * c;
      const bool ok = n0 + r < p.n && kk < p.k;
      const int8_t* src = ok ? w + (long long)(n0 + r) * p.k + kk : w;
      cp_async16(slot + r * kStep + ((c ^ (r & 7)) << 4), src, ok);
    }
  };

  // --- prologue: x (resident: all of it), then W steps 0 .. kRing - 1 ---
  if (!kQuant && resident) {
    load_a();
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < kRing; ++s) {
    if (s < steps) {
      load_w(s);
      if (!resident) load_x(s);
    }
    cp_async_commit();
  }

  // --- row scales (and, resident and quantizing, xq itself) ---
  if constexpr (kQuant) {
    if (resident) {
      // Each CTA of the cluster quantizes its share of the 64 rows (rows
      // rank, rank + csize, ...), a warp per row and three rows of a warp
      // at once, straight from device memory, and writes the int8 rows and
      // their scales into the shared memory of every CTA of the cluster.
      constexpr int kU = kSx;  // 16-byte loads per 16 values
      constexpr int kRows = 3; // rows per warp at once
      const int units = steps * kStep / 16;  // 16-value units to write (zeros past K)
      const int k_units = p.k / 16;
      for (int i0 = warp; i0 < mine; i0 += 4 * kRows) {
        uint4 v[kRows][kShareUnits][kU];
        float m[kRows];
#pragma unroll
        for (int h = 0; h < kRows; ++h) {
          const int i = i0 + 4 * h;
          const int r = rank + csize * i;
          const bool live = i < mine && r < kWideRows && m0 + r < p.m;
          const uint4* row = reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * p.k);
          m[h] = 0.0f;
#pragma unroll
          for (int u = 0; u < kShareUnits; ++u) {
            const int unit = lane + 32 * u;
#pragma unroll
            for (int e = 0; e < kU; ++e) {
              v[h][u][e] = live && unit < k_units ? __ldg(row + unit * kU + e)
                                                : make_uint4(0, 0, 0, 0);
              m[h] = fmaxf(m[h], absmax16<XT>(v[h][u][e]));
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int h = 0; h < kRows; ++h) m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], off));
#pragma unroll
        for (int h = 0; h < kRows; ++h) {
          const int i = i0 + 4 * h;
          const int r = rank + csize * i;
          if (i >= mine || r >= kWideRows) break;
          const float scale = row_scale(m[h]), inv = __frcp_rn(scale);
#pragma unroll
          for (int u = 0; u < kShareUnits; ++u) {
            const int unit = lane + 32 * u;
            if (unit >= units) continue;
            float f[4][4], sg[4], ig[4];
#pragma unroll
            for (int e = 0; e < kU; ++e) {
              float part[16 / kU];
              to_floats(v[h][u][e], part);
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
            const uint4 packed = make_uint4(qv[0], qv[1], qv[2], qv[3]);
            uint4* dst = reinterpret_cast<uint4*>(a_at(r, unit / 8, unit % 8));
            for (int d = 0; d < csize; ++d) *in_cta(dst, d, csize) = packed;
          }
          if (lane == 0)
            for (int d = 0; d < csize; ++d) *in_cta(scale_s + r, d, csize) = scale;
        }
      }
      if (csize > 1) cluster_sync();
    } else {
      constexpr int kPer = 16 / kSx;
      const int chunks = p.k / kPer;  // K % 16 == 0: whole chunks
      for (int rr = 0; rr < 16; ++rr) {
        float m = 0.0f;
        if (m0 + r0 + rr < p.m) {
          const uint4* src = reinterpret_cast<const uint4*>(x + (long long)(m0 + r0 + rr) * p.k);
          for (int c0 = lane; c0 < chunks; c0 += 32 * 4) {
            uint4 v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int c = c0 + 32 * u;
              v[u] = c < chunks ? __ldg(src + c) : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) m = fmaxf(m, absmax16<XT>(v[u]));
          }
        }
        m = warp_max(m);
        if (lane == 0) {
          scale_s[r0 + rr] = row_scale(m);
          inv_s[r0 + rr] = __frcp_rn(scale_s[r0 + rr]);
        }
      }
    }
  } else if (threadIdx.x < kWideRows) {  // (no rs with an int32 output)
    const int r = m0 + threadIdx.x;
    scale_s[threadIdx.x] = r < p.m && p.rs ? p.rs[z * p.rs_ls + r] : 1.0f;
  }

  // A fragments of step s for this warp (m16n8k32 layout, k in order):
  // a[j] = rows r0 + g / r0 + g + 8, k 32j + 4t .. + 3 and 32j + 16 + 4t ..
  // Resident: by ldmatrix from xq. Streamed: quantized from x here.
  const int ra = r0 + g;
  const int rb = ra + 8;
  auto make_a = [&](int s, uint32_t (&a)[4][4]) {
    if (resident) {
      const int q = lane >> 3;
      const int r = r0 + (lane & 7) + 8 * (q & 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) ldmatrix_x4(a[j], smem_addr(a_at(r, s, 2 * j + (q >> 1))));
      return;
    }
    const unsigned char* xa = x_row(ra, s);
    const unsigned char* xb = x_row(rb, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b_lo = (32 * j + 4 * t) * kSx;  // byte of k 32j + 4t in the step
      const int b_hi = b_lo + 16 * kSx;         // and of k 32j + 16 + 4t
      const int o_lo = (((b_lo >> 4) ^ g) << 4) + (b_lo & 15);  // (ra % 8) == g
      const int o_hi = (((b_hi >> 4) ^ g) << 4) + (b_hi & 15);
      if constexpr (kQuant) {
        float f[4][4];
        load4(reinterpret_cast<const XT*>(xa + o_lo), f[0]);
        load4(reinterpret_cast<const XT*>(xb + o_lo), f[1]);
        load4(reinterpret_cast<const XT*>(xa + o_hi), f[2]);
        load4(reinterpret_cast<const XT*>(xb + o_hi), f[3]);
        const float sc[4] = {scale_s[ra], scale_s[rb], scale_s[ra], scale_s[rb]};
        const float iv[4] = {inv_s[ra], inv_s[rb], inv_s[ra], inv_s[rb]};
        quant4(f, sc, iv, a[j]);
      } else {
        a[j][0] = *reinterpret_cast<const uint32_t*>(xa + o_lo);
        a[j][1] = *reinterpret_cast<const uint32_t*>(xb + o_lo);
        a[j][2] = *reinterpret_cast<const uint32_t*>(xa + o_hi);
        a[j][3] = *reinterpret_cast<const uint32_t*>(xb + o_hi);
      }
    }
  };

  int acc[BN / 2];  // n8 tile nt: acc[4nt + i], the m16n8 C layout
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  uint32_t a_cur[4][4], a_next[4][4];

  // Steps 0 and 1 (and resident xq, and every scale) visible to all.
  cp_async_wait<kRing - 2>();
  __syncthreads();
  make_a(0, a_cur);

  for (int s = 0; s < steps; ++s) {
    // Invariant: steps <= s + 1 are visible; a_cur holds step s.
    const uint32_t w_slot = smem_addr(w_s + (s % kRing) * L::kWSlot);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int nt = 0; nt < BN / 8; nt += 2) {
        // matrices: tiles nt / nt + 1 x k bytes 32j .. + 15 / 32j + 16 ..
        const int q = lane >> 3;
        const int n = 8 * (nt + (q >> 1)) + (lane & 7);
        uint32_t b[4];
        ldmatrix_x4(b, w_slot + n * kStep + (((2 * j + (q & 1)) ^ (n & 7)) << 4));
        int (&d0)[4] = *reinterpret_cast<int (*)[4]>(acc + 4 * nt);
        int (&d1)[4] = *reinterpret_cast<int (*)[4]>(acc + 4 * nt + 4);
        mma_s8(d0, a_cur[j][0], a_cur[j][1], a_cur[j][2], a_cur[j][3], b[0], b[1]);
        mma_s8(d1, a_cur[j][0], a_cur[j][1], a_cur[j][2], a_cur[j][3], b[2], b[3]);
      }
    // the A fragments of step s + 1 (ldmatrix, or quantized from x)
    if (s + 1 < steps) make_a(s + 1, a_next);
    // every warp is done with step s (its slot may be refilled) and
    // step s + 2 has landed
    cp_async_wait<kRing - 3>();
    __syncthreads();
    if (s + kRing < steps) {
      load_w(s + kRing);
      if (!resident) load_x(s + kRing);
    }
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) a_cur[j][i] = a_next[j][i];
  }

  // --- epilogue: c0, c1 -> row g, columns 2t, 2t + 1; c2, c3 -> row g + 8 ---
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + r0 + g + 8 * half;
    if (r >= p.m) continue;
    const float rsv = scale_s[r0 + g + 8 * half];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int col = n0 + 8 * nt + 2 * t;
      if (col >= p.n) continue;  // N even: col + 1 < N as well
      const int a0 = acc[4 * nt + 2 * half], a1 = acc[4 * nt + 2 * half + 1];
      if constexpr (std::is_same<OutT, int>::value) {
        *reinterpret_cast<int2*>(out + (long long)r * p.n + col) = make_int2(a0, a1);
      } else {
        const float2 wv = *reinterpret_cast<const float2*>(ws + col);
        store_pair(out + (long long)r * p.n + col, dequant(a0, rsv, wv.x), dequant(a1, rsv, wv.y));
      }
    }
  }
}

// How a wide launch runs: xq resident or x streamed, and the cluster.
struct WidePlan {
  bool resident;
  int cluster;
  size_t smem;
};
template <typename XT, int BN>
WidePlan wide_plan(const Params& p) {
  using L = Wide<XT, BN>;
  constexpr bool kQuant = !std::is_same<XT, int8_t>::value;
  const int steps = (p.k + kStep - 1) / kStep;
  const int tiles = (p.n + BN - 1) / BN;
  // the largest cluster (at most 8 CTAs, the portable size) that divides
  // the CTAs along N: they quantize their rows once between them
  int csize = 1;
  for (int c = 8; kQuant && c > 1; --c)
    if (tiles % c == 0) {
      csize = c;
      break;
    }
  const bool can = (!kQuant || (std::is_same<XT, __nv_bfloat16>::value && csize > 1 &&
                                steps * kStep <= kShareUnits * 32 * 16)) &&
                   L::smem(true, steps) <= static_cast<size_t>(kMaxSmem);
  WidePlan w;
  w.resident = can;
  w.cluster = w.resident ? csize : 1;
  w.smem = L::smem(w.resident, steps);
  return w;
}

template <typename XT, typename OutT, int BN>
cudaError_t launch_wide(Params p, int layers, cudaStream_t s) {
  auto kernel = w8a8_wide_kernel<XT, OutT, BN>;
  const WidePlan plan = wide_plan<XT, BN>(p);
  p.resident = plan.resident;
  p.cluster = plan.cluster;
  // Once per instantiation, at its first (uncaptured) launch, to the most
  // a block may use: later launches make no attribute call.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + kWideRows - 1) / kWideRows, layers);
  if (p.cluster == 1) {
    kernel<<<grid, kWideThreads, plan.smem, s>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.cluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
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
    static int per_sm = -1, sms = 0;
    if (per_sm < 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, 128, 8 * TILES * static_cast<size_t>(64 * STEPS + 16) + (16 * TILES + 1) * 4);
    }
    if (static_cast<long long>(ntiles) * p.splits > static_cast<long long>(per_sm) * sms)
      return cudaErrorCooperativeLaunchTooLarge;  // nothing launched
  }
  kernel<<<dim3(ntiles, p.splits, layers), 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename XT, typename OutT>
cudaError_t launch(const Params& p, int layers, long long part_cap,
                   long long count_cap, cudaStream_t s) {
  cudaError_t err = cudaErrorCooperativeLaunchTooLarge;
  if (p.m <= 8 && p.k <= 1024)
    err = launch_narrow<XT, OutT, 1, 16>(p, layers, part_cap, count_cap, s);
  else if (p.m <= 8)
    err = launch_narrow<XT, OutT, 1, 8>(p, layers, part_cap, count_cap, s);
  else if (p.m <= 16)
    err = launch_narrow<XT, OutT, 2, 8>(p, layers, part_cap, count_cap, s);
  else if (p.m <= 32)
    err = launch_narrow<XT, OutT, 4, 8>(p, layers, part_cap, count_cap, s);
  // M > 32, or a narrow split whose CTAs cannot all be resident for the
  // scale exchange (a long K over many column tiles: Phi-2's lm_head,
  // 2560 -> 51200 at M = 1, is 800 tiles x 5 slices): the wide design,
  // which exchanges nothing between CTAs along N but the cluster's rows.
  if (err == cudaErrorCooperativeLaunchTooLarge)
    return launch_wide<XT, OutT, kWideCols>(p, layers, s);
  return err;
}

template <typename XT>
cudaError_t dispatch_out(const Params& p, int layers, int out_dtype,
                         long long part_cap, long long count_cap, cudaStream_t s) {
  switch (out_dtype) {
    case 0: return launch<XT, __nv_bfloat16>(p, layers, part_cap, count_cap, s);
    case 1: return launch<XT, float>(p, layers, part_cap, count_cap, s);
    case 2:  // the int32 accumulator, no dequant: xq given only
      if constexpr (std::is_same<XT, int8_t>::value)
        return launch<XT, int>(p, layers, part_cap, count_cap, s);
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
  p.resident = 0;
  p.cluster = 1;
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
// M <= 32 (left zeroed; null: no split). K % 16 == 0, N even, pointers
// 16-byte aligned (the wrapper checks shapes; PyTorch allocations are
// aligned; a K not a multiple of 16 is zero-padded by the caller, once for
// the weight and inside the quantization for x). Returns a cudaError_t.
extern "C" int vla_w8a8_matmul(
    const void* x, const void* rs, const void* w, const void* ws, void* out,
    int m, int n, int k, int layer0, int layers,
    long long x_ls, long long rs_ls, long long w_ls, long long ws_ls,
    long long o_ls, int x_dtype, int out_dtype, void* part, void* count,
    long long part_cap, long long count_cap, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 2 || layers <= 0 ||
      (x_dtype == 0 && rs == nullptr && out_dtype != 2) || (out_dtype == 2 && x_dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(x, rs, w, ws, out, m, n, k, layer0, x_ls, rs_ls,
                               w_ls, ws_ls, o_ls, part, count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return dispatch_out<int8_t>(p, layers, out_dtype, part_cap, count_cap, s);
    case 1: return dispatch_out<__nv_bfloat16>(p, layers, out_dtype, part_cap, count_cap, s);
    case 2: return dispatch_out<float>(p, layers, out_dtype, part_cap, count_cap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
