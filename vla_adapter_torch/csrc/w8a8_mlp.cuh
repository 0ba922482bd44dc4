// The w8a8 MLP panel walk, spread over the card: the device code shared by
// fused_mlp_w8a8.cu (kernels B2/B3) and megalayer_w8a8.cu (kernel B6).
//
//   for each block_f-wide panel of F:
//     g  = float(xq @ W1_panel^T) * rs * s1 (+ b1)
//     h  = act(g)                  or act(g) * (float(xq @ Wu^T) * rs * su)
//     h  = 0 in columns >= F       (the ragged tail panel)
//     hq, hs = quantize_rows(h)    per (token, panel)
//     acc += float(hq @ W2_panel^T) * hs      float32, panels in order
//
// block_f = 512 is part of the numerics (h is re-quantized per panel), not
// a tile size.
//
// Work items. The kernels run a persistent grid of 8-warp CTAs (one per
// SM, two for the plain MLP below K ~ 1200) that take work items from an
// atomic ticket, in
// an order where every item waits only on items with earlier tickets:
// those are already taken by running CTAs, so no wait can deadlock,
// whether or not every CTA is resident. The MLP's items:
// * up (32-row tile, panel): the tile's xq rows (written by an earlier
//   item) resident in shared memory, the panel's up product(s) over the
//   whole K, the dequantization and activation, the row absmax over the
//   panel, and hq (int8) and hs (float32) written to a scratch in device
//   memory (L2-resident: 3.1 MB of hq at the Qwen2 shape, M = 640);
// * down (64-row tile, 128 output columns): waits until both 32-row tiles
//   have every panel in the scratch, then walks the panels in order, the
//   panel's int32 product exact, its float(part) * hs added into a float32
//   accumulator in registers that starts at zero: the plain version's sum
//   in its order, with no partial buffers and no float atomics.
// Ready counters are int32 atomics in a per-device scratch that the last
// CTA to leave zeroes for the next launch; a wait that never ends traps.
//
// Products. mma.sync.m16n8k32 (s8 x s8 -> s32); a warp computes 16 MT
// rows x 16 columns (each weight fragment serves MT m16 tiles, each A
// fragment both n8 tiles), the CTA's 8 warps 128 columns of a weight tile.
// Weight tiles (128 rows x 128 bytes of k) stream through a ring of 3 or 4
// slots fed by cp.async, 2 or 3 steps ahead of the tensor cores; the up
// item holds its 32 rows of xq for the whole K, the down item streams its
// 64 hq rows through the ring beside W2. Shared-memory rows are 128 bytes
// with the 16-byte units swizzled by (row % 8): conflict-free ldmatrix. An
// up item walks its panel in chunks of 128 columns and keeps h (32 x 512
// float32, 64 values a thread) in registers until the panel's row absmax
// is known; hq is staged through the idle ring and written out in 16-byte
// stores. Every row quantization (x, h, and B6's ctx and h2) takes the
// correctly rounded quotient without a division (quant_bits).
//
// What bounds it on an H100 (timed per item with %globaltimer stamps in a
// probe): neither the tensor cores nor HBM. An up item spends a large
// share of its time in ring steps whose copies have not landed (one CTA of
// 8 warps per SM keeps only a few steps in flight), a similar share in
// ldmatrix + mma.sync (each warp loads its own A and B fragments through
// the register file), and a smaller one in the activation; at B=1 the tail
// is the items that one wave of CTAs cannot hold (the Qwen2 MLP: 20 + 200
// items before the first down item on 132 CTAs) and the down items that
// wait for them.
//
// Numerics. __fmul_rn / __fadd_rn / __fdiv_rn keep every product, sum and
// quotient a separate rounding (nvcc would contract a*b + c into an FMA),
// and "gelu" is the A&S 7.1.26 erf polynomial of the TPU kernel (_erf),
// not erff. expf/tanhf are the CUDA math library's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vla_w8a8 {

constexpr int kBM = 32;         // rows of an up item: two m16 tiles
constexpr int kBMd = 64;        // rows of a down item: four m16 tiles
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 128;     // weight rows per tile: 16 per warp
constexpr int kStep = 128;      // bytes of k per ring step
constexpr int kMaxPanel = 512;
constexpr int kMaxChunks = kMaxPanel / kTileN;
constexpr int kMaxSmem = 232448;  // shared memory a block may use

enum Act { kSilu = 0, kGelu = 1, kGeluTanh = 2, kQuickGelu = 3 };

__host__ __device__ constexpr int round_up(int n, int to) { return (n + to - 1) / to * to; }

// Ring slots: 4 for the gated MLP (one CTA per SM, two weights per step),
// 3 for the plain one, whose CTAs then fit two to an SM at the serving
// shapes below K ~ 1200 (the kernel's launch bounds cap them at 128
// registers a thread), which hides more of each step's copy latency.
__host__ __device__ constexpr int ring_depth(bool gated) { return gated ? 4 : 3; }

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously (L2 only); zeros where !pred.
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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Byte offset of 16-byte unit c of row r in a tile of 128-byte rows.
__device__ __forceinline__ int swz(int r, int c) { return r * kStep + ((c ^ (r & 7)) << 4); }

// Four consecutive values (16-byte aligned for f32, 8 for bf16) as float.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
}

__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// clip(round_half_even(f / scale), -127, 127) for a value of a row quantized
// with its own absmax, bits as __fdiv_rn would give them, without a division. With inv = 1 / scale rounded to nearest,
// y0 = f * inv is within an ulp of f / scale, the residual f - y0 * scale
// is exact in one FMA, and y0 + residual * inv rounded once is the
// correctly rounded quotient (Markstein's theorem for division with an
// FMA), which __fdiv_rn computes. Ties of that quotient at a half-integer
// are common in bf16 data (x = +-absmax / 2 among them), so the rounding
// must start from it and not from y0. The clip never acts: |f| <= absmax
// and scale >= absmax / 127 rounded down by at most an ulp, so
// |f / scale| < 127.0001 rounds into [-127, 127].
// Adding 1.5 * 2^23 rounds a float of magnitude < 2^22 to an integer,
// half to even (the ulp there is 1), and leaves that integer in the low
// mantissa bits: its low byte is the int8 in two's complement.
constexpr float kRound = 12582912.0f;

__device__ __forceinline__ uint32_t quant_bits(float f, float scale, float inv) {
  const float y0 = __fmul_rn(f, inv);
  const float y = __fmaf_rn(__fmaf_rn(-y0, scale, f), inv, y0);
  return __float_as_uint(__fadd_rn(y, kRound));
}

// The low byte of each of four words, packed into one.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}


// max(absmax, 1e-8) / 127
__device__ __forceinline__ float row_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-8f), 127.0f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// erf by Abramowitz & Stegun 7.1.26, the TPU kernel's _erf, op for op.
__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float a = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, a)));
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fadd_rn(0.254829592f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  return __fmul_rn(s, __fsub_rn(1.0f, __fmul_rn(poly, expf(__fmul_rn(-a, a)))));
}

template <int ACT>
__device__ __forceinline__ float activation(float x) {
  if (ACT == kSilu) return __fmul_rn(x, sigmoid(x));
  if (ACT == kGelu)  // 0.5 x (1 + erf(x 2^-0.5))
    return __fmul_rn(__fmul_rn(0.5f, x),
                     __fadd_rn(1.0f, erf_as(__fmul_rn(x, 0.70710678118654752f))));
  if (ACT == kGeluTanh) {  // x (0.5 (1 + tanh(c (x + 0.044715 x^3))))
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float inner = __fmul_rn(0.79788456080286536f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
    return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
  }
  return __fmul_rn(x, sigmoid(__fmul_rn(1.702f, x)));  // quick_gelu
}

// One warp quantizes up to four rows at once, row i when live & (1 << i):
// load4v(i, c, f) fills f with values c .. c + 3 of row i (n % 4 == 0);
// store4(i, c, packed) takes the int8 of values c .. c + 3 of row i, zeros
// from n up to kpad and for rows not live. scale[i] = max(absmax, 1e-8) /
// 127 of row i, on every lane. The rows' loads are interleaved, so four
// rows take about as long as one.
template <typename Load4, typename Store4>
__device__ __forceinline__ void quantize_rows4(int live, int n, int kpad, Load4 load4v,
                                               Store4 store4, float (&scale)[4]) {
  const int lane = threadIdx.x % 32;
  auto load = [&](int c, float (&f)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (live & (1 << i)) {
        load4v(i, c, f[i]);
      } else {
        f[i][0] = f[i][1] = f[i][2] = f[i][3] = 0.0f;
      }
    }
  };
  float amax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int c = 4 * lane; c < n; c += 128) {
    float f[4][4];
    load(c, f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) amax[i] = fmaxf(amax[i], fabsf(f[i][e]));
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    scale[i] = row_scale(warp_max(amax[i]));
    inv[i] = __frcp_rn(scale[i]);
  }
#pragma unroll 4
  for (int c = 4 * lane; c < kpad; c += 128) {
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (c < n) {
      float f[4][4];
      load(c, f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        packed[i] = low_bytes(quant_bits(f[i][0], scale[i], inv[i]),
                              quant_bits(f[i][1], scale[i], inv[i]),
                              quant_bits(f[i][2], scale[i], inv[i]),
                              quant_bits(f[i][3], scale[i], inv[i]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) store4(i, c, packed[i]);
  }
}

// Four bf16 values c .. c + 3 (8-byte aligned) through L2, as float.
__device__ __forceinline__ void load4_cg(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
}

// The warp's 16 MT rows x 16 columns over one 128-byte k step: a_step
// holds the warp's 16 MT rows of A, w[i] weight tile i, whose rows wrow ..
// wrow + 15 the warp takes, all swizzled. acc[i][mt][nt] is the m16n8 C
// fragment of rows 16 mt + (g, g + 8), columns 8 nt + (2t, 2t + 1) of the
// warp's 16.
template <int NW, int MT>
__device__ __forceinline__ void step_mma(uint32_t a_step, const uint32_t (&w)[NW], int wrow,
                                         int (&acc)[NW][MT][2][4]) {
  const int lane = threadIdx.x % 32;
  const int q = lane >> 3;
  const int n = wrow + 8 * (q >> 1) + (lane & 7);
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // k bytes 32j .. 32j + 31
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = 16 * mt + (lane & 7) + 8 * (q & 1);
      ldsm_x4(a[mt], a_step + swz(r, 2 * j + (q >> 1)));
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint32_t b[4];
      ldsm_x4(b, w[i] + swz(n, 2 * j + (q & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_s8(acc[i][mt][0], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0], b[1]);
        mma_s8(acc[i][mt][1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[2], b[3]);
      }
    }
  }
}

template <int NW, int MT>
__device__ __forceinline__ void zero(int (&acc)[NW][MT][2][4]) {
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][mt][nt][e] = 0;
}

// Stage rows [n0, n0 + 128) x k bytes [k0, k0 + 128) of an int8 (rows, ld)
// matrix into a swizzled tile; zeros where the row reaches `rows`, or the
// k offset within the window reaches klim, or k reaches kend.
__device__ __forceinline__ void stage_w(uint32_t tile, const int8_t* w, long long ld, int n0,
                                        int rows, int k0, int klim, int kend) {
#pragma unroll
  for (int i = 0; i < kTileN * 8 / kThreads; ++i) {
    const int u = threadIdx.x + kThreads * i;
    const int r = u >> 3;
    const int c = u & 7;
    const int kk = 16 * c;
    const bool ok = n0 + r < rows && kk < klim && k0 + kk < kend;
    cp_async16(tile + swz(r, c), ok ? w + (long long)(n0 + r) * ld + k0 + kk : w, ok);
  }
}

// Stage `rows` rows from row0 of an int8 (M, ld) matrix, all of its k0 ..
// k0 + 127, into a swizzled tile; zeros for rows >= M.
__device__ __forceinline__ void stage_rows(uint32_t tile, const int8_t* a, long long ld,
                                           int row0, int rows, int m, int k0) {
  for (int u = threadIdx.x; u < rows * 8; u += kThreads) {
    const int r = u >> 3;
    const int c = u & 7;
    const bool ok = row0 + r < m;
    cp_async16(tile + swz(r, c), ok ? a + (row0 + r) * ld + k0 + 16 * c : a, ok);
  }
}

// What the kernels share about one MLP: weights in the PyTorch (out, in)
// layout, W1/Wu (F, K), W2 (D, F), int8, and the scratch the stages pass
// on: xq and rs (the quantized input rows, from an earlier stage), hq and
// hs (from the up items), with their ready counters.
struct Mlp {
  const int8_t* w1;   // (F, K)  gate or fc1
  const float* s1;    // (F)
  const int8_t* wu;   // (F, K)  up, gated only
  const float* su;    // (F)
  const float* b1;    // (F) or null
  const int8_t* w2;   // (D, F)  down or fc2
  const float* s2;    // (D)
  const float* b2;    // (D) or null
  const int8_t* xq;   // (M, kpad) scratch: zeros from K up
  const float* rs;    // (M) scratch
  int8_t* hq;         // (M, panels * pw) scratch: each panel padded to pw
  float* hs;          // (M, panels) scratch
  int* ready_x;       // (up row tiles) 1 once the tile's xq and rs are in
  int* ready_h;       // (up row tiles) panels of each tile in hq / hs
  int m, k, f, d, block_f;
  int kpad;           // K rounded up to kStep
  int panels;         // ceil(F / block_f)
  int pw;             // block_f rounded up to kStep
};

// Shared memory of an MLP stage, in the kernels' order: a resident A tile
// (kBM rows of kpad bytes: xq), the ring, the down item's panel scales, the
// cross-warp absmax and the row scales.
struct MlpSmem {
  unsigned char* xq;
  unsigned char* ring;
  int slot;           // bytes per ring slot
  float* hs;          // kBMd x panels
  float* red;         // kWarps x kBM
  float* rs;          // kBM
};

// A ring slot holds an up step (128 rows of W1, and of Wu) or a down step
// (64 rows of hq and 128 rows of W2).
__host__ __device__ constexpr int ring_slot(bool gated) {
  return (gated ? 2 : 1) * kTileN * kStep > (kBMd + kTileN) * kStep
             ? (gated ? 2 : 1) * kTileN * kStep
             : (kBMd + kTileN) * kStep;
}

__host__ __device__ inline size_t mlp_smem_bytes(int kpad, int panels, bool gated) {
  return static_cast<size_t>(kBM) * kpad +
         static_cast<size_t>(ring_depth(gated)) * ring_slot(gated) +
         sizeof(float) * (static_cast<size_t>(kBMd) * panels + kWarps * kBM + kBM);
}

__device__ __forceinline__ MlpSmem carve_mlp(unsigned char* base, int kpad, int panels,
                                             bool gated) {
  MlpSmem s;
  s.xq = base;
  s.ring = s.xq + kBM * kpad;
  s.slot = ring_slot(gated);
  s.hs = reinterpret_cast<float*>(s.ring + ring_depth(gated) * s.slot);
  s.red = s.hs + kBMd * panels;
  s.rs = s.red + kWarps * kBM;
  return s;
}

// Byte offset of byte c of row r in a resident A tile of kBM rows.
__device__ __forceinline__ int a_at(int r, int c) {
  return (c / kStep) * (kBM * kStep) + swz(r, (c % kStep) / 16) + c % 16;
}

// ------------------------------------------------------------ the tickets

// counters[0]: the next ticket; counters[1]: CTAs done; then the ready
// counters, zeroed with both by the last CTA to leave.
__device__ __forceinline__ int next_ticket(int* counters, int* slot) {
  __syncthreads();  // every thread has read the previous ticket
  if (threadIdx.x == 0) *slot = atomicAdd(counters, 1);
  __syncthreads();
  return *slot;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every thread returns once *c >= target; the writes that preceded the
// signals are then visible (read them through L2: __ldcg or cp.async.cg).
// A wait that outlasts any real one (~2^26 polls, seconds) traps: a fault
// to report, not a hung card.
__device__ __forceinline__ void wait_count(const int* c, int target) {
  if (threadIdx.x == 0) {
    long long spin = 0;
    while (load_acquire(c) < target) {
      __nanosleep(64);
      if (++spin > (1ll << 26)) __trap();
    }
  }
  __syncthreads();
}

// After every thread's writes of an item: one more on *c.
__device__ __forceinline__ void signal(int* c) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(c, 1);
  }
}

// Called by every CTA once it has no more items: the last one zeroes the
// ticket, the exit count and the n ready counters for the next launch.
__device__ __forceinline__ void leave(int* counters, int n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      for (int i = 0; i < n; ++i) counters[2 + i] = 0;
      counters[0] = 0;
      counters[1] = 0;
      __threadfence();
    }
  }
}

// ------------------------------------------------------------- up items

// Up item (32-row tile rt, panel): waits for the tile's xq and rs, then
// hq and hs of the panel for the tile's rows into the scratch, then one
// more on p.ready_h[rt]. Warp w computes columns 16w .. 16w + 15 of each
// 128-column chunk for all 32 rows. Every thread calls it.
template <int ACT, bool GATED>
__device__ __forceinline__ void up_item(const Mlp& p, const MlpSmem& s, int rt, int panel) {
  constexpr int NW = GATED ? 2 : 1;
  constexpr int kRing = ring_depth(GATED);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = rt * kBM;
  const int f0 = panel * p.block_f;
  const int chunks = p.pw / kTileN;
  const int ksteps = p.kpad / kStep;
  const int steps = chunks * ksteps;
  const uint32_t ring = smem_u32(s.ring);
  const uint32_t xq = smem_u32(s.xq);

  auto load = [&](int st) {
    if (st < steps) {
      const int c = st / ksteps;
      const int k0 = (st % ksteps) * kStep;
      const uint32_t slot = ring + (st % kRing) * s.slot;
      // rows f0 + 128c + r of W1 (and Wu), the panel's columns only
      const int n0 = f0 + kTileN * c;
      const int rows = min(p.f, f0 + p.block_f);
      stage_w(slot, p.w1, p.k, n0, rows, k0, kStep, p.k);
      if (GATED) stage_w(slot + kTileN * kStep, p.wu, p.k, n0, rows, k0, kStep, p.k);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) load(st);
  // the tile's xq rows (resident for the whole K) and scales
  wait_count(p.ready_x + rt, 1);
  for (int ks = 0; ks < ksteps; ++ks)
    stage_rows(xq + ks * (kBM * kStep), p.xq, p.kpad, row0, kBM, p.m, ks * kStep);
  cp_async_commit();
  if (threadIdx.x < kBM) {
    const int r = threadIdx.x;
    s.rs[r] = row0 + r < p.m ? __ldcg(p.rs + row0 + r) : 1.0f;
  }

  float h[kMaxChunks][2][2][4];
  int st = 0;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c >= chunks) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) h[c][mt][nt][i] = 0.0f;
      continue;
    }
    int acc[NW][2][2][4];
    zero(acc);
    for (int ks = 0; ks < ksteps; ++ks, ++st) {
      if (st == 0)
        cp_async_wait<0>();  // xq, issued after the first weight steps
      else
        cp_async_wait<kRing - 2>();  // this thread's copies of step st landed
      __syncthreads();               // everyone's, and step st - 1 is done
      load(st + kRing - 1);          // into the slot step st - 1 used
      const uint32_t slot = ring + (st % kRing) * s.slot;
      uint32_t w[NW];
      w[0] = slot;
      if (GATED) w[NW - 1] = slot + kTileN * kStep;
      step_mma<NW, 2>(xq + ks * (kBM * kStep), w, 16 * warp, acc);
    }
    // dequantize, bias, activation (* up); columns past the panel or F are
    // exact zeros
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int local = kTileN * c + 16 * warp + 8 * nt + 2 * t + (i & 1);
          const int col = f0 + local;
          float v = 0.0f;
          if (local < p.block_f && col < p.f) {
            const float rs = s.rs[16 * mt + g + 8 * (i >> 1)];
            float gv = __fmul_rn(__fmul_rn(__int2float_rn(acc[0][mt][nt][i]), rs), p.s1[col]);
            if (p.b1 != nullptr) gv = __fadd_rn(gv, p.b1[col]);
            v = activation<ACT>(gv);
            if (GATED)
              v = __fmul_rn(v, __fmul_rn(__fmul_rn(__int2float_rn(acc[NW - 1][mt][nt][i]), rs),
                                         p.su[col]));
          }
          h[c][mt][nt][i] = v;
        }
  }

  // --- the panel's row absmax across the warps -> hs ---
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float m = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          m = fmaxf(m, fmaxf(fabsf(h[c][mt][nt][2 * hi]), fabsf(h[c][mt][nt][2 * hi + 1])));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) s.red[warp * kBM + 16 * mt + 8 * hi + g] = m;
    }
  cp_async_wait<0>();
  __syncthreads();  // every warp's absmax is in, and the ring is idle
  float hs[2][2], hinv[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = 16 * mt + 8 * hi + g;
      float m = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s.red[w * kBM + r]);
      hs[mt][hi] = row_scale(m);
      hinv[mt][hi] = __frcp_rn(hs[mt][hi]);
      if (warp == 0 && t == 0 && row0 + r < p.m)
        p.hs[(long long)(row0 + r) * p.panels + panel] = hs[mt][hi];
    }

  // --- hq: staged in the idle ring (32 x pw bytes), then 16-byte stores ---
  unsigned char* stage = s.ring;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c >= chunks) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = 16 * mt + 8 * hi + g;
          const int local = kTileN * c + 16 * warp + 8 * nt + 2 * t;
          const uint32_t q = low_bytes(quant_bits(h[c][mt][nt][2 * hi], hs[mt][hi], hinv[mt][hi]),
                                       quant_bits(h[c][mt][nt][2 * hi + 1], hs[mt][hi],
                                                  hinv[mt][hi]),
                                       0u, 0u);
          *reinterpret_cast<uint16_t*>(stage + r * p.pw + local) = static_cast<uint16_t>(q);
        }
  }
  __syncthreads();
  const int units = p.pw / 16;
  const long long ld = static_cast<long long>(p.panels) * p.pw;
  for (int u = threadIdx.x; u < kBM * units; u += kThreads) {
    const int r = u / units;
    const int c = u % units;
    if (row0 + r < p.m)
      *reinterpret_cast<uint4*>(p.hq + (row0 + r) * ld + panel * p.pw + 16 * c) =
          *reinterpret_cast<const uint4*>(stage + r * p.pw + 16 * c);
  }
  signal(p.ready_h + rt);
}

// ----------------------------------------------------------- down items

// Down item (64-row tile rt, column tile ct): waits for every panel of the
// two 32-row up tiles it covers, then acc = sum over panels, in order, of
// float(hq @ W2^T) * hs for the tile's 64 rows and 128 columns (warp w:
// columns 16w .. 16w + 15), and calls epi(row, col, a0, a1) for rows < M
// and the column pairs col, col + 1 < D. Every thread calls it.
template <bool GATED, typename Epi>
__device__ __forceinline__ void down_item(const Mlp& p, const MlpSmem& s, int rt, int ct,
                                          Epi epi) {
  constexpr int MT = kBMd / 16;
  constexpr int kRing = ring_depth(GATED);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = rt * kBMd;
  const int n0 = ct * kTileN;
  const int psteps = p.pw / kStep;
  const int steps = p.panels * psteps;
  const long long ld = static_cast<long long>(p.panels) * p.pw;
  const uint32_t ring = smem_u32(s.ring);

  auto load = [&](int st, bool rows) {
    if (st < steps) {
      const int panel = st / psteps;
      const int kk = (st % psteps) * kStep;
      const uint32_t slot = ring + (st % kRing) * s.slot;
      // W2 rows n0 .. n0 + 127 over the panel's k window, then the tile's
      // hq rows
      stage_w(slot + kBMd * kStep, p.w2, p.f, n0, p.d, panel * p.block_f + kk, p.block_f - kk,
              p.f);
      if (rows) stage_rows(slot, p.hq, ld, row0, kBMd, p.m, panel * p.pw + kk);
    }
    cp_async_commit();
  };
  // W2 steps before the wait; their hq rows once the panels are in
#pragma unroll
  for (int st = 0; st < kRing - 1; ++st) load(st, false);
  for (int tile = 2 * rt; tile < min(2 * rt + 2, (p.m + kBM - 1) / kBM); ++tile)
    wait_count(p.ready_h + tile, p.panels);
  for (int st = 0; st < kRing - 1 && st < steps; ++st)
    stage_rows(ring + (st % kRing) * s.slot, p.hq, ld, row0, kBMd, p.m,
               (st / psteps) * p.pw + (st % psteps) * kStep);
  cp_async_commit();
  for (int i = threadIdx.x; i < kBMd * p.panels; i += kThreads)
    s.hs[i] = row0 + i / p.panels < p.m ? __ldcg(p.hs + (long long)row0 * p.panels + i) : 0.0f;

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  int st = 0;
  for (int panel = 0; panel < p.panels; ++panel) {
    int part[1][MT][2][4];
    zero(part);
    for (int ks = 0; ks < psteps; ++ks, ++st) {
      if (st == 0)
        cp_async_wait<0>();
      else
        cp_async_wait<kRing - 2>();
      __syncthreads();
      load(st + kRing - 1, true);
      const uint32_t slot = ring + (st % kRing) * s.slot;
      const uint32_t w[1] = {slot + kBMd * kStep};
      step_mma<1, MT>(slot, w, 16 * warp, part);
    }
    // acc += float(part) * hs, panel by panel
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float hs = s.hs[(16 * mt + g + 8 * (i >> 1)) * p.panels + panel];
          acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i],
                                     __fmul_rn(__int2float_rn(part[0][mt][nt][i]), hs));
        }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 16 * mt + 8 * hi + g;
      if (row >= p.m) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + 16 * warp + 8 * nt + 2 * t;
        if (col < p.d) epi(row, col, acc[mt][nt][2 * hi], acc[mt][nt][2 * hi + 1]);
      }
    }
}

}  // namespace vla_w8a8
