// The wgmma tile machinery of the port's attention kernels for Hopper
// (sm_90a): B1's forward (fused_attention.cu) and its backward
// (attention_bwd.cu). Tiles of 64 rows of a head dim padded to DP (a
// multiple of 16), written by TMA in swizzled column chunks; the product
// chains over them (both operands in shared memory, or A in registers);
// the register fragments' conversions; the turn barriers of two consumer
// warpgroups; and the host's tensor-map encoding of a (B, H, S, D) operand.
//
// Layouts. Every tile is 64 rows of the head dim padded to DP, written by
// TMA in column chunks of CW = 64, 32 or 16 bf16 with the 128-, 64- or
// 32-byte swizzle (the widest that divides DP), each chunk its own
// 1024-aligned region: TMA does the swizzle, so wgmma's descriptors match
// it by construction. D = 72 (so400m) pads to 80, which no 128-byte row
// holds: it takes 32-byte chunks (five per tile). Products that contract
// over the head dim read the tiles K-major (a k-step advances 32 bytes
// inside a chunk row, or to the next chunk); products that contract over
// rows read the same tiles MN-major (the transpose bit; LBO = the next
// chunk along the head dim, SBO = the next 8 rows).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace vla_attention {

using namespace vla_hopper;

// The softmax terms of a tile come in two forms, chosen per warp: without
// masks (every key allowed for every row: most tiles) and with them. As one
// loop with a per-score test, ptxas kept the tests (and a branch each) on
// every tile: 600 instructions where the math is 200.
using Open = std::false_type;
using Masked = std::true_type;

constexpr int kTile = 64;          // query rows or keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;   // shared memory a block may use

// Shared-memory tiles of 64 rows x DP bf16 in TMA column chunks.
template <int DP>
struct Tile {
  static constexpr int kCW = DP % 64 == 0 ? 64 : DP % 32 == 0 ? 32 : 16;
  static constexpr int kChunks = DP / kCW;
  static constexpr int kRowBytes = kCW * 2;
  static constexpr int kRegion = kTile * kRowBytes;  // one chunk, 1024-aligned
  static constexpr int kBytes = kChunks * kRegion;
  static constexpr int kSbo = 8 * kRowBytes;         // the next 8 rows
  // wgmma descriptor layout: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t kMode = kCW == 64 ? 1 : kCW == 32 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kCW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                : kCW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

// A 64-row tile at (row0, head, batch) of a 4-d (D, S, H, B) tensor map,
// chunk by chunk, completing on `bar`.
template <int DP>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int row0, int head, int batch, uint32_t bar) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
#pragma unroll
  for (int c = 0; c < Tile<DP>::kChunks; ++c) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst + c * Tile<DP>::kRegion), "l"(desc), "r"(c * Tile<DP>::kCW),
           "r"(row0), "r"(head), "r"(batch), "r"(bar)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// wgmma

// A tile read K-major (contracted over the head dim): k-step kk covers
// dims 16kk .. 16kk + 15, in chunk 16kk / CW.
template <int DP>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using T = Tile<DP>;
  const uint32_t addr = tile + (kk * 16 / T::kCW) * T::kRegion + (kk * 16 % T::kCW) * 2;
  return make_desc(addr, 16, T::kSbo, T::kMode);
}
// A tile read MN-major (contracted over its rows, N = the head dim):
// k-step kk covers rows 16kk .. 16kk + 15.
template <int DP>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using T = Tile<DP>;
  return make_desc(tile + kk * 16 * T::kRowBytes, T::kRegion, T::kSbo, T::kMode);
}

// Keep the compiler from moving accumulator registers across the async
// product (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments that an in-flight product reads.
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

#define VLA_ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VLA_R8(a, b, c, e, f, g, h, i) \
  "%" #a ", %" #b ", %" #c ", %" #e ", %" #f ", %" #g ", %" #h ", %" #i
#define VLA_S0 VLA_R8(0, 1, 2, 3, 4, 5, 6, 7)
#define VLA_S1 VLA_R8(8, 9, 10, 11, 12, 13, 14, 15)
#define VLA_S2 VLA_R8(16, 17, 18, 19, 20, 21, 22, 23)
#define VLA_S3 VLA_R8(24, 25, 26, 27, 28, 29, 30, 31)
#define VLA_S4 VLA_R8(32, 33, 34, 35, 36, 37, 38, 39)
#define VLA_S5 VLA_R8(40, 41, 42, 43, 44, 45, 46, 47)
#define VLA_S6 VLA_R8(48, 49, 50, 51, 52, 53, 54, 55)
#define VLA_S7 VLA_R8(56, 57, 58, 59, 60, 61, 62, 63)

#define VLA_ACC_S8 VLA_S0
#define VLA_ACC_S16 VLA_S0 ", " VLA_S1
#define VLA_ACC_S24 VLA_S0 ", " VLA_S1 ", " VLA_S2
#define VLA_ACC_S32 VLA_S0 ", " VLA_S1 ", " VLA_S2 ", " VLA_S3
#define VLA_ACC_S40 VLA_ACC_S32 ", " VLA_S4
#define VLA_ACC_S48 VLA_ACC_S32 ", " VLA_S4 ", " VLA_S5
#define VLA_ACC_S56 VLA_ACC_S32 ", " VLA_S4 ", " VLA_S5 ", " VLA_S6
#define VLA_ACC_S64 VLA_ACC_S32 ", " VLA_S4 ", " VLA_S5 ", " VLA_S6 ", " VLA_S7

// d (64 x 64, fp32) = sum over K k-steps of A_k (64 x 16) . B_k (16 x 64)^T,
// both K-major in shared memory. One asm statement for the whole chain, so
// that every operand is live at once: ptxas then issues the k-steps back
// to back instead of waiting for each before it reuses its registers.
template <int K>
struct WgmmaSS;

template <>
struct WgmmaSS<1> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint64_t (&a)[1],
                                             const uint64_t (&b)[1]) {
    asm volatile("{\n.reg .pred p, q;\nsetp.ne.b32 p, %34, 0;\nsetp.eq.b32 q, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %32, %33, p, 1, 1, 0, 0;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24)
                 : "l"(a[0]), "l"(b[0]), "r"(0));
  }
};

template <>
struct WgmmaSS<2> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint64_t (&a)[2],
                                             const uint64_t (&b)[2]) {
    asm volatile("{\n.reg .pred p, q;\nsetp.ne.b32 p, %36, 0;\nsetp.eq.b32 q, %36, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %32, %33, p, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %34, %35, q, 1, 1, 0, 0;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24)
                 : "l"(a[0]), "l"(b[0]), "l"(a[1]), "l"(b[1]), "r"(0));
  }
};

template <>
struct WgmmaSS<3> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint64_t (&a)[3],
                                             const uint64_t (&b)[3]) {
    asm volatile("{\n.reg .pred p, q;\nsetp.ne.b32 p, %38, 0;\nsetp.eq.b32 q, %38, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %32, %33, p, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %34, %35, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %36, %37, q, 1, 1, 0, 0;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24)
                 : "l"(a[0]), "l"(b[0]), "l"(a[1]), "l"(b[1]), "l"(a[2]), "l"(b[2]), "r"(0));
  }
};

template <>
struct WgmmaSS<4> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint64_t (&a)[4],
                                             const uint64_t (&b)[4]) {
    asm volatile("{\n.reg .pred p, q;\nsetp.ne.b32 p, %40, 0;\nsetp.eq.b32 q, %40, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %32, %33, p, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %34, %35, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %36, %37, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %38, %39, q, 1, 1, 0, 0;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24)
                 : "l"(a[0]), "l"(b[0]), "l"(a[1]), "l"(b[1]), "l"(a[2]), "l"(b[2]), "l"(a[3]), "l"(b[3]), "r"(0));
  }
};

template <>
struct WgmmaSS<5> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint64_t (&a)[5],
                                             const uint64_t (&b)[5]) {
    asm volatile("{\n.reg .pred p, q;\nsetp.ne.b32 p, %42, 0;\nsetp.eq.b32 q, %42, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %32, %33, p, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %34, %35, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %36, %37, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %38, %39, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %40, %41, q, 1, 1, 0, 0;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24)
                 : "l"(a[0]), "l"(b[0]), "l"(a[1]), "l"(b[1]), "l"(a[2]), "l"(b[2]), "l"(a[3]), "l"(b[3]), "l"(a[4]), "l"(b[4]), "r"(0));
  }
};

template <>
struct WgmmaSS<6> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint64_t (&a)[6],
                                             const uint64_t (&b)[6]) {
    asm volatile("{\n.reg .pred p, q;\nsetp.ne.b32 p, %44, 0;\nsetp.eq.b32 q, %44, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %32, %33, p, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %34, %35, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %36, %37, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %38, %39, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %40, %41, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %42, %43, q, 1, 1, 0, 0;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24)
                 : "l"(a[0]), "l"(b[0]), "l"(a[1]), "l"(b[1]), "l"(a[2]), "l"(b[2]), "l"(a[3]), "l"(b[3]), "l"(a[4]), "l"(b[4]), "l"(a[5]), "l"(b[5]), "r"(0));
  }
};

template <>
struct WgmmaSS<7> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint64_t (&a)[7],
                                             const uint64_t (&b)[7]) {
    asm volatile("{\n.reg .pred p, q;\nsetp.ne.b32 p, %46, 0;\nsetp.eq.b32 q, %46, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %32, %33, p, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %34, %35, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %36, %37, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %38, %39, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %40, %41, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %42, %43, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %44, %45, q, 1, 1, 0, 0;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24)
                 : "l"(a[0]), "l"(b[0]), "l"(a[1]), "l"(b[1]), "l"(a[2]), "l"(b[2]), "l"(a[3]), "l"(b[3]), "l"(a[4]), "l"(b[4]), "l"(a[5]), "l"(b[5]), "l"(a[6]), "l"(b[6]), "r"(0));
  }
};

template <>
struct WgmmaSS<8> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint64_t (&a)[8],
                                             const uint64_t (&b)[8]) {
    asm volatile("{\n.reg .pred p, q;\nsetp.ne.b32 p, %48, 0;\nsetp.eq.b32 q, %48, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %32, %33, p, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %34, %35, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %36, %37, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %38, %39, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %40, %41, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %42, %43, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %44, %45, q, 1, 1, 0, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, %46, %47, q, 1, 1, 0, 0;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24)
                 : "l"(a[0]), "l"(b[0]), "l"(a[1]), "l"(b[1]), "l"(a[2]), "l"(b[2]), "l"(a[3]), "l"(b[3]), "l"(a[4]), "l"(b[4]), "l"(a[5]), "l"(b[5]), "l"(a[6]), "l"(b[6]), "l"(a[7]), "l"(b[7]), "r"(0));
  }
};

// d (64 x N, fp32) += sum over 4 k-steps of A_k (64 x 16, registers) .
// B_k (16 x N), B MN-major in shared memory (the transpose bit set); one
// asm statement, as above.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  __device__ __forceinline__ static void run(float (&d)[8], const uint32_t (&a)[4][4],
                                             const uint64_t (&b)[4]) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %28, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" VLA_ACC_S8 "}, {%8, %9, %10, %11}, %24, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" VLA_ACC_S8 "}, {%12, %13, %14, %15}, %25, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" VLA_ACC_S8 "}, {%16, %17, %18, %19}, %26, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" VLA_ACC_S8 "}, {%20, %21, %22, %23}, %27, p, 1, 1, 1;\n"
                 "}\n"
                 : VLA_ACC8(0)
                 : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
                   "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
                   "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
                   "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
                   "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  __device__ __forceinline__ static void run(float (&d)[16], const uint32_t (&a)[4][4],
                                             const uint64_t (&b)[4]) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" VLA_ACC_S16 "}, {%16, %17, %18, %19}, %32, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" VLA_ACC_S16 "}, {%20, %21, %22, %23}, %33, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" VLA_ACC_S16 "}, {%24, %25, %26, %27}, %34, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" VLA_ACC_S16 "}, {%28, %29, %30, %31}, %35, p, 1, 1, 1;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8)
                 : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
                   "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
                   "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
                   "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
                   "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(1));
  }
};

template <>
struct WgmmaRS<48> {
  __device__ __forceinline__ static void run(float (&d)[24], const uint32_t (&a)[4][4],
                                             const uint64_t (&b)[4]) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %44, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {" VLA_ACC_S24 "}, {%24, %25, %26, %27}, %40, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {" VLA_ACC_S24 "}, {%28, %29, %30, %31}, %41, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {" VLA_ACC_S24 "}, {%32, %33, %34, %35}, %42, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {" VLA_ACC_S24 "}, {%36, %37, %38, %39}, %43, p, 1, 1, 1;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16)
                 : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
                   "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
                   "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
                   "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
                   "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t (&a)[4][4],
                                             const uint64_t (&b)[4]) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %52, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, {%32, %33, %34, %35}, %48, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, {%36, %37, %38, %39}, %49, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, {%40, %41, %42, %43}, %50, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" VLA_ACC_S32 "}, {%44, %45, %46, %47}, %51, p, 1, 1, 1;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24)
                 : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
                   "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
                   "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
                   "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
                   "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(1));
  }
};

template <>
struct WgmmaRS<80> {
  __device__ __forceinline__ static void run(float (&d)[40], const uint32_t (&a)[4][4],
                                             const uint64_t (&b)[4]) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %60, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {" VLA_ACC_S40 "}, {%40, %41, %42, %43}, %56, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {" VLA_ACC_S40 "}, {%44, %45, %46, %47}, %57, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {" VLA_ACC_S40 "}, {%48, %49, %50, %51}, %58, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {" VLA_ACC_S40 "}, {%52, %53, %54, %55}, %59, p, 1, 1, 1;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24), VLA_ACC8(32)
                 : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
                   "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
                   "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
                   "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
                   "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(1));
  }
};

template <>
struct WgmmaRS<96> {
  __device__ __forceinline__ static void run(float (&d)[48], const uint32_t (&a)[4][4],
                                             const uint64_t (&b)[4]) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" VLA_ACC_S48 "}, {%48, %49, %50, %51}, %64, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" VLA_ACC_S48 "}, {%52, %53, %54, %55}, %65, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" VLA_ACC_S48 "}, {%56, %57, %58, %59}, %66, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" VLA_ACC_S48 "}, {%60, %61, %62, %63}, %67, p, 1, 1, 1;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24), VLA_ACC8(32), VLA_ACC8(40)
                 : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
                   "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
                   "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
                   "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
                   "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(1));
  }
};

template <>
struct WgmmaRS<112> {
  __device__ __forceinline__ static void run(float (&d)[56], const uint32_t (&a)[4][4],
                                             const uint64_t (&b)[4]) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %76, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {" VLA_ACC_S56 "}, {%56, %57, %58, %59}, %72, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {" VLA_ACC_S56 "}, {%60, %61, %62, %63}, %73, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {" VLA_ACC_S56 "}, {%64, %65, %66, %67}, %74, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {" VLA_ACC_S56 "}, {%68, %69, %70, %71}, %75, p, 1, 1, 1;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24), VLA_ACC8(32), VLA_ACC8(40), VLA_ACC8(48)
                 : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
                   "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
                   "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
                   "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
                   "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t (&a)[4][4],
                                             const uint64_t (&b)[4]) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %84, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" VLA_ACC_S64 "}, {%64, %65, %66, %67}, %80, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" VLA_ACC_S64 "}, {%68, %69, %70, %71}, %81, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" VLA_ACC_S64 "}, {%72, %73, %74, %75}, %82, p, 1, 1, 1;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" VLA_ACC_S64 "}, {%76, %77, %78, %79}, %83, p, 1, 1, 1;\n"
                 "}\n"
                 : VLA_ACC8(0), VLA_ACC8(8), VLA_ACC8(16), VLA_ACC8(24), VLA_ACC8(32), VLA_ACC8(40), VLA_ACC8(48), VLA_ACC8(56)
                 : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),
                   "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),
                   "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),
                   "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),
                   "l"(b[0]), "l"(b[1]), "l"(b[2]), "l"(b[3]), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// The A fragments of a 64 x 64 fp32 accumulator, rounded to bf16: k-step
// kk takes its columns 16kk .. 16kk + 15 (the accumulator's 8-column
// groups 2kk and 2kk + 1 are the A fragment's halves).
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&v)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(v[8 * kk + 0], v[8 * kk + 1]);
    a[kk][1] = pack_bf16(v[8 * kk + 2], v[8 * kk + 3]);
    a[kk][2] = pack_bf16(v[8 * kk + 4], v[8 * kk + 5]);
    a[kk][3] = pack_bf16(v[8 * kk + 6], v[8 * kk + 7]);
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// a and b rounded to bf16 (one packed conversion) and back
__device__ __forceinline__ float2 round_bf16x2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}
// The two consumer warpgroups take turns to issue their score products
// (named barriers 1 and 2, 256 threads): one computes its softmax terms
// while the other's products run.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
}

// ---------------------------------------------------------------------------
// Host side

// A (D, S, H, B) map of a bf16 tensor with element strides (sb, sh, ss),
// boxes of CW x 64 rows, the chunk width's swizzle, zeros out of bounds.
template <int DP>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int heads, int seq,
                     int dim, long long sb, long long sh, long long ss) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tile<DP>::kCW), kTile, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Tile<DP>::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace vla_attention
