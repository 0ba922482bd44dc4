// W8A8 matmul for Hopper (sm_90a): int8 x int8 -> int32 on the tensor
// cores, then the rank-1 dequantization, in one kernel.
//
// Replaces vla_adapter_tpu/ops/pallas_matmul.py:w8a8_matmul (kernel B4,
// _w8a8_kernel) and :w8a8_matmul_stacked (kernel B5). Same arithmetic:
//
//   acc = xq @ W^T                  int32, exact
//   y   = out(float(acc) * rs * ws)  two float32 products in that order,
//                                    one rounding to the output type
//
// xq (M, K) int8 row-major, rs (M) f32 per-row scales, W (N, K) int8 in the
// PyTorch (out, in) layout, ws (N) f32 per-column scales. With W stored
// (out, in), both mma.sync operands are K-contiguous (A row-major, B "col"),
// so every fragment is a plain 32-bit read: no transpose in shared memory.
// blockIdx.z walks layers: x/rs/out layer z (strides 0 for one shared x)
// against weight layer layer0 + z, which covers a flat weight (B4), one
// layer of an (L, N, K) stack (B5) and the action head's BatchedDense.
//
// Design. One CTA of 4 warps computes a 64 x 64 output tile; each warp a
// 32 x 32 quarter with mma.sync.m16n8k32 (s8 x s8 -> s32). The K loop
// stages 64-byte slices of A and B through shared memory; the next slice
// is loaded into registers while the tensor cores work on the current one.
// Inside a 64-byte slice each thread reads 16 contiguous bytes of its row,
// which is a fixed permutation of k shared by A and B: the int32 sum does
// not depend on the order of k, so the result is exact all the same.
//
// Bound on this card: at the serving shapes (M = 8 .. 2560, N, K ~ 1000)
// the weights and activations are ~1-3 MB per call: a few microseconds at
// 3.35 TB/s, and the int8 work (2MNK ~ 1 GOP) half a microsecond at the
// 1979 TOP/s peak: bytes bound. This first version uses mma.sync, not
// wgmma/TMA, synchronous shared-memory staging and 64 x 64 tiles, so at
// M = 8 (the action head) 7/8 of each tile is padding; it is the simple,
// exact form, not the fast one.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream; it returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;  // bytes of K per stage
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct Params {
  const int8_t* xq;
  const float* rs;
  const int8_t* w;
  const float* ws;
  void* out;
  int m, n, k, layer0;
  long long x_ls, rs_ls, w_ls, ws_ls, o_ls;  // per-layer strides (elements)
};

__device__ __forceinline__ void store_pair(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) w8a8_matmul_kernel(const Params p) {
  // Rows of 64 bytes: a quarter-warp's 16-byte reads (two rows, four
  // threads each) then cover all 32 banks.
  __shared__ __align__(16) int8_t a_s[kBM * kBK];
  __shared__ __align__(16) int8_t b_s[kBN * kBK];

  const int z = blockIdx.z;
  const int8_t* xq = p.xq + z * p.x_ls;
  const float* rs = p.rs + z * p.rs_ls;
  const int8_t* w = p.w + (p.layer0 + z) * p.w_ls;
  const float* ws = p.ws + (p.layer0 + z) * p.ws_ls;
  OutT* out = static_cast<OutT*>(p.out) + z * p.o_ls;

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / 2) * 32;  // warp's rows in the tile
  const int wn = (warp % 2) * 32;  // warp's columns in the tile

  // Global -> register staging: 256 16-byte chunks per operand, 2 each.
  uint4 a_reg[2], b_reg[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / 16);
      const int c = (idx % (kBK / 16)) * 16;
      const bool kin = k0 + c < p.k;  // K % 16 == 0: whole chunks
      a_reg[i] = make_uint4(0, 0, 0, 0);
      b_reg[i] = make_uint4(0, 0, 0, 0);
      if (kin && m0 + r < p.m)
        a_reg[i] = *reinterpret_cast<const uint4*>(xq + (long long)(m0 + r) * p.k + k0 + c);
      if (kin && n0 + r < p.n)
        b_reg[i] = *reinterpret_cast<const uint4*>(w + (long long)(n0 + r) * p.k + k0 + c);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (kBK / 16);
      const int c = (idx % (kBK / 16)) * 16;
      *reinterpret_cast<uint4*>(&a_s[r * kBK + c]) = a_reg[i];
      *reinterpret_cast<uint4*>(&b_s[r * kBK + c]) = b_reg[i];
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  load(0);
  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    store();
    __syncthreads();
    if (k0 + kBK < p.k) load(k0 + kBK);
    // Thread (g, t) reads bytes [16t, 16t + 16) of its rows; mma h of the
    // two uses words 2h (logical k 4t..4t+3) and 2h + 1 (16 + 4t..).
    uint4 af[2][2], bf[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      af[i][0] = *reinterpret_cast<const uint4*>(&a_s[(wm + 16 * i + g) * kBK + 16 * t]);
      af[i][1] = *reinterpret_cast<const uint4*>(&a_s[(wm + 16 * i + g + 8) * kBK + 16 * t]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bf[j] = *reinterpret_cast<const uint4*>(&b_s[(wn + 8 * j + g) * kBK + 16 * t]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_s8(acc[i][j], af[i][0].x, af[i][1].x, af[i][0].y, af[i][1].y, bf[j].x, bf[j].y);
        mma_s8(acc[i][j], af[i][0].z, af[i][1].z, af[i][0].w, af[i][1].w, bf[j].z, bf[j].w);
      }
    __syncthreads();
  }

  // Epilogue: c0, c1 -> row g, columns 2t, 2t + 1; c2, c3 -> row g + 8.
  // __fmul_rn keeps the two products separate roundings, as the plain
  // version computes them.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + 16 * i + g + 8 * half;
      if (row >= p.m) continue;
      const float r = rs[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        if (col >= p.n) continue;  // N even: col + 1 < N as well
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half]), r), ws[col]);
        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), r), ws[col + 1]);
        store_pair(out + (long long)row * p.n + col, v0, v1);
      }
    }
  }
}

template <typename OutT>
cudaError_t launch(const Params& p, int layers, cudaStream_t stream) {
  dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, layers);
  w8a8_matmul_kernel<OutT><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// xq (layers, M, K) int8 [layer stride x_ls, 0 = shared], rs (.., M) f32,
// w (L, N, K) int8, ws (L, N) f32, out (layers, M, N) bf16 (out_dtype 0) or
// f32 (1). K % 16 == 0, N even, pointers 16-byte aligned (the wrapper
// checks shapes; PyTorch allocations are aligned). Returns a cudaError_t.
extern "C" int vla_w8a8_matmul(
    const void* xq, const void* rs, const void* w, const void* ws, void* out,
    int m, int n, int k, int layer0, int layers,
    long long x_ls, long long rs_ls, long long w_ls, long long ws_ls,
    long long o_ls, int out_dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 2 || layers <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xq = static_cast<const int8_t*>(xq);
  p.rs = static_cast<const float*>(rs);
  p.w = static_cast<const int8_t*>(w);
  p.ws = static_cast<const float*>(ws);
  p.out = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.layer0 = layer0;
  p.x_ls = x_ls;
  p.rs_ls = rs_ls;
  p.w_ls = w_ls;
  p.ws_ls = ws_ls;
  p.o_ls = o_ls;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch<__nv_bfloat16>(p, layers, s);
    case 1: return launch<float>(p, layers, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
