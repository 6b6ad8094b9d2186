// The grouped matmul's earlier design (mma.sync m16n8k16 from padded shared
// rows, one block per row tile and 128-column F tile, x and w chunks staged
// through registers), kept below this note as it was (one comment
// shortened) as a yardstick:
// chip_smoke.py builds it beside src/repro_torch/csrc/grouped_mm.cu (same C
// interface) and times both in one run. The port never loads it.
//
// Grouped matrix product of the MoE expert FFN, written by hand for Hopper
// (sm_90a). Built by repro_torch/kernels/build.py into a plain-C shared
// library and called through ctypes from repro_torch/kernels/grouped_mm.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_mm.py
// grouped_matmul (_kernel): out = x . w[tile_expert[i / BT]] over expert-
// sorted, tile-aligned rows of x (T, d), with w (E, d, F), accumulated in
// f32 and written in x's dtype. BT (block_t) is 128 on prefill and 8 on
// small-batch decode (repro/models/moe.py picks it).
//
// What bounds it on an H100: at prefill (BT = 128, granite-moe: 135,168
// padded rows, d = 1024, F = 512) a call is ~142 GFLOP against ~449 MB,
// near the bf16 ridge (0.143 ms of tensor-core work vs 0.134 ms of bytes),
// so the tensor cores must carry the product. At decode (BT = 8, 40 tiles)
// it reads up to 32 expert strips of 1 MB for 64 real rows: bytes only.
//
// What the design does about it: one block per (row tile, 128-column F
// tile). The block reads its tile's expert id itself, stages 32-column
// chunks of x and of that expert's w strip in shared memory (double
// buffered: the next chunk is fetched into registers while the tensor cores
// work on this one) and, for bf16, runs mma.sync m16n8k16 (bf16 x bf16 ->
// f32) from fragments read straight out of padded, bank-conflict-free
// shared rows. BT = 128 uses 8 warps on a 128 x 128 tile (32 x 64 a warp);
// BT = 8 uses 4 warps on a 16 x 128 tile whose rows 8..15 stay zero, so the
// decode block streams its 128 w columns with every warp busy. f32 inputs
// run f32 FMA on the CUDA cores (no TF32), so f32 results keep f32 accuracy.
// A ragged F and a ragged d are masked in the kernel (w is never padded per
// call), rows past the real tokens are zero in x and give zero rows, and a
// tile whose expert id lies outside [0, E) writes zeros. Not done yet:
// wgmma, TMA and a multistage cp.async pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBF = 128;       // output columns per block (bf16 path)
constexpr int kKC = 32;        // d columns per mainloop step
constexpr int kLdA = kKC + 8;  // padded smem row of an x chunk (bf16)
constexpr int kLdB = kBF + 8;  // padded smem row of a w chunk (bf16)

// Warp layout of the bf16 path for each block_t.
template <int BT>
struct Mma;
template <>
struct Mma<128> {
  static constexpr int WARPS_M = 4, WARPS_N = 2, MT = 2, NT = 8;
};
template <>
struct Mma<8> {
  static constexpr int WARPS_M = 1, WARPS_N = 4, MT = 1, NT = 4;
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 of row `row` (ncols wide) from column `col`; columns past
// ncols read as 0. `vec`: the row may be read as one 16-byte load.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ row,
                                       int col, int ncols, bool vec) {
  if (vec && col + 8 <= ncols)
    return *reinterpret_cast<const uint4*>(row + col);
  __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    tmp[i] = col + i < ncols ? row[col + i] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(tmp);
}

template <int BT>
__global__ void __launch_bounds__(Mma<BT>::WARPS_M* Mma<BT>::WARPS_N * 32)
    grouped_mm_bf16(const __nv_bfloat16* __restrict__ x,
                    const int* __restrict__ tile_expert,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int d, int f, int e,
                    int vec_x, int vec_w) {
  using L = Mma<BT>;
  constexpr int kThreads = L::WARPS_M * L::WARPS_N * 32;
  constexpr int kRows = L::WARPS_M * L::MT * 16;  // BT, or 16 for BT = 8
  constexpr int kAVec = BT * kKC / 8;             // 16-byte pieces per chunk
  constexpr int kBVec = kKC * kBF / 8;
  constexpr int kAPer = (kAVec + kThreads - 1) / kThreads;
  constexpr int kBPer = kBVec / kThreads;
  __shared__ __align__(16) __nv_bfloat16 As[2][kRows][kLdA];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kKC][kLdB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp / L::WARPS_N, warp_n = warp % L::WARPS_N;
  const int row0 = blockIdx.x * BT;  // first row of x / out
  const int col0 = blockIdx.y * kBF; // first output column
  const int expert = tile_expert[blockIdx.x];
  const bool live = expert >= 0 && expert < e;
  const __nv_bfloat16* wx = w + (size_t)(live ? expert : 0) * d * f;

  if constexpr (kRows > BT) {  // BT = 8: rows 8..15 of the m16 tile stay zero
    for (int i = tid; i < 2 * (kRows - BT) * kLdA; i += kThreads) {
      const int buf = i / ((kRows - BT) * kLdA);
      const int rem = i % ((kRows - BT) * kLdA);
      As[buf][BT + rem / kLdA][rem % kLdA] = __float2bfloat16(0.f);
    }
  }

  uint4 ra[kAPer], rb[kBPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int v = tid + i * kThreads;
      if (v < kAVec) {
        const int r = v / (kKC / 8), c = (v % (kKC / 8)) * 8;
        ra[i] = load8(x + (size_t)(row0 + r) * d, k0 + c, d, vec_x);
      }
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBF / 8), c = (v % (kBF / 8)) * 8;
      if (live && k0 + r < d)
        rb[i] = load8(wx + (size_t)(k0 + r) * f, col0 + c, f, vec_w);
      else
        rb[i] = make_uint4(0, 0, 0, 0);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int v = tid + i * kThreads;
      if (v < kAVec) {
        const int r = v / (kKC / 8), c = (v % (kKC / 8)) * 8;
        *reinterpret_cast<uint4*>(&As[buf][r][c]) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (kBF / 8), c = (v % (kBF / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[buf][r][c]) = rb[i];
    }
  };

  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int chunks = (d + kKC - 1) / kKC;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) fetch((c + 1) * kKC);
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t a[L::MT][4];
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt) {
        const int r = warp_m * L::MT * 16 + mt * 16 + g;
        const int k = ks * 16 + t * 2;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[buf][r][k]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][k]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&As[buf][r][k + 8]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&As[buf][r + 8][k + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const int n = warp_n * L::NT * 8 + nt * 8 + g;
        const int k = ks * 16 + t * 2;
        const uint32_t b0 = pack_bf16(Bs[buf][k][n], Bs[buf][k + 1][n]);
        const uint32_t b1 = pack_bf16(Bs[buf][k + 8][n], Bs[buf][k + 9][n]);
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    if (c + 1 < chunks) stash(buf ^ 1);
    __syncthreads();
  }

  const bool pair_ok = (f & 1) == 0;  // bf16x2 stores stay 4-byte aligned
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp_m * L::MT * 16 + mt * 16 + g + half * 8;
      if (r >= BT) continue;
      __nv_bfloat16* orow = out + (size_t)(row0 + r) * f;
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const int n = col0 + warp_n * L::NT * 8 + nt * 8 + t * 2;
        const float v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
        if (pair_ok && n + 1 < f) {
          *reinterpret_cast<__nv_bfloat162*>(orow + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < f) orow[n] = __float2bfloat16(v0);
          if (n + 1 < f) orow[n + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// f32 path: FMA on the CUDA cores. A block of 256 threads owns a BT x 64
// tile; thread (ty, tx) = (tid / 64, tid % 64) computes column tx of rows
// ty, ty + 4, ... (BT / 4 accumulators).
constexpr int kBF32 = 64;
constexpr int kThreads32 = 256;

template <int BT>
__global__ void __launch_bounds__(kThreads32)
    grouped_mm_f32(const float* __restrict__ x,
                   const int* __restrict__ tile_expert,
                   const float* __restrict__ w, float* __restrict__ out,
                   int d, int f, int e) {
  constexpr int kRowsPer = BT / 4;
  __shared__ float As[BT][kKC + 1];
  __shared__ float Bs[kKC][kBF32];
  const int tid = threadIdx.x, tx = tid % kBF32, ty = tid / kBF32;
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * kBF32;
  const int expert = tile_expert[blockIdx.x];
  const bool live = expert >= 0 && expert < e;
  const float* wx = w + (size_t)(live ? expert : 0) * d * f;
  float acc[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kKC) {
    for (int v = tid; v < BT * kKC; v += kThreads32) {
      const int r = v / kKC, k = v % kKC;
      As[r][k] = k0 + k < d ? x[(size_t)(row0 + r) * d + k0 + k] : 0.f;
    }
    for (int v = tid; v < kKC * kBF32; v += kThreads32) {
      const int k = v / kBF32, n = v % kBF32;
      Bs[k][n] = live && k0 + k < d && col0 + n < f
                     ? wx[(size_t)(k0 + k) * f + col0 + n]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKC; ++k) {
      const float b = Bs[k][tx];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) acc[i] = fmaf(As[ty + 4 * i][k], b, acc[i]);
    }
    __syncthreads();
  }
  if (col0 + tx < f) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
      out[(size_t)(row0 + ty + 4 * i) * f + col0 + tx] = acc[i];
  }
}

template <int BT>
cudaError_t launch(int bf16, const void* x, const int* tile_expert,
                   const void* w, void* out, int tiles, int d, int f, int e,
                   cudaStream_t stream) {
  if (bf16) {
    constexpr int threads = Mma<BT>::WARPS_M * Mma<BT>::WARPS_N * 32;
    const int vec_x = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int vec_w = f % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const dim3 grid(tiles, (f + kBF - 1) / kBF);
    grouped_mm_bf16<BT><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), tile_expert,
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), d, f, e, vec_x, vec_w);
  } else {
    const dim3 grid(tiles, (f + kBF32 - 1) / kBF32);
    grouped_mm_f32<BT><<<grid, kThreads32, 0, stream>>>(
        static_cast<const float*>(x), tile_expert,
        static_cast<const float*>(w), static_cast<float*>(out), d, f, e);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (tiles * block_t, f) = x (tiles * block_t, d) . w[tile_expert[i]]
// (e, d, f), on `stream` (a cudaStream_t) of `device`. bf16 != 0: x, w and
// out are bf16, else f32. block_t is 8 or 128. Returns the cudaError_t of
// the launch (0 on success); allocates nothing.
int grouped_mm_launch(int bf16, int device, const void* x,
                      const void* tile_expert, const void* w, void* out,
                      int tiles, int block_t, int d, int f, int e,
                      void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err != cudaSuccess) return err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  if (block_t == 128)
    err = launch<128>(bf16, x, te, w, out, tiles, d, f, e, s);
  else if (block_t == 8)
    err = launch<8>(bf16, x, te, w, out, tiles, d, f, e, s);
  else
    err = cudaErrorInvalidValue;
  // Leave the caller's current device as it was (PyTorch reads it).
  const cudaError_t restored = cudaSetDevice(caller_device);
  return err != cudaSuccess ? err : restored;
}

const char* grouped_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
