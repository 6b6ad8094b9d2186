// Stage-1 catalog kernels of the ER match job and the dense thresholded
// score kernel, written by hand for Hopper (sm_90a). Built by
// repro_torch/kernels/build.py into a plain-C shared library and called
// through ctypes from repro_torch/kernels/pair_sim.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pair_sim.py:
//   pair_scores_catalog_compact (_catalog_compact_kernel, _load_strips,
//     _entry_keep)                      -> catalog_kernel<T, BM, BN, true>
//   pair_scores_catalog (_catalog_kernel) -> catalog_kernel<T, BM, BN, false>
//   pair_scores (_kernel)               -> dense_kernel<T, BM, BN>
//
// Catalog kernels: for catalog entry t the block computes
// s = A[a_tile*BM:+BM] . B[b_tile*BN:+BN]^T in f32, keeps a cell when
// s >= threshold and the entry's predicate holds (validity window, triangle,
// lb/ub corner cuts, SN band), and writes either the survivors' tile-local
// ids i*BN + j packed in row-major order plus the exact survivor count
// (compact), or a dense f32 0/1 mask.
//
// Dense kernel: block (i, j) of a (ceil(M/BM), ceil(N/BN)) grid computes the
// same f32 dot for rows [i*BM, +BM) x cols [j*BN, +BN) of (M, N) and writes
// s, or 0 where s < threshold (and, with `triangular`, where row >= col),
// straight into the (M, N) f32 output.
//
// What bounds them on an H100: operations. A 128x128 tile at d = 256 is
// 8.4 MFLOP against at most 256 KB of strips, most of them re-read from L2
// (neighbouring tiles share strips), so the dot is far above the card's
// byte/FLOP balance. The survivor set must equal the f32 reference, so the
// tensor cores (TF32 drops mantissa bits) are out: the kernels run f32 FMA
// on the CUDA cores, whose peak is 67 TFLOP/s. The dense kernel also writes
// 4 bytes per cell whatever the data, so at small d (below ~40 columns for
// f32 at these peaks) its output bytes bound it instead.
//
// What the design does about it: 256 threads in a 16x16 grid per block. The
// tile is cut into sub-tiles of at most 128x128 cells so each thread keeps
// at most 64 accumulators in registers (a strided 8x8 micro-tile at
// 128x128). The d axis streams through shared memory in chunks of 32
// columns, staged transposed with a +1 pad so neither the stores nor the
// inner-loop reads conflict on banks; bf16 is widened to f32 on the way in.
// Ragged rows past M/N and ragged d are masked here, so the wrappers never
// pad a feature matrix. Catalog kernels: one block per entry; the keep bits
// of the whole tile go to shared memory; the compact epilogue gives each
// thread a contiguous run of bit words, counts it with popc, takes an
// exclusive block scan (warp shuffles) and writes ids in row-major order --
// the order the host decode relies on. Entries with an empty validity
// window (the zero rows that pad a chunk) skip the mainloop. Dense kernel:
// each thread writes its accumulators straight to device memory (a half
// warp covers 16 consecutive columns); with `triangular` a tile wholly on or
// below the diagonal writes zeros and skips the mainloop, so the triangular
// case does about half the work. Not done yet: wgmma, TMA and a multistage
// pipeline -- work for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;             // d columns staged per mainloop step
constexpr int kNcols = 13;             // catalog entry width (pair_sim.NCOLS)
constexpr int kMaxAcc = 128 * 128;     // sub-tile cells: <= 64 per thread

// Column layout of one catalog entry (repro_torch/kernels/pair_sim.py).
enum { A_TILE, B_TILE, R0, R1, C0, C1, TRI, LB_R, LB_C, UB_R, UB_C, BAND };

template <int BM, int BN>
struct Geometry {
  static constexpr int SN = BN < 128 ? BN : 128;                   // sub-tile cols
  static constexpr int SM = BM < kMaxAcc / SN ? BM : kMaxAcc / SN; // sub-tile rows
  static constexpr int TM = SM / 16;   // rows per thread, strided by 16
  static constexpr int TN = SN / 16;   // cols per thread, strided by 16
  static constexpr int LDA = SM + 1;   // +1 pad: conflict-free transposed stores
  static constexpr int LDB = SN + 1;
  static constexpr int WORDS = BM * BN / 32;                // keep bits
  static constexpr int STAGE_FLOATS = kChunk * (LDA + LDB);
  static constexpr int SMEM_BYTES = (STAGE_FLOATS + WORDS) * 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows [row0, row0 + ROWS) x columns [k0, k0 + kChunk) of x (nrows, d),
// transposed into dst[k * LD + r]; out-of-range cells read as 0.
template <typename T, int ROWS, int LD>
__device__ __forceinline__ void stage(const T* __restrict__ x, int nrows,
                                      int d, int row0, int k0,
                                      float* __restrict__ dst) {
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * kChunk; e += kThreads) {
    const int r = e / kChunk, k = e % kChunk;
    const int gr = row0 + r, gk = k0 + k;
    float v = 0.f;
    if (gr < nrows && gk < d) v = to_f32(x[(size_t)gr * d + gk]);
    dst[k * LD + r] = v;
  }
}

// catalog_tile_mask of pair_sim.py on one cell's global row/col.
__device__ __forceinline__ bool in_entry(const int* e, int gi, int gj) {
  return gi >= e[R0] && gi < e[R1] && gj >= e[C0] && gj < e[C1] &&
         (e[TRI] == 0 || gi < gj) && (gi > e[LB_R] || gj >= e[LB_C]) &&
         (gi < e[UB_R] || gj <= e[UB_C]) &&
         (e[BAND] == 0 || gj - gi < e[BAND]);
}

// The shared mainloop: the f32 dot of rows [row0, row0 + BM) of a with
// rows [col0, col0 + BN) of b, one sub-tile of at most 128x128 cells at a
// time; epi(li, lj, s) gets every cell's tile-local row, col and score.
template <typename T, int BM, int BN, typename Epilogue>
__device__ __forceinline__ void tile_mainloop(
    const T* __restrict__ a, const T* __restrict__ b, int m, int n, int d,
    int row0, int col0, float* As, float* Bs, Epilogue epi) {
  using G = Geometry<BM, BN>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int pm = 0; pm < BM; pm += G::SM) {
    for (int pn = 0; pn < BN; pn += G::SN) {
      float acc[G::TM][G::TN];
#pragma unroll
      for (int i = 0; i < G::TM; ++i)
#pragma unroll
        for (int j = 0; j < G::TN; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < d; k0 += kChunk) {
        stage<T, G::SM, G::LDA>(a, m, d, row0 + pm, k0, As);
        stage<T, G::SN, G::LDB>(b, n, d, col0 + pn, k0, Bs);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          float fa[G::TM], fb[G::TN];
#pragma unroll
          for (int i = 0; i < G::TM; ++i) fa[i] = As[k * G::LDA + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < G::TN; ++j) fb[j] = Bs[k * G::LDB + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < G::TM; ++i)
#pragma unroll
            for (int j = 0; j < G::TN; ++j)
              acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < G::TM; ++i)
#pragma unroll
        for (int j = 0; j < G::TN; ++j)
          epi(pm + ty + 16 * i, pn + tx + 16 * j, acc[i][j]);
    }
  }
}

// The catalog kernels' keep bits: bit i*BN + j of `bits` for every kept cell.
template <typename T, int BM, int BN>
__device__ __forceinline__ void tile_keep_bits(
    const T* __restrict__ a, const T* __restrict__ b, int m, int n, int d,
    const int* entry, float threshold, float* As, float* Bs, uint32_t* bits) {
  const int row0 = entry[A_TILE] * BM, col0 = entry[B_TILE] * BN;
  tile_mainloop<T, BM, BN>(
      a, b, m, n, d, row0, col0, As, Bs, [&](int li, int lj, float s) {
        if (s >= threshold && in_entry(entry, row0 + li, col0 + lj)) {
          const int c = li * BN + lj;
          atomicOr(&bits[c >> 5], 1u << (c & 31));
        }
      });
}

// Exclusive prefix sum of v over the block; `total` gets the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[kWarps - 1];
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

// Survivor ids in row-major order into out[0, min(count, capacity)), zeros
// after, and the exact count even past capacity.
template <int BM, int BN>
__device__ __forceinline__ void compact_epilogue(const uint32_t* bits,
                                                 int* __restrict__ out,
                                                 int* __restrict__ count,
                                                 int capacity, int* warp_sums) {
  constexpr int kWords = BM * BN / 32;
  constexpr int kPer = (kWords + kThreads - 1) / kThreads;
  const int w0 = min((int)threadIdx.x * kPer, kWords);
  const int w1 = min(w0 + kPer, kWords);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(bits[w]);
  int total;
  int rank = block_exclusive_scan(mine, warp_sums, total);
  for (int w = w0; w < w1 && rank < capacity; ++w) {
    uint32_t word = bits[w];
    while (word && rank < capacity) {
      const int bit = __ffs(word) - 1;
      word &= word - 1;
      out[rank++] = w * 32 + bit;
    }
  }
  for (int s = min(total, capacity) + threadIdx.x; s < capacity; s += kThreads)
    out[s] = 0;
  if (threadIdx.x == 0) *count = total;
}

// The keep bits as a dense f32 0/1 mask, four cells per 16-byte store.
template <int BM, int BN>
__device__ __forceinline__ void mask_epilogue(const uint32_t* bits,
                                              float* __restrict__ out) {
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int q = threadIdx.x; q < BM * BN / 4; q += kThreads) {
    const uint32_t nib = bits[q >> 3] >> ((q & 7) * 4);
    out4[q] = make_float4(nib & 1u ? 1.f : 0.f, nib & 2u ? 1.f : 0.f,
                          nib & 4u ? 1.f : 0.f, nib & 8u ? 1.f : 0.f);
  }
}

template <typename T, int BM, int BN, bool kCompact>
__global__ void __launch_bounds__(kThreads)
    catalog_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int* __restrict__ catalog, int m, int n, int d,
                   float threshold, float* __restrict__ mask,
                   int* __restrict__ packed, int* __restrict__ counts,
                   int capacity) {
  using G = Geometry<BM, BN>;
  extern __shared__ float smem[];
  __shared__ int entry[kNcols];
  __shared__ int warp_sums[kWarps];
  float* As = smem;
  float* Bs = smem + kChunk * G::LDA;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + G::STAGE_FLOATS);

  const int t = blockIdx.x;
  if (threadIdx.x < kNcols)
    entry[threadIdx.x] = catalog[(size_t)t * kNcols + threadIdx.x];
  for (int w = threadIdx.x; w < G::WORDS; w += kThreads) bits[w] = 0u;
  __syncthreads();
  // An empty validity window (the all-zero rows that pad a chunk) keeps
  // nothing; the condition is uniform over the block.
  if (entry[R0] < entry[R1] && entry[C0] < entry[C1])
    tile_keep_bits<T, BM, BN>(a, b, m, n, d, entry, threshold, As, Bs, bits);
  __syncthreads();
  if constexpr (kCompact) {
    compact_epilogue<BM, BN>(bits, packed + (size_t)t * capacity, counts + t,
                             capacity, warp_sums);
  } else {
    mask_epilogue<BM, BN>(bits, mask + (size_t)t * BM * BN);
  }
}

// Dense thresholded scores: block (blockIdx.y, blockIdx.x) owns rows
// [by*BM, +BM) x cols [bx*BN, +BN) of the (m, n) f32 output.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    dense_kernel(const T* __restrict__ a, const T* __restrict__ b, int m,
                 int n, int d, float threshold, int triangular,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + kChunk * Geometry<BM, BN>::LDA;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (triangular && row0 >= col0 + BN - 1) {
    // Every cell has row >= col: nothing is kept (uniform over the block).
    for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
      const int gi = row0 + e / BN, gj = col0 + e % BN;
      if (gi < m && gj < n) out[(size_t)gi * n + gj] = 0.f;
    }
    return;
  }
  tile_mainloop<T, BM, BN>(
      a, b, m, n, d, row0, col0, As, Bs, [&](int li, int lj, float s) {
        const int gi = row0 + li, gj = col0 + lj;
        if (gi < m && gj < n) {
          const bool keep = s >= threshold && (!triangular || gi < gj);
          out[(size_t)gi * n + gj] = keep ? s : 0.f;
        }
      });
}

template <typename T, int BM, int BN, bool kCompact>
cudaError_t launch(const void* a, const void* b, const void* catalog, int m,
                   int n, int d, int t, float threshold, void* mask,
                   void* packed, void* counts, int capacity,
                   cudaStream_t stream) {
  using G = Geometry<BM, BN>;
  auto kernel = catalog_kernel<T, BM, BN, kCompact>;
  if (G::SMEM_BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  kernel<<<t, kThreads, G::SMEM_BYTES, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int*>(catalog), m, n, d, threshold,
      static_cast<float*>(mask), static_cast<int*>(packed),
      static_cast<int*>(counts), capacity);
  return cudaGetLastError();
}

template <typename T, bool kCompact>
cudaError_t dispatch(int bm, int bn, const void* a, const void* b,
                     const void* catalog, int m, int n, int d, int t,
                     float threshold, void* mask, void* packed, void* counts,
                     int capacity, cudaStream_t stream) {
#define PAIR_SIM_CASE(BM, BN)                                                \
  if (bm == BM && bn == BN)                                                  \
    return launch<T, BM, BN, kCompact>(a, b, catalog, m, n, d, t, threshold, \
                                       mask, packed, counts, capacity, stream);
  PAIR_SIM_CASE(32, 32) PAIR_SIM_CASE(32, 64) PAIR_SIM_CASE(32, 128)
  PAIR_SIM_CASE(32, 256) PAIR_SIM_CASE(64, 32) PAIR_SIM_CASE(64, 64)
  PAIR_SIM_CASE(64, 128) PAIR_SIM_CASE(64, 256) PAIR_SIM_CASE(128, 32)
  PAIR_SIM_CASE(128, 64) PAIR_SIM_CASE(128, 128) PAIR_SIM_CASE(128, 256)
  PAIR_SIM_CASE(256, 32) PAIR_SIM_CASE(256, 64) PAIR_SIM_CASE(256, 128)
  PAIR_SIM_CASE(256, 256)
#undef PAIR_SIM_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int BM, int BN>
cudaError_t launch_dense(const void* a, const void* b, int m, int n, int d,
                         float threshold, int triangular, void* out,
                         cudaStream_t stream) {
  constexpr int kSmem = Geometry<BM, BN>::STAGE_FLOATS * 4;
  auto kernel = dense_kernel<T, BM, BN>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), m, n, d, threshold,
      triangular, static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dense(int bm, int bn, const void* a, const void* b,
                           int m, int n, int d, float threshold,
                           int triangular, void* out, cudaStream_t stream) {
#define PAIR_SIM_DENSE(BM, BN)                                            \
  if (bm == BM && bn == BN)                                               \
    return launch_dense<T, BM, BN>(a, b, m, n, d, threshold, triangular, \
                                   out, stream);
  PAIR_SIM_DENSE(32, 32) PAIR_SIM_DENSE(32, 64) PAIR_SIM_DENSE(32, 128)
  PAIR_SIM_DENSE(32, 256) PAIR_SIM_DENSE(64, 32) PAIR_SIM_DENSE(64, 64)
  PAIR_SIM_DENSE(64, 128) PAIR_SIM_DENSE(64, 256) PAIR_SIM_DENSE(128, 32)
  PAIR_SIM_DENSE(128, 64) PAIR_SIM_DENSE(128, 128) PAIR_SIM_DENSE(128, 256)
  PAIR_SIM_DENSE(256, 32) PAIR_SIM_DENSE(256, 64) PAIR_SIM_DENSE(256, 128)
  PAIR_SIM_DENSE(256, 256)
#undef PAIR_SIM_DENSE
  return cudaErrorInvalidValue;
}

template <int BM, int BN>
int smem_bytes() { return Geometry<BM, BN>::SMEM_BYTES; }

}  // namespace

extern "C" {

// Launches one catalog kernel on `stream` (a cudaStream_t) of `device`.
// compact != 0: packed (t, capacity) int32 + counts (t,) int32; else mask
// (t, bm, bn) f32. bf16 != 0: a and b are bf16, else f32. Returns the
// cudaError_t of the launch (0 on success); allocates nothing.
int pair_sim_catalog_launch(int compact, int bf16, int device, const void* a,
                            const void* b, const void* catalog, int m, int n,
                            int d, int t, int bm, int bn, float threshold,
                            void* mask, void* packed, void* counts,
                            int capacity, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err != cudaSuccess) return err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    err = compact ? dispatch<__nv_bfloat16, true>(bm, bn, a, b, catalog, m, n,
                                                  d, t, threshold, mask,
                                                  packed, counts, capacity, s)
                  : dispatch<__nv_bfloat16, false>(bm, bn, a, b, catalog, m,
                                                   n, d, t, threshold, mask,
                                                   packed, counts, capacity, s);
  } else {
    err = compact ? dispatch<float, true>(bm, bn, a, b, catalog, m, n, d, t,
                                          threshold, mask, packed, counts,
                                          capacity, s)
                  : dispatch<float, false>(bm, bn, a, b, catalog, m, n, d, t,
                                           threshold, mask, packed, counts,
                                           capacity, s);
  }
  // Leave the caller's current device as it was (PyTorch reads it).
  const cudaError_t restored = cudaSetDevice(caller_device);
  return err != cudaSuccess ? err : restored;
}

// Launches the dense kernel on `stream` of `device`: out (m, n) f32 gets
// a . b^T where it is >= threshold (and row < col with triangular != 0), 0
// elsewhere. bf16 != 0: a and b are bf16, else f32. Returns the cudaError_t
// of the launch (0 on success); allocates nothing.
int pair_sim_dense_launch(int bf16, int device, const void* a, const void* b,
                          int m, int n, int d, int bm, int bn,
                          float threshold, int triangular, void* out,
                          void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err != cudaSuccess) return err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? dispatch_dense<__nv_bfloat16>(bm, bn, a, b, m, n, d, threshold,
                                             triangular, out, s)
             : dispatch_dense<float>(bm, bn, a, b, m, n, d, threshold,
                                     triangular, out, s);
  const cudaError_t restored = cudaSetDevice(caller_device);
  return err != cudaSuccess ? err : restored;
}

// Dynamic shared memory of one block at geometry (bm, bn); -1 off the
// lattice. The Python shared-memory model must agree.
int pair_sim_smem_bytes(int bm, int bn) {
#define PAIR_SIM_SMEM(BM, BN) \
  if (bm == BM && bn == BN) return smem_bytes<BM, BN>();
  PAIR_SIM_SMEM(32, 32) PAIR_SIM_SMEM(32, 64) PAIR_SIM_SMEM(32, 128)
  PAIR_SIM_SMEM(32, 256) PAIR_SIM_SMEM(64, 32) PAIR_SIM_SMEM(64, 64)
  PAIR_SIM_SMEM(64, 128) PAIR_SIM_SMEM(64, 256) PAIR_SIM_SMEM(128, 32)
  PAIR_SIM_SMEM(128, 64) PAIR_SIM_SMEM(128, 128) PAIR_SIM_SMEM(128, 256)
  PAIR_SIM_SMEM(256, 32) PAIR_SIM_SMEM(256, 64) PAIR_SIM_SMEM(256, 128)
  PAIR_SIM_SMEM(256, 256)
#undef PAIR_SIM_SMEM
  return -1;
}

const char* pair_sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
