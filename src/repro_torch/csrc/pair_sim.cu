// Stage-1 catalog kernels of the ER match job and the dense thresholded
// score kernel, written by hand for Hopper (sm_90a). Built by
// repro_torch/kernels/build.py into a plain-C shared library and called
// through ctypes from repro_torch/kernels/pair_sim.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pair_sim.py:
//   pair_scores_catalog_compact (_catalog_compact_kernel, _load_strips,
//     _entry_keep)                      -> catalog_kernel<T, BM, BN, true>
//   pair_scores_catalog (_catalog_kernel) -> catalog_kernel<T, BM, BN, false>
//   pair_scores (_kernel)               -> dense_kernel<T, BM, BN> for f32,
//     and for bf16 that csrc/dense_scores.cu (wgmma + TMA) cannot take:
//     operands not 16-byte aligned, d % 8 != 0, N % 4 != 0 or block_m 32
//     (repro_torch/kernels/pair_sim.py::dense_route)
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
// straight into the (M, N) f32 output. It serves every f32 call and the
// bf16 calls the tensor-core kernel of csrc/dense_scores.cu cannot take;
// bf16 is widened to f32 as it is loaded, so it costs what f32 costs.
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
// at most 64 accumulators in registers. A thread owns a contiguous
// micro-tile: at 128x128 two 4-row by two 4-column runs (rows ty*4 and
// 64 + ty*4, columns tx*4 and 64 + tx*4), so each k step reads its operands
// with four 16-byte shared loads for 64 FMAs (16 FMAs a load). The d axis
// streams through shared memory in chunks of 32 columns, stored transposed
// (k-major) with the 4-float groups of a k row XOR-swizzled by (k / 4) % 8,
// so the transposed stores and the 16-byte reads are both free of bank
// conflicts without padding. Staging is pipelined through registers into
// two shared stages: each thread issues the global loads of chunk c + 1
// (16-byte loads where d and the base allow, scalar otherwise; bf16 widened
// to f32 on the way) before it runs chunk c's FMAs, then stores them into
// the other stage, so the load latency hides behind the FMAs and each chunk
// costs one __syncthreads. Ragged rows past M/N and ragged d are masked
// here, so the wrappers never pad a feature matrix. Catalog kernels: one
// block per entry; each thread turns its run of 2 or 4 cells into bits, the
// lanes that share a 32-bit word of the tile's keep bits OR them with warp
// shuffles, and one lane stores the word (no shared atomics); the compact
// epilogue gives each thread a contiguous run of bit words, counts it with
// popc, takes an exclusive block scan (warp shuffles) and writes ids in
// row-major order -- the order the host decode relies on. Entries with an
// empty validity window (the zero rows that pad a chunk) skip the mainloop.
// Dense kernel: each thread writes its runs straight to device memory
// (16-byte stores where N allows); with `triangular` a tile wholly on or
// below the diagonal writes zeros and skips the mainloop, so the triangular
// case does about half the work. (bf16 that TMA can address runs
// csrc/dense_scores.cu instead: a persistent wgmma kernel with a TMA-store
// epilogue.) Not done yet: a persistent block that prefetches the next
// entry's strips during the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // a 16 x 16 thread grid
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;             // d columns staged per mainloop step
static_assert(kThreads == 8 * 32 && kChunk == 32,
              "the stager maps 8 threads x 4 columns to a chunk row");
constexpr int kStages = 2;             // shared stages of the staging ring
constexpr int kNcols = 13;             // catalog entry width (pair_sim.NCOLS)
constexpr int kMaxAcc = 128 * 128;     // sub-tile cells: <= 64 per thread

// Column layout of one catalog entry (repro_torch/kernels/pair_sim.py).
enum { A_TILE, B_TILE, R0, R1, C0, C1, TRI, LB_R, LB_C, UB_R, UB_C, BAND };

template <int BM, int BN>
struct Geometry {
  static constexpr int SN = BN < 128 ? BN : 128;                   // sub-tile cols
  static constexpr int SM = BM < kMaxAcc / SN ? BM : kMaxAcc / SN; // sub-tile rows
  static constexpr int TM = SM / 16;   // rows per thread
  static constexpr int TN = SN / 16;   // cols per thread
  static constexpr int VM = TM < 4 ? TM : 4;   // contiguous rows in a run
  static constexpr int VN = TN < 4 ? TN : 4;   // contiguous cols in a run
  static constexpr int WORDS = BM * BN / 32;                // keep bits
  // kStages x (A chunk + B chunk), each kChunk rows of SM / SN floats
  static constexpr int STAGE_FLOATS = kChunk * (SM + SN);
  static constexpr int RING_FLOATS = kStages * STAGE_FLOATS;
  static constexpr int SMEM_BYTES = (RING_FLOATS + WORDS) * 4;
};

// Four consecutive elements x[gk, gk + 4) of one row as f32; `vec` says that
// d % 4 == 0 and the rows are aligned for one 16-byte (f32) or 8-byte (bf16)
// load, so the four are either all inside d or all past it.
__device__ __forceinline__ float4 load_run(const float* p, int gk, int d,
                                           bool vec) {
  if (vec) return gk < d ? *reinterpret_cast<const float4*>(p) : float4{};
  return make_float4(gk < d ? p[0] : 0.f, gk + 1 < d ? p[1] : 0.f,
                     gk + 2 < d ? p[2] : 0.f, gk + 3 < d ? p[3] : 0.f);
}
__device__ __forceinline__ float4 load_run(const __nv_bfloat16* p, int gk,
                                           int d, bool vec) {
  if (vec) {
    if (gk >= d) return float4{};
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return make_float4(gk < d ? __bfloat162float(p[0]) : 0.f,
                     gk + 1 < d ? __bfloat162float(p[1]) : 0.f,
                     gk + 2 < d ? __bfloat162float(p[2]) : 0.f,
                     gk + 3 < d ? __bfloat162float(p[3]) : 0.f);
}

// Index of row r, column k of a transposed chunk of ROWS rows: k-major, the
// 4-float groups of each k row XOR-swizzled by k / 4 (k < 32). A warp's
// transposed stores (8 k-quads x 4 rows) and its 16-byte reads of a k row
// then hit 32 distinct banks.
template <int ROWS>
__device__ __forceinline__ int swz(int k, int r) {
  return k * ROWS + (((r >> 2) ^ (k >> 2)) << 2) + (r & 3);
}

// One thread's share of a chunk of ROWS rows x kChunk columns, held in
// registers between its global loads and its shared stores: thread
// (rr, kq) = (tid / 8, tid % 8) takes columns [4kq, 4kq + 4) of rows
// rr, rr + 32, ...
template <typename T, int ROWS>
struct Stager {
  static constexpr int kPasses = ROWS / 32;
  float4 v[kPasses];

  __device__ __forceinline__ void load(const T* __restrict__ x, int nrows,
                                       int d, int row0, int k0, bool vec) {
    const int kq = threadIdx.x & 7, rr = threadIdx.x >> 3;
    const int gk = k0 + kq * 4;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int gr = row0 + rr + 32 * p;
      v[p] = gr < nrows ? load_run(x + (size_t)gr * d + gk, gk, d, vec)
                        : float4{};
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ dst) const {
    const int kq = threadIdx.x & 7, rr = threadIdx.x >> 3;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = rr + 32 * p;
      dst[swz<ROWS>(kq * 4 + 0, r)] = v[p].x;
      dst[swz<ROWS>(kq * 4 + 1, r)] = v[p].y;
      dst[swz<ROWS>(kq * 4 + 2, r)] = v[p].z;
      dst[swz<ROWS>(kq * 4 + 3, r)] = v[p].w;
    }
  }
};

// V contiguous floats of k row k starting at row r0 (r0 % V == 0, V <= 4:
// one shared load of 8 or 16 bytes).
template <int ROWS, int V>
__device__ __forceinline__ void read_run(const float* src, int k, int r0,
                                         float* out) {
  const float* p = src + swz<ROWS>(k, r0);
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = p[i];
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
// time. Thread (ty, tx) owns rows (i / VM) * 16 VM + ty VM + i % VM and
// columns (j / VN) * 16 VN + tx VN + j % VN of each sub-tile. epi(li, lj, s)
// gets a run of VN cells: tile-local row li, columns [lj, lj + VN), scores
// s[0, VN); every thread of the block calls it the same number of times in
// the same order (warp-uniform, so it may shuffle). `ring` holds kStages
// stages of (A chunk, B chunk).
template <typename T, int BM, int BN, typename Epilogue>
__device__ __forceinline__ void tile_mainloop(
    const T* __restrict__ a, const T* __restrict__ b, int m, int n, int d,
    int row0, int col0, float* ring, Epilogue epi) {
  using G = Geometry<BM, BN>;
  constexpr int TM = G::TM, TN = G::TN, VM = G::VM, VN = G::VN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int chunks = (d + kChunk - 1) / kChunk;
  const bool vec = d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b)) % (4 * sizeof(T)) == 0;
  Stager<T, G::SM> sa;
  Stager<T, G::SN> sb;
  for (int pm = 0; pm < BM; pm += G::SM) {
    for (int pn = 0; pn < BN; pn += G::SN) {
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      // prologue: chunk 0 into stage 0 (the stages are free: every thread
      // passed the last chunk's barrier of the previous sub-tile)
      sa.load(a, m, d, row0 + pm, 0, vec);
      sb.load(b, n, d, col0 + pn, 0, vec);
      sa.store(ring);
      sb.store(ring + kChunk * G::SM);
      __syncthreads();
      for (int c = 0; c < chunks; ++c) {
        const bool more = c + 1 < chunks;
        if (more) {  // chunk c + 1's loads are in flight during chunk c
          sa.load(a, m, d, row0 + pm, (c + 1) * kChunk, vec);
          sb.load(b, n, d, col0 + pn, (c + 1) * kChunk, vec);
        }
        const float* As = ring + (c % kStages) * G::STAGE_FLOATS;
        const float* Bs = As + kChunk * G::SM;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          float fa[TM], fb[TN];
#pragma unroll
          for (int i = 0; i < TM; i += VM)
            read_run<G::SM, VM>(As, k, (i / VM) * 16 * VM + ty * VM, fa + i);
#pragma unroll
          for (int j = 0; j < TN; j += VN)
            read_run<G::SN, VN>(Bs, k, (j / VN) * 16 * VN + tx * VN, fb + j);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
        }
        if (more) {
          // the stage chunk c - 1 used: every thread passed the barrier
          // that ended chunk c - 1
          float* next = ring + ((c + 1) % kStages) * G::STAGE_FLOATS;
          sa.store(next);
          sb.store(next + kChunk * G::SM);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; j += VN)
          epi(pm + (i / VM) * 16 * VM + ty * VM + i % VM,
              pn + (j / VN) * 16 * VN + tx * VN, &acc[i][j]);
    }
  }
}

// The catalog kernels' keep bits: bit i*BN + j of `bits` for every kept
// cell. A 32-bit word covers 32 / VN consecutive lanes of one half-warp
// (one row); they OR their runs' bits with shuffles and the first stores it.
template <typename T, int BM, int BN>
__device__ __forceinline__ void tile_keep_bits(
    const T* __restrict__ a, const T* __restrict__ b, int m, int n, int d,
    const int* entry, float threshold, float* ring, uint32_t* bits) {
  constexpr int VN = Geometry<BM, BN>::VN;
  constexpr int kLanes = 32 / VN;            // lanes per word, <= 16
  const int row0 = entry[A_TILE] * BM, col0 = entry[B_TILE] * BN;
  tile_mainloop<T, BM, BN>(
      a, b, m, n, d, row0, col0, ring,
      [&](int li, int lj, const float* s) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < VN; ++j)
          if (s[j] >= threshold && in_entry(entry, row0 + li, col0 + lj + j))
            word |= 1u << j;
        word <<= lj & 31;
#pragma unroll
        for (int o = 1; o < kLanes; o <<= 1)
          word |= __shfl_xor_sync(0xffffffffu, word, o);
        if ((lj & 31) == 0) bits[(li * BN + lj) >> 5] = word;
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
__global__ void __launch_bounds__(kThreads, 2)
    catalog_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int* __restrict__ catalog, int m, int n, int d,
                   float threshold, float* __restrict__ mask,
                   int* __restrict__ packed, int* __restrict__ counts,
                   int capacity) {
  using G = Geometry<BM, BN>;
  extern __shared__ float smem[];
  __shared__ int entry[kNcols];
  __shared__ int warp_sums[kWarps];
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + G::RING_FLOATS);

  const int t = blockIdx.x;
  if (threadIdx.x < kNcols)
    entry[threadIdx.x] = catalog[(size_t)t * kNcols + threadIdx.x];
  for (int w = threadIdx.x; w < G::WORDS; w += kThreads) bits[w] = 0u;
  __syncthreads();
  // An empty validity window (the all-zero rows that pad a chunk) keeps
  // nothing; the condition is uniform over the block.
  if (entry[R0] < entry[R1] && entry[C0] < entry[C1])
    tile_keep_bits<T, BM, BN>(a, b, m, n, d, entry, threshold, smem, bits);
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
__global__ void __launch_bounds__(kThreads, 2)
    dense_kernel(const T* __restrict__ a, const T* __restrict__ b, int m,
                 int n, int d, float threshold, int triangular,
                 float* __restrict__ out) {
  constexpr int VN = Geometry<BM, BN>::VN;
  extern __shared__ float smem[];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (triangular && row0 >= col0 + BN - 1) {
    // Every cell has row >= col: nothing is kept (uniform over the block).
    for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
      const int gi = row0 + e / BN, gj = col0 + e % BN;
      if (gi < m && gj < n) out[(size_t)gi * n + gj] = 0.f;
    }
    return;
  }
  // A run of VN cells is one aligned vector store when N is a multiple of
  // VN (col0 and the run's offset are).
  const bool vec = n % VN == 0;
  tile_mainloop<T, BM, BN>(
      a, b, m, n, d, row0, col0, smem, [&](int li, int lj, const float* s) {
        const int gi = row0 + li, gj = col0 + lj;
        if (gi >= m) return;
        float v[VN];
#pragma unroll
        for (int j = 0; j < VN; ++j)
          v[j] = s[j] >= threshold && (!triangular || gi < gj + j) ? s[j]
                                                                    : 0.f;
        float* o = out + (size_t)gi * n + gj;
        if (vec && gj < n) {
          if constexpr (VN == 4)
            *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
          else if constexpr (VN == 2)
            *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
          else
            o[0] = v[0];
        } else if (!vec) {
#pragma unroll
          for (int j = 0; j < VN; ++j)
            if (gj + j < n) o[j] = v[j];
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
  constexpr int kSmem = Geometry<BM, BN>::RING_FLOATS * 4;
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
