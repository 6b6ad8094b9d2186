// Dense thresholded scores of bf16 feature matrices on the tensor cores,
// written by hand for Hopper (sm_90a). Built by repro_torch/kernels/build.py
// into a plain-C shared library and called through ctypes from
// repro_torch/kernels/pair_sim.py.
//
// Replaces, for bf16 inputs that TMA can address, the Pallas TPU kernel
// src/repro/kernels/pair_sim.py pair_scores (_kernel): out (M, N) f32 =
// s where s >= threshold (and, with `triangular`, row < col), 0 elsewhere,
// s = a . b^T for a (M, d), b (N, d) bf16, accumulated in f32. f32 inputs,
// and bf16 inputs TMA cannot address, stay on pair_sim.cu's dense_kernel
// (kernels/pair_sim.py::dense_route states the rule).
//
// What bounds it on an H100: bytes, and only the output's. At 16,384 DS1
// titles, d 256, triangular, the product is 68.7 GFLOP of bf16 (0.069 ms at
// 989 TFLOP/s), the inputs are 8 MB, and the (M, N) f32 output is 1.07 GB
// (0.32 ms at 3.35 TB/s). Every cell is written, kept or not. So the design
// keeps the output stores streaming while the tensor cores compute.
//
// What the design does about it:
// * A persistent grid (as many blocks as fit the SMs) walks the (block_m,
//   block_n) output tiles in row-major order, so the blocks in flight share
//   an A strip and read B (8 MB at DS1) from L2; a grouped raster (8 or 16
//   tile rows walked column by column) measured slower on the H100. A tile
//   is cut into sub-tiles of SM = min(block_m, 128) rows by SN =
//   min(block_n, 128) columns, in row-major order; the kernel is
//   instantiated per (SM, SN).
// * A block is one producer warp and SM / 64 consumer warpgroups. One
//   producer thread keeps a 4-stage ring full: per 64-column chunk of d, one
//   TMA box of a (SM rows) and one of b (SN rows), K-major under the 128 B
//   swizzle, guarded by full and empty mbarriers. It runs ahead across
//   sub-tiles, so the next sub-tile's operands load during an epilogue. The
//   maps' extents are the tensors', so TMA zero-fills rows past M or N and
//   columns past d: nothing is padded or copied.
// * Each consumer warpgroup owns 64 rows of a sub-tile and runs wgmma
//   m64nSNk16 (f32 += bf16 . bf16) with both operands K-major in shared
//   memory (the flash kernel's Q K^T layout), f32 accumulators in registers
//   (SN / 2 a thread, at most 64, so no setmaxnreg is needed), one chunk's
//   wgmmas in flight while the next chunk's are issued. A ragged last chunk
//   runs all four k16 steps over TMA's zeros: a wgmma under a condition
//   makes ptxas serialize every wgmma of the kernel (warning C7520), and
//   the tensor cores have time to spare. bf16 products are exact in f32,
//   so the result differs from the f32 dot of the widened inputs only by
//   the order of the f32 sums.
// * The epilogue thresholds (and masks row >= col) in registers and stages
//   the f32 scores in swizzled shared memory, one 64-row x 32-column box
//   (8 KB) at a time; one thread stores each box by TMA, which clips rows
//   past M and columns past N. Each box is its own bulk group, and a box's
//   staging buffer is rewritten only after the store issued from it one
//   sub-tile earlier has read it (wait_group.read), so the stores of one
//   sub-tile stream out during the next sub-tile's mainloop and epilogue.
// * L2 cache policies: operand loads evict_last, output stores
//   evict_first, so the 1 GB of output streaming through L2 does not evict
//   the 8 MB of operands that every tile re-reads from L2.
// * With `triangular`, a sub-tile wholly on or below the diagonal does no
//   loads and no wgmma: its rows are stored by TMA from a zeroed 8 KB box
//   that is never rewritten. At DS1 that is half the tiles.
//
// TMA needs 16-byte aligned a and b, d % 8 == 0 (the bf16 row stride) and
// N % 4 == 0 (the f32 output's row stride); block_m >= 64 (wgmma's 64
// rows). The launch refuses anything else with cudaErrorInvalidValue; the
// Python route never sends it. A wait on an mbarrier that passes 10 s
// traps, so a lost arrival fails the launch instead of hanging the card.
// The tensor maps come from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links no more than the runtime.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

// ---------------------------------------------------------------------------
// Shared-memory, barrier, TMA and tensor-core helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Returns once the phase of parity `parity` of the barrier has completed;
// traps past 10 s (a lost arrival or transfer).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// L2 cache policies for TMA: operands stay (evict_last), the output
// streams through (evict_first).
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// One box of a 2-D tensor map at (c0, c1) into dst under L2 policy
// `policy`; the bytes count against `bar`'s transaction.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "l"(policy)
      : "memory");
}

// One box from shared memory at src into a 2-D tensor map at (c0, c1) under
// L2 policy `policy`; the parts past the tensor's extents are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// All but this thread's N newest bulk groups have read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// This thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory, made visible to TMA (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1..15) over `threads` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void st_shared_f32x2(uint32_t addr, float x,
                                                float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle layout type (1: 128 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma they belong to.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk16: d (64 x N, f32) += A . B^T, A (64 x 16) and B (N x 16)
// bf16 in shared memory, both K-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Sub-tiles of SM rows x SN columns (SM 64 or 128, SN 32, 64 or 128).
template <int SM, int SN>
struct DenseCfg {
  static constexpr int NC = SM / 64;               // consumer warpgroups
  static constexpr int kThreads = 128 * NC + 32;   // + one producer warp
  static constexpr int BK = 64;                    // d columns a k chunk
  static constexpr int STAGES = 4;
  static constexpr int A_BYTES = SM * BK * 2;      // one a box
  static constexpr int B_BYTES = SN * BK * 2;      // one b box
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_BOX = 64 * 32 * 4;      // 64 rows x 32 f32 columns
  static constexpr int NBOX = SN / 32;             // output boxes a consumer
  static constexpr int STAGED = NC * NBOX * OUT_BOX;   // = SM * SN * 4
  // + 1024: the stages start at the first 1024-byte boundary (the 128 B
  // swizzle atom); the ring, the consumers' staged boxes, the zero box,
  // full and empty barriers per stage
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + STAGED + OUT_BOX + 8 * 2 * STAGES;
  static_assert(SM == 64 || SM == 128, "wgmma's 64-row warpgroups");
  static_assert(SN == 32 || SN == 64 || SN == 128, "a generated wgmma width");
};

// Sub-tile s of work item w: rows [r0, +SM) x cols [c0, +SN). `present`:
// it has a cell inside (M, N); `live`: some cell may be kept (with
// `triangular`, a cell with row < col).
struct Sub {
  int r0, c0;
  bool present, live;
};

template <int SM, int SN>
__device__ __forceinline__ Sub sub_tile(int w, int s, int col_tiles, int bm,
                                        int bn, int m, int n, int tri) {
  const int across = bn / SN;
  Sub u;
  u.r0 = (w / col_tiles) * bm + (s / across) * SM;
  u.c0 = (w % col_tiles) * bn + (s % across) * SN;
  u.present = u.r0 < m && u.c0 < n;
  u.live = u.present && !(tri && u.r0 >= u.c0 + SN - 1);
  return u;
}

// out (m, n) f32 = threshold(a . b^T): persistent blocks walk the
// (bm, bn) tiles, each cut into (SM, SN) sub-tiles; the producer's TMA ring
// feeds the consumers' wgmma, whose epilogue stores by TMA.
template <int SM, int SN>
__global__ void __launch_bounds__(DenseCfg<SM, SN>::kThreads, 1)
    dense_scores_tma(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tout, int m, int n,
                     int d, int bm, int bn, float threshold, int triangular) {
  using C = DenseCfg<SM, SN>;
  constexpr int ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staged = base + ST * C::STAGE_BYTES;
  const uint32_t zero_box = staged + C::STAGED;
  const uint32_t bars = zero_box + C::OUT_BOX;
  // ring position `it` (a k-chunk count that runs on across sub-tiles) is
  // stage it % ST in round it / ST, whose parity its waits use
  auto full = [&](int it) { return bars + 8 * (it % ST); };
  auto empty = [&](int it) { return bars + 8 * (ST + it % ST); };
  auto stage = [&](int it) { return base + (it % ST) * C::STAGE_BYTES; };
  const int col_tiles = (n + bn - 1) / bn;
  const int items = ((m + bm - 1) / bm) * col_tiles;
  const int subs = (bm / SM) * (bn / SN);
  const int kchunks = (d + C::BK - 1) / C::BK;

  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (zero_box -
                                                    smem_u32(smem_raw)));
    for (int i = threadIdx.x; i < C::OUT_BOX / 16; i += C::kThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_async_smem();   // the zero box is read by TMA stores only
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (ST + i), 128 * C::NC);   // every consumer arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::NC) {
    // ---- producer: one thread issues every TMA load ----
    if (threadIdx.x == 128 * C::NC) {
      const uint64_t keep = l2_evict_last();
      int it = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        for (int s = 0; s < subs; ++s) {
          const Sub u =
              sub_tile<SM, SN>(w, s, col_tiles, bm, bn, m, n, triangular);
          if (!u.live) continue;
          for (int kc = 0; kc < kchunks; ++kc, ++it) {
            mbar_wait(empty(it), ((it / ST) & 1) ^ 1);   // round 0 passes
            mbar_expect_tx(full(it), C::STAGE_BYTES);
            const uint32_t st = stage(it);
            tma_load_2d(st, &ta, full(it), kc * C::BK, u.r0, keep);
            tma_load_2d(st + C::A_BYTES, &tb, full(it), kc * C::BK, u.c0,
                        keep);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, +64) of each sub-tile ----
  const int tid = threadIdx.x % 128, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = (tid >> 5) * 16 + g;   // accumulator rows r_lo, r_lo + 8
  const uint32_t my_boxes = staged + wg * C::NBOX * C::OUT_BOX;
  const uint64_t stream = l2_evict_first();
  int it = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    for (int s = 0; s < subs; ++s) {
      const Sub u =
          sub_tile<SM, SN>(w, s, col_tiles, bm, bn, m, n, triangular);
      if (!u.present) continue;
      const int row0 = u.r0 + 64 * wg;   // this warpgroup's first row
      if (!u.live) {
        // every cell has row >= col: store zeros from the zero box
        if (tid == 0 && row0 < m) {
          for (int j = 0; j < C::NBOX; ++j)
            if (u.c0 + 32 * j < n)
              tma_store_2d(&tout, zero_box, u.c0 + 32 * j, row0, stream);
          bulk_commit();
        }
        continue;
      }
      float acc[SN / 2];
#pragma unroll
      for (int i = 0; i < SN / 2; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < kchunks; ++kc, ++it) {
        mbar_wait(full(it), (it / ST) & 1);
        const uint32_t st = stage(it);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk) {
          // K-major, 128 B rows: SBO 8 rows; k16 step kk is 32 bytes in
          const uint64_t da =
              gmma_desc(st + wg * 64 * 128 + kk * 32, 16, 1024, 1);
          const uint64_t db =
              gmma_desc(st + C::A_BYTES + kk * 32, 16, 1024, 1);
          Wgmma<SN>::ss(acc, da, db);
        }
        wgmma_commit();
        if (kc > 0) {   // the previous chunk's wgmmas are done with it
          wgmma_wait<1>();
          mbar_arrive(empty(it - 1));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(it - 1));

      // epilogue, one 32-column box j at a time: threshold (and the
      // triangle) in registers, f32 into the box under the 128 B swizzle
      // (16-byte chunk c of row r at c ^ (r % 8)), then one thread stores
      // it by TMA, which clips rows past m and columns past n
#pragma unroll
      for (int j = 0; j < C::NBOX; ++j) {
        const uint32_t box = my_boxes + j * C::OUT_BOX;
        // the store issued from this box one sub-tile ago has read it
        if (tid == 0) bulk_wait_read<C::NBOX - 1>();
        named_sync(1 + wg, 128);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // accumulator n8 block 4 j + q: rows r_lo + 8 h, columns
            // 8 (4 j + q) + 2 t, + 1 of the sub-tile
            const int r = r_lo + 8 * h;
            const int gi = row0 + r;
            const int gj = u.c0 + 32 * j + 8 * q + 2 * t;
            const float s0 = acc[4 * (4 * j + q) + 2 * h];
            const float s1 = acc[4 * (4 * j + q) + 2 * h + 1];
            const float v0 =
                s0 >= threshold && (!triangular || gi < gj) ? s0 : 0.f;
            const float v1 =
                s1 >= threshold && (!triangular || gi < gj + 1) ? s1 : 0.f;
            st_shared_f32x2(
                box + r * 128 + (((2 * q + (t >> 1)) ^ (r & 7)) << 4) +
                    (t & 1) * 8,
                v0, v1);
          }
        }
        fence_async_smem();
        named_sync(1 + wg, 128);
        if (tid == 0) {
          if (row0 < m && u.c0 + 32 * j < n)
            tma_store_2d(&tout, box, u.c0 + 32 * j, row0, stream);
          bulk_commit();
        }
      }
    }
  }
  if (tid == 0) bulk_wait();   // the last stores are complete
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

std::mutex g_mu;   // guards everything below that a launch reads or fills

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) tensor map of `type` (elements of `bytes` bytes),
// boxes of box_cols x box_rows under the 128 B swizzle (box_cols * bytes
// is 128); elements past the extents read as 0 and are not written.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int bytes,
                const void* ptr, int rows, int cols, int box_cols,
                int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Per device and (SM, SN) instance: blocks that fit one SM times the SM
// count (the persistent grid), found once; the shared-memory limit is
// raised on that first launch.
constexpr int kDevices = 64;
constexpr int kInstances = 6;   // SM in {64, 128} x SN in {32, 64, 128}
int g_grid[kDevices][kInstances];

template <int SM, int SN>
cudaError_t launch(const void* a, const void* b, void* out, int m, int n,
                   int d, int bm, int bn, float threshold, int triangular,
                   int device, cudaStream_t stream) {
  using C = DenseCfg<SM, SN>;
  constexpr int inst = (SM / 64 - 1) * 3 + (SN == 32 ? 0 : SN == 64 ? 1 : 2);
  auto kernel = dense_scores_tma<SM, SN>;
  CUtensorMap ta, tb, tout;
  int grid = 0;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, m, d, 64,
                    SM) ||
        !encode_map(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, n, d, 64,
                    SN) ||
        !encode_map(&tout, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, m, n, 32,
                    64))
      return cudaErrorInvalidValue;
    if (g_grid[device][inst] == 0) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
      int sms = 0, per_sm = 0;
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, C::kThreads, C::SMEM);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      g_grid[device][inst] = sms * per_sm;
    }
    grid = g_grid[device][inst];
  }
  const int items = ((m + bm - 1) / bm) * ((n + bn - 1) / bn);
  kernel<<<min(items, grid), C::kThreads, C::SMEM, stream>>>(
      ta, tb, tout, m, n, d, bm, bn, threshold, triangular);
  return cudaGetLastError();
}

bool on_lattice(int bm, int bn) {
  return (bm == 64 || bm == 128 || bm == 256) &&
         (bn == 32 || bn == 64 || bn == 128 || bn == 256);
}

}  // namespace

extern "C" {

// Launches the bf16 wgmma + TMA dense kernel on `stream` (a cudaStream_t) of
// `device`: out (m, n) f32 gets a . b^T where it is >= threshold (and row <
// col with triangular != 0), 0 elsewhere; a (m, d) and b (n, d) are bf16.
// Returns cudaErrorInvalidValue, launching nothing, unless TMA can address
// the tensors (16-byte aligned a, b and out, d % 8 == 0, n % 4 == 0) and
// (bm, bn) has bm in {64, 128, 256}, bn in {32, 64, 128, 256}; else the
// cudaError_t of the launch (0 on success). Allocates nothing.
int dense_scores_launch(int device, const void* a, const void* b, int m,
                        int n, int d, int bm, int bn, float threshold,
                        int triangular, void* out, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (!on_lattice(bm, bn) || m < 1 || n < 1 || d < 1 || d % 8 != 0 ||
      n % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorInvalidValue;
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err != cudaSuccess) return err;
  if (caller_device != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sm = bm < 128 ? bm : 128, sn = bn < 128 ? bn : 128;
#define DENSE_SCORES_CASE(SM, SN)                                          \
  if (sm == SM && sn == SN)                                                \
    err = launch<SM, SN>(a, b, out, m, n, d, bm, bn, threshold, triangular, \
                         device, s);
  DENSE_SCORES_CASE(64, 32) DENSE_SCORES_CASE(64, 64) DENSE_SCORES_CASE(64, 128)
  DENSE_SCORES_CASE(128, 32) DENSE_SCORES_CASE(128, 64)
  DENSE_SCORES_CASE(128, 128)
#undef DENSE_SCORES_CASE
  // Leave the caller's current device as it was (PyTorch reads it).
  const cudaError_t restored =
      caller_device != device ? cudaSetDevice(caller_device) : cudaSuccess;
  return err != cudaSuccess ? err : restored;
}

// Dynamic shared memory of one block at geometry (bm, bn); -1 off the
// kernel's lattice. The Python shared-memory model must agree.
int dense_scores_smem_bytes(int bm, int bn) {
  if (!on_lattice(bm, bn)) return -1;
  const int sm = bm < 128 ? bm : 128, sn = bn < 128 ? bn : 128;
#define DENSE_SCORES_SMEM(SM, SN) \
  if (sm == SM && sn == SN) return DenseCfg<SM, SN>::SMEM;
  DENSE_SCORES_SMEM(64, 32) DENSE_SCORES_SMEM(64, 64) DENSE_SCORES_SMEM(64, 128)
  DENSE_SCORES_SMEM(128, 32) DENSE_SCORES_SMEM(128, 64)
  DENSE_SCORES_SMEM(128, 128)
#undef DENSE_SCORES_SMEM
  return -1;
}

const char* dense_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
