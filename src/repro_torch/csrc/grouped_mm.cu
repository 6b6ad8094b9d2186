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
// padded rows, d = 1024, F = 512) a call is ~137 GFLOP of real rows against
// ~0.45 GB, near the bf16 ridge, so the tensor cores must carry the product
// at their wgmma rate. At decode (BT = 8, 40 tiles) it reads up to 32
// expert strips of 1 MB for 64 real rows: bytes only, so each strip must be
// read once and the reads kept in flight.
//
// The kernels, chosen by dtype, block_t and alignment (a dispatch stated
// here, never a fallback; each is held against the plain version):
//
// * bf16, BT = 128, d and F multiples of 8 and x, w 16-byte aligned (what
//   TMA needs): grouped_mm_tma, a warp-specialised wgmma + TMA mainloop. A
//   block is one producer warpgroup and two consumer warpgroups (384
//   threads; setmaxnreg moves registers to the consumers); the grid is
//   persistent, one block an SM, walking (row tile, 128-column F tile) work
//   items in row-tile order, so the blocks in flight share x tiles and the
//   expert's w tiles in L2. One producer thread keeps a 5-stage ring full:
//   per 64-deep k chunk, one TMA box of x (128 rows x 64 columns, K-major,
//   128 B swizzle) and two of w[e] (64 d rows x 64 F columns each, MN-major,
//   128 B swizzle), guarded by full and empty mbarriers, and it runs ahead
//   across items, so one item's loads overlap the last item's epilogue.
//   Each consumer owns 64 of the 128 rows and runs wgmma m64n128k16 with x
//   and w straight from shared memory (w through the transposed, MN-major
//   descriptor, as the flash kernel reads V) and f32 accumulators in
//   registers, keeping one k chunk's wgmmas in flight while the next are
//   issued; the epilogue stores bf16 from registers. The x map is encoded
//   per launch; w's maps (which depend only on pointer, shape, strides and
//   dtype) are cached under exactly that key. A ragged d is zero-filled by
//   TMA (the maps' extents are the tensors'), a ragged F is zero-filled in
//   the last box and masked at the store, a box wholly past F is not loaded
//   (it feeds only columns that are not stored), and a tile whose expert id
//   lies outside [0, E) loads nothing and stores zeros.
// * bf16, BT = 8, the same alignment: grouped_mm_decode, a bytes-bound
//   streaming kernel. A run of consecutive tiles with one expert is cut
//   into chunks of up to 4 tiles (32 rows); one block owns one chunk and
//   one or more F tiles, found on the device from tile_expert (the block of
//   a chunk's first tile works, the others return at once), so the tail
//   tiles, which all name expert E - 1, read its strip once per 4 tiles,
//   not once each. Thread 0 streams the expert's d x F-tile strip once by
//   TMA (the cached w map: no tensor map is encoded per launch) through a
//   3-stage ring of 64-row stages, a full mbarrier each, while the chunk's
//   x rows arrive by cp.async beside them; the block applies each stage to
//   every row of the chunk with mma.sync m16n8k16 from ldmatrix fragments
//   (the w boxes read through their 128 B swizzle), 8-row tiles padded to
//   the MMA's 16 rows in shared memory only. A block's streaming rate is
//   bounded (measured: deeper rings did not move it), so the grid must
//   cover the card: F tiles are 256 columns wide where the chunks times
//   those tiles still give every SM a block, else 128, and a block walks
//   several F tiles only when the chunks alone fill two blocks an SM.
// * bf16 rows TMA cannot address (d or F not a multiple of 8, or x, w not
//   16-byte aligned), either block_t: grouped_mm_unaligned, the same
//   chunks with element loads, one stage at a time. No serving shape
//   takes it; it keeps the contract for every shape.
// * f32: grouped_mm_f32, FMA on the CUDA cores (no TF32), so f32 results
//   keep f32 accuracy. f32 is on no serving path.
//
// Every kernel: w is never padded per call, zero rows of x give zero rows,
// and the wait on an mbarrier traps after 10 s, so a lost arrival fails the
// launch instead of hanging the card. The tensor maps come from
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library links no more than the CUDA runtime.

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

// One box of a 2-D / 3-D tensor map at the given coordinates into dst; the
// bytes count against `bar`'s transaction.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One box from shared memory at src into a 2-D tensor map at (c0, c1); the
// parts past the tensor's extents are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and are complete.
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

// wgmma m64nNk16, bf16 x bf16 -> f32, A and B in shared memory, B MN-major.
template <int N>
struct WgmmaTB;

template <>
struct WgmmaTB<128> {
  // d (64 x 128, f32) += A . B, A bf16 in shared memory (K-major), B
  // bf16 in shared memory (MN-major: the transposed descriptor)
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
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
// bf16, BT = 128: wgmma + TMA
// ---------------------------------------------------------------------------

struct TmaCfg {
  static constexpr int BM = 128;                   // rows: one row tile
  static constexpr int BN = 128;                   // F columns a work item
  static constexpr int BK = 64;                    // d columns a k chunk
  static constexpr int NC = 2;                     // consumer warpgroups
  static constexpr int kThreads = 128 * (NC + 1);  // + the producer
  static constexpr int NB = BN / 64;               // 64-column w boxes
  static constexpr int STAGES = 5;
  static constexpr int A_BYTES = BM * BK * 2;      // one x box
  static constexpr int BOX_BYTES = BK * 128;       // one w box
  static constexpr int STAGE_BYTES = A_BYTES + NB * BOX_BYTES;
  // a consumer's output tile, staged for the TMA store: NB boxes of 64
  // rows x 128 B
  static constexpr int OUT_BYTES = NB * 64 * 128;
  // + 1024: the stages start at the first 1024-byte boundary (the 128 B
  // swizzle atom); then the consumers' output tiles; full and empty
  // barriers per stage
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + NC * OUT_BYTES + 8 * 2 * STAGES;
};

// out (tiles * 128, f) = x . w[tile_expert[row tile]]: persistent blocks
// walk work items (row tile, F tile), the producer's TMA ring feeding the
// two consumers' wgmma.
__global__ void __launch_bounds__(TmaCfg::kThreads, 1)
    grouped_mm_tma(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tout,
                   const int* __restrict__ tile_expert, int tiles, int d,
                   int f, int e) {
  using C = TmaCfg;
  constexpr int ST = C::STAGES, BN = C::BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staged = base + ST * C::STAGE_BYTES;   // output tiles
  const uint32_t bars = staged + C::NC * C::OUT_BYTES;
  // ring position `it` (a k-chunk count that runs on across work items) is
  // stage it % ST in round it / ST, whose parity its waits use
  auto full = [&](int it) { return bars + 8 * (it % ST); };
  auto empty = [&](int it) { return bars + 8 * (ST + it % ST); };
  auto stage = [&](int it) { return base + (it % ST) * C::STAGE_BYTES; };
  const int col_tiles = (f + BN - 1) / BN;
  const int items = tiles * col_tiles;
  const int kchunks = (d + C::BK - 1) / C::BK;

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * C::NC) {
      int it = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int rt = w / col_tiles, n0 = (w % col_tiles) * BN;
        const int ex = tile_expert[rt];
        if (ex < 0 || ex >= e) continue;    // the consumers store zeros
        // boxes that reach a column < f (a box wholly past f is not loaded)
        const int boxes = min(C::NB, (f - n0 + 63) / 64);
        for (int kc = 0; kc < kchunks; ++kc, ++it) {
          mbar_wait(empty(it), ((it / ST) & 1) ^ 1);   // round 0 passes
          mbar_expect_tx(full(it), C::A_BYTES + boxes * C::BOX_BYTES);
          const uint32_t st = stage(it);
          tma_load_2d(st, &tx, full(it), kc * C::BK, rt * C::BM);
          for (int j = 0; j < boxes; ++j)
            tma_load_3d(st + C::A_BYTES + j * C::BOX_BYTES, &tw, full(it),
                        n0 + 64 * j, kc * C::BK, ex);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, +64) of each item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t out_tile = staged + wg * C::OUT_BYTES;
    int it = 0;
    // the next item's expert id is read one item ahead
    int ex_next = blockIdx.x < items ? tile_expert[blockIdx.x / col_tiles] : 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int rt = w / col_tiles, n0 = (w % col_tiles) * BN;
      const int ex = ex_next;
      if (w + (int)gridDim.x < items)
        ex_next = tile_expert[(w + gridDim.x) / col_tiles];
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      if (ex >= 0 && ex < e) {
        for (int kc = 0; kc < kchunks; ++kc, ++it) {
          mbar_wait(full(it), (it / ST) & 1);
          const uint32_t st = stage(it);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::BK / 16; ++kk) {
            // x: K-major, 128 B rows, SBO 8 rows; w: MN-major, k16 step kk
            // is 16 rows of the boxes, LBO the distance between boxes
            const uint64_t da = gmma_desc(st + wg * 64 * 128 + kk * 32, 16,
                                          1024, 1);
            const uint64_t db = gmma_desc(st + C::A_BYTES + kk * 16 * 128,
                                          C::BOX_BYTES, 1024, 1);
            WgmmaTB<BN>::ss(acc, da, db);
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
      }
      // epilogue: bf16 into this warpgroup's staged tile (64 rows, NB
      // boxes of 64 columns, 128 B swizzle: 16-byte chunk c of row r at
      // c ^ (r % 8)), then one thread stores it by TMA, which clips the
      // columns past f, and the consumers go on to the next item
      if (tid == 0) bulk_wait_read();   // the last item's store read it
      named_sync(1 + wg, 128);
      // accumulator n8 block nb: rows (g, g + 8) of this warp's 16,
      // columns 8 nb + 2 t, + 1
      const int r0 = (tid >> 5) * 16 + g;
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * nb + 2 * h], acc[4 * nb + 2 * h + 1]);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           out_tile + (nb / 8) * 8192 + r * 128 +
                           (((nb % 8) ^ (r & 7)) << 4) + t * 4),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
      fence_async_smem();
      named_sync(1 + wg, 128);
      if (tid == 0) {
        const int boxes = min(C::NB, (f - n0 + 63) / 64);
        for (int j = 0; j < boxes; ++j)
          tma_store_2d(&tout, out_tile + j * 8192, n0 + 64 * j,
                       rt * C::BM + wg * 64);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait();   // the last stores are complete
  }
}

// ---------------------------------------------------------------------------
// Helpers of the mma.sync kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(in ? 16 : 0)
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  ldmatrix_x4_trans(r, smem_u32(p));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16, BT = 8, TMA-fed: the decode path
// ---------------------------------------------------------------------------

// MT m16 row tiles a chunk, NB 64-column w boxes a block's F tile, ST ring
// stages of 64 d rows. A stage is NB w boxes (64 rows x 128 B, 128 B
// swizzle) and the chunk's x rows (64 d columns padded to 72), on
// 1,024-byte boundaries.
template <int MT, int NB, int ST>
struct DecodeCfg {
  static constexpr int BN = 64 * NB;     // F columns a block's tile
  static constexpr int BK = 64;          // d rows a stage
  static constexpr int kThreads = 128;   // 4 warps, BN / 4 columns each
  static constexpr int STAGES = ST;
  static constexpr int ROWS = 16 * MT;
  static constexpr int LDX = BK + 8;
  static constexpr int BOX_BYTES = BK * 128;
  static constexpr int W_BYTES = NB * BOX_BYTES;
  static constexpr int X_BYTES = (ROWS * LDX * 2 + 1023) / 1024 * 1024;
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
  static constexpr int SMEM = 1024 + ST * STAGE_BYTES + 8 * ST;
  static_assert(BN % 64 == 0 && (BN / 4) % 16 == 0, "warps own n8 pairs");
};

// The decode kernel's two instances: 128- and 256-column F tiles; the
// launch takes the wider where it still gives a block to every SM (see
// launch_decode). Both fit two blocks an SM.
using DecodeNarrow = DecodeCfg<2, 2, 3>;
using DecodeWide = DecodeCfg<2, 4, 3>;

// Block (i, y): as grouped_mm_stream, but the expert's strip arrives by TMA
// (thread 0 issues each stage's boxes, a full mbarrier per stage) while the
// chunk's x rows come by cp.async; no tensor map is encoded per launch (the
// w map is cached).
template <int BT, class C>
__global__ void __launch_bounds__(C::kThreads)
    grouped_mm_decode(const __grid_constant__ CUtensorMap tw,
                      const __nv_bfloat16* __restrict__ x,
                      const int* __restrict__ tile_expert,
                      __nv_bfloat16* __restrict__ out, int tiles, int d,
                      int f, int e) {
  constexpr int CH = C::ROWS / BT;
  constexpr int ST = C::STAGES, LDX = C::LDX;
  constexpr int MT = C::ROWS / 16, WN = C::BN / 32;   // n8 tiles a warp
  static_assert(CH >= 1 && CH < 32 && C::ROWS % BT == 0,
                "chunks hold whole tiles");
  const int i = blockIdx.x;
  const int ex = tile_expert[i];
  const int prev = i % CH != 0 ? tile_expert[i - 1] : 0;
  if (i % CH != 0 && prev == ex) return;   // not a chunk start
  const bool live = ex >= 0 && ex < e;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + ST * C::STAGE_BYTES;
  __shared__ int s_rows;
  const int nk = (d + C::BK - 1) / C::BK;
  const int nft = (f + C::BN - 1) / C::BN;
  const int my_ft = (nft - (int)blockIdx.y + (int)gridDim.y - 1) / gridDim.y;
  const int total = my_ft * nk;   // ring positions: (F tile, k chunk)

  auto issue_w = [&](int it) {   // thread 0
    const int n0 = (blockIdx.y + (it / nk) * gridDim.y) * C::BN;
    const int boxes = min(C::BN / 64, (f - n0 + 63) / 64);
    const uint32_t full = bars + 8 * (it % ST);
    mbar_expect_tx(full, boxes * C::BOX_BYTES);
    for (int j = 0; j < boxes; ++j)
      tma_load_3d(base + (it % ST) * C::STAGE_BYTES + j * C::BOX_BYTES, &tw,
                  full, n0 + 64 * j, (it % nk) * C::BK, ex);
  };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (live)
      for (int s = 0; s < ST - 1 && s < total; ++s) issue_w(s);
  }
  // the chunk's extent, as in grouped_mm_stream
  if (warp == 0) {
    const int jj = i + lane;
    const bool stop = lane >= CH ||
                      (lane >= 1 && (jj >= tiles || jj % CH == 0 ||
                                     tile_expert[jj] != ex));
    const unsigned m = __ballot_sync(0xffffffffu, lane >= 1 && stop);
    if (lane == 0) s_rows = (__ffs(m) - 1) * BT;
  }
  __syncthreads();   // also: the barriers are initialised
  const int row0 = i * BT, rows = s_rows;
  const int mts = (rows + 15) / 16;

  auto load_x = [&](int it) {
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
        gbase + (it % ST) * C::STAGE_BYTES + C::W_BYTES);
    const int k0 = (it % nk) * C::BK;
    for (int p = tid; p < mts * 16 * 8; p += C::kThreads) {
      const int r = p >> 3, c = (p & 7) * 8;
      const bool in = r < rows && k0 + c < d;
      cp_async16(xs + r * LDX + c,
                 x + (size_t)(in ? row0 + r : 0) * d + (in ? k0 + c : 0), in);
    }
  };
  if (live)
    for (int s = 0; s < ST - 1; ++s) {
      if (s < total) load_x(s);
      cp_async_commit();
    }

  float acc[MT][WN][4];
  int it = 0;
  for (int q = 0; q < my_ft; ++q) {
    const int n0 = (blockIdx.y + q * gridDim.y) * C::BN;
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int b = 0; b < WN; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;
    if (live) {
      for (int kc = 0; kc < nk; ++kc, ++it) {
        cp_async_wait<ST - 2>();
        mbar_wait(bars + 8 * (it % ST), (it / ST) & 1);
        __syncthreads();   // stage it landed; stage it - 1 is free again
        if (it + ST - 1 < total) {
          if (tid == 0) {
            // the generic-proxy reads of that stage are done (the barrier
            // above); order them before the async-proxy writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            issue_w(it + ST - 1);
          }
          load_x(it + ST - 1);
        }
        cp_async_commit();
        const uint32_t ws = base + (it % ST) * C::STAGE_BYTES;
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
            gbase + (it % ST) * C::STAGE_BYTES + C::W_BYTES);
#pragma unroll
        for (int ks = 0; ks < C::BK / 16; ++ks) {
          const int krow = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          uint32_t b[WN / 2][4];
#pragma unroll
          for (int j = 0; j < WN / 2; ++j) {
            // this warp's columns 8 WN warp on; the 16-byte chunk of a
            // 128-byte box row sits at chunk ^ (row % 8) (128 B swizzle)
            const int col = warp * 8 * WN + j * 16 + (lane >> 4) * 8;
            ldmatrix_x4_trans(b[j], ws + (col / 64) * C::BOX_BYTES +
                                        krow * 128 +
                                        ((((col % 64) / 8) ^ (krow & 7)) << 4));
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt < mts) {
              uint32_t a[4];
              ldmatrix_x4(a, xs + (mt * 16 + (lane & 15)) * LDX + ks * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
              for (int j = 0; j < WN / 2; ++j) {
                mma_bf16(acc[mt][2 * j], a, b[j][0], b[j][1]);
                mma_bf16(acc[mt][2 * j + 1], a, b[j][2], b[j][3]);
              }
            }
          }
        }
      }
    }
    // f is a multiple of 8 here
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= mts) continue;
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
        const int col = n0 + warp * 8 * WN + nt * 8 + 2 * t;
        if (col >= f) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g + half * 8;
          if (r < rows)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * f +
                                               col) =
                __floats2bfloat162_rn(acc[mt][nt][2 * half],
                                      acc[mt][nt][2 * half + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 rows TMA cannot address (d or F not a multiple of 8, or unaligned)
// ---------------------------------------------------------------------------

// Block (i, y), as the decode kernel's chunks (up to ROWS rows of one
// expert), F columns [64 y, +64): element loads with the ragged edges
// zero, one 64-deep stage at a time, mma.sync from ldmatrix fragments.
// Correctness only: no serving shape takes it.
template <int BT, int ROWS>
__global__ void __launch_bounds__(128)
    grouped_mm_unaligned(const __nv_bfloat16* __restrict__ x,
                         const int* __restrict__ tile_expert,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out, int tiles, int d,
                         int f, int e) {
  constexpr int CH = ROWS / BT, MT = ROWS / 16, LD = 72;
  static_assert(CH >= 1 && ROWS % BT == 0 && ROWS % 16 == 0,
                "chunks hold whole tiles");
  __shared__ __align__(16) __nv_bfloat16 xs[ROWS * LD];
  __shared__ __align__(16) __nv_bfloat16 ws[64 * LD];
  const int i = blockIdx.x;
  const int ex = tile_expert[i];
  if (i % CH != 0 && tile_expert[i - 1] == ex) return;   // not a chunk start
  int j = i + 1;
  while (j < tiles && j % CH != 0 && tile_expert[j] == ex) ++j;
  const int row0 = i * BT, rows = (j - i) * BT, mts = (rows + 15) / 16;
  const int n0 = blockIdx.y * 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][2][4] = {};
  if (ex >= 0 && ex < e) {
    const __nv_bfloat16* wx = w + (size_t)ex * d * f;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int k0 = 0; k0 < d; k0 += 64) {
      __syncthreads();   // the last stage's fragments are read
      for (int p = tid; p < mts * 16 * 64; p += 128) {
        const int r = p / 64, c = p % 64;
        xs[r * LD + c] = r < rows && k0 + c < d
                             ? x[(size_t)(row0 + r) * d + k0 + c] : zero;
      }
      for (int p = tid; p < 64 * 64; p += 128) {
        const int r = p / 64, c = p % 64;
        ws[r * LD + c] = k0 + r < d && n0 + c < f
                             ? wx[(size_t)(k0 + r) * f + n0 + c] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t b[4];   // (k 0-7, k 8-15) of this warp's n8 tiles 0 and 1
        ldmatrix_x4_trans(b, ws + (ks * 16 + ((lane >> 3) & 1) * 8 +
                                   (lane & 7)) * LD +
                                 warp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt < mts) {
            uint32_t a[4];
            ldmatrix_x4(a, xs + (mt * 16 + (lane & 15)) * LD + ks * 16 +
                               (lane >> 4) * 8);
            mma_bf16(acc[mt][0], a, b[0], b[1]);
            mma_bf16(acc[mt][1], a, b[2], b[3]);
          }
        }
      }
    }
  }
  const bool pair_ok = (f & 1) == 0;   // bf16x2 stores stay 4-byte aligned
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= mts) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = n0 + warp * 16 + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + half * 8;
        if (r >= rows) continue;
        __nv_bfloat16* o = out + (size_t)(row0 + r) * f;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (pair_ok && col + 1 < f) {
          *reinterpret_cast<__nv_bfloat162*>(o + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < f) o[col] = __float2bfloat16(v0);
          if (col + 1 < f) o[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// f32 path: FMA on the CUDA cores. A block of 256 threads owns a BT x 64
// tile; thread (ty, tx) = (tid / 64, tid % 64) computes column tx of rows
// ty, ty + 4, ... (BT / 4 accumulators).
constexpr int kBF32 = 64;
constexpr int kThreads32 = 256;
constexpr int kKC = 32;   // d columns a mainloop step

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

// A bf16 tensor map of `rank` dims (innermost first), 64 x `rows` boxes
// (x 1 in a third dim), 128 B swizzle; elements past the extents read as 0.
bool encode_map(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w's maps, cached under exactly what they encode (pointer, shape; the
// strides and dtype follow from the shape): a model's expert weights keep
// their maps across launches. Open addressing from a hash of the pointer,
// kProbe slots deep; a full run overwrites its first slot.
struct WMap {
  const void* ptr;
  int d, f, e;
  CUtensorMap map;
};
constexpr int kMaps = 512, kProbe = 8;   // kMaps a power of two
WMap g_wmaps[kMaps];

bool w_map(CUtensorMap* out, const void* w, int d, int f, int e) {
  const uint64_t h =
      (reinterpret_cast<uintptr_t>(w) >> 8) * 0x9E3779B97F4A7C15ull >> 40;
  WMap* slot = &g_wmaps[h % kMaps];
  for (int i = 0; i < kProbe; ++i) {
    WMap& m = g_wmaps[(h + i) % kMaps];
    if (m.ptr == w && m.d == d && m.f == f && m.e == e) {
      *out = m.map;
      return true;
    }
    if (m.ptr == nullptr) {
      slot = &m;
      break;
    }
  }
  const cuuint64_t dims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)e};
  const cuuint64_t strides[2] = {(cuuint64_t)f * 2, (cuuint64_t)d * f * 2};
  if (!encode_map(out, w, 3, dims, strides, 64)) return false;
  *slot = WMap{w, d, f, e, *out};
  return true;
}

// Per device: the SM count, and whether each kernel's dynamic shared
// memory limit was raised (once, not per launch).
constexpr int kDevices = 64;
int g_sms[kDevices];
const void* g_raised[kDevices][8];

cudaError_t prepare(const void* kernel, int smem, int device) {
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  for (const void* k : g_raised[device])
    if (k == kernel) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  for (const void*& k : g_raised[device])
    if (k == nullptr) {
      k = kernel;
      break;
    }
  return cudaSuccess;
}

cudaError_t sm_count(int device, int* sms) {
  if (g_sms[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = g_sms[device];
  return cudaSuccess;
}

bool tma_ok(const void* x, const void* w, int d, int f) {
  return d % 8 == 0 && f % 8 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

cudaError_t launch_tma(const void* x, const int* te, const void* w, void* out,
                       int tiles, int d, int f, int e, int device,
                       cudaStream_t stream) {
  using C = TmaCfg;
  CUtensorMap tx, tw, tout;
  const cuuint64_t xdims[2] = {(cuuint64_t)d, (cuuint64_t)tiles * C::BM};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d * 2};
  const cuuint64_t odims[2] = {(cuuint64_t)f, (cuuint64_t)tiles * C::BM};
  const cuuint64_t ostrides[1] = {(cuuint64_t)f * 2};
  int sms = 0;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!encode_map(&tx, x, 2, xdims, xstrides, C::BM) ||
        !encode_map(&tout, out, 2, odims, ostrides, 64) ||
        !w_map(&tw, w, d, f, e))
      return cudaErrorInvalidValue;
    auto kernel = grouped_mm_tma;
    cudaError_t err = prepare(reinterpret_cast<const void*>(kernel), C::SMEM,
                              device);
    if (err == cudaSuccess) err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
  }
  const int items = tiles * ((f + C::BN - 1) / C::BN);
  grouped_mm_tma<<<min(items, sms), C::kThreads, C::SMEM, stream>>>(
      tx, tw, tout, te, tiles, d, f, e);
  return cudaSuccess;
}

template <int BT, int ROWS>
void launch_unaligned(const void* x, const int* te, const void* w, void* out,
                      int tiles, int d, int f, int e, cudaStream_t stream) {
  const dim3 grid(tiles, (f + 63) / 64);
  grouped_mm_unaligned<BT, ROWS><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), te,
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      tiles, d, f, e);
}

template <class C>
void launch_decode_as(const CUtensorMap& tw, const void* x, const int* te,
                      void* out, int tiles, int d, int f, int e, int sms,
                      cudaStream_t stream) {
  constexpr int CH = C::ROWS / 8;
  const int nft = (f + C::BN - 1) / C::BN;
  const int chunks = min(tiles, e + (tiles + CH - 1) / CH);
  const int want = max(1, (2 * sms + chunks - 1) / chunks);
  const int per = (nft + want - 1) / want;
  const dim3 grid(tiles, (nft + per - 1) / per);
  grouped_mm_decode<8, C><<<grid, C::kThreads, C::SMEM, stream>>>(
      tw, static_cast<const __nv_bfloat16*>(x), te,
      static_cast<__nv_bfloat16*>(out), tiles, d, f, e);
}

// The decode kernel with 256-column F tiles where the chunks that work (at
// most one per expert run plus one per 4 tiles) times those tiles still
// give every SM a block, else with 128-column tiles: a block's rate is
// bounded, so the grid must cover the card, and wider tiles stream longer
// row segments.
cudaError_t launch_decode(const void* x, const int* te, const void* w,
                          void* out, int tiles, int d, int f, int e,
                          int device, cudaStream_t stream) {
  CUtensorMap tw;
  int sms = 0;
  const int chunks = min(tiles, e + (tiles + 3) / 4);
  bool wide;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (!w_map(&tw, w, d, f, e)) return cudaErrorInvalidValue;
    cudaError_t err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    wide = chunks * ((f + DecodeWide::BN - 1) / DecodeWide::BN) >= sms;
    err = wide ? prepare(reinterpret_cast<const void*>(
                             grouped_mm_decode<8, DecodeWide>),
                         DecodeWide::SMEM, device)
               : prepare(reinterpret_cast<const void*>(
                             grouped_mm_decode<8, DecodeNarrow>),
                         DecodeNarrow::SMEM, device);
    if (err != cudaSuccess) return err;
  }
  if (wide)
    launch_decode_as<DecodeWide>(tw, x, te, out, tiles, d, f, e, sms, stream);
  else
    launch_decode_as<DecodeNarrow>(tw, x, te, out, tiles, d, f, e, sms,
                                   stream);
  return cudaSuccess;
}

template <int BT>
void launch_f32(const void* x, const int* te, const void* w, void* out,
                int tiles, int d, int f, int e, cudaStream_t stream) {
  const dim3 grid(tiles, (f + kBF32 - 1) / kBF32);
  grouped_mm_f32<BT><<<grid, kThreads32, 0, stream>>>(
      static_cast<const float*>(x), te, static_cast<const float*>(w),
      static_cast<float*>(out), d, f, e);
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
  if (caller_device != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  if (block_t != 8 && block_t != 128) {
    err = cudaErrorInvalidValue;
  } else if (!bf16) {
    if (block_t == 128)
      launch_f32<128>(x, te, w, out, tiles, d, f, e, s);
    else
      launch_f32<8>(x, te, w, out, tiles, d, f, e, s);
  } else if (!tma_ok(x, w, d, f)) {
    if (block_t == 8)
      launch_unaligned<8, 32>(x, te, w, out, tiles, d, f, e, s);
    else
      launch_unaligned<128, 128>(x, te, w, out, tiles, d, f, e, s);
  } else if (block_t == 8) {
    err = launch_decode(x, te, w, out, tiles, d, f, e, device, s);
  } else {
    err = launch_tma(x, te, w, out, tiles, d, f, e, device, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  // Leave the caller's current device as it was (PyTorch reads it).
  const cudaError_t restored =
      caller_device != device ? cudaSetDevice(caller_device) : cudaSuccess;
  return err != cudaSuccess ? err : restored;
}

// Dynamic shared memory of one block of bf16 kernel `kernel`, in the order
// of grouped_mm.KERNELS: 0 the wgmma + TMA kernel (block_t 128), 1 and 2
// the decode kernel with 128- and 256-column tiles (block_t 8); -1 past
// them. The Python shared-memory model must agree.
int grouped_mm_smem_bytes(int kernel) {
  switch (kernel) {
    case 0: return TmaCfg::SMEM;
    case 1: return DecodeNarrow::SMEM;
    case 2: return DecodeWide::SMEM;
    default: return -1;
  }
}

const char* grouped_mm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
