// Flash attention (online softmax, GQA in place) written by hand for Hopper
// (sm_90a). Built by repro_torch/kernels/build.py into a plain-C shared
// library and called through ctypes from repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (_kernel): o = softmax(scale . q k^T [causal]) v for
// q (B, H, S, D) against k, v (B, KVH, S, D); query head h reads KV head
// h / (H / KVH) in place, with no repeated K/V.
//
// What bounds it on an H100: operations. Causal prefill at granite-moe's
// shapes (B = 8, H = 16, S = 2048, D = 64) is ~68.7 GFLOP against ~100 MB a
// layer, far above the bf16 ridge, so the tensor cores must carry QK^T and
// PV at their wgmma rate, and the S x S scores must never reach device
// memory.
//
// What the design does about it (bf16, every head dim 16, 32, 64, 128): a
// scaled-down FlashAttention-3 forward. A block is one producer warpgroup
// and two consumer warpgroups (384 threads); setmaxnreg hands the
// producer's registers (down to 24) to the consumers (up to 240), whose
// code fits the 168 registers of the launch bound. The grid is persistent,
// one block an SM: a work item is 128 q rows of one (b, h), each consumer
// owns 64 of them, and a block walks one item in each round of gridDim.x,
// longest (causal) items first and in snake order (forward, then backward)
// so long and short items even out over the blocks. One producer thread
// loads each item's q tile by TMA into one of two buffers, then its K and V
// tiles (128 kv rows, 64 at D = 128) into a 3-stage ring, all guarded by
// full and empty mbarriers, so it runs ahead across items: one item's loads
// overlap the previous item's compute and epilogue. The tensor maps are 3-D,
// (D, S, B*H) for q and (D, S, B*KVH) for k and v, built per launch on the
// host: the S edge is a tensor boundary, TMA zero-fills rows past S, and
// nothing is copied or padded. Each row of a box is D * 2 bytes under the
// swizzle of that width (32, 64 or 128 B); D = 128 loads two 64-column
// boxes. S = Q K^T runs as wgmma m64nBKk16 with q and k both in shared
// memory (K-major descriptors) and f32 accumulators in registers. The online
// softmax works on the accumulator layout in the log2 domain with the scale
// (> 0) folded into one FFMA before ex2.approx: the row max runs as four
// independent chains and then over the quad; m moves only when the row max
// passes it by more than 2^8 (p stays below 256), O is rescaled only when a
// max of the warp moved, and l stays a per-thread partial sum until the
// epilogue. Only a tile reaching past S, or past a consumer's first row when
// causal, is masked, and causal items stop at the diagonal. O += P V runs as
// wgmma with p, rounded to bf16, as the A operand from registers and v as
// the B operand from shared memory through an MN-major (transposed)
// descriptor, so no V fragment is gathered by hand; each tile's PV and the
// next tile's QK^T are issued together, one tensor-core phase between two
// softmaxes. p is rounded to bf16 for PV, where the JAX kernel keeps it in
// f32 (flash_attention.py:74-76); the bf16 tolerance covers it, and l sums
// the f32 p. A fully masked score gives p = 0, and l is clamped at 1e-30 as in
// the JAX kernel. The epilogue normalises by l and stores bf16 straight from
// registers (rows past S are skipped). f32 inputs run an FMA kernel on the
// CUDA cores (32-row q tiles, no TF32). Not done
// yet: one block serving the G query heads of a KV head (each K/V tile is
// loaded once per query head), and overlap of one tile's softmax with the
// next tile's QK^T inside a warpgroup (two score tiles do not fit the 168
// registers at 128 kv rows).
//
// The tensor maps come from cuTensorMapEncodeTiled, a driver-API call,
// reached through cudaGetDriverEntryPoint, so the library links no more
// than the CUDA runtime. A wait on an mbarrier that passes 10 s traps, so a
// lost arrival fails the launch instead of hanging the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;        // running-max start, as in the JAX kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLazy = 8.f;          // log2 of the largest p before m moves

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

template <int D>
struct FlashCfg {
  static constexpr int NC = 2;                       // consumer warpgroups
  static constexpr int BQ = 64 * NC;                 // q rows a block
  static constexpr int BK = D == 128 ? 64 : 128;     // kv rows a tile
  static constexpr int kThreads = 128 * (NC + 1);    // + the producer
  static constexpr int BOXC = D < 64 ? D : 64;       // columns of a TMA box
  static constexpr int NBOX = D / BOXC;              // boxes across D
  static constexpr int RB = BOXC * 2;                // bytes a box row = swizzle
  static constexpr int KPB = BOXC / 16;              // k16 steps a box
  static constexpr int STAGES = 3;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // one K or one V tile
  // wgmma descriptor layout type of the swizzle: B128 1, B64 2, B32 3
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  // barriers: q_full[2], q_empty[2], k_full[STAGES], v_full[STAGES],
  // empty[STAGES]
  static constexpr int BARS = 4 + 3 * STAGES;
  // + 1024: the tiles start at the first 1024-byte boundary (the swizzle
  // atoms must be aligned to their repeat); two q tiles (the next work
  // item's loads while this one finishes), the K/V ring, the barriers
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

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

// Returns once the phase of parity `parity` of the barrier has completed.
// A wait past 10 s means an arrival or a transfer was lost: the kernel traps
// (the launch then fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// One box of a 3-D tensor map at coordinates (c0, c1, c2) into dst; the
// bytes count against `bar`'s transaction.
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

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle layout type.
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma they belong to.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma m64nNk16, bf16 x bf16 -> f32, generated for the N the kernel uses.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (64 x 16, f32) += A . B, A bf16 in registers, B bf16 in shared
  // memory, MN-major (transposed)
  __device__ __forceinline__ static void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32, f32) += A . B, A bf16 in registers, B bf16 in shared
  // memory, MN-major (transposed)
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64, f32) (+)= A . B, A and B bf16 in shared memory, K-major
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d (64 x 64, f32) += A . B, A bf16 in registers, B bf16 in shared
  // memory, MN-major (transposed)
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128, f32) (+)= A . B, A and B bf16 in shared memory, K-major
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d (64 x 128, f32) += A . B, A bf16 in registers, B bf16 in shared
  // memory, MN-major (transposed)
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};


__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The kernel's mbarriers, 8 bytes each from `bars`: q_full[2], q_empty[2]
// (the two q tiles), then k_full, v_full and empty of each ring stage. Ring
// position `it` (a tile count that runs on across work items) is stage
// it % ST in round it / ST, whose parity its waits use.
template <int D>
struct Bars {
  static constexpr int ST = FlashCfg<D>::STAGES;
  uint32_t bars;
  __device__ __forceinline__ uint32_t q_full(int i) const {
    return bars + 8 * i;
  }
  __device__ __forceinline__ uint32_t q_empty(int i) const {
    return bars + 8 * (2 + i);
  }
  __device__ __forceinline__ uint32_t k_full(int it) const {
    return bars + 8 * (4 + it % ST);
  }
  __device__ __forceinline__ uint32_t v_full(int it) const {
    return bars + 8 * (4 + ST + it % ST);
  }
  __device__ __forceinline__ uint32_t empty(int it) const {
    return bars + 8 * (4 + 2 * ST + it % ST);
  }
};

// Work item w of the persistent grid: q tile (longest rows first, as w
// grows) of head bh; `tiles` kv tiles (causal rows stop at the diagonal).
template <int D>
struct Item {
  int bh, q0, tiles;
  __device__ __forceinline__ Item(int w, int heads, int s, int causal) {
    using C = FlashCfg<D>;
    const int q_tiles = (s + C::BQ - 1) / C::BQ;
    bh = w % heads;
    q0 = (q_tiles - 1 - w / heads) * C::BQ;
    tiles = (s + C::BK - 1) / C::BK;
    if (causal) tiles = min(tiles, (min(q0 + C::BQ, s) - 1) / C::BK + 1);
  }
};

// One consumer thread of warpgroup wg, which owns q rows [row_wg, +64) of
// the current work item: the scores of the current kv tile, the output
// accumulator, the running max and normaliser, and the steps of a tile.
// Everything is inlined, so the arrays stay in registers.
template <int D>
struct Consumer {
  using C = FlashCfg<D>;
  static constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES, RB = C::RB;
  Bars<D> bar;
  uint32_t sq, sk, sv;   // the current q tile, the K and V stages
  int wg, t, row_wg, rows[2], s, causal;
  float scale_log2;
  // S: accumulator n8 block nt holds rows (g, g + 8) x columns
  // (8 nt + 2 t, + 1) in sc[4 nt, + 4)
  float sc[BK / 2];
  float acc[D / 2];
  float m[2], l[2];

  // sc = Q K^T of the tile at ring position it, issued and committed, not
  // waited for.
  __device__ __forceinline__ void issue_qk(int it) {
    const uint32_t kst = sk + (it % ST) * C::KV_BYTES;
    mbar_wait(bar.k_full(it), (it / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % C::KPB) * 32;   // bytes into the row
      const uint64_t da = gmma_desc(
          sq + (kk / C::KPB) * BQ * RB + wg * 64 * RB + off, 16, 8 * RB,
          C::LAYOUT);
      const uint64_t db = gmma_desc(kst + (kk / C::KPB) * BK * RB + off, 16,
                                    8 * RB, C::LAYOUT);
      Wgmma<BK>::ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
  }

  // The online softmax of tile j's scores: m, this thread's share of l
  // and acc rescaled, p packed to bf16 as the A operand of PV (the k16
  // step kk is score blocks 2 kk, 2 kk + 1). Only a tile reaching past S,
  // or past this warpgroup's first row when causal, is masked. The scale
  // (> 0) is folded into the exp2: m is the scaled max and p = 2^(s c - m)
  // one FFMA from the raw score. The max and sum run as four independent
  // chains a row, and l stays a per-thread partial sum until the end.
  __device__ __forceinline__ void softmax(int j, uint32_t (&pa)[BK / 16][4]) {
    const int kv0 = j * BK;
    if (kv0 + BK > s || (causal && kv0 + BK - 1 > row_wg)) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = kv0 + (i / 4) * 8 + t * 2 + (i & 1);
        if (col >= s || (causal && col > rows[(i >> 1) & 1]))
          sc[i] = -INFINITY;
      }
    }
    // element i is row (i >> 1) & 1; chain (i >> 2) & 3 of that row
    float mx[2][4], sum[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mx[r][q] = -INFINITY;
        sum[r][q] = 0.f;
      }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i >> 1) & 1][(i >> 2) & 3] =
          fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      // m moves only when the row max passes it by more than kLazy (so p
      // stays below 2^kLazy and O is rarely rescaled); a fully masked row
      // has x = -inf: m stays, alpha = 1
      x *= scale_log2;
      const float m_new = x > m[r] + kLazy ? x : m[r];
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    // p = 2^(s c - m); a masked s = -inf gives p = 0 (m is finite)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m[r]));
      sum[r][(i >> 2) & 3] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * alpha[r] +
             ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_f32(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    // O is rescaled only when a row max of the warp moved (alpha < 1):
    // after the first tiles it rarely does
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
  }

  // acc += P V of the tile at ring position it, issued and committed: v
  // rows [16 kk, +16) of the stage, MN-major B, the second 64-column box
  // (D = 128) BK rows further on.
  __device__ __forceinline__ void issue_pv(int it,
                                           const uint32_t (&pa)[BK / 16][4]) {
    const uint32_t vst = sv + (it % ST) * C::KV_BYTES;
    mbar_wait(bar.v_full(it), (it / ST) & 1);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = gmma_desc(vst + kk * 16 * RB, BK * RB, 8 * RB,
                                    C::LAYOUT);
      Wgmma<D>::rs(acc, pa[kk], db);
    }
    wgmma_commit();
  }
};

// A persistent grid: block b walks one work item in each round of
// gridDim.x (one item is a 128-row q tile of one (b, h); longest first). Its producer
// warpgroup runs ahead through the items' q tiles (two buffers) and K/V
// tiles (the ring), so one item's loads overlap the previous item's
// compute and epilogue.
template <int D>
__global__ void __launch_bounds__(FlashCfg<D>::kThreads, 1)
    flash_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int heads, int h, int kvh,
               int s, float scale_log2, int causal) {
  using C = FlashCfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES, RB = C::RB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;   // see SMEM
  const uint32_t sk = sq + 2 * C::Q_BYTES;             // K stages
  const uint32_t sv = sk + ST * C::KV_BYTES;           // V stages
  const Bars<D> bar{sv + ST * C::KV_BYTES};
  const int items = heads * ((s + BQ - 1) / BQ);
  // this block's n-th work item: round n of gridDim.x items, walked in
  // snake order (forward, then backward) so the long and short items of
  // the longest-first order even out over the blocks
  auto item_index = [&](int n) {
    return n * gridDim.x +
           ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar.q_full(i), 1);
      mbar_init(bar.q_empty(i), 128 * C::NC);   // every consumer arrives
    }
    for (int i = 0; i < ST; ++i) {
      mbar_init(bar.k_full(i), 1);
      mbar_init(bar.v_full(i), 1);
      mbar_init(bar.empty(i), 128 * C::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::NC) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * C::NC) {
      int it = 0;   // ring position
      for (int n = 0;; ++n) {
        const int w = item_index(n);
        if (w >= items) break;
        const Item<D> item(w, heads, s, causal);
        const int kv_row = (item.bh / h) * kvh + (item.bh % h) / (h / kvh);
        const int qb = n & 1;
        mbar_wait(bar.q_empty(qb), ((n >> 1) & 1) ^ 1);   // round 0 passes
        mbar_expect_tx(bar.q_full(qb), C::Q_BYTES);
        for (int x = 0; x < C::NBOX; ++x)
          tma_load_3d(sq + qb * C::Q_BYTES + x * BQ * RB, &tq,
                      bar.q_full(qb), x * C::BOXC, item.q0, item.bh);
        for (int j = 0; j < item.tiles; ++j, ++it) {
          const int st = it % ST;
          mbar_wait(bar.empty(it), ((it / ST) & 1) ^ 1);
          mbar_expect_tx(bar.k_full(it), C::KV_BYTES);
          for (int x = 0; x < C::NBOX; ++x)
            tma_load_3d(sk + st * C::KV_BYTES + x * BK * RB, &tk,
                        bar.k_full(it), x * C::BOXC, j * BK, kv_row);
          mbar_expect_tx(bar.v_full(it), C::KV_BYTES);
          for (int x = 0; x < C::NBOX; ++x)
            tma_load_3d(sv + st * C::KV_BYTES + x * BK * RB, &tv,
                        bar.v_full(it), x * C::BOXC, j * BK, kv_row);
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, g = (tid & 31) >> 2;
    Consumer<D> c;
    c.bar = bar;
    c.sk = sk;
    c.sv = sv;
    c.wg = wg;
    c.t = tid & 3;
    c.s = s;
    c.causal = causal;
    c.scale_log2 = scale_log2;
    int it = 0;   // ring position
    for (int n = 0;; ++n) {
      const int w = item_index(n);
      if (w >= items) break;
      const Item<D> item(w, heads, s, causal);
      const int qb = n & 1;
      c.sq = sq + qb * C::Q_BYTES;
      c.row_wg = item.q0 + wg * 64;
      c.rows[0] = c.row_wg + (tid >> 5) * 16 + g;
      c.rows[1] = c.rows[0] + 8;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) c.acc[i] = 0.f;
      c.m[0] = c.m[1] = kNeg;
      c.l[0] = c.l[1] = 0.f;

      mbar_wait(bar.q_full(qb), (n >> 1) & 1);
      c.issue_qk(it);
      wgmma_wait_all();
      fence_regs(c.sc);
      // tile j: softmax, then its PV and the next tile's QK^T in one
      // tensor-core phase
      for (int j = 0; j < item.tiles; ++j, ++it) {
        uint32_t pa[BK / 16][4];
        c.softmax(j, pa);
        c.issue_pv(it, pa);
        if (j + 1 < item.tiles) c.issue_qk(it + 1);
        wgmma_wait_all();
        fence_regs(c.acc);
        fence_regs(c.sc);
        mbar_arrive(bar.empty(it));
      }
      mbar_arrive(bar.q_empty(qb));   // every QK^T of the item is done

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = c.l[r];   // the row's four partial sums, one per thread
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if (c.rows[r] >= s) continue;
        const float inv = 1.f / fmaxf(l, 1e-30f);
        __nv_bfloat16* orow =
            o + ((size_t)item.bh * s + c.rows[r]) * D + c.t * 2;
#pragma unroll
        for (int u = 0; u < D / 8; ++u)
          *reinterpret_cast<__nv_bfloat162*>(orow + u * 8) =
              __floats2bfloat162_rn(c.acc[4 * u + 2 * r] * inv,
                                    c.acc[4 * u + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// 128 threads own 32 q rows: thread (row, c4) = (tid / 4, tid % 4) scores
// kv columns c4, c4 + 4, ... of a 32-column tile and accumulates output
// dims c4, c4 + 4, ... of its row; a row's four threads are one quad.
constexpr int kBQ32 = 32, kBK32 = 32, kThreads32 = 128;

template <int D>
__global__ void __launch_bounds__(kThreads32)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int h,
              int kvh, int s, float scale_log2, int causal) {
  // dynamic: Qs[32][D + 1], Ks[32][D + 1], Vs[32][D], Ps[32][33] (53 KB
  // at D = 128, past the 48 KB of static shared memory)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float(*Qs)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem_raw);
  float(*Ks)[D + 1] = Qs + kBQ32;
  float(*Vs)[D] = reinterpret_cast<float(*)[D]>(Ks + kBK32);
  float(*Ps)[kBK32 + 1] = reinterpret_cast<float(*)[kBK32 + 1]>(Vs + kBK32);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ32;  // longest rows first
  const int b = bh / h, kv_head = (bh % h) / (h / kvh);
  const size_t q_off = (size_t)bh * s * D;
  const size_t kv_off = ((size_t)b * kvh + kv_head) * s * D;
  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int row = q0 + r;

  for (int e = tid; e < kBQ32 * D; e += kThreads32) {
    const int rr = e / D, dd = e % D;
    Qs[rr][dd] = q0 + rr < s ? q[q_off + (size_t)(q0 + rr) * D + dd] : 0.f;
  }
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  int tiles = (s + kBK32 - 1) / kBK32;
  if (causal) tiles = min(tiles, (min(q0 + kBQ32, s) - 1) / kBK32 + 1);
  for (int j = 0; j < tiles; ++j) {
    const int kv0 = j * kBK32;
    __syncthreads();
    for (int e = tid; e < kBK32 * D; e += kThreads32) {
      const int rr = e / D, dd = e % D;
      const bool in = kv0 + rr < s;
      const size_t off = kv_off + (size_t)(kv0 + rr) * D + dd;
      Ks[rr][dd] = in ? k[off] : 0.f;
      Vs[rr][dd] = in ? v[off] : 0.f;
    }
    __syncthreads();

    float sc[kBK32 / 4];
    float mx = kNeg;
#pragma unroll
    for (int jj = 0; jj < kBK32 / 4; ++jj) {
      const int c = c4 + 4 * jj;
      float dot = 0.f;
#pragma unroll 16
      for (int dd = 0; dd < D; ++dd) dot = fmaf(Qs[r][dd], Ks[c][dd], dot);
      const int col = kv0 + c;
      const bool ok = col < s && (!causal || col <= row);
      sc[jj] = ok ? dot * scale_log2 : -INFINITY;
      mx = fmaxf(mx, sc[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBK32 / 4; ++jj) {
      const float p = sc[jj] == -INFINITY ? 0.f : exp2f(sc[jj] - m);
      Ps[r][c4 + 4 * jj] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    __syncwarp();  // a row's p values come from its own warp
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const int dd = c4 + 4 * i;
      float a = acc[i] * alpha;
#pragma unroll 8
      for (int c = 0; c < kBK32; ++c) a = fmaf(Ps[r][c], Vs[c][dd], a);
      acc[i] = a;
    }
    __syncwarp();
  }
  if (row < s) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 4; ++i)
      o[q_off + (size_t)row * D + c4 + 4 * i] = acc[i] * inv;
  }
}

// Qs[32][D + 1], Ks[32][D + 1], Vs[32][D], Ps[32][33] of flash_f32.
template <int D>
constexpr int f32_smem() {
  return 4 * (2 * kBQ32 * (D + 1) + kBK32 * D + kBQ32 * (kBK32 + 1));
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

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

// The 3-D map of a (planes, s, D) bf16 tensor: boxes of rows x BOXC columns,
// swizzled by the box's row bytes; rows past s read as zeros.
template <int D>
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int s, int planes, int rows) {
  using C = FlashCfg<D>;
  const cuuint64_t dims[3] = {D, (cuuint64_t)s, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {D * 2, (cuuint64_t)s * D * 2};
  const cuuint32_t box[3] = {C::BOXC, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : C::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(int bf16, const void* q, const void* k, const void* v,
                   void* o, int b, int h, int kvh, int s, float scale,
                   int causal, cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  if (bf16) {
    using C = FlashCfg<D>;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    CUtensorMap tq, tk, tv;
    if (!tensor_map<D>(encode, &tq, q, s, b * h, C::BQ) ||
        !tensor_map<D>(encode, &tk, k, s, b * kvh, C::BK) ||
        !tensor_map<D>(encode, &tv, v, s, b * kvh, C::BK))
      return cudaErrorInvalidValue;
    auto kernel = flash_bf16<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    const int items = b * h * ((s + C::BQ - 1) / C::BQ);   // one block an SM
    kernel<<<min(items, sms), C::kThreads, C::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), b * h, h, kvh, s,
        scale_log2, causal);
  } else {
    constexpr int smem = f32_smem<D>();
    auto kernel = flash_f32<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(b * h, (s + kBQ32 - 1) / kBQ32);
    kernel<<<grid, kThreads32, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), h, kvh, s,
        scale_log2, causal);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o (b, h, s, d) = attention of q (b, h, s, d) over k, v (b, kvh, s, d) on
// `stream` (a cudaStream_t) of `device`; query head hh reads KV head
// hh / (h / kvh). bf16 != 0: all four are bf16, else f32. d is 16, 32, 64
// or 128. Returns the cudaError_t of the launch (0 on success); allocates
// nothing.
int flash_attention_launch(int bf16, int device, const void* q, const void* k,
                           const void* v, void* o, int b, int h, int kvh,
                           int s, int d, float scale, int causal,
                           void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err != cudaSuccess) return err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: err = launch<16>(bf16, q, k, v, o, b, h, kvh, s, scale, causal, st); break;
    case 32: err = launch<32>(bf16, q, k, v, o, b, h, kvh, s, scale, causal, st); break;
    case 64: err = launch<64>(bf16, q, k, v, o, b, h, kvh, s, scale, causal, st); break;
    case 128: err = launch<128>(bf16, q, k, v, o, b, h, kvh, s, scale, causal, st); break;
    default: err = cudaErrorInvalidValue;
  }
  // Leave the caller's current device as it was (PyTorch reads it).
  const cudaError_t restored = cudaSetDevice(caller_device);
  return err != cudaSuccess ? err : restored;
}

// Dynamic shared memory of one block for head dim d (bf16 != 0: the wgmma
// kernel, else the f32 one); -1 for a head dim not built. The Python
// shared-memory model must agree.
int flash_attention_smem_bytes(int d, int bf16) {
  switch (d) {
    case 16: return bf16 ? FlashCfg<16>::SMEM : f32_smem<16>();
    case 32: return bf16 ? FlashCfg<32>::SMEM : f32_smem<32>();
    case 64: return bf16 ? FlashCfg<64>::SMEM : f32_smem<64>();
    case 128: return bf16 ? FlashCfg<128>::SMEM : f32_smem<128>();
    default: return -1;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
