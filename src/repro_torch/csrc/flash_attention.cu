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
// PV, and the S x S scores must never reach device memory.
//
// What the design does about it: one block per (b*h, 64-row q tile), four
// warps of 16 q rows each. The block stages its q tile once, keeps the q
// fragments in registers, and walks 64-row K/V tiles through shared memory
// (rows padded by 8 bf16 so fragment reads do not conflict on banks). For
// bf16, QK^T runs on mma.sync m16n8k16 (bf16 x bf16 -> f32; the products are
// exact). The running max m, normaliser l and the output accumulator stay in
// registers; scores and softmax are f32 in the log2 domain. The score
// fragment is reused in place as the A operand of PV, which rounds p to bf16
// before the second mma.sync -- the JAX kernel keeps p in f32 there
// (flash_attention.py:74-76); l sums the f32 p. f32 inputs run an FMA
// kernel on the CUDA cores (32-row q tiles, no TF32). Causal blocks stop at
// the diagonal tile, and the q tiles launch in reverse order so the longest
// causal rows start first. Ragged S is masked in the kernel (no padded
// copies of q, k or v); a fully masked score gives p = 0, and l is clamped
// at 1e-30 as in the JAX kernel. Head dims 16, 32, 64 and 128 are template
// instances. Not done yet: wgmma, TMA, warp specialisation -- later PRs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;        // running-max start, as in the JAX kernel
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64, kBK = 64, kThreads16 = 128;

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of a (S, D) matrix into dst (64 x LD); rows past
// S read as 0. D is a multiple of 8 and the rows are 16-byte aligned.
template <int D, int LD>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ src,
                                           int s, int row0,
                                           __nv_bfloat16* __restrict__ dst) {
  constexpr int kVecs = kBQ * D / 8;
#pragma unroll
  for (int v = threadIdx.x; v < kVecs; v += kThreads16) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < s)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads16)
    flash_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int h, int kvh, int s,
               float scale_log2, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int b = bh / h, kv_head = (bh % h) / (h / kvh);
  const size_t q_off = (size_t)bh * s * D;
  const size_t kv_off = ((size_t)b * kvh + kv_head) * s * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  stage_rows<D, LD>(q + q_off, s, q0, Qs);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* r = Qs + (warp * 16 + g) * LD + ks * 16 + t * 2;
    qf[ks][0] = ld32(r);
    qf[ks][1] = ld32(r + 8 * LD);
    qf[ks][2] = ld32(r + 8);
    qf[ks][3] = ld32(r + 8 * LD + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int u = 0; u < D / 8; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int tiles = (s + kBK - 1) / kBK;
  if (causal) tiles = min(tiles, (min(q0 + kBQ, s) - 1) / kBK + 1);
  for (int j = 0; j < tiles; ++j) {
    const int kv0 = j * kBK;
    __syncthreads();  // the previous tile's K/V reads are done
    stage_rows<D, LD>(k + kv_off, s, kv0, Ks);
    stage_rows<D, LD>(v + kv_off, s, kv0, Vs);
    __syncthreads();

    float sc[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + t * 2;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_bf16(sc[nt], qf[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }

    // mask, scale (log2 domain) and the running max of rows g and g + 8
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kv0 + nt * 8 + t * 2 + (i & 1);
        const int row = rows[i >> 1];
        const bool ok = col < s && (!causal || col <= row);
        sc[nt][i] = ok ? sc[nt][i] * scale_log2 : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[nt][i]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = sc[nt][i];
        const float p = x == -INFINITY ? 0.f : exp2f(x - m[i >> 1]);
        sc[nt][i] = p;
        sum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int u = 0; u < D / 8; ++u) {
      acc[u][0] *= alpha[0];
      acc[u][1] *= alpha[0];
      acc[u][2] *= alpha[1];
      acc[u][3] *= alpha[1];
    }

    // acc += p . V: the score fragment of kv columns [16kk, 16kk + 16) is
    // the A fragment of the k16 step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_f32(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_f32(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_f32(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const __nv_bfloat16* vr = Vs + (kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int u = 0; u < D / 8; ++u) {
        const __nv_bfloat16* c = vr + u * 8;
        mma_bf16(acc[u], a, pack_bf16(c[0], c[LD]),
                 pack_bf16(c[8 * LD], c[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= s) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + q_off + (size_t)rows[r] * D + t * 2;
#pragma unroll
    for (int u = 0; u < D / 8; ++u)
      *reinterpret_cast<__nv_bfloat162*>(orow + u * 8) = __floats2bfloat162_rn(
          acc[u][2 * r] * inv, acc[u][2 * r + 1] * inv);
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

template <int D>
cudaError_t launch(int bf16, const void* q, const void* k, const void* v,
                   void* o, int b, int h, int kvh, int s, float scale,
                   int causal, cudaStream_t stream) {
  const float scale_log2 = scale * kLog2e;
  if (bf16) {
    constexpr int smem = 3 * kBQ * (D + 8) * 2;
    auto kernel = flash_bf16<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(b * h, (s + kBQ - 1) / kBQ);
    kernel<<<grid, kThreads16, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        h, kvh, s, scale_log2, causal);
  } else {
    constexpr int smem =
        4 * (2 * kBQ32 * (D + 1) + kBK32 * D + kBQ32 * (kBK32 + 1));
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

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
