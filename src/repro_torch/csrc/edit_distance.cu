// Stage 2 of the ER match job -- the exact normalized edit similarity of
// candidate row pairs -- as one CUDA kernel written by hand for Hopper
// (sm_90a). Built by repro_torch/kernels/build.py into a plain-C shared
// library and called through ctypes from repro_torch/kernels/edit_distance.py.
//
// Replaces no Pallas kernel: the JAX package verifies with a lax.scan over
// the DP rows (src/repro/er/similarity.py::edit_distance), which the port
// first carried over as a PyTorch loop (repro_torch/er/similarity.py, still
// the CPU route and the oracle). That loop issues ~10 small kernels per DP
// row, 64 rows per chunk of 8,192 pairs, and paced both services from the
// host; this kernel verifies every pair of a call in one launch.
//
// Algorithm: Myers' bit-vector Levenshtein in Hyyro's formulation. The
// a-row is the pattern: one bit per a position, 64 positions a word, W
// words (W = ceil(L / 64): 1, 2 or 4). Pv/Mv hold the +1/-1 vertical deltas
// of the current DP column; one step per b character updates them with
// ~17 integer operations a word and tracks the score D[la][j] at bit la - 1.
// Row 0 is D[0][j] = j, so the first word's horizontal carry-in is +1 every
// step (global distance, not substring search); a later word takes the
// carry-out of the word below it (Myers 1999, the block-based step). Carries
// only move up, so bits past la (and codes past the length) never reach the
// score, and words above the one holding row la - 1 are skipped.
//
// Eq (the a positions equal to the b character) is built in registers with
// no table: the a-row's bytes sit in 8 W uint64 registers; each is XORed
// with the b byte broadcast to all 8 lanes, the exact zero-byte test
// ~(((x & 0x7f..) + 0x7f..) | x | 0x7f..) leaves 0x80 in every zero byte
// and nowhere else (the cheaper test with false positives would corrupt
// Eq), and one multiply gathers the 8 flags into 8 bits.
//
// Each thread owns one pair: it gathers the pair's rows itself through the
// survivors' int64 row indices, so neither a[rows_a] nor b[rows_b] is made,
// and writes one f32 similarity 1 - d / max(la, lb, 1), with __fdiv_rn so
// that it is bit for bit the plain route's f32 division (no fast math in
// the build flags). la = 0 gives lb and lb = 0 gives la, as the DP does.
//
// What bounds it on an H100: neither bytes nor FLOPs. A pair reads two
// 64-byte rows, two lengths and two indices (~150 B: 57,000 pairs ~9 MB,
// ~3 us at 3.35 TB/s) and does ~64 x 64 / 64 word steps of ~100 integer
// operations (Eq included); the 64-bit adds and multiplies run as pairs of
// 32-bit ones. At a service's ~57,000 pairs the grid is ~450 blocks of 128
// threads, 3.4 per SM, so the latency of each thread's serial chain of lb
// steps, not throughput, sets the time; the design keeps that chain in
// registers (no shared memory, no local memory) and reads the b-row 8
// bytes at a time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr uint64_t kLow7 = 0x7F7F7F7F7F7F7F7FULL;
constexpr uint64_t kBroadcast = 0x0101010101010101ULL;
// (flags & 0x80 in each byte) * kGather >> 56: byte i's flag to bit i.
constexpr uint64_t kGather = 0x0002040810204081ULL;

// Bytes [j, j + 8) of a row of L codes as one little-endian word, 0 past
// L. `aligned`: L % 8 == 0 and the matrix 8-byte aligned, so one load.
__device__ __forceinline__ uint64_t load8(const uint8_t* row, int j, int L,
                                          bool aligned) {
  if (aligned)
    return __ldg(reinterpret_cast<const unsigned long long*>(row + j));
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (j + k < L) w |= static_cast<uint64_t>(__ldg(row + j + k)) << (8 * k);
  return w;
}

// Bit i set where byte i of `a` equals the byte broadcast in `bc`.
__device__ __forceinline__ uint64_t eq_bits(uint64_t a, uint64_t bc) {
  const uint64_t x = a ^ bc;
  const uint64_t zero = ~(((x & kLow7) + kLow7) | x | kLow7);
  return (zero * kGather) >> 56;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    edit_similarity_kernel(const uint8_t* __restrict__ codes_a,
                           const int32_t* __restrict__ lens_a,
                           const uint8_t* __restrict__ codes_b,
                           const int32_t* __restrict__ lens_b,
                           const int64_t* __restrict__ rows_a,
                           const int64_t* __restrict__ rows_b, int L, int p,
                           bool aligned, float* __restrict__ sim,
                           int32_t* __restrict__ dist) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const int64_t ra = rows_a[i], rb = rows_b[i];
  const int la_raw = lens_a[ra], lb_raw = lens_b[rb];
  // Lengths lie in [0, L] (encode_titles); clamped only to stay in the rows.
  const int la = min(max(la_raw, 0), L), lb = min(max(lb_raw, 0), L);
  const uint8_t* arow = codes_a + ra * L;
  const uint8_t* brow = codes_b + rb * L;

  int d = lb;
  if (la > 0) {
    uint64_t a[8 * W];
#pragma unroll
    for (int k = 0; k < 8 * W; ++k)
      a[k] = 8 * k < L ? load8(arow, 8 * k, L, aligned) : 0;
    uint64_t pv[W], mv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      pv[w] = ~0ULL;
      mv[w] = 0;
    }
    const int last = (la - 1) >> 6;  // the word that holds row la - 1
    const int bit = (la - 1) & 63;
    d = la;                          // D[la][0]
    for (int j0 = 0; j0 < lb; j0 += 8) {
      const uint64_t bw = load8(brow, j0, L, aligned);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (j0 + k >= lb) break;
        const uint64_t bc = ((bw >> (8 * k)) & 0xFF) * kBroadcast;
        int hin = 1;                 // D[0][j] - D[0][j - 1]
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (w > last) break;
          uint64_t eq = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            eq |= eq_bits(a[8 * w + q], bc) << (8 * q);
          const uint64_t xv = eq | mv[w];
          eq |= static_cast<uint64_t>(hin < 0);
          const uint64_t xh = (((eq & pv[w]) + pv[w]) ^ pv[w]) | eq;
          uint64_t ph = mv[w] | ~(xh | pv[w]);
          uint64_t mh = pv[w] & xh;
          if (w == last)
            d += static_cast<int>((ph >> bit) & 1) -
                 static_cast<int>((mh >> bit) & 1);
          const int hout = static_cast<int>(ph >> 63) -
                           static_cast<int>(mh >> 63);
          ph = (ph << 1) | static_cast<uint64_t>(hin > 0);
          mh = (mh << 1) | static_cast<uint64_t>(hin < 0);
          pv[w] = mh | ~(xv | ph);
          mv[w] = ph & xv;
          hin = hout;
        }
      }
    }
  }
  const int mx = max(max(la_raw, lb_raw), 1);
  sim[i] = 1.0f - __fdiv_rn(static_cast<float>(d), static_cast<float>(mx));
  if (dist != nullptr) dist[i] = d;
}

template <int W>
cudaError_t launch(const void* codes_a, const void* lens_a,
                   const void* codes_b, const void* lens_b,
                   const void* rows_a, const void* rows_b, int L, int p,
                   bool aligned, void* sim, void* dist, cudaStream_t stream) {
  const int blocks = (p + kThreads - 1) / kThreads;
  edit_similarity_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(codes_a),
      static_cast<const int32_t*>(lens_a),
      static_cast<const uint8_t*>(codes_b),
      static_cast<const int32_t*>(lens_b),
      static_cast<const int64_t*>(rows_a),
      static_cast<const int64_t*>(rows_b), L, p, aligned,
      static_cast<float*>(sim), static_cast<int32_t*>(dist));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The words a pair's pattern takes at code width L (1, 2 or 4); -1 when the
// kernel has no instance for L (L < 1 or L > 256).
int edit_distance_words(int L) {
  if (L < 1) return -1;
  if (L <= 64) return 1;
  if (L <= 128) return 2;
  if (L <= 256) return 4;
  return -1;
}

// Launches the verifier on `stream` (a cudaStream_t) of `device`: for each
// of the p pairs (rows_a[i], rows_b[i]) (int64 rows of the (na, L) and
// (nb, L) uint8 code matrices, int32 lengths), sim[i] (f32) gets
// 1 - d / max(la, lb, 1) and, when dist is not null, dist[i] (int32) the
// Levenshtein distance d. Returns the cudaError_t of the launch (0 on
// success); allocates nothing.
int edit_distance_launch(int device, const void* codes_a, const void* lens_a,
                         const void* codes_b, const void* lens_b, int L,
                         const void* rows_a, const void* rows_b, int p,
                         void* sim, void* dist, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  const int words = edit_distance_words(L);
  if (words < 0 || p < 1) return cudaErrorInvalidValue;
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err != cudaSuccess) return err;
  if (caller_device != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const bool aligned = L % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(codes_a) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(codes_b) % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words == 1)
    err = launch<1>(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b, L, p,
                    aligned, sim, dist, s);
  else if (words == 2)
    err = launch<2>(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b, L, p,
                    aligned, sim, dist, s);
  else
    err = launch<4>(codes_a, lens_a, codes_b, lens_b, rows_a, rows_b, L, p,
                    aligned, sim, dist, s);
  // Leave the caller's current device as it was (PyTorch reads it).
  const cudaError_t restored =
      caller_device != device ? cudaSetDevice(caller_device) : cudaSuccess;
  return err != cudaSuccess ? err : restored;
}

const char* edit_distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
