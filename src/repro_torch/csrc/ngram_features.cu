// The filter features of the ER pipeline -- L2-normalised hashed character
// n-gram counts of every title -- as one CUDA kernel written by hand for
// Hopper (sm_90a). Built by repro_torch/kernels/build.py into a plain-C
// shared library and called through ctypes from repro_torch/kernels/ngram.py.
//
// Replaces no Pallas kernel: the JAX package featurizes on the host with
// NumPy (src/repro/er/encode.py::ngram_features), and so did the port
// (repro_torch/er/encode.py, still the CPU route and the oracle). At the
// paper's DS2 size that host work took ~13 s of a one-shot run and most of
// the resident service's ingest, and its 1.42 GB result then went up to the
// card as a pageable copy; the titles' codes, which the card needs anyway,
// are 64 bytes a title. This kernel makes the features on the card from
// them.
//
// Arithmetic, exactly the NumPy route's: window w of a row is valid iff
// w + n <= len; its n bytes are hashed with 64-bit FNV-1a and counted in
// bucket h % dim. A row with len < n gets one count at the FNV-1a of its
// whole padded row of L bytes. Counts are integers and so is their sum of
// squares; with at most 4,096 windows a row (the wrapper's limit) that sum
// is below 2^24, so NumPy's float32 sum of the squares is exact in any
// order, and __fsqrt_rn of it, then __fdiv_rn of each count by
// max(norm, 1e-12), rounds as NumPy's sqrt and divide do: the features are
// the NumPy route's bit for bit (no fast math in the build flags, no float
// atomics).
//
// Design: one warp a title (a grid-stride loop over rows). The row's
// windows are strided over the 32 lanes; each lane hashes its window from
// global memory (neighbouring lanes read neighbouring bytes) and adds 1 to
// an int histogram of dim entries that the warp owns in shared memory
// (shared atomics). Each lane then owns 4 neighbouring entries at a time:
// it squares them, a shuffle tree sums the row, and the lane writes them as
// one 16-byte store (neighbouring lanes on neighbouring addresses) and
// zeroes them for the next row. A width that is no multiple of 4 takes
// single entries instead. Zero counts skip the divide (0 / d is +0).
//
// What bounds it on an H100: bytes. A row reads its L codes and its length
// and writes dim floats: for DS2, 1.39 M rows x (64 + 4 + 1,024) B =
// 1.52 GB, 0.45 ms at 3.35 TB/s. The ~62 hashes a row (three 64-bit
// multiplies each) and the divides of its <= 62 non-zero counts are far
// below the card's integer and float rates.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 8;
// One warp's histogram has to fit the default 48 KiB of shared memory.
constexpr int kSmemBytes = 48 * 1024;
constexpr int kMaxDim = kSmemBytes / 4;
constexpr int kMaxBlocks = 16384;
constexpr uint64_t kFnvOffset = 14695981039346656037ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

template <bool kVec>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ngram_features_kernel(const uint8_t* __restrict__ codes,
                          const int32_t* __restrict__ lens, int64_t n_rows,
                          int L, int ngram, int dim,
                          float* __restrict__ out) {
  extern __shared__ int hist_all[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* hist = hist_all + warp * dim;
  const bool pow2 = (dim & (dim - 1)) == 0;
  const uint64_t udim = static_cast<uint64_t>(dim);
  for (int j = lane; j < dim; j += 32) hist[j] = 0;
  __syncwarp();

  for (int64_t row = static_cast<int64_t>(blockIdx.x) * warps + warp;
       row < n_rows; row += static_cast<int64_t>(gridDim.x) * warps) {
    const uint8_t* c = codes + row * L;
    const int len = lens[row];
    if (len < ngram) {
      if (lane == 0) {
        uint64_t h = kFnvOffset;
        for (int k = 0; k < L; ++k)
          h = (h ^ static_cast<uint64_t>(__ldg(c + k))) * kFnvPrime;
        hist[pow2 ? (h & (udim - 1)) : (h % udim)] += 1;
      }
    } else {
      const int windows = min(len, L) - ngram + 1;
      for (int w = lane; w < windows; w += 32) {
        uint64_t h = kFnvOffset;
        for (int k = 0; k < ngram; ++k)
          h = (h ^ static_cast<uint64_t>(__ldg(c + w + k))) * kFnvPrime;
        atomicAdd(hist + (pow2 ? (h & (udim - 1)) : (h % udim)), 1);
      }
    }
    __syncwarp();

    // Each lane reads, squares, writes and zeroes only its own entries.
    int ss = 0;
    if (kVec) {
      const int4* h4 = reinterpret_cast<const int4*>(hist);
      for (int j = lane; j < dim / 4; j += 32) {
        const int4 v = h4[j];
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
    } else {
      for (int j = lane; j < dim; j += 32) ss += hist[j] * hist[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float denom = fmaxf(__fsqrt_rn(static_cast<float>(ss)), 1e-12f);
    float* o = out + row * dim;
    if (kVec) {
      int4* h4 = reinterpret_cast<int4*>(hist);
      float4* o4 = reinterpret_cast<float4*>(o);
      for (int j = lane; j < dim / 4; j += 32) {
        const int4 v = h4[j];
        float4 f;
        f.x = v.x ? __fdiv_rn(static_cast<float>(v.x), denom) : 0.0f;
        f.y = v.y ? __fdiv_rn(static_cast<float>(v.y), denom) : 0.0f;
        f.z = v.z ? __fdiv_rn(static_cast<float>(v.z), denom) : 0.0f;
        f.w = v.w ? __fdiv_rn(static_cast<float>(v.w), denom) : 0.0f;
        o4[j] = f;
        h4[j] = make_int4(0, 0, 0, 0);
      }
    } else {
      for (int j = lane; j < dim; j += 32) {
        const int v = hist[j];
        o[j] = v ? __fdiv_rn(static_cast<float>(v), denom) : 0.0f;
        hist[j] = 0;
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Launches the featurizer on `stream` (a cudaStream_t) of `device`: for
// each of the n_rows rows of the (n_rows, L) uint8 codes with int32
// lengths, out[row] (dim f32) gets the row's L2-normalised hashed n-gram
// counts (n = ngram). Returns the cudaError_t of the launch (0 on success);
// allocates nothing.
int ngram_features_launch(int device, const void* codes, const void* lens,
                          long long n_rows, int L, int ngram, int dim,
                          void* out, void* stream) {
  cudaGetLastError();  // clear an earlier, unrelated error
  if (n_rows < 1 || L < 0 || ngram < 1 || dim < 1 || dim > kMaxDim)
    return cudaErrorInvalidValue;
  int caller_device = 0;
  cudaError_t err = cudaGetDevice(&caller_device);
  if (err != cudaSuccess) return err;
  if (caller_device != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  int warps = kSmemBytes / (4 * dim);
  if (warps > kMaxWarps) warps = kMaxWarps;
  const long long want = (n_rows + warps - 1) / warps;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const size_t smem = static_cast<size_t>(warps) * dim * 4;
  const bool vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const int32_t* l = static_cast<const int32_t*>(lens);
  float* o = static_cast<float*>(out);
  if (vec)
    ngram_features_kernel<true><<<blocks, 32 * warps, smem, s>>>(
        c, l, n_rows, L, ngram, dim, o);
  else
    ngram_features_kernel<false><<<blocks, 32 * warps, smem, s>>>(
        c, l, n_rows, L, ngram, dim, o);
  err = cudaGetLastError();
  // Leave the caller's current device as it was (PyTorch reads it).
  const cudaError_t restored =
      caller_device != device ? cudaSetDevice(caller_device) : cudaSuccess;
  return err != cudaSuccess ? err : restored;
}

const char* ngram_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
