// Bitonic sort of (hi, lo) 32-bit word pairs, ascending by the unsigned
// 64-bit value hi * 2^32 + lo, in place. N is a power of two >= 2.
//
// Replaces rapmap_tpu/ops/pallas/sort2.py::bitonic_sort_pairs_pallas, the
// collate voting sort's specialised network (rapmap_tpu/ops/collate.py,
// cfg.bitonic_sort). The Pallas kernel holds all N pairs in VMEM for the
// whole network; on the main path N = expand_budget * chunk = 65,536, whose
// 512 KB do not fit one block's 227 KB of shared memory. So:
//
//   (a) tile_sort: each block sorts one tile of kTile = 4,096 pairs (32 KB of
//       shared memory as 64-bit keys) through every stage k <= kTile;
//   (b) for each stage k > kTile: one global compare-exchange launch per
//       stride j >= kTile, then one tile_merge launch that finishes the
//       strides j < kTile of that stage in shared memory.
//
// The direction for element i is ascending iff (i & k) == 0, as in the
// reference network (sort2.py bitonic_sort_pairs and _kernel). At N = 65,536
// that is 1 + 10 + 4 = 15 launches instead of one per (k, j) step (136).
//
// Bound on the card: bytes. The sort must read and write both words once,
// 16 * N bytes, against ~N/2 * log2(N) * (log2(N)+1) / 2 64-bit compares; at
// N = 65,536 the bytes take ~0.3 us at 3.35 TB/s. Each global pass moves the
// 16 * N bytes again (through the 50 MB L2 at this size), and the tile
// passes cut the global passes from 136 to 10 + 5 tile passes. Launch
// latency, not bandwidth, dominates at this size.
//
// C interface for ctypes: every pointer and the stream are void* on the
// Python side; the function returns the CUDA error code (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;     // pairs per shared-memory tile
constexpr int kThreads = 512;   // threads per tile block
constexpr int kStepThreads = 256;

__device__ __forceinline__ uint64_t load_key(const uint32_t* hi, const uint32_t* lo,
                                             int64_t i) {
  return (static_cast<uint64_t>(hi[i]) << 32) | static_cast<uint64_t>(lo[i]);
}

__device__ __forceinline__ void store_key(uint32_t* hi, uint32_t* lo, int64_t i,
                                          uint64_t v) {
  hi[i] = static_cast<uint32_t>(v >> 32);
  lo[i] = static_cast<uint32_t>(v);
}

// One compare-exchange step (k, j) over the t/2 pairs of a shared tile whose
// element 0 has global index gbase.
__device__ __forceinline__ void tile_step(uint64_t* s, int t, int64_t gbase,
                                          int64_t k, int j) {
  for (int p = threadIdx.x; p < t / 2; p += blockDim.x) {
    const int i = (p / j) * 2 * j + (p % j);  // low element: bit j clear
    const int q = i + j;
    const bool asc = ((gbase + i) & k) == 0;
    const uint64_t a = s[i];
    const uint64_t b = s[q];
    if ((a > b) == asc) {
      s[i] = b;
      s[q] = a;
    }
  }
}

__global__ void tile_sort_kernel(uint32_t* hi, uint32_t* lo, int t) {
  extern __shared__ uint64_t s[];
  const int64_t gbase = static_cast<int64_t>(blockIdx.x) * t;
  for (int i = threadIdx.x; i < t; i += blockDim.x) s[i] = load_key(hi, lo, gbase + i);
  __syncthreads();
  for (int k = 2; k <= t; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      tile_step(s, t, gbase, k, j);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < t; i += blockDim.x) store_key(hi, lo, gbase + i, s[i]);
}

// Strides j < t of stage k (k > t): each tile is independent.
__global__ void tile_merge_kernel(uint32_t* hi, uint32_t* lo, int t, int64_t k) {
  extern __shared__ uint64_t s[];
  const int64_t gbase = static_cast<int64_t>(blockIdx.x) * t;
  for (int i = threadIdx.x; i < t; i += blockDim.x) s[i] = load_key(hi, lo, gbase + i);
  __syncthreads();
  for (int j = t >> 1; j > 0; j >>= 1) {
    tile_step(s, t, gbase, k, j);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < t; i += blockDim.x) store_key(hi, lo, gbase + i, s[i]);
}

// One compare-exchange step (k, j) over all n/2 pairs, j >= t.
__global__ void global_step_kernel(uint32_t* hi, uint32_t* lo, int64_t n, int64_t k,
                                   int64_t j) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n / 2) return;
  const int64_t i = (p / j) * 2 * j + (p % j);
  const int64_t q = i + j;
  const bool asc = (i & k) == 0;
  const uint64_t a = load_key(hi, lo, i);
  const uint64_t b = load_key(hi, lo, q);
  if ((a > b) == asc) {
    store_key(hi, lo, i, b);
    store_key(hi, lo, q, a);
  }
}

}  // namespace

extern "C" int tqm_bitonic_sort_pairs(void* hi_p, void* lo_p, int64_t n, void* stream_p) {
  if (n < 2 || (n & (n - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* hi = static_cast<uint32_t*>(hi_p);
  uint32_t* lo = static_cast<uint32_t*>(lo_p);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  const int t = n < kTile ? static_cast<int>(n) : kTile;
  const unsigned tiles = static_cast<unsigned>(n / t);
  const int threads = t / 2 < kThreads ? t / 2 : kThreads;
  const size_t smem = static_cast<size_t>(t) * sizeof(uint64_t);
  cudaError_t err;

  tile_sort_kernel<<<tiles, threads, smem, stream>>>(hi, lo, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const unsigned step_blocks =
      static_cast<unsigned>((n / 2 + kStepThreads - 1) / kStepThreads);
  for (int64_t k = 2 * static_cast<int64_t>(t); k <= n; k <<= 1) {
    for (int64_t j = k >> 1; j >= t; j >>= 1) {
      global_step_kernel<<<step_blocks, kStepThreads, 0, stream>>>(hi, lo, n, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    tile_merge_kernel<<<tiles, threads, smem, stream>>>(hi, lo, t, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
