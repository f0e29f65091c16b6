// Bitonic sort of (hi, lo) 32-bit word pairs, ascending by the unsigned
// 64-bit value hi * 2^32 + lo. N is a power of two >= 2. Out of place: each
// key is read from the inputs once and written to the outputs once.
//
// Replaces rapmap_tpu/ops/pallas/sort2.py::bitonic_sort_pairs_pallas, the
// collate voting sort's specialised network (rapmap_tpu/ops/collate.py,
// cfg.bitonic_sort). The Pallas kernel holds all N pairs in VMEM for the
// whole network. On the main path N = expand_budget * chunk = 65,536: 512 KB
// as 64-bit keys, more than one block's 227 KB of shared memory but not more
// than a thread-block cluster's. The entry picks one of three paths by N:
//
//   cluster (8,192 <= N <= 65,536): ONE launch of one cluster of N / 8,192
//       blocks (8 at the main path's N, the portable maximum). Each block
//       keeps its 8,192 keys in registers, 8 a thread, for the whole network,
//       and shared memory is only the exchange medium:
//         strides 1, 2, 4        in the thread's own registers (it holds 8
//                                consecutive keys), no barrier;
//         strides 8 .. 64        warp shuffles, no barrier;
//         strides 128 .. 4,096   through the block's shared memory, three
//                                strides per barrier: a thread picks up the 8
//                                keys that differ in three index bits;
//         strides >= 8,192       the partner block's copy of the same keys,
//                                read through distributed shared memory in
//                                the layout of strides 1,024 .. 4,096
//                                (consecutive threads read consecutive keys:
//                                strided remote reads were measured several
//                                times slower), one cluster.sync() per stride in
//                                place of a kernel boundary. Two buffers, so
//                                a block never overwrites what its partner
//                                still reads.
//       Inside stage k the keys whose index has bit k set ride complemented,
//       so every compare-exchange is "smaller key to the lower index" and
//       carries no direction logic. The 136 steps cost 21 block barriers and
//       6 cluster barriers. Shuffles move 16 lanes a clock, so a shuffle
//       stride costs as much as a round trip through shared memory; doing
//       strides 16 .. 64 through shared memory too was measured and is no
//       faster.
//   one block (N <= 4,096): tile_sort alone, one launch.
//   tiled (N > 65,536): tile_sort on 4,096-key tiles, then per larger stage
//       one global compare-exchange launch per stride >= 4,096 and one
//       tile_merge launch for the rest.
//
// The direction for element i is ascending iff (i & k) == 0 on every path,
// as in the reference network (sort2.py bitonic_sort_pairs and _kernel).
//
// Bound on the card: bytes (16 * N: both words read once, written once;
// ~0.3 us at N = 65,536 and 3.35 TB/s, against 4.5 M 64-bit compares). No
// single launch can meet that: at this N the sort is latency-bound, not
// byte-bound. One launch costs several microseconds before its first
// instruction, and the network is 136 dependent steps of which 8 SMs can
// work on at a time. The yardstick that can be met is torch.sort's time on
// the same keys; the byte bound stays in the records for what it is.
//
// Not Triton: clusters and distributed shared memory are not reachable from
// it.
//
// C interface for ctypes: every pointer and the stream are void* on the
// Python side; the sort returns the CUDA error code (0 = success).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

__global__ void tile_sort_kernel(const uint32_t* in_hi, const uint32_t* in_lo,
                                 uint32_t* hi, uint32_t* lo, int t) {
  extern __shared__ uint64_t s[];
  const int64_t gbase = static_cast<int64_t>(blockIdx.x) * t;
  for (int i = threadIdx.x; i < t; i += blockDim.x) s[i] = load_key(in_hi, in_lo, gbase + i);
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

// ---- the cluster path -----------------------------------------------------

constexpr int kKeys = 8;                          // keys a thread holds
constexpr int kClusterThreads = 1024;
constexpr int kClusterTile = kKeys * kClusterThreads;  // 8,192 keys a block
constexpr int kMaxCluster = 8;                    // portable cluster size
// Shared-memory slot of tile index i: one pad slot per 16 keys, so that both
// access patterns are free of bank conflicts: a thread's own 8 consecutive
// keys (lanes 64 bytes apart) and consecutive keys across lanes.
__device__ __forceinline__ int slot_of(int i) { return i + (i >> 4); }
constexpr int kBufSlots = kClusterTile + (kClusterTile >> 4);
constexpr size_t kClusterSmem = 2 * kBufSlots * sizeof(uint64_t);  // two buffers

// Inside a stage every key whose index has bit k set is held complemented,
// which turns its descending runs into ascending ones: every
// compare-exchange of the stage then puts the smaller key at the lower index.
__device__ __forceinline__ void exchange(uint64_t& a, uint64_t& c) {
  const uint64_t mn = a < c ? a : c;
  const uint64_t mx = a < c ? c : a;
  a = mn;
  c = mx;
}

// Strides 4*jlo, 2*jlo, jlo (those below k) on the 8 keys v[m] at indices
// i0 + m * jlo.
__device__ __forceinline__ void reg_steps(uint64_t (&v)[kKeys], int jlo, int k) {
#pragma unroll
  for (int b = 2; b >= 0; --b) {
    if ((jlo << b) >= k) continue;
#pragma unroll
    for (int m = 0; m < kKeys; ++m) {
      if (m & (1 << b)) continue;
      exchange(v[m], v[m | (1 << b)]);
    }
  }
}

// The 8 keys of thread q in the layout that holds strides 4*jlo, 2*jlo, jlo
// in one thread: tile indices group_base(q, jlo) + m * jlo. Consecutive
// threads take consecutive keys, so shared-memory accesses (the partner
// block's too) are contiguous across a warp.
__device__ __forceinline__ int group_base(int q, int jlo) {
  return ((q & ~(jlo - 1)) << 3) | (q & (jlo - 1));
}

__device__ __forceinline__ void load_group(uint64_t (&v)[kKeys], const uint64_t* s, int i0,
                                           int jlo) {
#pragma unroll
  for (int m = 0; m < kKeys; ++m) v[m] = s[slot_of(i0 + m * jlo)];
}

__device__ __forceinline__ void store_group(const uint64_t (&v)[kKeys], uint64_t* s, int i0,
                                            int jlo) {
#pragma unroll
  for (int m = 0; m < kKeys; ++m) s[slot_of(i0 + m * jlo)] = v[m];
}

__global__ void __launch_bounds__(kClusterThreads)
cluster_sort_kernel(const uint32_t* __restrict__ in_hi, const uint32_t* __restrict__ in_lo,
                    uint32_t* __restrict__ out_hi, uint32_t* __restrict__ out_lo) {
  extern __shared__ uint64_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks()) * kClusterTile;
  const int tile_base = rank * kClusterTile;
  const int q = threadIdx.x;
  const int home = q * kKeys;            // tile index of v[0] at home
  const int g0 = tile_base + home;       // its global index
  const int lane = q & 31;
  const int a0 = group_base(q, 1024);    // strides 4,096 .. 1,024
  const int b0 = group_base(q, 128);     // strides 512 .. 128
  int cur = 0;                           // buffer the next write goes to

  uint64_t v[kKeys];
  {
    const uint4* h4 = reinterpret_cast<const uint4*>(in_hi + g0);
    const uint4* l4 = reinterpret_cast<const uint4*>(in_lo + g0);
    const uint4 ha = h4[0], hb = h4[1], la = l4[0], lb = l4[1];
    const uint32_t h[kKeys] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
    const uint32_t l[kKeys] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
#pragma unroll
    for (int e = 0; e < kKeys; ++e) v[e] = (static_cast<uint64_t>(h[e]) << 32) | l[e];
  }

  for (int k = 2; k <= n; k <<= 1) {
    // keys of descending runs ride complemented: undo the last stage's
    // complement (bit k/2 of the index) and apply this one's (bit k)
#pragma unroll
    for (int e = 0; e < kKeys; ++e) {
      const int i = g0 + e;
      if (((i & k) != 0) != ((i & (k >> 1)) != 0 && k > 2)) v[e] = ~v[e];
    }
    if (k > 128) {
      // strides >= 128 go through shared memory, three a layout
      uint64_t* s = smem + cur * kBufSlots;
      store_group(v, s, home, 1);
      if (k > kClusterTile) {
        // strides across blocks: the partner's copy of the same keys, read
        // through distributed shared memory
        cluster.sync();
        load_group(v, s, a0, 1024);
        for (int j = k >> 1; j >= kClusterTile; j >>= 1) {
          const int d = j / kClusterTile;
          const uint64_t* theirs = cluster.map_shared_rank(s, rank ^ d);
          const bool upper = (rank & d) != 0;
#pragma unroll
          for (int m = 0; m < kKeys; ++m) {
            const uint64_t p = theirs[slot_of(a0 + m * 1024)];
            v[m] = ((p < v[m]) != upper) ? p : v[m];
          }
          // the partner may still be reading the buffer just used
          cur ^= 1;
          s = smem + cur * kBufSlots;
          if (j > kClusterTile) {
            store_group(v, s, a0, 1024);
            cluster.sync();
          }
        }
        reg_steps(v, 1024, k);
        store_group(v, s, a0, 1024);
        __syncthreads();
      } else {
        __syncthreads();
        if (k > 1024) {
          load_group(v, s, a0, 1024);
          reg_steps(v, 1024, k);
          store_group(v, s, a0, 1024);
          __syncthreads();
        }
      }
      load_group(v, s, b0, 128);
      reg_steps(v, 128, k);
      store_group(v, s, b0, 128);
      __syncthreads();
      load_group(v, s, home, 1);
    }
    // strides 64 .. 8 between the lanes of a warp
#pragma unroll
    for (int j = 64; j >= kKeys; j >>= 1) {
      if (j >= k) continue;
      const int d = j / kKeys;
      const bool upper = (lane & d) != 0;
#pragma unroll
      for (int e = 0; e < kKeys; ++e) {
        const uint64_t p = __shfl_xor_sync(0xFFFFFFFFu, v[e], d);
        v[e] = ((p < v[e]) != upper) ? p : v[e];
      }
    }
    // strides 4, 2, 1 in the thread's own registers
    reg_steps(v, 1, k);
  }
  // in the last stage (k == n) no index has bit k set: no key is left
  // complemented

  {
    uint4 ha, hb, la, lb;
    ha.x = v[0] >> 32; ha.y = v[1] >> 32; ha.z = v[2] >> 32; ha.w = v[3] >> 32;
    hb.x = v[4] >> 32; hb.y = v[5] >> 32; hb.z = v[6] >> 32; hb.w = v[7] >> 32;
    la.x = static_cast<uint32_t>(v[0]); la.y = static_cast<uint32_t>(v[1]);
    la.z = static_cast<uint32_t>(v[2]); la.w = static_cast<uint32_t>(v[3]);
    lb.x = static_cast<uint32_t>(v[4]); lb.y = static_cast<uint32_t>(v[5]);
    lb.z = static_cast<uint32_t>(v[6]); lb.w = static_cast<uint32_t>(v[7]);
    uint4* h4 = reinterpret_cast<uint4*>(out_hi + g0);
    uint4* l4 = reinterpret_cast<uint4*>(out_lo + g0);
    h4[0] = ha; h4[1] = hb; l4[0] = la; l4[1] = lb;
  }
  // no block may exit while a partner can still read its shared memory
  cluster.sync();
}

}  // namespace

// Which path the sort takes at N: 0 = one block, 1 = one cluster launch,
// 2 = tiled passes.
extern "C" int tqm_bitonic_sort_path(int64_t n) {
  if (n <= kTile) return 0;
  if (n >= kClusterTile && n <= static_cast<int64_t>(kMaxCluster) * kClusterTile) return 1;
  return 2;
}

extern "C" int tqm_bitonic_sort_pairs(const void* in_hi_p, const void* in_lo_p,
                                      void* out_hi_p, void* out_lo_p, int64_t n,
                                      void* stream_p) {
  if (n < 2 || (n & (n - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* in_hi = static_cast<const uint32_t*>(in_hi_p);
  const uint32_t* in_lo = static_cast<const uint32_t*>(in_lo_p);
  uint32_t* hi = static_cast<uint32_t*>(out_hi_p);
  uint32_t* lo = static_cast<uint32_t*>(out_lo_p);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  cudaError_t err;

  if (tqm_bitonic_sort_path(n) == 1) {
    // 16-byte vector loads and stores
    if ((reinterpret_cast<uintptr_t>(in_hi) | reinterpret_cast<uintptr_t>(in_lo) |
         reinterpret_cast<uintptr_t>(hi) | reinterpret_cast<uintptr_t>(lo)) & 15)
      return static_cast<int>(cudaErrorMisalignedAddress);
    // above the 48 KB default; the attribute is per device, so ask every time
    err = cudaFuncSetAttribute(cluster_sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kClusterSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>(n / kClusterTile);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = kClusterSmem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, cluster_sort_kernel, in_hi, in_lo, hi, lo);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }

  const int t = n < kTile ? static_cast<int>(n) : kTile;
  const unsigned tiles = static_cast<unsigned>(n / t);
  const int threads = t / 2 < kThreads ? t / 2 : kThreads;
  const size_t smem = static_cast<size_t>(t) * sizeof(uint64_t);

  tile_sort_kernel<<<tiles, threads, smem, stream>>>(in_hi, in_lo, hi, lo, t);
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
