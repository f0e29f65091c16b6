// The mapping score of every record row: the read's orientation, its
// transcript window and the banded affine-gap DP, fused into one launch with
// a group of G lanes per record row.
//
// Replaces no Pallas kernel. The reference scores with XLA
// (rapmap_tpu/ops/align.py, composed by score_records :169-198 and
// score_pe_rows :201-225): extract_ref_windows (:59-108, clipped word
// gathers, a sub-word shift and a static unpack into an (N, L + 2b) window)
// and banded_scores (:111-166), a lax.scan over the L read columns carrying
// the (N, 2b+1) band of H/E scores, whose within-row gap state F is an
// exclusive prefix-max in log2(2b+1) shifted maxes. Eager PyTorch runs that
// scan as ~36 launches a column (ops/align.py banded_scores, the plain
// version), ~3,000 for a 76 bp batch, where a chunk of the mapping path
// takes 555.
//
// What bounds it on the card. Per live record it reads its row's fields,
// the read row (L bytes), ~(L + 2b)/16 + 1 text words and one txp_align
// row, and writes 4 bytes: ~140 bytes for 76 bp. It does min(len, L) x
// (2b+1) cells of ~10 integer operations each, ~11,000 for 76 bp at b = 7,
// so the operations bound it: 32-bit integer add, min and max issue at 64 a
// clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
// arithmetic instruction throughput), ~4x the bytes' time on an H100. What
// stood in the way of that rate was latency: one thread a record made each
// live record one serial chain of L x (2b+1) cells, and the 8,108 live rows
// of a smoke chunk were under 2 warps an SM, nothing to hide it with. The
// design:
//  - A group of G lanes a record (G = 4, 8, 16 or 32 by the band:
//    group_lanes), each lane owning C = ceil((2b+1)/G) consecutive cells of
//    the band in registers. A row costs one __shfl_down_sync (the next
//    lane's first cell of the previous row, as max(H - go, E - ge)), an
//    in-lane prefix max over the lane's C cells, and a cross-lane exclusive
//    prefix max of the lane totals in log2(G) + 1 __shfl_up_sync steps. So a
//    row's chain is C cells and a few shuffles deep, and a smoke chunk's
//    live records are G times as many lanes. Every max(x + y, z) of a cell
//    is one DPX instruction (__viaddmax_s32), Hopper's dynamic-programming
//    instructions, not two.
//  - Inputs are staged once, before the DP, in the group's slice of dynamic
//    shared memory: the read row as the aligned 16-byte chunks that hold it,
//    the window's text words as whole 16-byte quad rows of text2q (row i
//    holds words i..i+3) where the quad lies inside the table, word by word
//    with each index clipped on its own where not; then the oriented read
//    codes and the L + G*C window chars, each lane a share. A row's read
//    code and its one new window char a lane are shared-memory loads off the
//    DP's chain.
//  - Dead rows cost a mask read, not a group. The grid is the card's
//    occupancy (or fewer blocks when the rows are fewer); block b takes rows
//    b, b + grid, b + 2 grid, ..., a thread each: it reads the row's mask
//    byte and writes the 0 of a dead row, and the block packs its live rows
//    into a list (a warp ballot and the warps' counts in shared memory) that
//    its groups then take in turn. So live rows spread evenly over the blocks
//    wherever they lie (live first in a chunk's cap, scattered, the PE stacked
//    rows with dead rows on either side), a warp's groups all score, and
//    nothing syncs with the host.
// Bands above kRegBandMax (and reads longer than kStageMaxCols) take the
// scratch build: one thread a record, H, E and a ring of the window's chars
// in global scratch, as the first version of this kernel did for b > 15.
// Any --bandwidth >= 1 is taken; the plain version never is.
//
// Arithmetic follows the reference exactly: int32 throughout, NEG = -2^20 as
// the -inf stand-in (never INT_MIN, so nothing wraps), the closed-form row
// H = max(Hnf, F) with F = exclusive prefix-max(Hnf + d*ge) - d*ge - (go-ge)
// and E from the left-shifted previous row; the best of H over the band,
// clamped to [0, 4095]. A max is exact in any order, so the split of the
// prefix max over lanes gives the reference's integers. Padding cells (d >=
// 2b+1, after every real cell) hold NEG for H and E and are never updated,
// which is what the shift beyond the band reads. Window char j lives in word
// tw + ((tsub + start + j) >> 4) (arithmetic shift: start may be negative)
// at shift 30 - 2 * ((tsub + start + j) & 15); each word index is clipped on
// its own, as the reference's per-word gathers are, and chars outside [0,
// txp_len) are 5 and never match. An invalid read code is 4, which no
// window char equals.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 20);
constexpr int kScoreMax = (1 << 12) - 1;  // SCORE_BITS = 12
constexpr int kRegBandMax = 63;           // ops/align.py REG_BAND_MAX
constexpr int kStageMaxCols = 16384;      // ops/align.py STAGE_MAX_COLS
constexpr int kThreads = 256;             // a block of the group build
constexpr int kScratchThreads = 128;
constexpr int kCellsPerLane = 2;          // group_lanes' target

// A 1-D integer column read in place: int32 or int64 elements, any stride.
struct IntCol {
  const char* p;
  int64_t stride;  // in elements
  int is64;
  __device__ __forceinline__ int64_t operator[](int64_t i) const {
    if (is64) return __ldg(reinterpret_cast<const long long*>(p) + i * stride);
    return __ldg(reinterpret_cast<const int*>(p) + i * stride);
  }
};

struct Args {
  const int8_t* reads;  // (B, L) codes 1..4, 5 = N
  int64_t B;
  int L;
  IntCol lens, rid, t, pos, strand;
  const uint8_t* valid;  // bool
  int64_t valid_stride;
  const int* text2q;  // word i at text2q[i * text_stride]
  int64_t nw, text_stride;
  bool quad;  // text2q rows of 4 words on 16-byte boundaries: row i holds words i..i+3
  const int* txp_align;  // (n_txps, 3) [offset >> 4, offset & 15, txp_len]
  int64_t n_txps;
  int64_t N;
  int band, ma, mp, go, ge;
  int* scratch;  // (3, 2b+1, N): H, E, window ring; the scratch build only
  int* out;
};

__device__ __forceinline__ int finish(int best) {
  return best < 0 ? 0 : (best > kScoreMax ? kScoreMax : best);
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A record row's fields, clamped as the plain version's gathers clamp.
struct Fields {
  int64_t rid, rlen;
  int len;     // rows of the DP: min(read length, L)
  bool rc;
  int tw, tlen;
  int start;   // window char 0's transcript position (pos - band)
  int goff;    // window char 0 as a char offset from word tw
};

__device__ __forceinline__ Fields load_fields(const Args& a, int64_t r) {
  Fields f;
  f.rid = clamp64(a.rid[r], 0, a.B - 1);
  const int64_t t = clamp64(a.t[r], 0, a.n_txps - 1);
  f.rlen = a.lens[f.rid];
  f.len = f.rlen < 0 ? 0 : (f.rlen > a.L ? a.L : static_cast<int>(f.rlen));
  f.rc = a.strand[r] != 0;
  const int* ta = a.txp_align + t * 3;
  f.tw = __ldg(ta);
  f.tlen = __ldg(ta + 2);
  f.start = static_cast<int>(a.pos[r]) - a.band;
  f.goff = __ldg(ta + 1) + f.start;
  return f;
}

// Read code of the oriented read at column i (0..3, 4 never matches) from its
// forward row: revcomp_batch's rc position i is the complement of column
// rlen-1-i (clamped to the row), NCODE where that falls before column 0.
__device__ __forceinline__ int oriented_code(const uint8_t* row, int L, int64_t rlen, bool rc,
                                             int i) {
  int c;
  if (!rc) {
    c = static_cast<int8_t>(row[i]);
  } else {
    const int src = static_cast<int>(rlen - 1 - i);
    if (src < 0) return 4;
    const int v = static_cast<int8_t>(row[src < L - 1 ? src : L - 1]);
    c = (v >= 1 && v <= 4) ? 5 - v : 5;
  }
  return (c >= 1 && c <= 4) ? c - 1 : 4;
}

// Text word wi (an index into text2q's words), clipped to the table.
__device__ __forceinline__ uint32_t text_word(const Args& a, int64_t wi) {
  wi = clamp64(wi, 0, a.nw - 1);
  return static_cast<uint32_t>(__ldg(a.text2q + wi * a.text_stride));
}

// ---- the group build ---------------------------------------------------------

// One group's slice of the block's shared memory, byte offsets: the read
// row's aligned 16-byte chunks, the window's words as whole quads, the
// oriented read codes, and the window chars (L + G*C of them, so that a
// padding cell's char stays inside).
struct Stage {
  int words, codes, wc, bytes;  // the raw row chunks sit at offset 0
};

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

Stage stage_of(int L, int band, int cells) {
  const int W = L + 2 * band;
  const int nraw = (L + 15) / 16 + 1;
  const int nquads = ((W + 15) / 16 + 1 + 3) / 4;
  Stage s;
  s.words = 16 * nraw;
  s.codes = s.words + 16 * nquads;
  s.wc = s.codes + round16(L);
  s.bytes = s.wc + round16(L + cells);
  return s;
}

// One live record row r, scored by the group (lanes gl = 0..G-1 of gmask)
// with `st` as its stage.
template <int G, int C>
__device__ __forceinline__ void score_row(const Args& a, const Stage& sl, unsigned char* st,
                                          int gl, unsigned gmask, int64_t r) {
  uint4* raw = reinterpret_cast<uint4*>(st);
  uint32_t* words = reinterpret_cast<uint32_t*>(st + sl.words);
  uint8_t* codes = st + sl.codes;
  uint8_t* wc = st + sl.wc;
  const int wb = 2 * a.band + 1;
  const int W = a.L + 2 * a.band;
  const int n_wc = a.L + G * C;
  const int go = a.go, ge = a.ge, ma = a.ma, mp = a.mp;
  const Fields f = load_fields(a, r);  // every lane loads the same words

  // stage: the read row's chunks, then the window's words
  const int8_t* row = a.reads + f.rid * a.L;
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const uint4* chunks = reinterpret_cast<const uint4*>(row - head);
  for (int c = gl; c < ((head + a.L + 15) >> 4); c += G) raw[c] = __ldg(chunks + c);
  const int wlo = f.goff >> 4;  // word m of the stage is text word tw + wlo + m
  const int nwords = ((f.goff + W - 1) >> 4) - wlo + 1;
  for (int q = gl; 4 * q < nwords; q += G) {
    const int64_t w0 = static_cast<int64_t>(f.tw + (wlo + 4 * q));
    if (a.quad && w0 >= 0 && w0 + 3 < a.nw) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(a.text2q) + w0);
      words[4 * q] = v.x;
      words[4 * q + 1] = v.y;
      words[4 * q + 2] = v.z;
      words[4 * q + 3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        words[4 * q + u] = text_word(a, static_cast<int64_t>(f.tw + (wlo + 4 * q + u)));
    }
  }
  __syncwarp(gmask);
  // the oriented codes and the window chars
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(raw) + head;
  for (int i = gl; i < f.len; i += G)
    codes[i] = static_cast<uint8_t>(oriented_code(rb, a.L, f.rlen, f.rc, i));
  for (int j = gl; j < n_wc; j += G) {
    int ch = 5;
    const int p = f.start + j;
    if (j < W && p >= 0 && p < f.tlen) {
      const int g = f.goff + j;
      ch = static_cast<int>((words[(g >> 4) - wlo] >> (30 - 2 * (g & 15))) & 3u);
    }
    wc[j] = static_cast<uint8_t>(ch);
  }
  __syncwarp(gmask);

  // the DP: row i consumes window chars [i, i + 2b]; cell d its char i + d
  int dge[C], fc[C];  // this lane's cells d = gl * C + j
  bool real[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int d = gl * C + j;
    dge[j] = d * ge;
    fc[j] = d * ge + (go - ge);
    real[j] = d < wb;
  }
  int H[C], E[C], w[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    H[j] = real[j] ? 0 : kNeg;  // free leading window gap; padding holds NEG
    E[j] = kNeg;
    const int x = gl * C + j - 1;
    w[j] = x >= 0 ? wc[x] : 5;
  }
  // max(a + b, c) is one DPX instruction on compute capability 9.0
#pragma unroll 4
  for (int i = 0; i < f.len; ++i) {
#pragma unroll
    for (int j = 0; j + 1 < C; ++j) w[j] = w[j + 1];
    w[C - 1] = wc[i + gl * C + C - 1];
    const int rcode = codes[i];
    // shift_left of the previous row: the next lane's first cell
    const int next = __shfl_down_sync(gmask, __viaddmax_s32(E[0], -ge, H[0] - go), 1, G);
    int hnf[C], e2[C], pre[C];
    int q = kNeg;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      e2[j] = j + 1 < C ? __viaddmax_s32(E[j + 1], -ge, H[j + 1] - go) : next;
      hnf[j] = __viaddmax_s32(H[j], w[j] == rcode ? ma : mp, e2[j]);
      pre[j] = q;  // exclusive prefix max within the lane
      q = __viaddmax_s32(hnf[j], dge[j], q);
    }
    // the lanes' totals, inclusive prefix max (a lane below s gets its own
    // value back), then shifted one lane up
#pragma unroll
    for (int s = 1; s < G; s <<= 1) q = max(q, __shfl_up_sync(gmask, q, s, G));
    int before = __shfl_up_sync(gmask, q, 1, G);
    if (gl == 0) before = kNeg;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (real[j]) {
        E[j] = e2[j];
        H[j] = __viaddmax_s32(max(before, pre[j]), -fc[j], hnf[j]);
      }
    }
  }
  int best = kNeg;
#pragma unroll
  for (int j = 0; j < C; ++j) best = real[j] ? max(best, H[j]) : best;
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1) best = max(best, __shfl_xor_sync(gmask, best, s, G));
  if (gl == 0) a.out[r] = finish(best);
  __syncwarp(gmask);  // the stage is the next record's
}

// The block's share of the rows is r = k * gridDim.x + blockIdx.x, k = 0, 1,
// ...: live rows, wherever they lie, spread evenly over the blocks. A round
// reads one row a thread, writes the 0 of each dead one, packs the live ones
// into a list (ballot, then the warps' counts), and the block's groups take
// the list's rows in turn.
template <int G, int C>
__global__ void __launch_bounds__(kThreads) banded_group_kernel(Args a, Stage sl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t live_rows[kThreads];
  __shared__ int warp_live[kThreads / 32];
  const int gl = threadIdx.x & (G - 1);  // lane in the group
  const int gib = threadIdx.x / G;       // group in the block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const unsigned gmask = G == 32 ? 0xFFFFFFFFu : (((1u << G) - 1u) << (lane & ~(G - 1)));
  const int in_warp = blockDim.x - 32 * warp;  // < 32: the block's partial last warp
  const unsigned wmask = in_warp >= 32 ? 0xFFFFFFFFu : (1u << in_warp) - 1u;
  unsigned char* st = smem + static_cast<int64_t>(gib) * sl.bytes;
  const int gpb = blockDim.x / G;
  const int64_t share =
      a.N > blockIdx.x ? (a.N - 1 - static_cast<int64_t>(blockIdx.x)) / gridDim.x + 1 : 0;
  for (int64_t k0 = 0; k0 < share; k0 += blockDim.x) {
    const int64_t k = k0 + threadIdx.x;
    const int64_t r = k * gridDim.x + blockIdx.x;
    bool live = false;
    if (k < share) {
      live = a.valid[r * a.valid_stride] != 0;
      if (!live) a.out[r] = 0;
    }
    const unsigned ballot = __ballot_sync(wmask, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int n = warp_live[w];
      off += w < warp ? n : 0;
      total += n;
    }
    if (live) live_rows[off + __popc(ballot & ((1u << lane) - 1u))] = r;
    __syncthreads();
    for (int e = gib; e < total; e += gpb) score_row<G, C>(a, sl, st, gl, gmask, live_rows[e]);
    __syncthreads();  // the list is the next round's
  }
}

// Lanes a record for a band of wb cells: the fewest (4 at least) that hold it
// at kCellsPerLane cells a lane, else 32.
int group_lanes(int wb) {
  for (int g = 4; g < 32; g <<= 1)
    if (g * kCellsPerLane >= wb) return g;
  return 32;
}

template <int G, int C>
cudaError_t launch_group(const Args& a, cudaStream_t s) {
  const Stage sl = stage_of(a.L, a.band, G * C);
  int dev = 0, n_sm = 0, cap = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int gpb = kThreads / G;  // groups a block: as many as their stages fit
  while (gpb > 1 && static_cast<int64_t>(gpb) * sl.bytes > cap) gpb >>= 1;
  const int64_t smem = static_cast<int64_t>(gpb) * sl.bytes;
  if (smem > cap) return cudaErrorInvalidValue;
  auto kern = banded_group_kernel<G, C>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, gpb * G,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  const int64_t need = (a.N + gpb - 1) / gpb;
  const int64_t resident = static_cast<int64_t>(n_sm) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(need < resident ? need : resident);
  kern<<<grid, gpb * G, static_cast<size_t>(smem), s>>>(a, sl);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_cells(const Args& a, int cells, cudaStream_t s) {
  switch (cells) {
    case 1: return launch_group<G, 1>(a, s);
    case 2: return launch_group<G, 2>(a, s);
    case 3: return launch_group<G, 3>(a, s);
    case 4: return launch_group<G, 4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_groups(const Args& a, cudaStream_t s) {
  const int wb = 2 * a.band + 1;
  const int g = group_lanes(wb);
  const int cells = (wb + g - 1) / g;
  switch (g) {
    case 4: return launch_cells<4>(a, cells, s);
    case 8: return launch_cells<8>(a, cells, s);
    case 16: return launch_cells<16>(a, cells, s);
    case 32: return launch_cells<32>(a, cells, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the scratch build -------------------------------------------------------

// Any band, any read length: one thread a record, H, E and a ring of the
// window's 2b+1 chars in global scratch, laid out [state][d][record] so that
// neighbouring threads touch neighbouring words; window chars are read one
// at a time from a cached text word.
__global__ void __launch_bounds__(kScratchThreads) banded_scratch_kernel(Args a) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.N) return;
  if (!a.valid[r * a.valid_stride]) {
    a.out[r] = 0;
    return;
  }
  const Fields fl = load_fields(a, r);
  const uint8_t* row = reinterpret_cast<const uint8_t*>(a.reads + fl.rid * a.L);
  int64_t cur = -1;  // index of the cached word
  uint32_t word = 0;
  auto window_char = [&](int j) -> int {
    const int p = fl.start + j;
    if (p < 0 || p >= fl.tlen) return 5;
    const int g = fl.goff + j;
    const int64_t wi = clamp64(static_cast<int64_t>(fl.tw + (g >> 4)), 0, a.nw - 1);
    if (wi != cur) {
      cur = wi;
      word = text_word(a, wi);
    }
    return static_cast<int>((word >> (30 - 2 * (g & 15))) & 3u);
  };
  const int wb = 2 * a.band + 1;
  const int64_t N = a.N;
  int* H = a.scratch + r;
  int* E = a.scratch + static_cast<int64_t>(wb) * N + r;
  int* wc = a.scratch + 2 * static_cast<int64_t>(wb) * N + r;  // slot j % wb holds char j
  for (int d = 0; d < wb; ++d) {
    H[d * N] = 0;
    E[d * N] = kNeg;
  }
  for (int j = 0; j + 1 < wb; ++j) wc[j * N] = window_char(j);
  const int go = a.go, ge = a.ge, ma = a.ma, mp = a.mp;
  int base = 0;  // i % wb: the slot of window char i
  for (int i = 0; i < fl.len; ++i) {
    const int last = base == 0 ? wb - 1 : base - 1;  // (i + wb - 1) % wb
    wc[last * N] = window_char(i + wb - 1);
    const int rcode = oriented_code(row, a.L, fl.rlen, fl.rc, i);
    int p = kNeg;
    int slot = base;
    for (int d = 0; d < wb; ++d) {
      // cells d and d + 1 still hold the previous row: d is written last
      const int hs = d + 1 < wb ? H[(d + 1) * N] : kNeg;
      const int es = d + 1 < wb ? E[(d + 1) * N] : kNeg;
      const int e2 = max(hs - go, es - ge);
      const int w = wc[slot * N];
      slot = slot + 1 == wb ? 0 : slot + 1;
      const int sub = w == rcode ? ma : mp;
      const int hnf = max(H[d * N] + sub, e2);
      const int f = p - d * ge - (go - ge);
      p = max(p, hnf + d * ge);
      E[d * N] = e2;
      H[d * N] = max(hnf, f);
    }
    base = base + 1 == wb ? 0 : base + 1;
  }
  int best = H[0];
  for (int d = 1; d < wb; ++d) best = max(best, H[d * N]);
  a.out[r] = finish(best);
}

}  // namespace

// Scores of N record rows: out[r] = the clamped banded score of record r's
// oriented read rid[r] (rows of `reads`, lengths `lens`) against transcript
// t[r]'s window from pos[r] - band, 0 where valid[r] is false; what
// ops/align.py score_records_plain computes. Record columns are int32 or
// int64 (`*64`) with element strides; text2q's word i is at
// text2q[i * text_stride] (with text_stride 4, rows on 16-byte boundaries
// must hold words i..i+3, as the device index's quad rows do). Bands above
// 63 and reads of more than 16,384 columns need `scratch`, (3, 2b+1, N)
// int32. Writes every element of out; launches on `stream`, no sync.
extern "C" int tqm_banded_scores(
    const void* reads, int64_t B, int L, const void* lens, int64_t lens_stride, int lens64,
    const void* rid, int64_t rid_stride, int rid64, const void* t, int64_t t_stride, int t64,
    const void* pos, int64_t pos_stride, int pos64, const void* strand,
    int64_t strand_stride, int strand64, const void* valid, int64_t valid_stride,
    const void* text2q, int64_t nw, int64_t text_stride, const void* txp_align,
    int64_t n_txps, int64_t N, int band, int ma, int mp, int go, int ge, void* scratch,
    void* out, void* stream) {
  const bool grouped = band <= kRegBandMax && L <= kStageMaxCols;
  if (band < 1 || go < ge || B < 1 || L < 1 || nw < 1 || n_txps < 1 || N < 0 ||
      (!grouped && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  Args a;
  a.reads = static_cast<const int8_t*>(reads);
  a.B = B;
  a.L = L;
  a.lens = IntCol{static_cast<const char*>(lens), lens_stride, lens64};
  a.rid = IntCol{static_cast<const char*>(rid), rid_stride, rid64};
  a.t = IntCol{static_cast<const char*>(t), t_stride, t64};
  a.pos = IntCol{static_cast<const char*>(pos), pos_stride, pos64};
  a.strand = IntCol{static_cast<const char*>(strand), strand_stride, strand64};
  a.valid = static_cast<const uint8_t*>(valid);
  a.valid_stride = valid_stride;
  a.text2q = static_cast<const int*>(text2q);
  a.nw = nw;
  a.text_stride = text_stride;
  a.quad = text_stride == 4 && reinterpret_cast<uintptr_t>(text2q) % 16 == 0;
  a.txp_align = static_cast<const int*>(txp_align);
  a.n_txps = n_txps;
  a.N = N;
  a.band = band;
  a.ma = ma;
  a.mp = mp;
  a.go = go;
  a.ge = ge;
  a.scratch = static_cast<int*>(scratch);
  a.out = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grouped) return static_cast<int>(launch_groups(a, s));
  const unsigned grid = static_cast<unsigned>((N + kScratchThreads - 1) / kScratchThreads);
  banded_scratch_kernel<<<grid, kScratchThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
