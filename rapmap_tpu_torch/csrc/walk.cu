// The anchor walk of the MMP scan, with the extension inside it as device
// functions: one thread per lane, each looping to its own convergence; and,
// built without an extension, the pseudo walks.
//
// Replaces no Pallas kernel. The reference runs this as XLA lax.while_loops,
// which XLA compiles into one program: the strand-paired walk
// (rapmap_tpu/ops/mmp.py:190-248, after next- and previous-anchor tables
// built with cumulative min/max scans, :161-170) and the walk over explicit
// lanes of the binary-search probe path (scan_batch, :367-457, while_loop
// :419-456), each calling an extension every trip: the packed word compare
// (rapmap_tpu/ops/extend_packed.py:154-286) or, with packed_extension off,
// the charwise one (_extend :74-97, a while_loop over _col_lower_bound
// :49-71). Eager PyTorch has no counterpart: the plain versions
// (ops/mmp.py anchor_walk_plain, anchor_walk_lanes_plain, _extend;
// ops/extend_packed.py extend_packed) build the tables and then issue
// thousands of small launches per chunk, every trip for every lane whether
// or not it is active, and the charwise loop syncs with the host each depth.
// Here a lane's searches stop at lo == hi and its walk at pos >= S, so no
// masked trip runs and nothing syncs with the host. The pseudo walks
// (rapmap_tpu/models/pseudo.py pseudo_scan_batch_paired, while_loop :353,
// and pseudo_scan_batch, :268) are the same walk with no extension: a hit
// records its anchor's k-mer interval (the CSR occurrence range) with length
// k, and the walk jumps k columns on (plain versions ops/mmp.py
// pseudo_walk_plain, pseudo_walk_lanes_plain).
//
// Lane kinds: with R = 2B, lanes [0, B) are forward and [B, 2B) are rc lanes
// walked in mirrored forward columns (the canonical-CHD scan); with R = B
// every lane is a forward lane over its own (R, S) rows (the explicit
// [fwd; revcomp] lanes of scan_batch and pseudo_scan_batch). Extensions:
// the kernel is built once per extension kind (template parameter kExt):
// packed words (extend_lane), the charwise per-depth narrowing over the
// lanes' int8 codes and the flat sa/text arrays (extend_charwise), none
// (the pseudo walks), or packed words on the owning shard of a sharded
// index (extend_sharded, the sharded walks). The packed instantiation is
// the code the kernel had before the others were added (if constexpr).
//
// What bounds it on the card. The byte bound is the hit buffer written once
// (R x H x 32 bytes, three quarters of the bytes at H = 16) plus the 32-byte
// sectors of the inputs that the lanes read: each lane's anchor-mask row, a
// few columns of its interval rows and read words, and the random sa_cmp rows
// (one or two sectors each, data dependent). tqm_anchor_walk_traffic, the
// kCount = true build of the same code, counts those sectors for a given
// launch, each word where a scan or a compare uses it, so the count is what
// the function needs, not what the kernel loads ahead. In practice the
// kernel is latency-bound: a lane's compares form one dependent chain of
// gathers (row at mid, compare, next mid), and 16,384 lanes are only ~4
// warps per SM to hide it. One thread per lane stays: on a
// transcriptome most anchors have narrow intervals, so a lane's work is a
// chain of hops, not one wide search, and a warp per lane would idle.
//
// The charwise build has the same byte bound (tqm_anchor_walk_charwise_traffic
// counts the codes, sa entries and text chars the searches decide on), but
// the reference's per-depth narrowing is two lower-bound searches a char,
// each trip two dependent loads (sa[mid], then text[sa[mid] + d]): as
// written, ~35 trips a lane on the smoke chunk, one chain of ~70 dependent
// loads at ~4 warps an SM. What the design does about it: an interval of
// width 1 narrows at depth d iff text[clamp(sa[b] + d)] equals the read's
// code (both searches take one trip at mid = b), whatever the trips before,
// so a lane whose interval is, or narrows to, width 1 loads sa[b] once and
// compares its codes with the text 16 chars a step, 16-byte vector loads of
// both (width1_depth). On a transcriptome at k = 31 almost every anchor
// interval is 1 wide, so a lane's chain is a handful of loads. Wider
// intervals keep the per-depth searches until they narrow.
//
// The pseudo build reads only the lengths, the mask rows and one interval
// column pair a hit, and writes the hit buffer, so its byte bound is mostly
// the outputs; its counting build, tqm_pseudo_walk_traffic, counts those
// sectors and the walk's trips. Its lanes do a few mask scans each and wait
// on little but the mask loads and the stores.
//
// What the design does about it:
//  - Anchors come from masks. A lane reads its (B, S) bool mask row (forward
//    lanes anch_f, rc lanes anch_r in forward columns) with aligned 16-byte
//    loads and keeps it as bits, the first kMaskRegWords words in registers
//    (S <= 128; words beyond are rebuilt from the row when a scan reaches
//    them). The next anchor >= c is a find-first-set, the previous anchor
//    <= c a find-last-set, with S and -1 as the tables' sentinels; so the
//    dense phase launches no table scans and stacks no (2B, S) copies.
//  - Every output byte is written once, by the kernel, with no zero fill
//    before it: each warp stages its lanes' H slots (empty ones as zeros) in
//    dynamic shared memory and, when its lanes are done, writes its
//    contiguous part of the buffer with 16-byte stores. When H is so large
//    that the stage does not fit, a block takes fewer lanes; when not even
//    one lane's slots fit, lanes write their slots, zeros included, straight
//    to the buffer. (Writing the slots that must stay empty early, to overlap
//    the walk, cost more in per-unit bookkeeping than it saved: with ~4 warps
//    an SM nothing hides a warp's own instruction latency.)
//  - At each anchor the lane loads the query words a compare can reach once,
//    into registers (kRegWords: reads to k + 128 bases), and each sa_cmp row
//    whole, in one batch of 8-byte read-only loads, so a compare waits on one
//    load round, not on a chain of them. Query words beyond kRegWords load
//    from global memory. An sa_cmp row is 3 + F int32 with F fused words
//    (SA_CMP_WORDS = 3 in ops/device_index.py): the launch refuses a table
//    whose rows are not whole 8-byte pairs or hold more than kRegWords fused
//    words, so every fused word a compare reads is in registers. (Loading
//    them where a compare uses them, 4 bytes at a time, took 12-14% more
//    time with a warm L2 and 24-25% more with a cold one on an H100:
//    scripts/walk_ablation.py.)
//  - The equal range's two searches run one after the other. (Interleaving
//    them, one trip of each per pass so that two row loads are in flight,
//    took 3-4% more time: the same script.)
//
// Words are uint32_t here and compares are unsigned. The plain version
// carries them as int64 values in [0, 2^32) (ops/bits.py); the kernel loads
// that int64 carrier as it lies on the device and keeps the low 32 bits, so
// neither a narrowing pass in the wrapper nor a second pack_reads output is
// needed. Every gather clamps its index as ops/gather.py does, a shift by 32
// is branched around, and __clz(0) == 32 gives diffpos 16 on equal words as
// clz32 does.
//
// The extension alone has two entries: tqm_extend_packed (one anchor a read
// row, for locating a fault in the walk) and tqm_extend_packed_lanes, the
// anchor-parallel mode of the host-staged engine's stage A
// (rapmap_tpu/ops/extend_packed.py:286-307 with lane=, called from
// rapmap_tpu/parallel/staged.py:218-222): anchors outnumber read rows and
// anchor i reads row lane[i]. One thread an anchor runs extend_lane as the
// walk does; an inactive anchor (the compaction's dead tail) writes its
// inputs back without reading its row. Staged shards carry a 1-row text2q
// placeholder, so the wrapper refuses reads whose compares could reach
// past the fused sa_cmp words. tqm_extend_packed_traffic is its counting
// build, for the byte bound.
//
// The sharded walks (rapmap_tpu/parallel/sharded.py _sharded_scan_paired,
// while_loop :619, and _sharded_scan, :469) are the packed build over an
// SA-sharded index: the reference runs the walk replicated on every idx
// shard, and each trip extends a lane only on the shard that owns its global
// anchor interval, then unions the step's (b, e, mlen) with three psums over
// the idx axis. With every shard of a data row on one card there is nothing
// to exchange: a lane's thread picks the owner by the shards' [offset, true
// count] (tqm_sharded_walk, kExt kSharded) and extends over that shard's
// stacked sa_cmp rows at local slots, rebased to global ones; a lane no
// shard owns records (0, 0, 0) as the psum of nothing does. What bounds it:
// the packed walk's bytes (tqm_sharded_walk_traffic counts its sectors, the
// shard table included), and in practice the same latency, a lane's chain
// of dependent row loads with only 4-8 warps an SM to hide it. So a trip
// must cost the warp no more than the packed walk's: the 32 lanes of a warp
// hold anchors of random reads, which lie on different shards, and a loop
// over the shards with the extension inside each owner's branch ran the
// whole extension once per shard, a quarter of the lanes active each time.
// What the design does about it: each block copies the shard table into
// shared memory once; the shards' ranges ascend and do not overlap (the
// wrapper checks), so the only shard that can own a lane's b0 is the last
// one whose base is <= b0, which a branch-free search of the table finds
// without touching global memory; and every lane then makes ONE call of the
// extension on its owner's rows, the warp converged whatever shards its
// lanes own (an unowned lane takes part inactive and loads nothing). Global
// slots are int64 in the intervals and hits (the reference's int32 globals
// below 2^31, its int64 ones past it); slot_base is read in the type it was
// cut in, int32 or int64 (template parameter Slot).
//
// The sharded trip (tqm_sharded_trip, K10) is what the split path runs when a
// data row's idx shards lie on their own devices, as the reference's mesh
// lays them: one trip can then not see every shard's rows, so the lockstep
// trip loop runs on the row's home device (parallel/sharded.py trip_loop)
// and each trip launches this entry once per shard, on that shard's device,
// for its term of the reference's psum: the owner test in global
// coordinates against the true count, then extend_lane over the shard's
// rows. What bounds it: each launch is one trip's worth of the walk's bytes
// for the shard's lanes (tqm_sharded_trip_traffic counts them), a few
// hundred KB, so a launch is latency: an owned lane's chain of dependent
// loads (its lane values, then its query words and next_bad, then the
// sa_cmp rows its searches compare; on a transcriptome most anchor
// intervals are one slot wide, so one row serves all three searches), plus
// the launch itself (~1.4 us when no lane is active), and the slowest owned
// lane's searches set the time. What the design does about it: every lane
// value loads in one round (coalesced, also on lanes the shard does not
// own), not behind the active byte and then the owner test, and an owned
// lane prefetches its first compared row into L1 while its query words
// load. On an H100 (scripts/walk_ablation.py --k10) the one round took
// 5-6% off the time with a warm L2 and 9-10% with a cold one, the prefetch
// 2% more cold (2% less warm), and 256 lanes a block 4-13% off an empty
// trip against 128 and 64. (Compacting a block's owned lanes into a list in
// shared memory, so that full warps run the extension converged, took
// 9-15% more time: the owned lanes' scattered loads then all come from
// one warp instead of eight, behind two barriers.)
//
// The trip's home half (tqm_sharded_advance, K11) replaces the trip loop's
// eager PyTorch between two K10 rounds (the reference's while_loop body
// after its psums, rapmap_tpu/parallel/sharded.py :600-617 and :451-467:
// ops/mmp.py walk_advance after the terms' sum): one thread a lane on the
// home device sums the P shards' terms (P, 3, R), writes the hit at slot
// n (or sets trunc), moves pos by the NIP skip through the lane's
// next-anchor table row, and writes the next trip's act, posc, b0 and e0,
// all in place; with no terms it begins the walk (walk_begin: pos at the
// first anchor, the hit buffer zeroed by the block, the first trip's
// inputs). A lane that is not active returns after its act byte: its state
// cannot change again (pos only moves on an active lane, trunc only sets),
// so an empty trip reads R bytes. What bounds it: the active lanes' terms
// (P x 24 bytes each) and one sector of each table row, ~1-3 MB at the
// first trip; it is one launch where the eager body was ~60.
//
// C interface for ctypes: every pointer and the stream are void* on the
// Python side; every entry returns the CUDA error code (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 64;      // lanes (threads) per block: 16,384 lanes -> 256 blocks
constexpr int kTripLanes = 256;    // K10's lanes (threads) a block: 32,768 lanes -> 128 blocks
constexpr int kAdvanceLanes = 256; // K11's lanes (threads) a block
constexpr int kMaxShards = 1024;   // shard table in shared memory: 16 KB at most
constexpr int kMaskRegWords = 4;   // anchor-mask words in registers: S <= 128
constexpr int kRegWords = 8;       // query words and fused sa_cmp words in registers

// The extension a build of the walk runs at each anchor.
enum class Ext { kPacked, kCharwise, kNone, kSharded };

struct Index {
  const int32_t* sa_cmp;  // (n_sa, 3 + F) [wi, sub, tleft, w0..w_{F-1}], 8-byte aligned rows
  int64_t n_sa;
  int F;                  // odd and <= kRegWords (index_ok)
  const int32_t* text2q;  // (nw, 4) packed words i..i+3
  int64_t nw;
};

// The input tensors, as the traffic count names them.
enum Region {
  kPreads, kNextBad, kLens, kColOff, kBf, kEf, kBr, kEr, kAnchF, kAnchR, kSaCmp, kText2q,
  kCodes, kSa, kText,                   // the charwise extension's
  kLane, kB0, kE0, kPos, kActive,       // the extension alone's per-anchor inputs
  kSlotBase,                            // the sharded walk's shard offsets and counts
  kRegions
};

// The charwise extension's inputs: the lanes' left-aligned int8 codes and the
// flat suffix array and text.
struct CharIndex {
  const int8_t* codes;  // (R, L)
  const int32_t* sa;    // (n_sa,)
  int64_t n_sa;
  const int8_t* text;   // (n_text,)
  int64_t n_text;
};

// The sharded index of the sharded walks: P shard tables of s_pad sa_cmp rows
// each (rows as in Index), stacked, over one text2q (replicated content), and
// each shard's [global slot offset, true slot count] in the global slot type
// (int32, or int64 past 2^31 total slots), the offsets ascending and the
// ranges disjoint.
template <typename Slot>
struct Shards {
  const int32_t* sa_cmp;  // (P, s_pad, 3 + F), 8-byte aligned rows
  int P;                  // 1..kMaxShards
  int top;                // the owner search's first step: the largest power of 2 <= P - 1, or 0
  int64_t s_pad;
  int F;
  const int32_t* text2q;  // (nw, 4)
  int64_t nw;
  const Slot* slot_base;  // (P, 2)
};

// What a launch read, for the byte bound of a run: one bitmap per input
// tensor with a bit for each 32-byte sector (a sector read twice counts
// once), and the number of sa_cmp rows compared. Only the kCount = true
// instantiations touch it; the kernels of the main path are compiled with
// kCount = false and carry none of it.
struct Traffic {
  uintptr_t base[kRegions];  // first sector of each tensor (address >> 5)
  uint32_t* bits[kRegions];  // its bitmap
  unsigned long long* rows;
};

template <bool kCount>
__device__ __forceinline__ void touch(const Traffic& tr, Region g, const void* p, int nbytes) {
  if constexpr (kCount) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    for (uintptr_t s = a >> 5; s <= (a + nbytes - 1) >> 5; ++s) {
      const uintptr_t i = s - tr.base[g];
      atomicOr(tr.bits[g] + (i >> 5), 1u << (i & 31));
    }
  }
}

__device__ __forceinline__ int64_t ldg(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}
__device__ __forceinline__ int32_t ldg(const int32_t* p) { return __ldg(p); }
__device__ __forceinline__ int8_t ldg(const int8_t* p) {
  return static_cast<int8_t>(__ldg(reinterpret_cast<const signed char*>(p)));
}

// A counted load of one element, through the read-only path.
template <bool kCount, typename T>
__device__ __forceinline__ T load(const Traffic& tr, Region g, const T* p) {
  touch<kCount>(tr, g, p, sizeof(T));
  return ldg(p);
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---- anchor masks ------------------------------------------------------------

// 16 bool bytes -> 16 bits, bit i set when byte i is nonzero.
__device__ __forceinline__ uint32_t bits16(uint4 v) {
  auto b4 = [](uint32_t x) {  // the low bit of each byte, gathered into bits 24..27
    return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
  };
  return b4(v.x) | (b4(v.y) << 4) | (b4(v.z) << 8) | (b4(v.w) << 12);
}

// Bits of the aligned 16-byte chunk `i` of a mask row (chunk 0 holds the
// row's first byte), or 0 when the chunk starts at or past the row's end:
// such a chunk is never read, and one that is read lies in the 16-byte blocks
// the row's own bytes occupy, so no load leaves the tensor's pages.
__device__ __forceinline__ uint32_t chunk_bits(const uint8_t* row, int S, int i) {
  const uintptr_t r = reinterpret_cast<uintptr_t>(row);
  const uintptr_t c = (r & ~uintptr_t(15)) + 16 * static_cast<uintptr_t>(i);
  if (c >= r + S) return 0u;
  return bits16(__ldg(reinterpret_cast<const uint4*>(c)));
}

// Mask word w from the bits of chunks 2w, 2w + 1, 2w + 2: bit c is column
// 32 w + c, 0 at and beyond S.
__device__ __forceinline__ uint32_t mask_word(uint32_t h0, uint32_t h1, uint32_t h2, int head,
                                              int S, int w) {
  const uint32_t x = __funnelshift_r(h0 | (h1 << 16), h2, head);
  const int left = S - 32 * w;  // columns of the row in this word
  return left >= 32 ? x : (left <= 0 ? 0u : x & ((1u << left) - 1u));
}

// A lane's anchor columns as bits, bit c of word w being column 32 w + c.
template <bool kCount>
struct AnchorMask {
  const uint8_t* row;  // S bool bytes
  int S;
  int head;            // row address mod 16
  Region g;
  uint32_t reg[kMaskRegWords];

  __device__ __forceinline__ void init(const uint8_t* row_, int S_, Region g_) {
    row = row_;
    S = S_;
    g = g_;
    head = static_cast<int>(reinterpret_cast<uintptr_t>(row_) & 15);
    uint32_t h[2 * kMaskRegWords + 1];
#pragma unroll
    for (int i = 0; i < 2 * kMaskRegWords + 1; ++i) h[i] = chunk_bits(row, S, i);
#pragma unroll
    for (int w = 0; w < kMaskRegWords; ++w)
      reg[w] = mask_word(h[2 * w], h[2 * w + 1], h[2 * w + 2], head, S, w);
  }

  // Word w (32 w < S), counted as the row bytes of its columns.
  __device__ __forceinline__ uint32_t word(int w, const Traffic& tr) const {
    touch<kCount>(tr, g, row + 32 * w, S - 32 * w < 32 ? S - 32 * w : 32);
    if (w < kMaskRegWords) {
      uint32_t x = 0;
#pragma unroll
      for (int i = 0; i < kMaskRegWords; ++i) x = i == w ? reg[i] : x;
      return x;
    }
    return mask_word(chunk_bits(row, S, 2 * w), chunk_bits(row, S, 2 * w + 1),
                     chunk_bits(row, S, 2 * w + 2), head, S, w);
  }

  // Smallest anchor column >= c (c >= 0), else S: the next-anchor table.
  __device__ int next(int c, const Traffic& tr) const {
    for (int w = c >> 5; 32 * w < S; ++w) {
      uint32_t x = word(w, tr);
      if (w == c >> 5) x &= 0xFFFFFFFFu << (c & 31);
      if (x) return 32 * w + __ffs(static_cast<int>(x)) - 1;
    }
    return S;
  }

  // Largest anchor column <= c (0 <= c < S), else -1: the prev-anchor table.
  __device__ int prev(int c, const Traffic& tr) const {
    for (int w = c >> 5; w >= 0; --w) {
      uint32_t x = word(w, tr);
      if (w == c >> 5) x &= 0xFFFFFFFFu >> (31 - (c & 31));
      if (x) return 32 * w + 31 - __clz(static_cast<int>(x));
    }
    return -1;
  }
};

// ---- the charwise extension ---------------------------------------------------

// Lower bound of char c in the depth-d text column over SA[lo, hi): at most
// `steps` trips, as the plain version's static bound (a lane that stops at
// lo == hi has the lo the masked trips keep). Gathers clamp as
// ops/gather.py's do.
template <bool kCount>
__device__ int64_t col_lower_bound(const CharIndex& cx, int64_t lo, int64_t hi, int64_t d,
                                   int c, int steps, const Traffic& tr) {
  for (int t = 0; t < steps && lo < hi; ++t) {
    if constexpr (kCount) atomicAdd(tr.rows, 1ull);
    const int64_t mid = (lo + hi) >> 1;
    const int64_t g = load<kCount>(tr, kSa, cx.sa + clamp64(mid, 0, cx.n_sa - 1));
    const int v = load<kCount>(tr, kText, cx.text + clamp64(g + d, 0, cx.n_text - 1));
    if (v < c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// 16 bytes from p, of which the first n (1 <= n <= 16) are wanted: byte i
// of the result is p[i] for i < n. Loads only the aligned 16-byte blocks that
// hold those n bytes (so no load leaves the pages they lie in) and shifts
// them into place; bytes n..15 are unspecified.
__device__ __forceinline__ uint4 load_bytes(const int8_t* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* blk = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const int off = static_cast<int>(a & 15);
  const uint4 lo = __ldg(blk);
  const uint4 hi = off + n > 16 ? __ldg(blk + 1) : make_uint4(0u, 0u, 0u, 0u);
  uint32_t w0 = lo.x, w1 = lo.y, w2 = lo.z, w3 = lo.w, w4 = hi.x, w5 = hi.y, w6 = hi.z,
           w7 = hi.w;
  if (off & 8) {  // two words down
    w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7;
  }
  if (off & 4) {  // one word down
    w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5;
  }
  const int sh = (off & 3) * 8;
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

__device__ __forceinline__ uint32_t word_of(uint4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The first of n (1..16) read codes q[i] that stops the narrowing, against
// text chars t[i]: a code outside 1..4, or a char that differs -> its index
// (n if none), with `bad` set when it stopped on the code.
__device__ __forceinline__ int first_stop(uint4 q, uint4 t, int n, bool& bad) {
  int s = 16;
  uint32_t badw = 0;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    const uint32_t qw = word_of(q, i);
    const uint32_t b4 = ~(__vcmpgeu4(qw, 0x01010101u) & __vcmpleu4(qw, 0x04040404u));
    const uint32_t x = b4 | __vcmpne4(qw, word_of(t, i));
    if (x) {
      s = 4 * i + ((__ffs(static_cast<int>(x)) - 1) >> 3);
      badw = b4;
    }
  }
  bad = s < n && ((badw >> (8 * (s & 3))) & 1u);
  return s < n ? s : n;
}

// A width-1 interval [b, b + 1) from depth d: the depth at which the lane
// stops. Each lower bound takes one trip at mid = b, giving b + (v < c) and
// b + (v <= c) with v = text[clamp(sa[clamp(b)] + d)], so the interval
// narrows (to itself) iff v == c, however it got to width 1. So sa[b] loads
// once and the read's codes are compared with the text 16 chars a step, with
// vector loads of both, where neither index needs a clamp; char by char,
// clamped as the gathers clamp, where one does (a read running past the
// text's end sees its last char repeated). The counting build marks what the
// searches would read: the code of every depth reached, sa[b] and the text
// char of every depth compared, two trips each; not the unused tail of a
// vector load.
template <bool kCount>
__device__ int64_t width1_depth(const CharIndex& cx, const int8_t* row, int64_t len, int64_t pos,
                                int64_t d, int L, int64_t b, const Traffic& tr) {
  const int32_t* sp = cx.sa + clamp64(b, 0, cx.n_sa - 1);
  const int64_t g = ldg(sp);
  while (true) {
    const int64_t ic = pos + d;
    if (ic >= len) return d;
    const int64_t tg = g + d;
    int64_t m = 0;  // chars of this step that need no clamp
    if (ic >= 0 && tg >= 0) {
      m = len - ic;
      m = m < 16 ? m : 16;
      m = m < L - ic ? m : L - ic;
      m = m < cx.n_text - tg ? m : cx.n_text - tg;
    }
    if (m >= 1) {
      const int n = static_cast<int>(m);
      bool bad;
      const int s = first_stop(load_bytes(row + ic, n), load_bytes(cx.text + tg, n), n, bad);
      if constexpr (kCount) {
        touch<kCount>(tr, kCodes, row + ic, s < n ? s + 1 : n);
        const int nt = s < n ? (bad ? s : s + 1) : n;
        if (nt > 0) {
          touch<kCount>(tr, kSa, sp, 4);
          touch<kCount>(tr, kText, cx.text + tg, nt);
          atomicAdd(tr.rows, 2ull * nt);
        }
      }
      if (s < n) return d + s;
      d += n;
      continue;
    }
    const int c = load<kCount>(tr, kCodes, row + clamp64(ic, 0, L - 1));
    if (c < 1 || c > 4) return d;
    if constexpr (kCount) {
      touch<kCount>(tr, kSa, sp, 4);
      atomicAdd(tr.rows, 2ull);
    }
    if (load<kCount>(tr, kText, cx.text + clamp64(tg, 0, cx.n_text - 1)) != c) return d;
    d += 1;
  }
}

// ops/mmp.py _extend for one lane: from depth k, narrow [b, e) one char at a
// time (two lower bounds, for c and c + 1) until a mismatch, the read's end
// or a code outside 1..4; mlen is the final depth. row: the lane's codes. An
// interval of width 1 (with steps >= 1) finishes in width1_depth.
template <bool kCount>
__device__ void extend_charwise(const CharIndex& cx, const int8_t* row, int64_t len,
                                int64_t b0, int64_t e0, int64_t pos, bool active, int k,
                                int steps, int L, int64_t& b, int64_t& e, int64_t& mlen,
                                const Traffic& tr) {
  b = b0;
  e = e0;
  int64_t d = k;
  while (active) {
    if (steps >= 1 && e - b == 1) {
      d = width1_depth<kCount>(cx, row, len, pos, d, L, b, tr);
      break;
    }
    const int64_t ic = pos + d;
    if (ic >= len) break;
    const int c = load<kCount>(tr, kCodes, row + clamp64(ic, 0, L - 1));
    if (c < 1 || c > 4) break;
    const int64_t lb = col_lower_bound<kCount>(cx, b, e, d, c, steps, tr);
    const int64_t ub = col_lower_bound<kCount>(cx, b, e, d, c + 1, steps, tr);
    if (lb >= ub) break;
    b = lb;
    e = ub;
    d += 1;
  }
  mlen = d;
}

// ---- the packed extension ----------------------------------------------------

// One lane's query: the read suffix beyond depth k at column `base`.
struct Query {
  const int64_t* words;  // the lane's row of packed read words (L of them)
  int64_t base;
  int L;
  int W;                 // words that cover L - k chars
  uint32_t reg[kRegWords];  // words j < kRegWords that a compare can reach, else 0
};

// Query word j, 0 past the read's L columns; counted when kCount (the
// address is clamped as the load's is).
template <bool kCount>
__device__ __forceinline__ uint32_t query_word(const Query& q, int j, const Traffic& tr) {
  const int64_t c = q.base + 16 * j;
  if (c >= q.L) return 0u;
  return static_cast<uint32_t>(load<kCount>(tr, kPreads, q.words + clamp64(c, 0, q.L - 1)));
}

// The words j < kRegWords with 16 j < qmax, loaded together and counted
// where a compare uses them. A compare of qlen <= qmax chars never reads word
// j once 16 j >= qlen: it stops at the first word with fewer than 16 query
// chars, and a word with none is masked to nothing.
__device__ __forceinline__ void load_query(Query& q, int qmax) {
  const Traffic none{};
#pragma unroll
  for (int j = 0; j < kRegWords; ++j)
    q.reg[j] = (j < q.W && 16 * j < qmax) ? query_word<false>(q, j, none) : 0u;
}

// An sa_cmp row with its first fused words, loaded in one batch.
struct Row {
  const int32_t* p;
  int64_t wi;
  int sub;
  int tleft;
  uint32_t f[kRegWords];  // fused words j < min(F, W)
};

// The ints a compare can read, 3 + min(F, W), as 8-byte pairs: (3 + F) is
// even, so a pair that starts below them ends inside the row. What a compare
// uses is counted there (suffix_cmp), the row itself here.
template <bool kCount>
__device__ __forceinline__ Row load_row(const Index& ix, int64_t slot, int W, const Traffic& tr) {
  Row row;
  row.p = ix.sa_cmp + clamp64(slot, 0, ix.n_sa - 1) * (3 + ix.F);
  const int n = 3 + min(ix.F, W);
  int32_t v[3 + kRegWords + 1] = {};
#pragma unroll
  for (int i = 0; i < (3 + kRegWords + 1) / 2; ++i) {
    if (2 * i < n) {
      const int2 x = __ldg(reinterpret_cast<const int2*>(row.p) + i);
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
  }
  if constexpr (kCount) atomicAdd(tr.rows, 1ull);
  row.wi = v[0];
  row.sub = v[1];
  row.tleft = v[2];
#pragma unroll
  for (int j = 0; j < kRegWords; ++j) row.f[j] = static_cast<uint32_t>(v[3 + j]);
  return row;
}

// Raw text word i of the run that starts at quad row wi0: rows advance by 4
// words, and the ROW index is what clamps (ops/extend_packed.py _text_words).
template <bool kCount>
__device__ __forceinline__ uint32_t raw_text_word(const Index& ix, int64_t wi0, int i,
                                                  const Traffic& tr) {
  const int64_t row = clamp64(wi0 + 4 * (i >> 2), 0, ix.nw - 1);
  return static_cast<uint32_t>(load<kCount>(tr, kText2q, ix.text2q + row * 4 + (i & 3)));
}

// Text word j >= F of the suffix at a row: the text2q run shifted by the
// row's sub-word offset (words j < F are the row's fused words).
template <bool kCount>
__device__ uint32_t text_word(const Index& ix, const Row& row, int j, const Traffic& tr) {
  touch<kCount>(tr, kSaCmp, row.p, 8);  // wi, sub
  const int jj = j - ix.F;
  const int sh = row.sub << 1;
  const uint32_t r0 = raw_text_word<kCount>(ix, row.wi + ix.F, jj, tr);
  if (sh == 0) return r0;
  const uint32_t r1 = raw_text_word<kCount>(ix, row.wi + ix.F, jj + 1, tr);
  return (r0 << sh) | (r1 >> (32 - sh));
}

// Word j of a compare: n = min(query chars, text chars) chars from the top
// of each word. Adds the word's lcp and returns true, with cmp set, when the
// word decides.
__device__ __forceinline__ bool cmp_word(uint32_t qw, uint32_t tw, int qlen, int tleft, int j,
                                         int& cmp, int& lcp) {
  int qn = qlen - 16 * j;
  qn = qn < 0 ? 0 : (qn > 16 ? 16 : qn);
  int tn = tleft - 16 * j;
  tn = tn < 0 ? 0 : (tn > 16 ? 16 : tn);
  const int n = qn < tn ? qn : tn;
  // n chars from the top: a shift by 32 (n == 0) is undefined in C
  const uint32_t mask = n == 0 ? 0u : (0xFFFFFFFFu << (32 - 2 * n));
  const uint32_t qv = qw & mask;
  const uint32_t tv = tw & mask;
  const int diffpos = __clz(static_cast<int>(qv ^ tv)) >> 1;  // chars; 16 if equal
  const bool has_diff = diffpos < n;
  lcp += has_diff ? diffpos : n;
  if (has_diff || tn < qn || qn < 16) {
    // no diff within n: transcript ends first -> suffix smaller; query
    // exhausted -> prefix-equal
    cmp = has_diff ? (tv < qv ? -1 : 1) : (tn < qn ? -1 : 0);
    return true;
  }
  return false;
}

// Compare the suffix of a row (depth-k based) against the query's first
// qlen chars. cmp < 0: suffix < query; 0: prefix-equal; > 0: suffix > query.
// lcp in chars. Stops at the first deciding word; the plain version runs all
// W words with decided lanes masked, which gives the same pair.
template <bool kCount>
__device__ __forceinline__ void suffix_cmp(const Index& ix, const Query& q, const Row& row,
                                           int qlen, int& cmp, int& lcp, const Traffic& tr) {
  cmp = 0;
  lcp = 0;
  touch<kCount>(tr, kSaCmp, row.p + 2, 4);  // tleft
  // a word that holds no char of the query or of the suffix is masked away:
  // it is not counted, and no text2q word is loaded for it
#pragma unroll
  for (int j = 0; j < kRegWords; ++j) {
    if (j >= q.W) return;
    const bool used = 16 * j < qlen && 16 * j < row.tleft;
    if constexpr (kCount) {  // the register words this compare uses
      if (used) query_word<kCount>(q, j, tr);
      if (used && j < ix.F) touch<kCount>(tr, kSaCmp, row.p + 3 + j, 4);
    }
    const uint32_t tw = j < ix.F ? row.f[j] : (used ? text_word<kCount>(ix, row, j, tr) : 0u);
    if (cmp_word(q.reg[j], tw, qlen, row.tleft, j, cmp, lcp)) return;
  }
  for (int j = kRegWords; j < q.W; ++j) {
    const bool used = 16 * j < qlen && 16 * j < row.tleft;
    const uint32_t tw = used ? text_word<kCount>(ix, row, j, tr) : 0u;
    const uint32_t qw = used ? query_word<kCount>(q, j, tr) : 0u;
    if (cmp_word(qw, tw, qlen, row.tleft, j, cmp, lcp)) return;
  }
}

// Binary search in [lo, hi) for the first S_p >= Q (upper false) or the
// first S_p > Q (upper true), with the lcps of the last "less" and the last
// "not less" compare (the neighbours of the insertion point). At most
// `steps` trips, as the plain version's static bound.
template <bool kCount>
__device__ int64_t bound_search(const Index& ix, const Query& q, int qlen, int64_t lo,
                                int64_t hi, bool upper, int steps, int& ll, int& lg,
                                const Traffic& tr) {
  ll = 0;
  lg = 0;
  for (int t = 0; t < steps && lo < hi; ++t) {
    const int64_t mid = (lo + hi) >> 1;
    int cmp, lcp;
    suffix_cmp<kCount>(ix, q, load_row<kCount>(ix, mid, q.W, tr), qlen, cmp, lcp, tr);
    if (cmp < 0 || (upper && cmp == 0)) {
      ll = lcp;
      lo = mid + 1;
    } else {
      lg = lcp;
      hi = mid;
    }
  }
  return lo;
}

// ops/extend_packed.py extend_packed for one lane.
template <bool kCount>
__device__ void extend_lane(const Index& ix, const int64_t* words, const int64_t* nbad,
                            int64_t len, int64_t col_off, int64_t b0, int64_t e0,
                            int64_t pos, bool active, int k, int steps, int L, int W,
                            int64_t& b, int64_t& e, int64_t& mlen, const Traffic& tr) {
  Query q;
  q.words = words;
  q.base = pos + k + col_off;
  q.L = L;
  q.W = W;
  // valid query chars beyond depth k: up to the next N and the read end; the
  // query words are loaded beside next_bad, up to the read end alone (an
  // inactive lane loads neither: its searches run no trip)
  const int64_t end = len + col_off;
  load_query(q, active ? static_cast<int>(clamp64(end - q.base, 0, L - k)) : 0);
  const int64_t nb = active && q.base < L
                         ? load<kCount>(tr, kNextBad, nbad + clamp64(q.base, 0, L - 1))
                         : q.base;
  const int qlen = static_cast<int>(clamp64((nb < end ? nb : end) - q.base, 0, L - k));
  const int64_t b0a = active ? b0 : 0;
  const int64_t e0a = active ? e0 : 0;
  int ll, lg, unused0, unused1;
  const int64_t lb = bound_search<kCount>(ix, q, qlen, b0a, e0a, false, steps, ll, lg, tr);
  const int l_left = lb > b0a ? ll : 0;
  const int l_right = lb < e0a ? lg : 0;
  int ext = l_left > l_right ? l_left : l_right;
  ext = ext < qlen ? ext : qlen;
  // equal range of the query truncated to ext chars over the narrowed spans
  const int64_t lb2 = bound_search<kCount>(ix, q, ext, l_left < ext ? lb : b0a, lb, false,
                                           steps, unused0, unused1, tr);
  const int64_t ub2 = bound_search<kCount>(ix, q, ext, lb, l_right < ext ? lb : e0a, true,
                                           steps, unused0, unused1, tr);
  const bool ok = active && ub2 > lb2;
  b = ok ? lb2 : b0;
  e = ok ? ub2 : e0;
  mlen = ok ? k + ext : k;
}

// One trip's extension on the sharded index (rapmap_tpu/parallel/sharded.py
// _sharded_scan :437-451): the shard that owns the global anchor interval
// [b0, e0) -- b0 - base in [0, true count), tested in global coordinates
// before the rebase -- extends it over its own rows at local slots, and the
// step's (b, e, mlen) is its result rebased to global slots, the reference's
// psum over the idx axis. `table` is the block's copy of slot_base, (P, 2)
// int64 [base, true count] in shared memory. The ranges ascend and do not
// overlap, so the owner can only be the last shard whose base is <= b0:
// binary lifting over the bases finds it in the same number of steps on
// every lane, and then the lane makes ONE extend_lane call on that shard's
// rows. A lane no shard owns makes it inactive (no row, query word or
// next_bad load) and gets (0, 0, 0), as the psum of nothing does.
template <bool kCount, typename Slot>
__device__ void extend_sharded(const Shards<Slot>& sh, const int64_t* table,
                               const int64_t* words, const int64_t* nbad, int64_t len,
                               int64_t col_off, int64_t b0, int64_t e0, int64_t pos, int k,
                               int steps, int L, int W, int64_t& b, int64_t& e, int64_t& mlen,
                               const Traffic& tr) {
  int p = 0;
  for (int step = sh.top; step > 0; step >>= 1) {
    const int q = p + step;
    p = q < sh.P && table[2 * q] <= b0 ? q : p;
  }
  const int64_t base = table[2 * p];
  const int64_t n_local = table[2 * p + 1];
  const int64_t lb = b0 - base;
  const bool owner = lb >= 0 && lb < n_local;
  const Index ix{sh.sa_cmp + static_cast<int64_t>(p) * sh.s_pad * (3 + sh.F), sh.s_pad, sh.F,
                 sh.text2q, sh.nw};
  int64_t bl, el, ml;
  extend_lane<kCount>(ix, words, nbad, len, col_off, lb, clamp64(e0 - base, 0, n_local), pos,
                      owner, k, steps, L, W, bl, el, ml, tr);
  b = owner ? bl + base : 0;
  e = owner ? el + base : 0;
  mlen = owner ? ml : 0;
}

// ---- the walk ------------------------------------------------------------------

__device__ __forceinline__ void put_slot(int64_t* slot, int64_t a, int64_t b, int64_t c,
                                         int64_t d) {
  reinterpret_cast<longlong2*>(slot)[0] = make_longlong2(a, b);
  reinterpret_cast<longlong2*>(slot)[1] = make_longlong2(c, d);
}

// Lane r < B is forward and reads row r of bf/ef/anch_f; lane r >= B is rc
// and reads row r - B of br/er/anch_r, in forward columns (none when B = R).
// kExt kCharwise: the charwise extension over cx (preads, next_bad, col_off2
// and ix unused); kPacked: the packed one (cx unused); kNone: no extension
// (the pseudo walks: a hit is the anchor's own interval, with length k, and
// the walk jumps k columns; only lens2, the intervals and the masks are read);
// kSharded: the packed one on the owning shard of sh (the sharded walks:
// intervals and hits in global slots; ix and cx unused).
template <bool kCount, Ext kExt, typename Slot = int64_t>
__global__ void __launch_bounds__(kMaxLanes) anchor_walk_kernel(
    const int64_t* __restrict__ preads, const int64_t* __restrict__ next_bad,
    const int64_t* __restrict__ lens2, const int64_t* __restrict__ col_off2,
    const int64_t* __restrict__ bf, const int64_t* __restrict__ ef,
    const int64_t* __restrict__ br, const int64_t* __restrict__ er,
    const uint8_t* __restrict__ anch_f, const uint8_t* __restrict__ anch_r, Index ix,
    CharIndex cx, int64_t R, int64_t B, int L, int S, int k, int H, int steps, int W, bool staged,
    int64_t* __restrict__ buf, int64_t* __restrict__ n_out, uint8_t* __restrict__ trunc_out,
    Traffic tr, Shards<Slot> sh) {
  // kSharded: the shard table, (P, 2) int64, then the stage. staged: the
  // block's lanes x H slots x [pos, mlen, b, e], laid out as in buf
  extern __shared__ __align__(16) int64_t smem[];
  int64_t* const stage = kExt == Ext::kSharded ? smem + 2 * sh.P : smem;
  if constexpr (kExt == Ext::kSharded) {
    for (int i = threadIdx.x; i < 2 * sh.P; i += blockDim.x)
      smem[i] = load<kCount>(tr, kSlotBase, sh.slot_base + i);
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const bool live = r0 + threadIdx.x < R;
  const int64_t r = live ? r0 + threadIdx.x : R - 1;  // past R: lane R - 1, writing nothing
  const bool is_rc = r >= B;
  const int64_t rr = is_rc ? r - B : r;
  const int64_t len = load<kCount>(tr, kLens, lens2 + r);
  constexpr bool kWords = kExt == Ext::kPacked || kExt == Ext::kSharded;  // packed read words
  const int64_t col_off = kWords ? load<kCount>(tr, kColOff, col_off2 + r) : 0;
  AnchorMask<kCount> mask;
  mask.init((is_rc ? anch_r : anch_f) + rr * S, S, is_rc ? kAnchR : kAnchF);
  // Each warp zeroes, stages and writes out its own lanes' part of buf, so
  // its stores go out when its lanes are done, not when the block's are; the
  // zeroing runs while the loads above are in flight.
  const int lane = threadIdx.x & 31;
  const int wbase = threadIdx.x - lane;
  const int wthreads = blockDim.x - wbase < 32 ? blockDim.x - wbase : 32;  // < 32: partial warp
  const unsigned wmask = wthreads == 32 ? 0xFFFFFFFFu : (1u << wthreads) - 1u;
  const int64_t wlanes = R - (r0 + wbase) < wthreads ? R - (r0 + wbase) : wthreads;
  const int64_t units = wlanes * H * 2;  // 16-byte units of the warp's part
  longlong2* wstage = reinterpret_cast<longlong2*>(stage + static_cast<int64_t>(wbase) * H * 4);
  if (staged) {  // uniform over the block
    for (int64_t i = lane; i < units; i += wthreads) wstage[i] = make_longlong2(0, 0);
    __syncwarp(wmask);
  }
  if constexpr (kExt == Ext::kSharded) __syncthreads();  // the shard table is in place

  if (live) {
    const int64_t* db = (is_rc ? br : bf) + rr * S;
    const int64_t* de = (is_rc ? er : ef) + rr * S;
    const Region gb = is_rc ? kBr : kBf;
    const Region ge = is_rc ? kEr : kEf;

    // Smallest lane-local anchor position >= nxt, else S. Forward lanes take
    // the next anchor; rc lanes the previous one in mirrored columns.
    auto next_anchor_pos = [&](int64_t nxt) -> int64_t {
      if (!is_rc) return nxt < S ? mask.next(static_cast<int>(nxt < 0 ? 0 : nxt), tr) : S;
      const int64_t col = len - k - nxt;
      if (col < 0) return S;
      const int v = mask.prev(static_cast<int>(col < S - 1 ? col : S - 1), tr);
      return v >= 0 ? len - k - v : S;
    };

    int64_t* out = staged ? stage + static_cast<int64_t>(threadIdx.x) * H * 4 : buf + r * H * 4;
    int64_t pos = next_anchor_pos(0);
    int n = 0;
    bool trunc = false;
    while (pos < S) {
      if (n >= H) {  // the hit buffer is full: record nothing more
        trunc = true;
        break;
      }
      const int64_t posc = clamp64(pos, 0, S - 1);
      const int64_t col = clamp64(is_rc ? len - k - posc : posc, 0, S - 1);
      int64_t b, e, mlen;
      if constexpr (kExt == Ext::kCharwise) {
        extend_charwise<kCount>(cx, cx.codes + r * L, len, load<kCount>(tr, gb, db + col),
                                load<kCount>(tr, ge, de + col), posc, true, k, steps, L, b,
                                e, mlen, tr);
      } else if constexpr (kExt == Ext::kPacked) {
        extend_lane<kCount>(ix, preads + r * L, next_bad + r * L, len, col_off,
                            load<kCount>(tr, gb, db + col), load<kCount>(tr, ge, de + col),
                            posc, true, k, steps, L, W, b, e, mlen, tr);
      } else if constexpr (kExt == Ext::kSharded) {
        extend_sharded<kCount>(sh, smem, preads + r * L, next_bad + r * L, len, col_off,
                               load<kCount>(tr, gb, db + col), load<kCount>(tr, ge, de + col),
                               posc, k, steps, L, W, b, e, mlen, tr);
      } else {
        if constexpr (kCount) atomicAdd(tr.rows, 1ull);  // a trip of the walk
        b = load<kCount>(tr, gb, db + col);
        e = load<kCount>(tr, ge, de + col);
        mlen = k;
      }
      put_slot(out + 4 * n, posc, mlen, b, e);
      n += 1;
      if constexpr (kExt == Ext::kNone) {
        pos = next_anchor_pos(posc + k);  // jump-ahead k on a hit
      } else {
        const int64_t adv = mlen - k + 1;
        pos = next_anchor_pos(posc + (adv > 1 ? adv : 1));
      }
    }
    if (!staged)  // empty slots read 0
      for (int s = n; s < H; ++s) put_slot(out + 4 * s, 0, 0, 0, 0);
    n_out[r] = n;
    trunc_out[r] = trunc ? 1 : 0;
  }

  if (staged) {
    __syncwarp(wmask);
    longlong2* dst = reinterpret_cast<longlong2*>(buf + (r0 + wbase) * H * 4);
    for (int64_t i = lane; i < units; i += wthreads) dst[i] = wstage[i];
  }
}

// The extension alone, one thread an anchor: anchor i reads preads,
// next_bad, lens and col_off (0 when null) at row lane[i] (row i when lane is
// null; a lane index is clamped to [0, R) as ops/gather.py clamps) and b0,
// e0, pos and active at i. An inactive anchor keeps (b0, e0) with length k,
// what extend_lane gives it, without reading its row.
template <bool kCount>
__global__ void extend_packed_kernel(
    const int64_t* __restrict__ preads, const int64_t* __restrict__ next_bad,
    const int64_t* __restrict__ lens, const int64_t* __restrict__ col_off,
    const int64_t* __restrict__ lane, const int64_t* __restrict__ b0,
    const int64_t* __restrict__ e0, const int64_t* __restrict__ pos,
    const uint8_t* __restrict__ active, Index ix, int64_t A, int64_t R, int L, int k,
    int steps, int W, int64_t* __restrict__ b_out, int64_t* __restrict__ e_out,
    int64_t* __restrict__ mlen_out, Traffic tr) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= A) return;
  const int64_t b_in = load<kCount>(tr, kB0, b0 + i);
  const int64_t e_in = load<kCount>(tr, kE0, e0 + i);
  int64_t b = b_in, e = e_in, mlen = k;
  touch<kCount>(tr, kActive, active + i, 1);
  if (active[i] != 0) {
    const int64_t r = lane == nullptr ? i : clamp64(load<kCount>(tr, kLane, lane + i), 0, R - 1);
    const int64_t off = col_off == nullptr ? 0 : load<kCount>(tr, kColOff, col_off + r);
    extend_lane<kCount>(ix, preads + r * L, next_bad + r * L, load<kCount>(tr, kLens, lens + r),
                        off, b_in, e_in, load<kCount>(tr, kPos, pos + i), true, k, steps, L, W,
                        b, e, mlen, tr);
  }
  b_out[i] = b;
  e_out[i] = e;
  mlen_out[i] = mlen;
}

// One shard's term of one trip of the sharded walk (K10, the split path;
// rapmap_tpu/parallel/sharded.py _sharded_scan_paired :583-600 and
// _sharded_scan :433-451 on one idx shard, up to the psums): lane r is the
// shard's when it is active and its GLOBAL b0 lies in [base, base +
// n_local), n_local the true slot count, tested before the rebase; it
// extends over the shard's rows at local slots (extend_lane, as K8 does on
// the owner it finds) and writes (b + base, e + base, mlen), and every other
// lane (0, 0, 0) without reading its row. One thread a lane, kTripLanes a
// block. A lane's values (active, b0, e0, pos, lens2, col_off2) load in one
// round, not behind the owner test, and an owned lane prefetches the sa_cmp
// row its first search compares (the interval's middle) into L1 beside its
// query words, so its chain is two rounds of loads before the compares; the
// counting build marks only what the function needs (the active byte of
// every lane, b0 of the active ones, the rest on the owned ones). Every
// output byte is written.
template <bool kCount>
__global__ void __launch_bounds__(kTripLanes) sharded_trip_kernel(
    const int64_t* __restrict__ preads, const int64_t* __restrict__ next_bad,
    const int64_t* __restrict__ lens2, const int64_t* __restrict__ col_off2,
    const int64_t* __restrict__ b0, const int64_t* __restrict__ e0,
    const int64_t* __restrict__ pos, const uint8_t* __restrict__ active, Index ix, int64_t base,
    int64_t n_local, int64_t R, int L, int k, int steps, int W, int64_t* __restrict__ b_out,
    int64_t* __restrict__ e_out, int64_t* __restrict__ mlen_out, Traffic tr) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const bool act = active[r] != 0;
  const int64_t b0r = ldg(b0 + r);
  const int64_t e0r = ldg(e0 + r);
  const int64_t posr = ldg(pos + r);
  const int64_t len = ldg(lens2 + r);
  const int64_t off = ldg(col_off2 + r);
  touch<kCount>(tr, kActive, active + r, 1);
  if (act) touch<kCount>(tr, kB0, b0 + r, 8);
  const int64_t lb = act ? b0r - base : -1;
  int64_t b = 0, e = 0, mlen = 0;
  if (lb >= 0 && lb < n_local) {
    touch<kCount>(tr, kE0, e0 + r, 8);
    touch<kCount>(tr, kPos, pos + r, 8);
    touch<kCount>(tr, kLens, lens2 + r, 8);
    touch<kCount>(tr, kColOff, col_off2 + r, 8);
    const int64_t le = clamp64(e0r - base, 0, n_local);
    if (lb < le) {  // the first compare's row, both ends of it
      const int32_t* row = ix.sa_cmp + clamp64((lb + le) >> 1, 0, ix.n_sa - 1) * (3 + ix.F);
      asm volatile("prefetch.global.L1 [%0];" ::"l"(row));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(row + 2 + ix.F));
    }
    extend_lane<kCount>(ix, preads + r * L, next_bad + r * L, len, off, lb, le, posr, true, k,
                        steps, L, W, b, e, mlen, tr);
    b += base;
    e += base;
  }
  b_out[r] = b;
  e_out[r] = e;
  mlen_out[r] = mlen;
}

// The split walk's trip at home (K11; ops/mmp.py walk_begin and walk_advance
// after the sum of the terms, parallel/sharded.py sharded_advance_plain): one
// thread a lane over the lane-aligned tables db2, de2, anc2 (R, S), with the
// state pos, n, trunc, buf (R, H, 4) and the next trip's act, posc, b0, e0
// updated in place. With terms (P, 3, R): an active lane sums its P terms
// into (b1, e1, mlen), writes [posc, mlen, b1, e1] at slot n (n < H) or sets
// trunc, and moves pos to the next anchor at or past posc + max(mlen - k + 1,
// 1); an inactive lane returns. With no terms (the begin) the block zeroes
// its lanes' hit slots and every lane takes its first anchor with n = 0 and
// no trunc. Then the lane writes the next trip's inputs: act = pos < S and
// not trunc, posc = pos clamped to [0, S), and the anchor interval at its
// column (rc lanes mirrored, clamped as ops/gather.py clamps).
__global__ void __launch_bounds__(kAdvanceLanes) sharded_advance_kernel(
    const int64_t* __restrict__ terms, int P, const int64_t* __restrict__ db2,
    const int64_t* __restrict__ de2, const int64_t* __restrict__ anc2,
    const uint8_t* __restrict__ is_rc, const int64_t* __restrict__ lens2, int64_t R, int S,
    int k, int H, int64_t* __restrict__ pos, int64_t* __restrict__ n,
    uint8_t* __restrict__ trunc, int64_t* __restrict__ buf, uint8_t* __restrict__ act,
    int64_t* __restrict__ posc, int64_t* __restrict__ b0, int64_t* __restrict__ e0) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t r = r0 + threadIdx.x;
  if (terms == nullptr) {  // the begin: the block's lanes' hit slots, 16 bytes a store
    const int64_t lanes = R - r0 < blockDim.x ? R - r0 : blockDim.x;
    longlong2* dst = reinterpret_cast<longlong2*>(buf + r0 * H * 4);
    for (int64_t i = threadIdx.x; i < lanes * H * 2; i += blockDim.x)
      dst[i] = make_longlong2(0, 0);
  }
  if (r >= R || (terms != nullptr && act[r] == 0)) return;
  const bool rc = is_rc[r] != 0;
  const int64_t len = ldg(lens2 + r);
  const int64_t* row = anc2 + r * S;
  // smallest lane-local anchor position >= nxt, else S (ops/mmp.py _next_anchor_pos)
  auto next_anchor_pos = [&](int64_t nxt) -> int64_t {
    const int64_t col = rc ? len - k - nxt : nxt;
    const int64_t v = ldg(row + clamp64(col, 0, S - 1));
    if (!rc) return nxt < S ? v : S;
    return col >= 0 && v >= 0 ? len - k - v : S;
  };
  int64_t p;
  bool tr = false;
  if (terms == nullptr) {
    p = next_anchor_pos(0);
    n[r] = 0;
    trunc[r] = 0;
  } else {
    int64_t b1 = 0, e1 = 0, mlen = 0;
    for (int q = 0; q < P; ++q) {
      const int64_t* tq = terms + static_cast<int64_t>(q) * 3 * R;
      b1 += ldg(tq + r);
      e1 += ldg(tq + R + r);
      mlen += ldg(tq + 2 * R + r);
    }
    const int64_t pc = posc[r];
    const int64_t nn = n[r];
    tr = nn >= H;
    if (tr) {
      trunc[r] = 1;
    } else {
      put_slot(buf + (r * H + nn) * 4, pc, mlen, b1, e1);
      n[r] = nn + 1;
    }
    const int64_t adv = mlen - k + 1;
    p = next_anchor_pos(pc + (adv > 1 ? adv : 1));
  }
  pos[r] = p;
  const int64_t pc = clamp64(p, 0, S - 1);
  const int64_t col = clamp64(rc ? len - k - pc : pc, 0, S - 1);
  act[r] = p < S && !tr ? 1 : 0;
  posc[r] = pc;
  b0[r] = ldg(db2 + r * S + col);
  e0[r] = ldg(de2 + r * S + col);
}

__global__ void extend_charwise_kernel(
    const int64_t* __restrict__ lens, const int64_t* __restrict__ b0,
    const int64_t* __restrict__ e0, const int64_t* __restrict__ pos,
    const uint8_t* __restrict__ active, CharIndex cx, int64_t R, int L, int k, int steps,
    int64_t* __restrict__ b_out, int64_t* __restrict__ e_out, int64_t* __restrict__ mlen_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Traffic tr{};
  int64_t b, e, mlen;
  extend_charwise<false>(cx, cx.codes + r * L, lens[r], b0[r], e0[r], pos[r], active[r] != 0,
                         k, steps, L, b, e, mlen, tr);
  b_out[r] = b;
  e_out[r] = e;
  mlen_out[r] = mlen;
}

// What the compare takes: sa_cmp rows of whole 8-byte pairs on 8-byte
// boundaries, with at most kRegWords fused words.
bool index_ok(const void* sa_cmp, int64_t n_sa, int F, int64_t nw) {
  return n_sa > 0 && nw > 0 && F >= 0 && F <= kRegWords && (3 + F) % 2 == 0 &&
         reinterpret_cast<uintptr_t>(sa_cmp) % 8 == 0;
}

Index make_index(const void* sa_cmp, int64_t n_sa, int F, const void* text2q, int64_t nw) {
  return Index{static_cast<const int32_t*>(sa_cmp), n_sa, F,
               static_cast<const int32_t*>(text2q), nw};
}

bool char_index_ok(const void* codes, const void* sa, int64_t n_sa, const void* text,
                   int64_t n_text) {
  return codes != nullptr && sa != nullptr && text != nullptr && n_sa > 0 && n_text > 0;
}

CharIndex make_char_index(const void* codes, const void* sa, int64_t n_sa, const void* text,
                          int64_t n_text) {
  return CharIndex{static_cast<const int8_t*>(codes), static_cast<const int32_t*>(sa), n_sa,
                   static_cast<const int8_t*>(text), n_text};
}

// The launch of the extension alone (tqm_extend_packed*).
template <bool kCount>
int launch_extend(const void* preads, const void* next_bad, const void* lens,
                  const void* col_off, const void* lane, const void* b0, const void* e0,
                  const void* pos, const void* active, const Index& ix, int64_t A, int64_t R,
                  int L, int k, int steps, int W, void* b_out, void* e_out, void* mlen_out,
                  const Traffic& tr, void* stream) {
  if (A <= 0 || R <= 0 || L <= 0 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  extend_packed_kernel<kCount><<<static_cast<unsigned>((A + kMaxLanes - 1) / kMaxLanes),
                                 kMaxLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(preads), static_cast<const int64_t*>(next_bad),
      static_cast<const int64_t*>(lens), static_cast<const int64_t*>(col_off),
      static_cast<const int64_t*>(lane), static_cast<const int64_t*>(b0),
      static_cast<const int64_t*>(e0), static_cast<const int64_t*>(pos),
      static_cast<const uint8_t*>(active), ix, A, R, L, k, steps, W,
      static_cast<int64_t*>(b_out), static_cast<int64_t*>(e_out),
      static_cast<int64_t*>(mlen_out), tr);
  return static_cast<int>(cudaGetLastError());
}

// The launch of one shard's trip (tqm_sharded_trip*).
template <bool kCount>
int launch_trip(const void* preads, const void* next_bad, const void* lens2,
                const void* col_off2, const void* b0, const void* e0, const void* pos,
                const void* active, const Index& ix, int64_t base, int64_t n_local, int64_t R,
                int L, int k, int steps, int W, void* b_out, void* e_out, void* mlen_out,
                const Traffic& tr, void* stream) {
  if (R <= 0 || L <= 0 || W < 1 || n_local < 0 || n_local > ix.n_sa)
    return static_cast<int>(cudaErrorInvalidValue);
  sharded_trip_kernel<kCount><<<static_cast<unsigned>((R + kTripLanes - 1) / kTripLanes),
                                kTripLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(preads), static_cast<const int64_t*>(next_bad),
      static_cast<const int64_t*>(lens2), static_cast<const int64_t*>(col_off2),
      static_cast<const int64_t*>(b0), static_cast<const int64_t*>(e0),
      static_cast<const int64_t*>(pos), static_cast<const uint8_t*>(active), ix, base, n_local,
      R, L, k, steps, W, static_cast<int64_t*>(b_out), static_cast<int64_t*>(e_out),
      static_cast<int64_t*>(mlen_out), tr);
  return static_cast<int>(cudaGetLastError());
}

// The launch of a walk of any extension kind; the inputs of the others are
// not read (ix, cx or sh default, null lane pointers).
template <bool kCount, Ext kExt, typename Slot = int64_t>
int launch_walk(const void* preads, const void* next_bad, const void* lens2,
                const void* col_off2, const void* bf, const void* ef, const void* br,
                const void* er, const void* anch_f, const void* anch_r, const Index& ix,
                const CharIndex& cx, int64_t R, int64_t B, int L, int S, int k, int H,
                int steps, int W, void* buf, void* n_out, void* trunc_out, const Traffic& tr,
                void* stream, const Shards<Slot>& sh = Shards<Slot>{}) {
  if (R <= 0 || B <= 0 || R > 2 * B || L <= 0 || S <= 0 || H <= 0 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  int cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the shard table first (kSharded), then as many lanes a block (up to
  // kMaxLanes) as the rest of the shared memory stages
  const int64_t table_bytes = kExt == Ext::kSharded ? 16 * static_cast<int64_t>(sh.P) : 0;
  const int64_t room = cap - table_bytes;
  const int64_t lane_bytes = 32 * static_cast<int64_t>(H);
  const bool staged = lane_bytes <= room;
  const int lanes = staged ? static_cast<int>(kMaxLanes < room / lane_bytes ? kMaxLanes
                                                                           : room / lane_bytes)
                           : kMaxLanes;
  const size_t smem = static_cast<size_t>(table_bytes + (staged ? lanes * lane_bytes : 0));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(anchor_walk_kernel<kCount, kExt, Slot>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((R + lanes - 1) / lanes);
  anchor_walk_kernel<kCount, kExt, Slot><<<blocks, lanes, smem,
                                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(preads), static_cast<const int64_t*>(next_bad),
      static_cast<const int64_t*>(lens2), static_cast<const int64_t*>(col_off2),
      static_cast<const int64_t*>(bf), static_cast<const int64_t*>(ef),
      static_cast<const int64_t*>(br), static_cast<const int64_t*>(er),
      static_cast<const uint8_t*>(anch_f), static_cast<const uint8_t*>(anch_r), ix, cx, R, B, L,
      S, k, H, steps, W, staged, static_cast<int64_t*>(buf), static_cast<int64_t*>(n_out),
      static_cast<uint8_t*>(trunc_out), tr, sh);
  return static_cast<int>(cudaGetLastError());
}

// The traffic bitmaps of the named regions: region g gets word_off[i] of
// `bits` where regions[i] == g (the other regions are not read).
Traffic make_traffic(const void* const* tensors, const Region* regions, int n, void* bits,
                     const int64_t* word_off, void* rows) {
  Traffic tr{};
  for (int i = 0; i < n; ++i) {
    tr.base[regions[i]] = reinterpret_cast<uintptr_t>(tensors[i]) >> 5;
    tr.bits[regions[i]] = static_cast<uint32_t*>(bits) + word_off[i];
  }
  tr.rows = static_cast<unsigned long long*>(rows);
  return tr;
}

bool shards_ok(const void* sa_cmp, int P, int64_t s_pad, int F, const void* text2q, int64_t nw,
               const void* slot_base) {
  return P >= 1 && P <= kMaxShards && s_pad >= 1 && text2q != nullptr && slot_base != nullptr &&
         index_ok(sa_cmp, s_pad, F, nw);
}

template <typename Slot>
Shards<Slot> make_shards(const void* sa_cmp, int P, int64_t s_pad, int F, const void* text2q,
                         int64_t nw, const void* slot_base) {
  int top = 1;
  while (2 * top <= P - 1) top *= 2;
  if (P <= 1) top = 0;
  return Shards<Slot>{static_cast<const int32_t*>(sa_cmp), P, top, s_pad, F,
                      static_cast<const int32_t*>(text2q), nw,
                      static_cast<const Slot*>(slot_base)};
}

// The sharded walk at one global slot type.
template <bool kCount, typename Slot>
int launch_sharded(const void* preads, const void* next_bad, const void* lens2,
                   const void* col_off2, const void* bf, const void* ef, const void* br,
                   const void* er, const void* anch_f, const void* anch_r, const void* sa_cmp,
                   int P, int64_t s_pad, int F, const void* text2q, int64_t nw,
                   const void* slot_base, int64_t R, int64_t B, int L, int S, int k, int H,
                   int steps, int W, void* buf, void* n_out, void* trunc_out, const Traffic& tr,
                   void* stream) {
  return launch_walk<kCount, Ext::kSharded, Slot>(
      preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f, anch_r, Index{}, CharIndex{}, R,
      B, L, S, k, H, steps, W, buf, n_out, trunc_out, tr, stream,
      make_shards<Slot>(sa_cmp, P, s_pad, F, text2q, nw, slot_base));
}

}  // namespace

// The anchor walk with the packed extension. Strand-paired lanes: R = 2B
// (rows [0, B) forward, [B, 2B) rc) with bf, ef, br, er (B, S) int64 and
// anch_f, anch_r (B, S) bool, the dense phase's intervals and anchor masks of
// both strands in forward columns. Explicit lanes: B = R, every lane forward
// over its row of bf, ef, anch_f (R, S); br, er, anch_r unused. Writes every
// byte of buf (R, H, 4) int64 [pos, mlen, b, e] (unused slots 0), n_out (R,)
// int64 and trunc_out (R,) bytes: none needs a fill.
extern "C" int tqm_anchor_walk(
    const void* preads, const void* next_bad, const void* lens2, const void* col_off2,
    const void* bf, const void* ef, const void* br, const void* er, const void* anch_f,
    const void* anch_r, const void* sa_cmp, int64_t n_sa, int F, const void* text2q, int64_t nw,
    int64_t R, int64_t B, int L, int S, int k, int H, int steps, int W, void* buf, void* n_out,
    void* trunc_out, void* stream) {
  if (!index_ok(sa_cmp, n_sa, F, nw)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_walk<false, Ext::kPacked>(preads, next_bad, lens2, col_off2, bf, ef, br, er,
                                          anch_f, anch_r, make_index(sa_cmp, n_sa, F, text2q, nw),
                                          CharIndex{}, R, B, L, S, k, H, steps, W, buf, n_out,
                                          trunc_out, Traffic{}, stream);
}

// The same walk, counting what it reads: for measuring the byte bound of a
// run, never on the main path. `bits` is a zeroed device array of 32-bit
// words holding one bitmap per input tensor, in the order of the entry's
// arguments (preads ... anch_r, sa_cmp, text2q); the bitmap of the i-th starts
// at word word_off[i] (a host array) and gets a bit set for every 32-byte
// sector of that tensor that the launch read, sector 0 being the one the
// tensor's first byte lies in. `rows` is one zeroed device uint64 that
// receives the number of sa_cmp rows compared.
extern "C" int tqm_anchor_walk_traffic(
    const void* preads, const void* next_bad, const void* lens2, const void* col_off2,
    const void* bf, const void* ef, const void* br, const void* er, const void* anch_f,
    const void* anch_r, const void* sa_cmp, int64_t n_sa, int F, const void* text2q, int64_t nw,
    int64_t R, int64_t B, int L, int S, int k, int H, int steps, int W, void* buf, void* n_out,
    void* trunc_out, void* bits, const int64_t* word_off, void* rows, void* stream) {
  if (!index_ok(sa_cmp, n_sa, F, nw)) return static_cast<int>(cudaErrorInvalidValue);
  const void* tensors[] = {preads, next_bad, lens2,  col_off2, bf,     ef,
                           br,     er,       anch_f, anch_r,   sa_cmp, text2q};
  const Region regions[] = {kPreads, kNextBad, kLens,  kColOff, kBf,    kEf,
                            kBr,     kEr,      kAnchF, kAnchR,  kSaCmp, kText2q};
  return launch_walk<true, Ext::kPacked>(preads, next_bad, lens2, col_off2, bf, ef, br, er,
                                         anch_f, anch_r, make_index(sa_cmp, n_sa, F, text2q, nw),
                                         CharIndex{}, R, B, L, S, k, H, steps, W, buf, n_out,
                                         trunc_out,
                                         make_traffic(tensors, regions, 12, bits, word_off, rows),
                                         stream);
}

// The anchor walk with the charwise extension (ops/mmp.py _extend), lanes as
// in tqm_anchor_walk: codes (R, L) int8 holds every lane's codes left-aligned
// (for paired lanes the explicit [fwd; revcomp] rows: an rc lane's anchors
// are mirrored as in tqm_anchor_walk, its extension reads its own row); sa
// (n_sa,) int32 and text (n_text,) int8 are the flat suffix array and text.
// Writes every output byte as tqm_anchor_walk does.
extern "C" int tqm_anchor_walk_charwise(
    const void* codes, const void* lens2, const void* bf, const void* ef, const void* br,
    const void* er, const void* anch_f, const void* anch_r, const void* sa, int64_t n_sa,
    const void* text, int64_t n_text, int64_t R, int64_t B, int L, int S, int k, int H,
    int steps, void* buf, void* n_out, void* trunc_out, void* stream) {
  if (!char_index_ok(codes, sa, n_sa, text, n_text))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_walk<false, Ext::kCharwise>(
      nullptr, nullptr, lens2, nullptr, bf, ef, br, er, anch_f, anch_r, Index{},
      make_char_index(codes, sa, n_sa, text, n_text), R, B, L, S, k, H, steps, 1, buf, n_out,
      trunc_out, Traffic{}, stream);
}

// The charwise walk counting what it reads, as tqm_anchor_walk_traffic; the
// bitmaps follow the order lens2, bf, ef, br, er, anch_f, anch_r, codes, sa,
// text, and `rows` receives the number of search trips (one sa and one text
// gather each).
extern "C" int tqm_anchor_walk_charwise_traffic(
    const void* codes, const void* lens2, const void* bf, const void* ef, const void* br,
    const void* er, const void* anch_f, const void* anch_r, const void* sa, int64_t n_sa,
    const void* text, int64_t n_text, int64_t R, int64_t B, int L, int S, int k, int H,
    int steps, void* buf, void* n_out, void* trunc_out, void* bits, const int64_t* word_off,
    void* rows, void* stream) {
  if (!char_index_ok(codes, sa, n_sa, text, n_text))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* tensors[] = {lens2, bf, ef, br, er, anch_f, anch_r, codes, sa, text};
  const Region regions[] = {kLens, kBf, kEf, kBr, kEr, kAnchF, kAnchR, kCodes, kSa, kText};
  return launch_walk<true, Ext::kCharwise>(
      nullptr, nullptr, lens2, nullptr, bf, ef, br, er, anch_f, anch_r, Index{},
      make_char_index(codes, sa, n_sa, text, n_text), R, B, L, S, k, H, steps, 1, buf, n_out,
      trunc_out, make_traffic(tensors, regions, 10, bits, word_off, rows), stream);
}

// The pseudo walks (ops/mmp.py pseudo_walk): lanes as in tqm_anchor_walk,
// strand-paired (R = 2B, the canonical-CHD scan) or explicit (B = R, the
// [fwd; revcomp] lanes), with no extension: a hit is [pos, k, b, e] of its
// anchor's interval, and the walk jumps k columns. b and e are copied as the
// int64 values they are (uint32 occurrence ids of a big-occ table). Writes
// every output byte as tqm_anchor_walk does.
extern "C" int tqm_pseudo_walk(const void* lens2, const void* bf, const void* ef,
                               const void* br, const void* er, const void* anch_f,
                               const void* anch_r, int64_t R, int64_t B, int S, int k, int H,
                               void* buf, void* n_out, void* trunc_out, void* stream) {
  return launch_walk<false, Ext::kNone>(nullptr, nullptr, lens2, nullptr, bf, ef, br, er, anch_f,
                                        anch_r, Index{}, CharIndex{}, R, B, S + k - 1, S, k, H,
                                        0, 1, buf, n_out, trunc_out, Traffic{}, stream);
}

// The pseudo walk counting what it reads, as tqm_anchor_walk_traffic; the
// bitmaps follow the order lens2, bf, ef, br, er, anch_f, anch_r, and `rows`
// receives the number of trips (hits written).
extern "C" int tqm_pseudo_walk_traffic(const void* lens2, const void* bf, const void* ef,
                                       const void* br, const void* er, const void* anch_f,
                                       const void* anch_r, int64_t R, int64_t B, int S, int k,
                                       int H, void* buf, void* n_out, void* trunc_out,
                                       void* bits, const int64_t* word_off, void* rows,
                                       void* stream) {
  const void* tensors[] = {lens2, bf, ef, br, er, anch_f, anch_r};
  const Region regions[] = {kLens, kBf, kEf, kBr, kEr, kAnchF, kAnchR};
  return launch_walk<true, Ext::kNone>(nullptr, nullptr, lens2, nullptr, bf, ef, br, er, anch_f,
                                       anch_r, Index{}, CharIndex{}, R, B, S + k - 1, S, k, H,
                                       0, 1, buf, n_out, trunc_out,
                                       make_traffic(tensors, regions, 7, bits, word_off, rows),
                                       stream);
}

// The extension alone, once per lane on given (b0, e0, pos, active): the
// signature of ops/extend_packed.py extend_packed, so that a fault in the
// walk can be located.
extern "C" int tqm_extend_packed(
    const void* preads, const void* next_bad, const void* lens, const void* col_off,
    const void* b0, const void* e0, const void* pos, const void* active,
    const void* sa_cmp, int64_t n_sa, int F, const void* text2q, int64_t nw, int64_t R,
    int L, int k, int steps, int W, void* b_out, void* e_out, void* mlen_out,
    void* stream) {
  if (!index_ok(sa_cmp, n_sa, F, nw)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_extend<false>(preads, next_bad, lens, col_off, nullptr, b0, e0, pos, active,
                              make_index(sa_cmp, n_sa, F, text2q, nw), R, R, L, k, steps, W,
                              b_out, e_out, mlen_out, Traffic{}, stream);
}

// The extension in anchor-parallel mode (ops/extend_packed.py extend_packed
// with lane=, the host-staged engine's stage A): A anchors over R read rows,
// anchor i reading row lane[i] of preads, next_bad (R, L), lens and col_off
// (R,) (col_off may be null: every row left-aligned) at its own b0, e0, pos
// (A,) int64 and active (A,) bytes. Writes every byte of b_out, e_out and
// mlen_out (A,) int64.
extern "C" int tqm_extend_packed_lanes(
    const void* preads, const void* next_bad, const void* lens, const void* col_off,
    const void* lane, const void* b0, const void* e0, const void* pos, const void* active,
    const void* sa_cmp, int64_t n_sa, int F, const void* text2q, int64_t nw, int64_t A,
    int64_t R, int L, int k, int steps, int W, void* b_out, void* e_out, void* mlen_out,
    void* stream) {
  if (!index_ok(sa_cmp, n_sa, F, nw) || lane == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_extend<false>(preads, next_bad, lens, col_off, lane, b0, e0, pos, active,
                              make_index(sa_cmp, n_sa, F, text2q, nw), A, R, L, k, steps, W,
                              b_out, e_out, mlen_out, Traffic{}, stream);
}

// tqm_extend_packed_lanes counting what it reads, as tqm_anchor_walk_traffic:
// the bitmaps follow the order preads, next_bad, lens, col_off, lane, b0, e0,
// pos, active, sa_cmp, text2q (col_off's is unused when it is null), and
// `rows` receives the number of sa_cmp rows compared.
extern "C" int tqm_extend_packed_traffic(
    const void* preads, const void* next_bad, const void* lens, const void* col_off,
    const void* lane, const void* b0, const void* e0, const void* pos, const void* active,
    const void* sa_cmp, int64_t n_sa, int F, const void* text2q, int64_t nw, int64_t A,
    int64_t R, int L, int k, int steps, int W, void* b_out, void* e_out, void* mlen_out,
    void* bits, const int64_t* word_off, void* rows, void* stream) {
  if (!index_ok(sa_cmp, n_sa, F, nw) || lane == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* tensors[] = {preads, next_bad, lens, col_off, lane, b0,
                           e0,     pos,      active, sa_cmp, text2q};
  const Region regions[] = {kPreads, kNextBad, kLens, kColOff, kLane, kB0,
                            kE0,     kPos,     kActive, kSaCmp, kText2q};
  return launch_extend<true>(preads, next_bad, lens, col_off, lane, b0, e0, pos, active,
                             make_index(sa_cmp, n_sa, F, text2q, nw), A, R, L, k, steps, W,
                             b_out, e_out, mlen_out,
                             make_traffic(tensors, regions, 11, bits, word_off, rows), stream);
}

// The charwise extension alone, once per lane on given (b0, e0, pos, active):
// the signature of ops/mmp.py _extend (codes (R, L) int8, lane r reading row
// r), so that a fault in the charwise walk can be located.
extern "C" int tqm_extend_charwise(
    const void* codes, const void* lens, const void* b0, const void* e0, const void* pos,
    const void* active, const void* sa, int64_t n_sa, const void* text, int64_t n_text,
    int64_t R, int L, int k, int steps, void* b_out, void* e_out, void* mlen_out,
    void* stream) {
  if (R <= 0 || L <= 0 || !char_index_ok(codes, sa, n_sa, text, n_text))
    return static_cast<int>(cudaErrorInvalidValue);
  extend_charwise_kernel<<<static_cast<unsigned>((R + kMaxLanes - 1) / kMaxLanes), kMaxLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(lens), static_cast<const int64_t*>(b0),
      static_cast<const int64_t*>(e0), static_cast<const int64_t*>(pos),
      static_cast<const uint8_t*>(active), make_char_index(codes, sa, n_sa, text, n_text), R, L,
      k, steps, static_cast<int64_t*>(b_out), static_cast<int64_t*>(e_out),
      static_cast<int64_t*>(mlen_out));
  return static_cast<int>(cudaGetLastError());
}

// The sharded walks (rapmap_tpu/parallel/sharded.py _sharded_scan_paired,
// while_loop :619, and _sharded_scan, :469): lanes as in tqm_anchor_walk,
// strand-paired (R = 2B, the canonical-class sharded scan) or explicit
// (B = R, the [fwd; revcomp] lanes of the per-strand and binary-search
// scans), with bf, ef, br, er GLOBAL slot intervals (int64) of the sharded
// dense phase. Each trip extends the anchor on the shard that owns it:
// sa_cmp (P, s_pad, 3 + F) int32 holds the shards' rows stacked, text2q
// (nw, 4) the replicated packed text, slot_base (P, 2) each shard's [global
// offset, true slot count], int32 (slot64 = 0) or int64 (slot64 = 1), with
// 1 <= P <= kMaxShards and the ranges ascending and disjoint (offset + count
// <= the next offset; the caller checks it: the owner search relies on it).
// Hits are [pos, mlen, b, e] in global slots. Writes every output byte as
// tqm_anchor_walk does.
extern "C" int tqm_sharded_walk(
    const void* preads, const void* next_bad, const void* lens2, const void* col_off2,
    const void* bf, const void* ef, const void* br, const void* er, const void* anch_f,
    const void* anch_r, const void* sa_cmp, int P, int64_t s_pad, int F, const void* text2q,
    int64_t nw, const void* slot_base, int slot64, int64_t R, int64_t B, int L, int S, int k,
    int H, int steps, int W, void* buf, void* n_out, void* trunc_out, void* stream) {
  if (!shards_ok(sa_cmp, P, s_pad, F, text2q, nw, slot_base))
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = slot64 ? &launch_sharded<false, int64_t> : &launch_sharded<false, int32_t>;
  return run(preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f, anch_r, sa_cmp, P, s_pad,
             F, text2q, nw, slot_base, R, B, L, S, k, H, steps, W, buf, n_out, trunc_out,
             Traffic{}, stream);
}

// The sharded walk counting what it reads, as tqm_anchor_walk_traffic: the
// bitmaps follow the order preads, next_bad, lens2, col_off2, bf, ef, br, er,
// anch_f, anch_r, sa_cmp, text2q, slot_base, and `rows` receives the number
// of sa_cmp rows compared.
extern "C" int tqm_sharded_walk_traffic(
    const void* preads, const void* next_bad, const void* lens2, const void* col_off2,
    const void* bf, const void* ef, const void* br, const void* er, const void* anch_f,
    const void* anch_r, const void* sa_cmp, int P, int64_t s_pad, int F, const void* text2q,
    int64_t nw, const void* slot_base, int slot64, int64_t R, int64_t B, int L, int S, int k,
    int H, int steps, int W, void* buf, void* n_out, void* trunc_out, void* bits,
    const int64_t* word_off, void* rows, void* stream) {
  if (!shards_ok(sa_cmp, P, s_pad, F, text2q, nw, slot_base))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* tensors[] = {preads, next_bad, lens2,  col_off2, bf,     ef,     br,
                           er,     anch_f,   anch_r, sa_cmp,   text2q, slot_base};
  const Region regions[] = {kPreads, kNextBad, kLens,  kColOff, kBf,     kEf,      kBr,
                            kEr,     kAnchF,   kAnchR, kSaCmp,  kText2q, kSlotBase};
  const Traffic tr = make_traffic(tensors, regions, 13, bits, word_off, rows);
  auto run = slot64 ? &launch_sharded<true, int64_t> : &launch_sharded<true, int32_t>;
  return run(preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f, anch_r, sa_cmp, P, s_pad,
             F, text2q, nw, slot_base, R, B, L, S, k, H, steps, W, buf, n_out, trunc_out, tr,
             stream);
}

// One shard's term of one trip of the sharded walk over a data row whose
// shards lie on their own devices (parallel/sharded.py sharded_trip, the
// split path's K10): R lanes of preads, next_bad (R, L) int64 and lens2,
// col_off2, b0, e0, pos (R,) int64, active (R,) bytes, all on the shard's
// device with its sa_cmp (n_sa, 3 + F) int32 rows (8-byte aligned, F as in
// tqm_anchor_walk) and text2q (nw, 4); b0 and e0 are GLOBAL slots, base the
// shard's global slot offset and n_local its true slot count (0 <= n_local
// <= n_sa). Writes every byte of b_out, e_out and mlen_out (R,) int64: the
// owned lanes' extension in global slots, (0, 0, 0) on the others.
extern "C" int tqm_sharded_trip(
    const void* preads, const void* next_bad, const void* lens2, const void* col_off2,
    const void* b0, const void* e0, const void* pos, const void* active, const void* sa_cmp,
    int64_t n_sa, int F, const void* text2q, int64_t nw, int64_t base, int64_t n_local,
    int64_t R, int L, int k, int steps, int W, void* b_out, void* e_out, void* mlen_out,
    void* stream) {
  if (!index_ok(sa_cmp, n_sa, F, nw)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_trip<false>(preads, next_bad, lens2, col_off2, b0, e0, pos, active,
                            make_index(sa_cmp, n_sa, F, text2q, nw), base, n_local, R, L, k, steps,
                            W, b_out, e_out, mlen_out, Traffic{}, stream);
}

// The trip counting what it reads, as tqm_anchor_walk_traffic: the bitmaps
// follow the order preads, next_bad, lens2, col_off2, b0, e0, pos, active,
// sa_cmp, text2q, and `rows` receives the number of sa_cmp rows compared.
extern "C" int tqm_sharded_trip_traffic(
    const void* preads, const void* next_bad, const void* lens2, const void* col_off2,
    const void* b0, const void* e0, const void* pos, const void* active, const void* sa_cmp,
    int64_t n_sa, int F, const void* text2q, int64_t nw, int64_t base, int64_t n_local,
    int64_t R, int L, int k, int steps, int W, void* b_out, void* e_out, void* mlen_out,
    void* bits, const int64_t* word_off, void* rows, void* stream) {
  if (!index_ok(sa_cmp, n_sa, F, nw)) return static_cast<int>(cudaErrorInvalidValue);
  const void* tensors[] = {preads, next_bad, lens2, col_off2, b0, e0, pos, active, sa_cmp, text2q};
  const Region regions[] = {kPreads, kNextBad, kLens, kColOff, kB0,
                            kE0,     kPos,     kActive, kSaCmp, kText2q};
  return launch_trip<true>(preads, next_bad, lens2, col_off2, b0, e0, pos, active,
                           make_index(sa_cmp, n_sa, F, text2q, nw), base, n_local, R, L, k, steps,
                           W, b_out, e_out, mlen_out,
                           make_traffic(tensors, regions, 10, bits, word_off, rows), stream);
}

// The split walk's trip at home (parallel/sharded.py sharded_advance, K11),
// on the row's home device: terms (P, 3, R) int64, the P shards' (b, e, mlen)
// of the trip, 1 <= P <= kMaxShards, or null for the begin (P unread); the
// tables db2, de2, anc2 (R, S) int64, is_rc (R,) bytes, lens2 (R,) int64;
// the state pos, n (R,) int64, trunc (R,) bytes, buf (R, H, 4) int64 and the
// next trip's act (R,) bytes, posc, b0, e0 (R,) int64, updated in place (the
// begin writes every byte of them).
extern "C" int tqm_sharded_advance(const void* terms, int P, const void* db2, const void* de2,
                                   const void* anc2, const void* is_rc, const void* lens2,
                                   int64_t R, int S, int k, int H, void* pos, void* n,
                                   void* trunc, void* buf, void* act, void* posc, void* b0,
                                   void* e0, void* stream) {
  if (R <= 0 || S <= 0 || H <= 0 || (terms != nullptr && (P < 1 || P > kMaxShards)))
    return static_cast<int>(cudaErrorInvalidValue);
  sharded_advance_kernel<<<static_cast<unsigned>((R + kAdvanceLanes - 1) / kAdvanceLanes),
                           kAdvanceLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(terms), P, static_cast<const int64_t*>(db2),
      static_cast<const int64_t*>(de2), static_cast<const int64_t*>(anc2),
      static_cast<const uint8_t*>(is_rc), static_cast<const int64_t*>(lens2), R, S, k, H,
      static_cast<int64_t*>(pos), static_cast<int64_t*>(n), static_cast<uint8_t*>(trunc),
      static_cast<int64_t*>(buf), static_cast<uint8_t*>(act), static_cast<int64_t*>(posc),
      static_cast<int64_t*>(b0), static_cast<int64_t*>(e0));
  return static_cast<int>(cudaGetLastError());
}
