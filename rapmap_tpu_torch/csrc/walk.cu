// The anchor walk of the strand-paired MMP scan, with the packed-word
// extension (suffix compare, bound search, equal range) as device functions:
// one thread per (read, strand) lane, each looping to its own convergence.
//
// Replaces no Pallas kernel. The reference runs this as XLA lax.while_loops
// (rapmap_tpu/ops/mmp.py:190-248 calling rapmap_tpu/ops/extend_packed.py:
// 154-286 every trip), which XLA compiles into one program. Eager PyTorch has
// no counterpart: the plain versions (ops/mmp.py anchor_walk_plain,
// ops/extend_packed.py extend_packed) issue thousands of small launches per
// chunk, every trip for every lane whether or not it is active.
// Here a lane's searches stop at lo == hi and its walk at pos >= S, so no
// masked trip runs and nothing syncs with the host.
//
// Bound on the card: bytes, namely the hit buffer written once and the
// 32-byte sectors of the inputs that the lanes read (a few columns of each
// lane row, and the random 24-byte sa_cmp rows: one or two sectors each, data
// dependent). tqm_anchor_walk_traffic, the kCount = true build of the same
// code, counts those sectors for a given launch. The kernel is
// latency-bound, not byte-bound: a lane's compares form one dependent chain
// of ~10 uncached gathers. One thread per lane keeps 16,384 such chains in
// flight per launch, which hides most of that; a warp per lane, read words
// staged in shared memory and 8-byte row loads are later work.
//
// Words are uint32_t here and compares are unsigned. The plain version
// carries them as int64 values in [0, 2^32) (ops/bits.py); the kernel loads
// that int64 carrier as it lies on the device and keeps the low 32 bits, so
// neither a narrowing pass in the wrapper nor a second pack_reads output is
// needed. Every gather clamps its index as ops/gather.py does, a shift by 32
// is branched around, and __clz(0) == 32 gives diffpos 16 on equal words as
// clz32 does.
//
// C interface for ctypes: every pointer and the stream are void* on the
// Python side; both entries return the CUDA error code (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLaneThreads = 64;  // lanes per block: 16,384 lanes -> 256 blocks

struct Index {
  const int32_t* sa_cmp;  // (n_sa, 3 + F) [wi, sub, tleft, w0..w_{F-1}]
  int64_t n_sa;
  int F;
  const int32_t* text2q;  // (nw, 4) packed words i..i+3
  int64_t nw;
};

// One lane's query: the read suffix beyond depth k at column `base`.
struct Query {
  const int64_t* words;  // the lane's row of packed read words (L of them)
  int64_t base;
  int L;
  int W;                 // words that cover L - k chars
};

// The input tensors, as the traffic count names them.
enum Region {
  kPreads, kNextBad, kLens, kColOff, kDb, kDe, kAnc, kSaCmp, kText2q, kRegions
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

// A counted load of one element.
template <bool kCount, typename T>
__device__ __forceinline__ T load(const Traffic& tr, Region g, const T* p) {
  touch<kCount>(tr, g, p, sizeof(T));
  return *p;
}

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <bool kCount>
__device__ __forceinline__ uint32_t query_word(const Query& q, int j, const Traffic& tr) {
  const int64_t c = q.base + 16 * j;
  if (c >= q.L) return 0u;
  return static_cast<uint32_t>(load<kCount>(tr, kPreads, q.words + clamp64(c, 0, q.L - 1)));
}

// Raw text word i of the run that starts at quad row wi0: rows advance by 4
// words, and the ROW index is what clamps (ops/extend_packed.py _text_words).
template <bool kCount>
__device__ __forceinline__ uint32_t raw_text_word(const Index& ix, int64_t wi0, int i,
                                                  const Traffic& tr) {
  const int64_t row = clamp64(wi0 + 4 * (i >> 2), 0, ix.nw - 1);
  return static_cast<uint32_t>(load<kCount>(tr, kText2q, ix.text2q + row * 4 + (i & 3)));
}

// Compare the suffix at SA[slot] (depth-k based) against the query's first
// qlen chars. cmp < 0: suffix < query; 0: prefix-equal; > 0: suffix > query.
// lcp in chars. Stops at the first deciding word; the plain version runs all
// W words with decided lanes masked, which gives the same pair.
template <bool kCount>
__device__ void suffix_cmp(const Index& ix, const Query& q, int qlen, int64_t slot,
                           int& cmp, int& lcp, const Traffic& tr) {
  const int64_t s = clamp64(slot, 0, ix.n_sa - 1);
  const int32_t* row = ix.sa_cmp + s * (3 + ix.F);
  touch<kCount>(tr, kSaCmp, row, 12);  // wi, sub, tleft; the words as they are read
  if constexpr (kCount) atomicAdd(tr.rows, 1ull);
  const int64_t wi = row[0];
  const int sub = row[1];
  const int tleft = row[2];
  const int sh = sub << 1;
  cmp = 0;
  lcp = 0;
  for (int j = 0; j < q.W; ++j) {
    int qn = qlen - 16 * j;
    qn = qn < 0 ? 0 : (qn > 16 ? 16 : qn);
    int tn = tleft - 16 * j;
    tn = tn < 0 ? 0 : (tn > 16 ? 16 : tn);
    const int n = qn < tn ? qn : tn;
    // n chars from the top: a shift by 32 (n == 0) is undefined in C
    const uint32_t mask = n == 0 ? 0u : (0xFFFFFFFFu << (32 - 2 * n));
    uint32_t tw;
    if (j < ix.F) {
      tw = static_cast<uint32_t>(load<kCount>(tr, kSaCmp, row + 3 + j));
    } else {
      const int jj = j - ix.F;
      const uint32_t r0 = raw_text_word<kCount>(ix, wi + ix.F, jj, tr);
      if (sh == 0) {
        tw = r0;
      } else {
        const uint32_t r1 = raw_text_word<kCount>(ix, wi + ix.F, jj + 1, tr);
        tw = (r0 << sh) | (r1 >> (32 - sh));
      }
    }
    const uint32_t qv = query_word<kCount>(q, j, tr) & mask;
    const uint32_t tv = tw & mask;
    const int diffpos = __clz(static_cast<int>(qv ^ tv)) >> 1;  // chars; 16 if equal
    const bool has_diff = diffpos < n;
    lcp += has_diff ? diffpos : n;
    if (has_diff || tn < qn || qn < 16) {
      // no diff within n: transcript ends first -> suffix smaller; query
      // exhausted -> prefix-equal
      cmp = has_diff ? (tv < qv ? -1 : 1) : (tn < qn ? -1 : 0);
      return;
    }
  }
}

// Binary search in [lo, hi): first S_p >= Q (upper false) or first S_p > Q
// (upper true), with the lcps of the last "less" and the last "not less"
// compare (the neighbours of the insertion point). At most `steps` trips, as
// the plain version's static bound.
template <bool kCount>
__device__ int64_t bound_search(const Index& ix, const Query& q, int qlen, int64_t lo,
                                int64_t hi, bool upper, int steps, int& ll, int& lg,
                                const Traffic& tr) {
  ll = 0;
  lg = 0;
  for (int t = 0; t < steps && lo < hi; ++t) {
    const int64_t mid = (lo + hi) >> 1;
    int cmp, lcp;
    suffix_cmp<kCount>(ix, q, qlen, mid, cmp, lcp, tr);
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
  // valid query chars beyond depth k: up to the next N and the read end
  const int64_t nb =
      q.base < L ? load<kCount>(tr, kNextBad, nbad + clamp64(q.base, 0, L - 1)) : q.base;
  const int64_t end = len + col_off;
  const int qlen = static_cast<int>(clamp64((nb < end ? nb : end) - q.base, 0, L - k));
  const int64_t b0a = active ? b0 : 0;
  const int64_t e0a = active ? e0 : 0;
  int ll, lg, dummy0, dummy1;
  const int64_t lb = bound_search<kCount>(ix, q, qlen, b0a, e0a, false, steps, ll, lg, tr);
  const int l_left = lb > b0a ? ll : 0;
  const int l_right = lb < e0a ? lg : 0;
  int ext = l_left > l_right ? l_left : l_right;
  ext = ext < qlen ? ext : qlen;
  // equal range of the query truncated to ext chars over the narrowed spans
  const int64_t lb2 = bound_search<kCount>(ix, q, ext, l_left < ext ? lb : b0a, lb, false, steps,
                                   dummy0, dummy1, tr);
  const int64_t ub2 = bound_search<kCount>(ix, q, ext, lb, l_right < ext ? lb : e0a, true, steps,
                                   dummy0, dummy1, tr);
  const bool ok = active && ub2 > lb2;
  b = ok ? lb2 : b0;
  e = ok ? ub2 : e0;
  mlen = ok ? k + ext : k;
}

template <bool kCount>
__global__ void anchor_walk_kernel(
    const int64_t* __restrict__ preads, const int64_t* __restrict__ next_bad,
    const int64_t* __restrict__ lens2, const int64_t* __restrict__ col_off2,
    const int64_t* __restrict__ db2, const int64_t* __restrict__ de2,
    const int64_t* __restrict__ anc2, Index ix, int64_t R, int64_t B, int L, int S, int k,
    int H, int steps, int W, int64_t* __restrict__ buf, int64_t* __restrict__ n_out,
    uint8_t* __restrict__ trunc_out, Traffic tr) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const bool is_rc = r >= B;
  const int64_t len = load<kCount>(tr, kLens, lens2 + r);
  const int64_t col_off = load<kCount>(tr, kColOff, col_off2 + r);
  const int64_t* words = preads + r * L;
  const int64_t* nbad = next_bad + r * L;
  const int64_t* anc = anc2 + r * S;

  // Smallest lane-local anchor position >= nxt, else S. Forward lanes read
  // the next-anchor row; rc lanes the prev-anchor row in mirrored columns.
  auto next_anchor_pos = [&](int64_t nxt) -> int64_t {
    const int64_t col = is_rc ? len - k - nxt : nxt;
    const int64_t v = load<kCount>(tr, kAnc, anc + clamp64(col, 0, S - 1));
    if (!is_rc) return nxt < S ? v : S;
    return (col >= 0 && v >= 0) ? len - k - v : S;
  };

  int64_t pos = next_anchor_pos(0);
  int64_t n = 0;
  bool trunc = false;
  while (pos < S) {
    if (n >= H) {  // the hit buffer is full: record nothing more
      trunc = true;
      break;
    }
    const int64_t posc = clamp64(pos, 0, S - 1);
    const int64_t col = clamp64(is_rc ? len - k - posc : posc, 0, S - 1);
    int64_t b, e, mlen;
    extend_lane<kCount>(ix, words, nbad, len, col_off,
                        load<kCount>(tr, kDb, db2 + r * S + col),
                        load<kCount>(tr, kDe, de2 + r * S + col), posc, true, k, steps, L, W,
                        b, e, mlen, tr);
    int64_t* slot = buf + (r * H + n) * 4;
    slot[0] = posc;
    slot[1] = mlen;
    slot[2] = b;
    slot[3] = e;
    n += 1;
    const int64_t adv = mlen - k + 1;
    pos = next_anchor_pos(posc + (adv > 1 ? adv : 1));
  }
  n_out[r] = n;
  trunc_out[r] = trunc ? 1 : 0;
}

__global__ void extend_packed_kernel(
    const int64_t* __restrict__ preads, const int64_t* __restrict__ next_bad,
    const int64_t* __restrict__ lens, const int64_t* __restrict__ col_off,
    const int64_t* __restrict__ b0, const int64_t* __restrict__ e0,
    const int64_t* __restrict__ pos, const uint8_t* __restrict__ active, Index ix,
    int64_t R, int L, int k, int steps, int W, int64_t* __restrict__ b_out,
    int64_t* __restrict__ e_out, int64_t* __restrict__ mlen_out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Traffic tr{};
  int64_t b, e, mlen;
  extend_lane<false>(ix, preads + r * L, next_bad + r * L, lens[r], col_off[r], b0[r], e0[r],
              pos[r], active[r] != 0, k, steps, L, W, b, e, mlen, tr);
  b_out[r] = b;
  e_out[r] = e;
  mlen_out[r] = mlen;
}

unsigned lane_blocks(int64_t R) {
  return static_cast<unsigned>((R + kLaneThreads - 1) / kLaneThreads);
}

template <bool kCount>
int launch_walk(const void* preads, const void* next_bad, const void* lens2,
                const void* col_off2, const void* db2, const void* de2, const void* anc2,
                const void* sa_cmp, int64_t n_sa, int F, const void* text2q, int64_t nw,
                int64_t R, int64_t B, int L, int S, int k, int H, int steps, int W, void* buf,
                void* n_out, void* trunc_out, const Traffic& tr, void* stream) {
  if (R <= 0 || n_sa <= 0 || nw <= 0 || L <= 0 || S <= 0 || H <= 0 || F < 0 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Index ix{static_cast<const int32_t*>(sa_cmp), n_sa, F,
                 static_cast<const int32_t*>(text2q), nw};
  anchor_walk_kernel<kCount>
      <<<lane_blocks(R), kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int64_t*>(preads), static_cast<const int64_t*>(next_bad),
          static_cast<const int64_t*>(lens2), static_cast<const int64_t*>(col_off2),
          static_cast<const int64_t*>(db2), static_cast<const int64_t*>(de2),
          static_cast<const int64_t*>(anc2), ix, R, B, L, S, k, H, steps, W,
          static_cast<int64_t*>(buf), static_cast<int64_t*>(n_out),
          static_cast<uint8_t*>(trunc_out), tr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The anchor walk over R = 2B lanes (rows [0, B) forward, [B, 2B) rc).
// buf (R, H, 4) int64 [pos, mlen, b, e] must come in zeroed: unwritten slots
// read 0. n_out (R,) int64, trunc_out (R,) bytes.
extern "C" int tqm_anchor_walk(
    const void* preads, const void* next_bad, const void* lens2, const void* col_off2,
    const void* db2, const void* de2, const void* anc2, const void* sa_cmp, int64_t n_sa,
    int F, const void* text2q, int64_t nw, int64_t R, int64_t B, int L, int S, int k, int H,
    int steps, int W, void* buf, void* n_out, void* trunc_out, void* stream) {
  return launch_walk<false>(preads, next_bad, lens2, col_off2, db2, de2, anc2, sa_cmp, n_sa, F,
                            text2q, nw, R, B, L, S, k, H, steps, W, buf, n_out, trunc_out,
                            Traffic{}, stream);
}

// The same walk, counting what it reads: for measuring the byte bound of a
// run, never on the main path. `bits` is a zeroed device array of 32-bit
// words holding one bitmap per input tensor, in the order of Region; the
// bitmap of tensor g starts at word word_off[g] (a host array) and gets a bit
// set for every 32-byte sector of g that the launch read, sector 0 being the
// one the tensor's first byte lies in. `rows` is one zeroed device uint64 that
// receives the number of sa_cmp rows compared.
extern "C" int tqm_anchor_walk_traffic(
    const void* preads, const void* next_bad, const void* lens2, const void* col_off2,
    const void* db2, const void* de2, const void* anc2, const void* sa_cmp, int64_t n_sa,
    int F, const void* text2q, int64_t nw, int64_t R, int64_t B, int L, int S, int k, int H,
    int steps, int W, void* buf, void* n_out, void* trunc_out, void* bits,
    const int64_t* word_off, void* rows, void* stream) {
  const void* tensors[kRegions] = {preads, next_bad, lens2, col_off2, db2,
                                   de2,    anc2,     sa_cmp, text2q};
  Traffic tr;
  for (int g = 0; g < kRegions; ++g) {
    tr.base[g] = reinterpret_cast<uintptr_t>(tensors[g]) >> 5;
    tr.bits[g] = static_cast<uint32_t*>(bits) + word_off[g];
  }
  tr.rows = static_cast<unsigned long long*>(rows);
  return launch_walk<true>(preads, next_bad, lens2, col_off2, db2, de2, anc2, sa_cmp, n_sa, F,
                           text2q, nw, R, B, L, S, k, H, steps, W, buf, n_out, trunc_out, tr,
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
  if (R <= 0 || n_sa <= 0 || nw <= 0 || L <= 0 || F < 0 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Index ix{static_cast<const int32_t*>(sa_cmp), n_sa, F,
                 static_cast<const int32_t*>(text2q), nw};
  extend_packed_kernel<<<lane_blocks(R), kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(preads), static_cast<const int64_t*>(next_bad),
      static_cast<const int64_t*>(lens), static_cast<const int64_t*>(col_off),
      static_cast<const int64_t*>(b0), static_cast<const int64_t*>(e0),
      static_cast<const int64_t*>(pos), static_cast<const uint8_t*>(active), ix, R, L, k,
      steps, W, static_cast<int64_t*>(b_out), static_cast<int64_t*>(e_out),
      static_cast<int64_t*>(mlen_out));
  return static_cast<int>(cudaGetLastError());
}
