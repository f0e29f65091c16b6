// SA -> k-mer interval table scan (the reference indexer's SA->hash pass,
// upstream:src/RapMapSAIndexer.cpp "single pass over SA grouping suffixes by
// first k chars" — SURVEY.md §3.1), over the 2-bit packed text.
//
// Per SA slot: three packed-word loads + a shift tree extract the 2k key bits
// and the parallel sentinel bits (validity), then a serial run walk emits one
// [b, e) interval per distinct valid k-mer. The slots go a chunk at a time:
// key extraction is OpenMP-parallel into chunk-sized scratch, the grouping
// walk is sequential and carries the open run and its key across each
// chunk's end, so no scratch spans the SA (keys and flags over every slot
// took 9 bytes a slot, 19.8 GB at 2.2e9 slots). Called with null outputs it
// only counts the groups, so the caller sizes its outputs exactly. Exactly
// matches index/kmer_table.build_kmer_table's numpy fallback bit-for-bit
// (tested both ways).

#include <cstdint>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct KeyValid {
  uint64_t key;
  bool valid;
};

// Word i of the packed text and of its sentinel mask; words past the nw
// stored ones read as all-sentinel, so short suffixes read as invalid.
static inline uint32_t word(const uint32_t* w, int64_t i, int64_t nw, uint32_t pad) {
  return i < nw ? w[i] : pad;
}

static inline KeyValid extract(int64_t g, const uint32_t* tw, const uint32_t* sm,
                               int64_t nw, int32_t k, uint64_t m2k) {
  const int64_t wi = g >> 4;
  const uint32_t sub = (uint32_t)(g & 15);
  const uint32_t sh = 96 - 2 * (uint32_t)k - 2 * sub;  // in [2, 94]
  const uint64_t Ak = ((uint64_t)tw[wi] << 32) | word(tw, wi + 1, nw, 0u);
  const uint64_t As = ((uint64_t)sm[wi] << 32) | word(sm, wi + 1, nw, ~0u);
  uint64_t key, sent;
  if (sh <= 32) {
    key = (Ak << (32 - sh)) | ((uint64_t)word(tw, wi + 2, nw, 0u) >> sh);
    sent = (As << (32 - sh)) | ((uint64_t)word(sm, wi + 2, nw, ~0u) >> sh);
  } else {
    key = Ak >> (sh - 32);
    sent = As >> (sh - 32);
  }
  return {key & m2k, (sent & m2k) == 0};
}

// Groups of the SA -> their count; with outputs (out_hi != nullptr) also
// their keys and [b, e) slots, at most cap of them (-2 past it).
template <typename IdxT, typename SlotT>
static int64_t kmer_table_impl(const IdxT* sa, int64_t n, const uint32_t* tw,
                               const uint32_t* sm, int64_t nw, int32_t k,
                               int64_t chunk, uint32_t* out_hi, uint32_t* out_lo,
                               SlotT* out_b, SlotT* out_e, int64_t cap) {
  const uint64_t m2k =
      (k == 32) ? ~0ull : ((1ull << (2 * (uint32_t)k)) - 1ull);
  const bool write = out_hi != nullptr;
  const int64_t c = chunk < n ? chunk : n;
  std::vector<uint64_t> keys(c);
  std::vector<uint8_t> valid(c);
  // valid slots with equal keys are contiguous in SA order (SEMANTICS.md §2);
  // a group also never spans an invalid slot, so close it on any break.
  int64_t ng = 0;
  bool open = false;
  uint64_t cur = 0;
  for (int64_t s = 0; s < n; s += c) {
    const int64_t m = (n - s) < c ? (n - s) : c;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) if (m >= 4096)
#endif
    for (int64_t j = 0; j < m; j++) {
      KeyValid kv = extract((int64_t)sa[s + j], tw, sm, nw, k, m2k);
      keys[j] = kv.key;
      valid[j] = kv.valid ? 1 : 0;
    }
    for (int64_t j = 0; j < m; j++) {
      if (!valid[j]) {
        open = false;
        continue;
      }
      if (!open || keys[j] != cur) {
        cur = keys[j];
        if (write) {
          if (ng >= cap) return -2;
          out_hi[ng] = (uint32_t)(cur >> 32);
          out_lo[ng] = (uint32_t)cur;
          out_b[ng] = (SlotT)(s + j);
        }
        ng++;
        open = true;
      }
      if (write) out_e[ng - 1] = (SlotT)(s + j + 1);
    }
  }
  return ng;
}

}  // namespace

// tw/sm: the nw packed words of the text and of its sentinel mask (no
// padding needed). chunk: slots a chunk (>= 1). Null outputs: count only.
extern "C" int64_t tqm_kmer_table_i32(const int32_t* sa, int64_t n,
                                      const uint32_t* tw, const uint32_t* sm,
                                      int64_t nw, int32_t k, int64_t chunk,
                                      uint32_t* out_hi, uint32_t* out_lo,
                                      int32_t* out_b, int32_t* out_e, int64_t cap) {
  if (n <= 0 || nw <= 0 || chunk < 1 || k < 1 || k > 32) return -1;
  return kmer_table_impl(sa, n, tw, sm, nw, k, chunk, out_hi, out_lo, out_b, out_e, cap);
}

// i64 SA entry: slot intervals are int64 too — a bigSA text can exceed 2^31
// SA slots (upstream divsufsort64 regime uses 64-bit interval types as well).
extern "C" int64_t tqm_kmer_table_i64(const int64_t* sa, int64_t n,
                                      const uint32_t* tw, const uint32_t* sm,
                                      int64_t nw, int32_t k, int64_t chunk,
                                      uint32_t* out_hi, uint32_t* out_lo,
                                      int64_t* out_b, int64_t* out_e, int64_t cap) {
  if (n <= 0 || nw <= 0 || chunk < 1 || k < 1 || k > 32) return -1;
  return kmer_table_impl(sa, n, tw, sm, nw, k, chunk, out_hi, out_lo, out_b, out_e, cap);
}
