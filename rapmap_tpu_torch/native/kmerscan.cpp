// SA -> k-mer interval table scan (the reference indexer's SA->hash pass,
// upstream:src/RapMapSAIndexer.cpp "single pass over SA grouping suffixes by
// first k chars" — SURVEY.md §3.1), over the 2-bit packed text.
//
// Per SA slot: three packed-word loads + a shift tree extract the 2k key bits
// and the parallel sentinel bits (validity), then a serial run walk emits one
// [b, e) interval per distinct valid k-mer. Key extraction is OpenMP-parallel
// into scratch arrays; the grouping walk is sequential (it is a trivial
// single pass). Exactly matches index/kmer_table.build_kmer_table's numpy
// fallback bit-for-bit (tested both ways).

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

// tw/sm must carry >= 2 words of padding past nw_data words (caller pads; the
// pad must be all-sentinel in sm so short suffixes read as invalid).
static inline KeyValid extract(int64_t g, const uint32_t* tw, const uint32_t* sm,
                               int32_t k, uint64_t m2k) {
  const int64_t wi = g >> 4;
  const uint32_t sub = (uint32_t)(g & 15);
  const uint32_t sh = 96 - 2 * (uint32_t)k - 2 * sub;  // in [2, 94]
  const uint64_t Ak = ((uint64_t)tw[wi] << 32) | tw[wi + 1];
  const uint64_t As = ((uint64_t)sm[wi] << 32) | sm[wi + 1];
  uint64_t key, sent;
  if (sh <= 32) {
    key = (Ak << (32 - sh)) | ((uint64_t)tw[wi + 2] >> sh);
    sent = (As << (32 - sh)) | ((uint64_t)sm[wi + 2] >> sh);
  } else {
    key = Ak >> (sh - 32);
    sent = As >> (sh - 32);
  }
  return {key & m2k, (sent & m2k) == 0};
}

template <typename IdxT, typename SlotT>
static int64_t kmer_table_impl(const IdxT* sa, int64_t n, const uint32_t* tw,
                               const uint32_t* sm, int32_t k, uint32_t* out_hi,
                               uint32_t* out_lo, SlotT* out_b, SlotT* out_e) {
  const uint64_t m2k =
      (k == 32) ? ~0ull : ((1ull << (2 * (uint32_t)k)) - 1ull);
  std::vector<uint64_t> keys(n);
  std::vector<uint8_t> valid(n);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) {
    KeyValid kv = extract((int64_t)sa[i], tw, sm, k, m2k);
    keys[i] = kv.key;
    valid[i] = kv.valid ? 1 : 0;
  }
  // valid slots with equal keys are contiguous in SA order (SEMANTICS.md §2);
  // a group also never spans an invalid slot, so close it on any break.
  int64_t ng = 0;
  bool open = false;
  uint64_t cur = 0;
  for (int64_t i = 0; i < n; i++) {
    if (!valid[i]) {
      open = false;
      continue;
    }
    if (!open || keys[i] != cur) {
      cur = keys[i];
      out_hi[ng] = (uint32_t)(cur >> 32);
      out_lo[ng] = (uint32_t)cur;
      out_b[ng] = (SlotT)i;
      ng++;
      open = true;
    }
    out_e[ng - 1] = (SlotT)(i + 1);
  }
  return ng;
}

}  // namespace

extern "C" int64_t tqm_kmer_table_i32(const int32_t* sa, int64_t n,
                                      const uint32_t* tw, const uint32_t* sm,
                                      int32_t k, uint32_t* out_hi, uint32_t* out_lo,
                                      int32_t* out_b, int32_t* out_e) {
  if (n <= 0 || k < 1 || k > 32) return -1;
  return kmer_table_impl(sa, n, tw, sm, k, out_hi, out_lo, out_b, out_e);
}

// i64 SA entry: slot intervals are int64 too — a bigSA text can exceed 2^31
// SA slots (upstream divsufsort64 regime uses 64-bit interval types as well).
extern "C" int64_t tqm_kmer_table_i64(const int64_t* sa, int64_t n,
                                      const uint32_t* tw, const uint32_t* sm,
                                      int32_t k, uint32_t* out_hi, uint32_t* out_lo,
                                      int64_t* out_b, int64_t* out_e) {
  if (n <= 0 || k < 1 || k > 32) return -1;
  return kmer_table_impl(sa, n, tw, sm, k, out_hi, out_lo, out_b, out_e);
}
