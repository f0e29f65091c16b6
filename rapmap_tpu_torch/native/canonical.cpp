// Canonical k-mer class construction for the canonical-class CHD
// (index/chd.py build_canonical_chd): class key = min(kmer, rc(kmer)); for
// each distinct class, the table row of the class key itself (fwd_row) and of
// its reverse complement (rc_row), -1 when that orientation is absent.
//
// Replaces the numpy pipeline (key64/rc vector ops + argsort + scatters),
// whose large uint64 temporaries hit pathological page-fault stalls on this
// VM (3-10 s per op at 20 M keys). Here: OpenMP key/rc pass, gnu parallel
// sort of (class, row) pairs, and one sequential grouping walk.

#include <algorithm>
#include <cstdint>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#define TQM_SORT __gnu_parallel::sort
#else
#define TQM_SORT std::sort
#endif

namespace {

static inline uint64_t rc_key64(uint64_t x, int32_t k) {
  const int nb = 2 * k;
  const uint64_t mask = (nb == 64) ? ~0ull : ((1ull << nb) - 1ull);
  x = (~x) & mask;
  x = ((x & 0x3333333333333333ull) << 2) | ((x >> 2) & 0x3333333333333333ull);
  x = ((x & 0x0f0f0f0f0f0f0f0full) << 4) | ((x >> 4) & 0x0f0f0f0f0f0f0f0full);
  x = ((x & 0x00ff00ff00ff00ffull) << 8) | ((x >> 8) & 0x00ff00ff00ff00ffull);
  x = ((x & 0x0000ffff0000ffffull) << 16) | ((x >> 16) & 0x0000ffff0000ffffull);
  x = (x << 32) | (x >> 32);
  return (nb < 64) ? (x >> (64 - nb)) : x;
}

struct ClsRow {
  uint64_t cls;
  int32_t row;
};

}  // namespace

// out_cls_hi/lo, out_fwd, out_rc must hold n entries; returns n_cls (<= n).
//
// The k-mer table arrives sorted by key, so rows whose key IS the class key
// (canonical orientation, key <= rc) are already in class order as a
// subsequence — only the non-canonical rows (class = rc(key), a bijection
// that scrambles order) need sorting. Sort that half, then one linear 2-way
// merge; each class appears at most once per side (table keys are unique and
// rc is injective), so the merge is a plain sorted-set union.
extern "C" int64_t tqm_canonical_classes(const uint32_t* hi, const uint32_t* lo,
                                         int64_t n, int32_t k,
                                         uint32_t* out_cls_hi, uint32_t* out_cls_lo,
                                         int32_t* out_fwd, int32_t* out_rc) {
  if (n <= 0 || k < 1 || k > 32) return -1;
  std::vector<ClsRow> nc;    // non-canonical rows: (class = rc(key), row)
  std::vector<int64_t> can;  // canonical rows, ascending (key order)
  std::vector<uint8_t> pal(n, 0), is_can(n);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) {
    const uint64_t key = ((uint64_t)hi[i] << 32) | lo[i];
    const uint64_t rc = rc_key64(key, k);
    is_can[i] = key <= rc;  // palindromes count as canonical
    pal[i] = key == rc;
  }
  int64_t n_nc = 0;
  for (int64_t i = 0; i < n; i++) n_nc += !is_can[i];
  nc.reserve(n_nc);
  can.reserve(n - n_nc);
  // recomputing rc here beats staging (cls,row) for all n rows: it is a few
  // ALU ops vs a GB-scale temporary on this host's slow fresh-page path
  for (int64_t i = 0; i < n; i++) {
    if (is_can[i]) {
      can.push_back(i);
    } else {
      const uint64_t key = ((uint64_t)hi[i] << 32) | lo[i];
      nc.push_back(ClsRow{rc_key64(key, k), (int32_t)i});
    }
  }
  TQM_SORT(nc.begin(), nc.end(), [](const ClsRow& a, const ClsRow& b) {
    return a.cls < b.cls;  // rc is injective: cls values are unique here
  });
  // merge the two sorted class streams
  const int64_t nca = (int64_t)can.size(), nnc = (int64_t)nc.size();
  int64_t a = 0, b = 0, ng = 0;
  while (a < nca || b < nnc) {
    const uint64_t ka =
        a < nca ? (((uint64_t)hi[can[a]] << 32) | lo[can[a]]) : ~0ull;
    const uint64_t kb = b < nnc ? nc[b].cls : ~0ull;
    const uint64_t cls = ka < kb ? ka : kb;
    out_cls_hi[ng] = (uint32_t)(cls >> 32);
    out_cls_lo[ng] = (uint32_t)cls;
    int32_t fr = -1, rr = -1;
    if (ka == cls) {
      fr = (int32_t)can[a];
      if (pal[can[a]]) rr = fr;  // palindrome: same row serves both strands
      a++;
    }
    if (kb == cls) {
      rr = nc[b].row;
      b++;
    }
    out_fwd[ng] = fr;
    out_rc[ng] = rr;
    ng++;
  }
  return ng;
}
