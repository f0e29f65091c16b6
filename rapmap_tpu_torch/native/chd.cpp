// CHD-style hash-and-displace perfect hash over (hi, lo) uint32 k-mer keys.
//
// Covers the reference's BooPHF/FrugalBooMap role (upstream:include/BooPHF.hpp,
// upstream:include/FrugalBooMap.hpp — SURVEY.md §2.2): the device probes a
// k-mer with exactly TWO gathers (bucket displacement + table row) instead of
// the sorted-table binary search, whose trip count follows the largest
// prefix-LUT bucket.
//
// Scheme (Hash, displace, and compress — Belazzougui/Botelho/Dietzfelbinger,
// simplified, no compression): keys hash into m buckets; buckets are placed
// in decreasing-size order; bucket j stores one displacement d so that every
// key i in it lands in a free slot. Query recomputes g, d = dir[g], slot; a
// key/row compare verifies membership (alien keys just miss the compare).
//
// Partitioned mode (p_bits > 0): bucket j belongs to partition
// j >> (m_bits - p_bits), which owns the slot-space stripe
// [part << (t_bits - p_bits), ...). slot = stripe | (mix32(hb + d) & sub_mask).
// Partitions are fully independent CHD instances (same load factor each), so
// the sequential displacement search — the whole build's hot loop — runs
// them on separate threads, deterministically, with per-partition bitsets
// that stay cache-resident. p_bits = 0 reproduces the legacy formula.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

static inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

extern "C" int tqm_chd_build(const uint32_t* hi, const uint32_t* lo, int64_t n,
                             int32_t m_bits, int32_t t_bits, uint32_t seed,
                             int32_t maxd, int32_t p_bits, int32_t* dir,
                             int32_t* perm) {
  if (n <= 0 || m_bits < 1 || t_bits < 1 || (1ll << t_bits) < n) return -2;
  if (p_bits < 0 || p_bits >= m_bits || p_bits >= t_bits) return -2;
  const uint32_t m_mask = (uint32_t)((1ll << m_bits) - 1);
  const int64_t m = 1ll << m_bits;
  const int64_t T = 1ll << t_bits;
  const uint32_t sub_mask = (uint32_t)((1ll << (t_bits - p_bits)) - 1);
  const int32_t part_shift = m_bits - p_bits;   // bucket -> partition
  const int32_t slot_shift = t_bits - p_bits;   // partition -> stripe base
  const int64_t n_part = 1ll << p_bits;
  const uint32_t sa = seed * 0x9e3779b9u + 1u;
  const uint32_t sb = seed * 0x85ebca6bu + 2u;

  std::vector<int32_t> bcount(m, 0);
  std::vector<uint32_t> hb(n), g(n);
  // hashes in parallel; the bucket count stays a sequential linear pass so
  // bucket item order (and therefore the built perm) is deterministic
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) {
    g[i] = mix32(hi[i] ^ mix32(lo[i] ^ sa)) & m_mask;
    hb[i] = mix32(hi[i] ^ mix32(lo[i] ^ sb));
  }
  for (int64_t i = 0; i < n; i++) bcount[g[i]]++;
  std::vector<int64_t> boff(m + 1, 0);
  for (int64_t j = 0; j < m; j++) boff[j + 1] = boff[j] + bcount[j];
  std::vector<int32_t> items(n);
  {
    std::vector<int64_t> cur(boff.begin(), boff.end() - 1);
    for (int64_t i = 0; i < n; i++) items[cur[g[i]]++] = (int32_t)i;
  }
  // hb gathered into bucket order once, so the displacement search streams
  // it sequentially instead of cache-missing into the key-order array
  std::vector<uint32_t> hbs(n);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) hbs[i] = hb[items[i]];

  std::memset(perm, 0xFF, (size_t)T * sizeof(int32_t));  // all -1

  // one independent displacement search per partition; partitions own
  // disjoint bucket ranges AND disjoint slot stripes, so threads never
  // touch shared state and the result is deterministic
  int failed = 0;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) num_threads((int)n_part)
#endif
  for (int64_t part = 0; part < n_part; part++) {
    if (failed) continue;
    const int64_t j0 = part << part_shift;
    const int64_t j1 = (part + 1) << part_shift;
    const int64_t mp = j1 - j0;
    const uint32_t stripe = (uint32_t)(part << slot_shift);
    // process buckets in decreasing-size order: counting sort by size
    // (sizes are tiny), stable within a size class -> deterministic
    int32_t max_s = 0;
    for (int64_t j = j0; j < j1; j++)
      if (bcount[j] > max_s) max_s = bcount[j];
    std::vector<int64_t> soff(max_s + 2, 0);
    for (int64_t j = j0; j < j1; j++) soff[max_s - bcount[j] + 1]++;
    for (int32_t s = 0; s <= max_s; s++) soff[s + 1] += soff[s];
    std::vector<int32_t> order(mp);
    {
      std::vector<int64_t> cur(soff.begin(), soff.end() - 1);
      for (int64_t j = j0; j < j1; j++)
        order[cur[max_s - bcount[j]]++] = (int32_t)(j - j0);
    }
    // slot occupancy of this partition's stripe as a bitset (cache-resident)
    const int64_t Tp = 1ll << slot_shift;
    std::vector<uint64_t> used((Tp + 63) >> 6, 0);
    std::vector<uint32_t> slots;
    bool part_ok = true;
    for (int64_t oj = 0; oj < mp && part_ok; oj++) {
      const int64_t j = j0 + order[oj];
      const int32_t s = bcount[j];
      if (s == 0) {
        dir[j] = 0;
        continue;
      }
      const int32_t* it = &items[boff[j]];
      const uint32_t* hbj = &hbs[boff[j]];
      bool placed = false;
      for (int32_t d = 0; d < maxd && !placed; d++) {
        slots.clear();
        bool ok = true;
        for (int32_t q = 0; q < s; q++) {
          uint32_t sl = mix32(hbj[q] + (uint32_t)d) & sub_mask;
          if ((used[sl >> 6] >> (sl & 63)) & 1u) {
            ok = false;
            break;
          }
          for (uint32_t prev : slots)
            if (prev == sl) {
              ok = false;
              break;
            }
          if (!ok) break;
          slots.push_back(sl);
        }
        if (ok) {
          for (int32_t q = 0; q < s; q++) {
            used[slots[q] >> 6] |= 1ull << (slots[q] & 63);
            perm[stripe | slots[q]] = it[q];
          }
          dir[j] = d;
          placed = true;
        }
      }
      if (!placed) part_ok = false;  // caller retries with a different seed
    }
    if (!part_ok) {
#if defined(_OPENMP)
#pragma omp atomic write
#endif
      failed = 1;
    }
  }
  return failed ? -1 : 0;
}
