// Clean-room SA-IS suffix array construction (linear time, induced sorting),
// after Nong, Zhang & Chan (DCC'09). Fills the libdivsufsort role of the
// reference build (SURVEY.md §2.2) for the offline index path.
//
// Templated on index type (int32 below 2^31 chars, int64 above — bigSA) AND
// on text element type: level 0 runs directly over a uint8 staging copy
// (text codes + 1, terminator 0), which matters twice at genome scale
// (2-3 Gbase): the staging array is n bytes instead of 8n, and the induced
//-sort passes touch 1-byte chars instead of 8-byte ones. Bucket counts are
// computed once per level and reused across the five bucket-pointer
// rebuilds (they never change within a level).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename I, typename T>
void sais_core(const T* s, I* sa, I n, I sigma, std::vector<I>& work) {
  // s: text of length n over alphabet [0, sigma); s[n-1] must be the unique
  // smallest terminator within this invocation's framing (we append one).
  if (n == 0) return;
  if (n == 1) { sa[0] = 0; return; }

  std::vector<uint8_t> t(n);  // 1 = S-type, 0 = L-type
  t[n - 1] = 1;
  for (I i = n - 2; i >= 0; --i) {
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;
    if (i == 0) break;
  }
  auto is_lms = [&](I i) { return i > 0 && t[i] && !t[i - 1]; };

  // counts once per level; get_buckets only re-derives the prefix pointers
  std::vector<I> counts(sigma, I(0));
  for (I i = 0; i < n; ++i) counts[s[i]]++;
  std::vector<I> bkt(sigma);
  auto get_buckets = [&](bool end) {
    I sum = 0;
    for (I c = 0; c < sigma; ++c) {
      sum += counts[c];
      bkt[c] = end ? sum : sum - counts[c];
    }
  };

  auto induce = [&](/* LMS already placed */) {
    // induce L from left to right
    get_buckets(false);
    for (I i = 0; i < n; ++i) {
      I j = sa[i];
      if (j > 0 && !t[j - 1]) sa[bkt[s[j - 1]]++] = j - 1;
    }
    // induce S from right to left
    get_buckets(true);
    for (I i = n - 1; i >= 0; --i) {
      I j = sa[i];
      if (j > 0 && t[j - 1]) sa[--bkt[s[j - 1]]] = j - 1;
      if (i == 0) break;
    }
  };

  // stage 1: place LMS suffixes at bucket ends (unsorted), induce
  std::fill(sa, sa + n, I(-1));
  get_buckets(true);
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) sa[--bkt[s[i]]] = i;
  induce();

  // compact sorted LMS substrings into sa[0..n1)
  I n1 = 0;
  for (I i = 0; i < n; ++i)
    if (sa[i] > 0 && is_lms(sa[i])) sa[n1++] = sa[i];
  std::fill(sa + n1, sa + n, I(-1));

  // name LMS substrings
  I name = 0, prev = -1;
  for (I i = 0; i < n1; ++i) {
    I pos = sa[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (I d = 0;; ++d) {
        if (pos + d >= n || prev + d >= n) { diff = true; break; }
        if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) { diff = true; break; }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          diff = !(is_lms(pos + d) && is_lms(prev + d));
          break;
        }
      }
    }
    if (diff) { ++name; prev = pos; }
    sa[n1 + pos / 2] = name - 1;
  }
  // gather names in LMS order into s1 (stored in tail of sa)
  I* s1 = sa + n - n1;
  for (I i = n - 1, j = n - 1; i >= n1; --i) {
    if (sa[i] >= 0) sa[j--] = sa[i];
    if (i == 0) break;
  }

  // stage 2: sort the reduced problem
  if (name < n1) {
    // copy s1 out, recurse into sa[0..n1)
    std::vector<I> s1v(s1, s1 + n1);
    sais_core<I, I>(s1v.data(), sa, n1, name, work);
  } else {
    for (I i = 0; i < n1; ++i) sa[s1[i]] = i;
  }

  // map reduced SA back to LMS positions
  std::vector<I> lms;
  lms.reserve(n1);
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) lms.push_back(i);
  for (I i = 0; i < n1; ++i) sa[i] = lms[sa[i]];

  // stage 3: place sorted LMS at bucket ends, induce final SA
  std::fill(sa + n1, sa + n, I(-1));
  get_buckets(true);
  for (I i = n1 - 1; i >= 0; --i) {
    I j = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j]]] = j;
    if (i == 0) break;
  }
  induce();
}

template <typename I>
int sais_entry(const uint8_t* text, I* sa_out, int64_t n) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  // u8 level-0 fast path: stage text+1 with terminator 0 (alphabet must
  // leave headroom — true for any text whose max code is < 255)
  bool fits_u8 = true;
  for (int64_t i = 0; i < n; ++i)
    if (text[i] >= 255) { fits_u8 = false; break; }
  std::vector<I> sa(static_cast<size_t>(n) + 1);
  std::vector<I> work;
  if (fits_u8) {
    std::vector<uint8_t> s(static_cast<size_t>(n) + 1);
    for (int64_t i = 0; i < n; ++i) s[i] = text[i] + 1;
    s[n] = 0;
    sais_core<I, uint8_t>(s.data(), sa.data(), static_cast<I>(n + 1), I(256), work);
  } else {
    std::vector<I> s(static_cast<size_t>(n) + 1);
    for (int64_t i = 0; i < n; ++i) s[i] = static_cast<I>(text[i]) + 1;
    s[n] = 0;
    sais_core<I, I>(s.data(), sa.data(), static_cast<I>(n + 1), I(258), work);
  }
  // drop the terminator suffix (always rank 0)
  for (int64_t i = 0; i < n; ++i) sa_out[i] = sa[i + 1];
  return 0;
}

// In-place entry: sa_buf must hold n+1 entries; on success the suffix array
// of text occupies sa_buf[0..n) (the terminator suffix is shifted out).
// Saves the separate result copy — at 2-3 Gbase that copy alone is ~20 GB
// of fresh pages.
template <typename I>
int sais_entry_inplace(const uint8_t* text, I* sa_buf, int64_t n) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  bool fits_u8 = true;
  for (int64_t i = 0; i < n; ++i)
    if (text[i] >= 255) { fits_u8 = false; break; }
  if (!fits_u8) return -3;  // caller falls back to the copying entry
  std::vector<I> work;
  std::vector<uint8_t> s(static_cast<size_t>(n) + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = text[i] + 1;
  s[n] = 0;
  sais_core<I, uint8_t>(s.data(), sa_buf, static_cast<I>(n + 1), I(256), work);
  std::memmove(sa_buf, sa_buf + 1, static_cast<size_t>(n) * sizeof(I));
  return 0;
}

}  // namespace

extern "C" {

int tqm_sais_u8_i32(const uint8_t* text, int32_t* sa, int64_t n) {
  if (n >= (int64_t(1) << 31) - 2) return -2;  // needs bigSA
  return sais_entry<int32_t>(text, sa, n);
}

int tqm_sais_u8_i64(const uint8_t* text, int64_t* sa, int64_t n) {
  return sais_entry<int64_t>(text, sa, n);
}

int tqm_sais2_u8_i32(const uint8_t* text, int32_t* sa_buf, int64_t n) {
  if (n >= (int64_t(1) << 31) - 2) return -2;  // needs bigSA
  return sais_entry_inplace<int32_t>(text, sa_buf, n);
}

int tqm_sais2_u8_i64(const uint8_t* text, int64_t* sa_buf, int64_t n) {
  return sais_entry_inplace<int64_t>(text, sa_buf, n);
}

}  // extern "C"
