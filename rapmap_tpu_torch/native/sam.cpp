// Native SAM text formatter (RapMapUtils::writeAlignmentsToStream role,
// upstream:include/RapMapUtils.hpp / SURVEY.md §2.1 #16).
//
// Byte-exact replica of io/sam.py write_se_records_dense /
// write_pe_records_dense (the Python writers remain the executable spec and
// the parity oracle, tests/test_native_sam.py). The hot production path
// renders a whole batch of device-compacted records into one caller-provided
// buffer with zero Python-per-record work — at the 1M+ reads/s target the
// Python f-string loop alone would throttle the pipeline (~3-5 us/record).
//
// All strings arrive as flat concatenated byte buffers + (n+1) int64 offset
// tables, matching the layout the native FASTQ parser (fastx.cpp) already
// produces. Returns bytes written, or -1 if out_cap would overflow (caller
// grows the buffer and retries).

#include <cstdint>
#include <cstring>

namespace {

constexpr int32_t FLAG_PAIRED = 0x1;
constexpr int32_t FLAG_PROPER = 0x2;
constexpr int32_t FLAG_UNMAPPED = 0x4;
constexpr int32_t FLAG_MATE_UNMAPPED = 0x8;
constexpr int32_t FLAG_REVERSE = 0x10;
constexpr int32_t FLAG_MATE_REVERSE = 0x20;
constexpr int32_t FLAG_FIRST = 0x40;
constexpr int32_t FLAG_SECOND = 0x80;
constexpr int32_t FLAG_SECONDARY = 0x100;

struct Out {
  uint8_t* p;
  uint8_t* end;
  bool overflow = false;

  inline void put(const uint8_t* s, int64_t n) {
    if (p + n > end) { overflow = true; return; }
    std::memcpy(p, s, n);
    p += n;
  }
  inline void putc(char c) {
    if (p >= end) { overflow = true; return; }
    *p++ = (uint8_t)c;
  }
  inline void puts(const char* s) { put((const uint8_t*)s, (int64_t)std::strlen(s)); }
  inline void puti(int64_t v) {
    char buf[24];
    int n = 0;
    bool neg = v < 0;
    uint64_t u = neg ? (uint64_t)(-(v + 1)) + 1 : (uint64_t)v;
    do { buf[n++] = (char)('0' + u % 10); u /= 10; } while (u);
    if (neg) putc('-');
    while (n) putc(buf[--n]);
  }
  // sequence reverse-complemented (ACGTacgtNn table; others pass through)
  inline void put_rc(const uint8_t* s, int64_t n) {
    static uint8_t comp[256] = {0};
    if (!comp['A']) {
      for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
      comp['A'] = 'T'; comp['C'] = 'G'; comp['G'] = 'C'; comp['T'] = 'A';
      comp['a'] = 't'; comp['c'] = 'g'; comp['g'] = 'c'; comp['t'] = 'a';
    }
    if (p + n > end) { overflow = true; return; }
    for (int64_t i = n - 1; i >= 0; i--) *p++ = comp[s[i]];
  }
  inline void put_rev(const uint8_t* s, int64_t n) {  // reversed (quals)
    if (p + n > end) { overflow = true; return; }
    for (int64_t i = n - 1; i >= 0; i--) *p++ = s[i];
  }
};

struct Str {
  const uint8_t* s;
  int64_t n;
};

inline Str at(const uint8_t* buf, const int64_t* off, int64_t i) {
  return {buf + off[i], off[i + 1] - off[i]};
}

inline int64_t pos1(int32_t p) { return (p < 0 ? 0 : (int64_t)p) + 1; }

}  // namespace

extern "C" {

// Single-end records: recs rows are (t, pos, strand, score), row-major by
// read; counts[i] rows belong to read i. Mirrors write_se_records_dense.
// with_score != 0 appends "\tAS:i:<score>" to mapped records (--mappingScore,
// SEMANTICS.md §9).
int64_t tqm_sam_se(
    const int32_t* recs, const int32_t* counts, int64_t B,
    const uint8_t* names, const int64_t* name_off,
    const uint8_t* seqs, const int64_t* seq_off,
    const uint8_t* quals, const int64_t* qual_off,
    const uint8_t* tnames, const int64_t* tname_off, int64_t n_txps,
    int32_t write_unmapped, int32_t with_score,
    uint8_t* out_buf, int64_t out_cap, int64_t* n_records) {
  Out o{out_buf, out_buf + out_cap};
  int64_t off = 0, nrec = 0;
  for (int64_t i = 0; i < B; i++) {
    const int64_t c = counts[i];
    Str nm = at(names, name_off, i);
    Str sq = at(seqs, seq_off, i);
    Str qu = at(quals, qual_off, i);
    if (c == 0) {
      if (write_unmapped) {
        o.put(nm.s, nm.n);
        o.puts("\t4\t*\t0\t0\t*\t*\t0\t0\t");
        o.put(sq.s, sq.n);
        o.putc('\t');
        o.put(qu.s, qu.n);
        o.putc('\n');
      }
      continue;
    }
    for (int64_t j = 0; j < c; j++) {
      const int32_t* r = recs + (off + j) * 4;
      const int32_t t = r[0], pos = r[1], strand = r[2];
      if (t < 0 || t >= n_txps) return -2;
      int32_t flags = (j == 0 ? 0 : FLAG_SECONDARY);
      if (strand == 1) flags |= FLAG_REVERSE;
      o.put(nm.s, nm.n);
      o.putc('\t');
      o.puti(flags);
      o.putc('\t');
      Str tn = at(tnames, tname_off, t);
      o.put(tn.s, tn.n);
      o.putc('\t');
      o.puti(pos1(pos));
      o.putc('\t');
      o.puti(j == 0 ? 1 : 0);
      o.putc('\t');
      o.puti(sq.n);
      o.puts("M\t*\t0\t0\t");
      if (strand == 1) {
        o.put_rc(sq.s, sq.n);
        o.putc('\t');
        o.put_rev(qu.s, qu.n);
      } else {
        o.put(sq.s, sq.n);
        o.putc('\t');
        o.put(qu.s, qu.n);
      }
      if (with_score) {
        o.puts("\tAS:i:");
        o.puti(r[3]);
      }
      o.putc('\n');
      nrec++;
    }
    off += c;
    if (o.overflow) return -1;
  }
  if (o.overflow) return -1;
  *n_records = nrec;
  return o.p - out_buf;
}

// Paired-end records: recs rows are (t, p1, s1, has1, p2, s2, has2) —
// with_score != 0 widens rows to 9 with per-mate scores at r[7]/r[8],
// appended as AS:i on each mapped mate's record (never on the unmapped
// placeholder). Mirrors write_pe_records_dense including TLEN and orphans.
int64_t tqm_sam_pe(
    const int32_t* recs, const int32_t* counts, int64_t B,
    const uint8_t* names, const int64_t* name_off,
    const uint8_t* seqs1, const int64_t* seq1_off,
    const uint8_t* quals1, const int64_t* qual1_off,
    const uint8_t* seqs2, const int64_t* seq2_off,
    const uint8_t* quals2, const int64_t* qual2_off,
    const uint8_t* tnames, const int64_t* tname_off, int64_t n_txps,
    int32_t write_unmapped, int32_t with_score,
    uint8_t* out_buf, int64_t out_cap, int64_t* n_records) {
  Out o{out_buf, out_buf + out_cap};
  const int64_t rec_w = with_score ? 9 : 7;
  int64_t off = 0, nrec = 0;
  for (int64_t i = 0; i < B; i++) {
    const int64_t c = counts[i];
    Str nm = at(names, name_off, i);
    Str s1 = at(seqs1, seq1_off, i);
    Str q1 = at(quals1, qual1_off, i);
    Str s2 = at(seqs2, seq2_off, i);
    Str q2 = at(quals2, qual2_off, i);
    if (c == 0) {
      if (write_unmapped) {
        const int32_t f1 = FLAG_PAIRED | FLAG_UNMAPPED | FLAG_MATE_UNMAPPED | FLAG_FIRST;
        const int32_t f2 = FLAG_PAIRED | FLAG_UNMAPPED | FLAG_MATE_UNMAPPED | FLAG_SECOND;
        o.put(nm.s, nm.n); o.putc('\t'); o.puti(f1);
        o.puts("\t*\t0\t0\t*\t*\t0\t0\t");
        o.put(s1.s, s1.n); o.putc('\t'); o.put(q1.s, q1.n); o.putc('\n');
        o.put(nm.s, nm.n); o.putc('\t'); o.puti(f2);
        o.puts("\t*\t0\t0\t*\t*\t0\t0\t");
        o.put(s2.s, s2.n); o.putc('\t'); o.put(q2.s, q2.n); o.putc('\n');
      }
      continue;
    }
    for (int64_t j = 0; j < c; j++) {
      const int32_t* r = recs + (off + j) * rec_w;
      const int32_t t = r[0], p1 = r[1], st1 = r[2], h1 = r[3];
      const int32_t p2 = r[4], st2 = r[5], h2 = r[6];
      if (t < 0 || t >= n_txps) return -2;
      Str tn = at(tnames, tname_off, t);
      const int32_t sec = (j == 0 ? 0 : FLAG_SECONDARY);
      const int32_t mapq = (j == 0 ? 1 : 0);
      if (h1 && h2) {
        const bool r1 = st1 == 1, r2 = st2 == 1;
        const int64_t hi1 = (int64_t)p1 + s1.n, hi2 = (int64_t)p2 + s2.n;
        const int64_t span = (hi1 > hi2 ? hi1 : hi2) - (p1 < p2 ? p1 : p2);
        const int64_t t1 = (p1 <= p2) ? span : -span;
        const int64_t t2 = -t1;
        int32_t f1 = FLAG_PAIRED | FLAG_PROPER | FLAG_FIRST | sec;
        int32_t f2 = FLAG_PAIRED | FLAG_PROPER | FLAG_SECOND | sec;
        if (r1) { f1 |= FLAG_REVERSE; f2 |= FLAG_MATE_REVERSE; }
        if (r2) { f2 |= FLAG_REVERSE; f1 |= FLAG_MATE_REVERSE; }
        o.put(nm.s, nm.n); o.putc('\t'); o.puti(f1); o.putc('\t');
        o.put(tn.s, tn.n); o.putc('\t'); o.puti(pos1(p1)); o.putc('\t');
        o.puti(mapq); o.putc('\t'); o.puti(s1.n); o.puts("M\t=\t");
        o.puti(pos1(p2)); o.putc('\t'); o.puti(t1); o.putc('\t');
        if (r1) { o.put_rc(s1.s, s1.n); o.putc('\t'); o.put_rev(q1.s, q1.n); }
        else { o.put(s1.s, s1.n); o.putc('\t'); o.put(q1.s, q1.n); }
        if (with_score) { o.puts("\tAS:i:"); o.puti(r[7]); }
        o.putc('\n');
        o.put(nm.s, nm.n); o.putc('\t'); o.puti(f2); o.putc('\t');
        o.put(tn.s, tn.n); o.putc('\t'); o.puti(pos1(p2)); o.putc('\t');
        o.puti(mapq); o.putc('\t'); o.puti(s2.n); o.puts("M\t=\t");
        o.puti(pos1(p1)); o.putc('\t'); o.puti(t2); o.putc('\t');
        if (r2) { o.put_rc(s2.s, s2.n); o.putc('\t'); o.put_rev(q2.s, q2.n); }
        else { o.put(s2.s, s2.n); o.putc('\t'); o.put(q2.s, q2.n); }
        if (with_score) { o.puts("\tAS:i:"); o.puti(r[8]); }
        o.putc('\n');
        nrec += 2;
      } else {
        const bool m1 = h1 != 0;  // which mate is mapped
        const int32_t p = m1 ? p1 : p2;
        const bool rev = (m1 ? st1 : st2) == 1;
        const Str& sm = m1 ? s1 : s2;
        const Str& qm = m1 ? q1 : q2;
        const Str& so = m1 ? s2 : s1;
        const Str& qo = m1 ? q2 : q1;
        const int32_t fl_this = m1 ? FLAG_FIRST : FLAG_SECOND;
        const int32_t fl_other = m1 ? FLAG_SECOND : FLAG_FIRST;
        int32_t fm = FLAG_PAIRED | FLAG_MATE_UNMAPPED | fl_this | sec;
        if (rev) fm |= FLAG_REVERSE;
        o.put(nm.s, nm.n); o.putc('\t'); o.puti(fm); o.putc('\t');
        o.put(tn.s, tn.n); o.putc('\t'); o.puti(pos1(p)); o.putc('\t');
        o.puti(mapq); o.putc('\t'); o.puti(sm.n); o.puts("M\t=\t");
        o.puti(pos1(p)); o.puts("\t0\t");
        if (rev) { o.put_rc(sm.s, sm.n); o.putc('\t'); o.put_rev(qm.s, qm.n); }
        else { o.put(sm.s, sm.n); o.putc('\t'); o.put(qm.s, qm.n); }
        if (with_score) { o.puts("\tAS:i:"); o.puti(m1 ? r[7] : r[8]); }
        o.putc('\n');
        nrec++;
        if (j == 0) {
          const int32_t fu =
              FLAG_PAIRED | FLAG_UNMAPPED | fl_other | (rev ? FLAG_MATE_REVERSE : 0);
          o.put(nm.s, nm.n); o.putc('\t'); o.puti(fu); o.putc('\t');
          o.put(tn.s, tn.n); o.putc('\t'); o.puti(pos1(p));
          o.puts("\t0\t*\t=\t"); o.puti(pos1(p)); o.puts("\t0\t");
          o.put(so.s, so.n); o.putc('\t'); o.put(qo.s, qo.n); o.putc('\n');
          nrec++;
        }
      }
    }
    off += c;
    if (o.overflow) return -1;
  }
  if (o.overflow) return -1;
  *n_records = nrec;
  return o.p - out_buf;
}

}  // extern "C"
