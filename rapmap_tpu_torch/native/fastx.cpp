// Fast FASTQ batch parser: raw (already-decompressed) FASTQ bytes -> padded
// int8 code batches + record offsets. Host input pipeline fast path replacing
// the reference's kseq/FastxParser role (SURVEY.md §2.1 #15); gzip inflation
// stays in Python's zlib (C speed) so this stays allocation-free.

#include <cstdint>
#include <cstring>

namespace {

constexpr int8_t kPad = 5;  // NCODE

struct CodeLut {
  int8_t v[256];
  constexpr CodeLut() : v() {
    for (int i = 0; i < 256; ++i) v[i] = kPad;
    v['A'] = v['a'] = 1;
    v['C'] = v['c'] = 2;
    v['G'] = v['g'] = 3;
    v['T'] = v['t'] = 4;
  }
};
constexpr CodeLut kLut;

}  // namespace

extern "C" {

// Parse up to max_reads FASTQ records from buf[0..len). Incomplete trailing
// record is left unconsumed (caller re-feeds with more data appended).
// codes: (max_reads * pad_len) filled with pad; lens clipped to pad_len.
// name/seq/qual offsets+lengths index into buf for zero-copy SAM emission.
// Returns number of records parsed; *consumed = bytes consumed.
int64_t tqm_fastq_parse(const char* buf, int64_t len, int64_t max_reads,
                        int64_t pad_len, int8_t* codes, int32_t* lens,
                        int64_t* name_off, int32_t* name_len, int64_t* seq_off,
                        int32_t* seq_len, int64_t* qual_off, int64_t* consumed) {
  int64_t pos = 0, nrec = 0;
  while (nrec < max_reads) {
    int64_t rec_start = pos;
    // skip blank lines
    while (pos < len && (buf[pos] == '\n' || buf[pos] == '\r')) ++pos;
    if (pos >= len) { rec_start = pos; break; }
    if (buf[pos] != '@') { *consumed = pos; return -1; }  // malformed
    int64_t h = ++pos;
    while (pos < len && buf[pos] != '\n') ++pos;
    if (pos >= len) { pos = rec_start; break; }
    int64_t hend = (pos > h && buf[pos - 1] == '\r') ? pos - 1 : pos;
    // name = up to first space/tab
    int64_t ne = h;
    while (ne < hend && buf[ne] != ' ' && buf[ne] != '\t') ++ne;
    ++pos;
    int64_t s = pos;
    while (pos < len && buf[pos] != '\n') ++pos;
    if (pos >= len) { pos = rec_start; break; }
    int64_t send = (pos > s && buf[pos - 1] == '\r') ? pos - 1 : pos;
    ++pos;
    if (pos >= len) { pos = rec_start; break; }
    if (buf[pos] != '+') { *consumed = pos; return -1; }
    while (pos < len && buf[pos] != '\n') ++pos;
    if (pos >= len) { pos = rec_start; break; }
    ++pos;
    int64_t q = pos;
    int64_t want = send - s;
    // qual line must have same length as seq (allow \r)
    while (pos < len && buf[pos] != '\n') ++pos;
    int64_t qend = (pos > q && buf[pos - 1] == '\r') ? pos - 1 : pos;
    if (pos >= len && qend - q < want) { pos = rec_start; break; }
    if (pos < len) ++pos;

    int64_t L = want < pad_len ? want : pad_len;
    int8_t* row = codes + nrec * pad_len;
    for (int64_t i = 0; i < L; ++i) row[i] = kLut.v[(uint8_t)buf[s + i]];
    for (int64_t i = L; i < pad_len; ++i) row[i] = kPad;
    lens[nrec] = (int32_t)L;
    name_off[nrec] = h;
    name_len[nrec] = (int32_t)(ne - h);
    seq_off[nrec] = s;
    seq_len[nrec] = (int32_t)want;
    qual_off[nrec] = q;
    ++nrec;
  }
  *consumed = pos;
  return nrec;
}

// Encode an ASCII sequence buffer to int8 read codes in place of Python loops.
void tqm_encode_reads(const char* seq, int64_t n, int8_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = kLut.v[(uint8_t)seq[i]];
}

}  // extern "C"
