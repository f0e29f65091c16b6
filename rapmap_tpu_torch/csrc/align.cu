// The mapping score of every record row: the read's orientation, its
// transcript window and the banded affine-gap DP, fused into one launch with
// one thread per record row.
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
// takes 555. Here a thread takes one record: it orients its read, reads its
// window char by char straight from the packed text, and runs the DP in
// registers, rows frozen past the read's length (the loop simply stops), so
// dead rows and short reads cost nothing.
//
// What bounds it on the card. Per live record it reads its row's fields,
// the read row (L bytes), ~(L + 2b)/16 + 1 text words and one txp_align
// row, and writes 4 bytes: ~140 bytes for 76 bp. It does ~L x (2b+1) cells
// of ~10 integer operations each, ~11,000 for 76 bp at b = 7, so the
// operations bound it (compute-bound by ~4x at the non-tensor rate). The
// design is the simple one: each thread walks its own record's cells in
// sequence, the closed-form row kept in registers for b <= 15 (one template
// instantiation per band, so every array index is static), and in global
// scratch for wider bands (any --bandwidth >= 1 is taken, never the plain
// version). A warp per record (lanes over d, __shfl_up_sync for the prefix
// max) is the Hopper design for a later change.
//
// Arithmetic follows the reference exactly: int32 throughout, NEG = -2^20 as
// the -inf stand-in (never INT_MIN, so nothing wraps), the closed-form row
// H = max(Hnf, F) with F = exclusive prefix-max(Hnf + d*ge) - d*ge - (go-ge)
// and E from the left-shifted previous row; the best of H over the band,
// clamped to [0, 4095]. Window char j lives in word tw + ((tsub + start + j)
// >> 4) (arithmetic shift: start may be negative) at shift
// 30 - 2 * ((tsub + start + j) & 15), so no sub-word funnel shift (and no
// 32-bit shift by 32) is formed; each word index is clipped on its own, as
// the reference's per-word gathers are, and chars outside [0, txp_len) are
// 5 and never match.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 20);
constexpr int kScoreMax = (1 << 12) - 1;  // SCORE_BITS = 12
constexpr int kRegBandMax = 15;           // ops/align.py REG_BAND_MAX
constexpr int kThreads = 128;

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
  const int* txp_align;  // (n_txps, 3) [offset >> 4, offset & 15, txp_len]
  int64_t n_txps;
  int64_t N;
  int band, ma, mp, go, ge;
  int* scratch;  // (3, 2b+1, N): H, E, window ring; wide bands only
  int* out;
};

// One record's read and window, as the DP consumes them: read code at
// column i (0..3, 4 never matches) and window char j (0..3, 5 never
// matches), j increasing by one a row, so one cached word serves 16 chars.
struct Record {
  const int8_t* row;
  int len;     // rows of the DP: min(read length, L)
  int rlen;    // the read's length, for the reverse complement
  int L;
  bool rc;
  int start;   // window char 0's transcript position (pos - band)
  int goff;    // window char 0 as a char offset from word tw
  int tw, tlen;
  const int* text;
  int64_t nw, text_stride;
  int64_t cur;  // index of the cached word
  uint32_t word;

  __device__ __forceinline__ int read_code(int i) const {
    int c;
    if (!rc) {
      c = row[i];
    } else {
      // revcomp_batch: rc position i is the complement of column len-1-i
      // (clamped to the row), NCODE where that falls before column 0
      int src = rlen - 1 - i;
      if (src < 0) return 4;
      int v = row[src < L - 1 ? src : L - 1];
      c = (v >= 1 && v <= 4) ? 5 - v : 5;
    }
    return (c >= 1 && c <= 4) ? c - 1 : 4;
  }

  __device__ __forceinline__ int window_char(int j) {
    int p = start + j;
    if (p < 0 || p >= tlen) return 5;
    int g = goff + j;
    int64_t wi = static_cast<int64_t>(tw + (g >> 4));
    wi = wi < 0 ? 0 : (wi >= nw ? nw - 1 : wi);
    if (wi != cur) {
      cur = wi;
      word = static_cast<uint32_t>(__ldg(text + wi * text_stride));
    }
    return static_cast<int>((word >> (30 - 2 * (g & 15))) & 3u);
  }
};

__device__ __forceinline__ bool load_record(const Args& a, int64_t r, Record& rec) {
  if (!a.valid[r * a.valid_stride]) return false;
  int64_t rid = a.rid[r];
  rid = rid < 0 ? 0 : (rid >= a.B ? a.B - 1 : rid);
  int64_t t = a.t[r];
  t = t < 0 ? 0 : (t >= a.n_txps ? a.n_txps - 1 : t);
  int64_t rlen = a.lens[rid];
  rec.row = a.reads + rid * a.L;
  rec.L = a.L;
  rec.rlen = static_cast<int>(rlen);
  rec.len = rlen < 0 ? 0 : (rlen > a.L ? a.L : static_cast<int>(rlen));
  rec.rc = a.strand[r] != 0;
  const int* ta = a.txp_align + t * 3;
  rec.tw = __ldg(ta);
  rec.tlen = __ldg(ta + 2);
  rec.start = static_cast<int>(a.pos[r]) - a.band;
  rec.goff = __ldg(ta + 1) + rec.start;
  rec.text = a.text2q;
  rec.nw = a.nw;
  rec.text_stride = a.text_stride;
  rec.cur = -1;
  rec.word = 0;
  return true;
}

__device__ __forceinline__ int finish(int best) {
  return best < 0 ? 0 : (best > kScoreMax ? kScoreMax : best);
}

// Band half-width b = (WB - 1) / 2 <= kRegBandMax: the row, its E state and
// the window's WB chars in registers (every index static after unrolling).
template <int WB>
__global__ void __launch_bounds__(kThreads) banded_reg_kernel(Args a) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.N) return;
  Record rec;
  if (!load_record(a, r, rec)) {
    a.out[r] = 0;
    return;
  }
  int H[WB], E[WB], wc[WB];
#pragma unroll
  for (int d = 0; d < WB; ++d) {
    H[d] = 0;  // free leading window gap
    E[d] = kNeg;
    wc[d] = 5;
  }
#pragma unroll
  for (int d = 0; d + 1 < WB; ++d) wc[d + 1] = rec.window_char(d);
  const int go = a.go, ge = a.ge, ma = a.ma, mp = a.mp;
  for (int i = 0; i < rec.len; ++i) {
    // row i consumes window chars [i, i + 2b]
#pragma unroll
    for (int d = 0; d + 1 < WB; ++d) wc[d] = wc[d + 1];
    wc[WB - 1] = rec.window_char(i + WB - 1);
    const int rcode = rec.read_code(i);
    int p = kNeg;  // exclusive prefix max of Hnf + d*ge
#pragma unroll
    for (int d = 0; d < WB; ++d) {
      const int hs = d + 1 < WB ? H[d + 1] : kNeg;  // shift_left(H), E: old row
      const int es = d + 1 < WB ? E[d + 1] : kNeg;
      const int e2 = max(hs - go, es - ge);
      const int sub = (wc[d] == rcode && rcode <= 3) ? ma : mp;
      const int hnf = max(H[d] + sub, e2);
      const int f = p - d * ge - (go - ge);
      p = max(p, hnf + d * ge);
      E[d] = e2;
      H[d] = max(hnf, f);
    }
  }
  int best = H[0];
#pragma unroll
  for (int d = 1; d < WB; ++d) best = max(best, H[d]);
  a.out[r] = finish(best);
}

// Any band: the same DP with H, E and a ring of the window's 2b+1 chars in
// global scratch, laid out [state][d][record] so that neighbouring threads
// touch neighbouring words.
__global__ void __launch_bounds__(kThreads) banded_scratch_kernel(Args a) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.N) return;
  Record rec;
  if (!load_record(a, r, rec)) {
    a.out[r] = 0;
    return;
  }
  const int wb = 2 * a.band + 1;
  const int64_t N = a.N;
  int* H = a.scratch + r;
  int* E = a.scratch + static_cast<int64_t>(wb) * N + r;
  int* wc = a.scratch + 2 * static_cast<int64_t>(wb) * N + r;  // slot j % wb holds char j
  for (int d = 0; d < wb; ++d) {
    H[d * N] = 0;
    E[d * N] = kNeg;
  }
  for (int j = 0; j + 1 < wb; ++j) wc[j * N] = rec.window_char(j);
  const int go = a.go, ge = a.ge, ma = a.ma, mp = a.mp;
  int base = 0;  // i % wb: the slot of window char i
  for (int i = 0; i < rec.len; ++i) {
    const int last = base == 0 ? wb - 1 : base - 1;  // (i + wb - 1) % wb
    wc[last * N] = rec.window_char(i + wb - 1);
    const int rcode = rec.read_code(i);
    int p = kNeg;
    int slot = base;
    for (int d = 0; d < wb; ++d) {
      // cells d and d + 1 still hold the previous row: d is written last
      const int hs = d + 1 < wb ? H[(d + 1) * N] : kNeg;
      const int es = d + 1 < wb ? E[(d + 1) * N] : kNeg;
      const int e2 = max(hs - go, es - ge);
      const int w = wc[slot * N];
      slot = slot + 1 == wb ? 0 : slot + 1;
      const int sub = (w == rcode && rcode <= 3) ? ma : mp;
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

template <int WB>
cudaError_t launch_reg(const Args& a, unsigned grid, cudaStream_t s) {
  banded_reg_kernel<WB><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Scores of N record rows: out[r] = the clamped banded score of record r's
// oriented read rid[r] (rows of `reads`, lengths `lens`) against transcript
// t[r]'s window from pos[r] - band, 0 where valid[r] is false; what
// ops/align.py score_records_plain computes. Record columns are int32 or
// int64 (`*64`) with element strides; text2q's word i is at
// text2q[i * text_stride]. Bands above 15 need `scratch`, (3, 2b+1, N) int32.
// Writes every element of out; launches on `stream`, no sync.
extern "C" int tqm_banded_scores(
    const void* reads, int64_t B, int L, const void* lens, int64_t lens_stride, int lens64,
    const void* rid, int64_t rid_stride, int rid64, const void* t, int64_t t_stride, int t64,
    const void* pos, int64_t pos_stride, int pos64, const void* strand,
    int64_t strand_stride, int strand64, const void* valid, int64_t valid_stride,
    const void* text2q, int64_t nw, int64_t text_stride, const void* txp_align,
    int64_t n_txps, int64_t N, int band, int ma, int mp, int go, int ge, void* scratch,
    void* out, void* stream) {
  if (band < 1 || go < ge || B < 1 || L < 1 || nw < 1 || n_txps < 1 || N < 0 ||
      (band > kRegBandMax && scratch == nullptr))
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
  const unsigned grid = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (band) {
#define TQM_BAND(b) \
  case b:           \
    return static_cast<int>(launch_reg<2 * (b) + 1>(a, grid, s));
    TQM_BAND(1) TQM_BAND(2) TQM_BAND(3) TQM_BAND(4) TQM_BAND(5)
    TQM_BAND(6) TQM_BAND(7) TQM_BAND(8) TQM_BAND(9) TQM_BAND(10)
    TQM_BAND(11) TQM_BAND(12) TQM_BAND(13) TQM_BAND(14) TQM_BAND(15)
#undef TQM_BAND
    default:
      banded_scratch_kernel<<<grid, kThreads, 0, s>>>(a);
      return static_cast<int>(cudaGetLastError());
  }
}
