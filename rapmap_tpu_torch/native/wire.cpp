// Host pack of one read block of the wire_in format (ops/wire.py): (B, L)
// int8 read codes -> B rows of ceil(L/4) 2-bit bytes and B rows of
// ceil(L/8) non-ACGT mask bytes, the bytes of ops/wire.py::_pack_codes_np.
// A code in 1..4 (A, C, G, T) packs as c - 1 with mask bit 0; any other
// value (pad 0, N = 5, negatives) packs as 0 with mask bit 1; the bits of a
// row's last byte past L stay 0. Code j of a row is 2-bit field j % 4 of
// byte j / 4 (LSB first) and mask bit j % 8 of byte j / 8.
//
// One pass a row, eight codes a step (two 2-bit bytes and one mask byte),
// driven by two 256-entry tables; the row's last partial group apart. Rows
// may lie row_stride bytes apart (a view of a larger pool needs no copy);
// the outputs are dense. Serial: the caller packs one batch at a time.

#include <cstdint>

namespace {

struct PackLut {
  uint8_t two[256];  // code byte -> its 2-bit value
  uint8_t bad[256];  // code byte -> its mask bit
  constexpr PackLut() : two(), bad() {
    for (int i = 0; i < 256; ++i) {
      const bool acgt = i >= 1 && i <= 4;  // int8 codes 1..4 are bytes 1..4
      two[i] = acgt ? static_cast<uint8_t>(i - 1) : 0;
      bad[i] = acgt ? 0 : 1;
    }
  }
};
constexpr PackLut kPack;

}  // namespace

extern "C" {

// codes: row r at codes + r * row_stride, L bytes each; out2: B * ceil(L/4)
// bytes; outm: B * ceil(L/8) bytes. Every output byte is written. Returns 0,
// or -1 on a negative B or L.
int32_t tqm_pack_codes(const int8_t* codes, int64_t B, int64_t L, int64_t row_stride,
                       uint8_t* out2, uint8_t* outm) {
  if (B < 0 || L < 0) return -1;
  const uint8_t* two = kPack.two;
  const uint8_t* bad = kPack.bad;
  const int64_t nb2 = (L + 3) / 4, nbm = (L + 7) / 8, full = L / 8;
  for (int64_t r = 0; r < B; ++r) {
    const uint8_t* c = reinterpret_cast<const uint8_t*>(codes + r * row_stride);
    uint8_t* o2 = out2 + r * nb2;
    uint8_t* om = outm + r * nbm;
    for (int64_t g = 0; g < full; ++g, c += 8) {
      o2[2 * g] = static_cast<uint8_t>(two[c[0]] | two[c[1]] << 2 | two[c[2]] << 4 |
                                       two[c[3]] << 6);
      o2[2 * g + 1] = static_cast<uint8_t>(two[c[4]] | two[c[5]] << 2 | two[c[6]] << 4 |
                                           two[c[7]] << 6);
      om[g] = static_cast<uint8_t>(bad[c[0]] | bad[c[1]] << 1 | bad[c[2]] << 2 |
                                   bad[c[3]] << 3 | bad[c[4]] << 4 | bad[c[5]] << 5 |
                                   bad[c[6]] << 6 | bad[c[7]] << 7);
    }
    const int64_t rem = L - 8 * full;  // 0..7 codes left, at c
    if (rem > 0) {
      uint8_t lo = 0, hi = 0, m = 0;
      for (int64_t j = 0; j < rem; ++j) {
        if (j < 4) lo |= static_cast<uint8_t>(two[c[j]] << (2 * j));
        else hi |= static_cast<uint8_t>(two[c[j]] << (2 * (j - 4)));
        m |= static_cast<uint8_t>(bad[c[j]] << j);
      }
      o2[2 * full] = lo;
      if (rem > 4) o2[2 * full + 1] = hi;
      om[full] = m;
    }
  }
  return 0;
}

}  // extern "C"
