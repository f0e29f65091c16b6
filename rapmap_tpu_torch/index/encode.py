"""Alphabet encoding shared by index builder, oracle, and device engine.

Codes (SEMANTICS.md §1): text: $=0 A=1 C=2 G=3 T=4; reads: A..T=1..4, N/pad=5.
Replaces the jellyfish mer_dna 2-bit codec role of the reference
(SURVEY.md §2.2 "jellyfish 2") with plain integer ops shared host/device.
"""

from __future__ import annotations

import numpy as np

SENT = 0  # '$' transcript separator
A, C, G, T = 1, 2, 3, 4
NCODE = 5  # read-side N / padding; never equals any text code

# ASCII -> text code lookup (non-ACGT mapped to 255 so the builder can randomize them)
_TEXT_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T), ("a", A), ("c", C), ("g", G), ("t", T)):
    _TEXT_LUT[ord(_ch)] = _code

# ASCII -> read code lookup (non-ACGT -> NCODE)
_READ_LUT = np.full(256, NCODE, dtype=np.uint8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T), ("a", A), ("c", C), ("g", G), ("t", T)):
    _READ_LUT[ord(_ch)] = _code

BASE_CHARS = np.frombuffer(b"$ACGTN", dtype=np.uint8)


def splitmix32(x: np.ndarray) -> np.ndarray:
    """Deterministic 32-bit mix for non-ACGT replacement (SEMANTICS.md §1)."""
    x = x.astype(np.uint32)
    x = (x + np.uint32(0x9E3779B9)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x21F0AAAD)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x735A2D97)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    return x


def encode_transcript(seq_ascii: np.ndarray, global_start: int, seed: int) -> np.ndarray:
    """ASCII bytes -> int8 text codes, replacing non-ACGT with a deterministic
    pseudo-random base keyed by (seed, global text position).

    Mirrors the reference's random-base replacement during concatenation
    (SURVEY.md §3.1) but reproducibly.
    """
    codes = _TEXT_LUT[seq_ascii]
    bad = codes == 255
    if bad.any():
        pos = np.nonzero(bad)[0].astype(np.uint32) + np.uint32(global_start)
        rnd = splitmix32(pos ^ np.uint32(seed))
        codes[bad] = (rnd % 4 + 1).astype(np.uint8)
    return codes.astype(np.int8)


def encode_reads(seq_ascii: np.ndarray) -> np.ndarray:
    """ASCII bytes -> int8 read codes (N and anything odd -> NCODE)."""
    return _READ_LUT[seq_ascii].astype(np.int8)


def decode(codes: np.ndarray) -> str:
    return BASE_CHARS[np.asarray(codes, dtype=np.int64)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement read codes: comp(c)=5-c for 1..4, N stays N."""
    c = np.asarray(codes)
    comp = np.where((c >= 1) & (c <= 4), 5 - c, np.int8(NCODE)).astype(np.int8)
    return comp[::-1]


def kmer_keys(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All k-mer keys of a 1-D code array as (hi, lo, valid) uint32/uint32/bool.

    key = sum (c_i - 1) << 2*(k-1-i), big-endian so numeric order == lex order
    (SEMANTICS.md §1). valid[i] iff window i..i+k has only codes 1..4.
    Output length: len(codes) - k + 1 (empty if shorter than k).
    """
    c = np.asarray(codes, dtype=np.int64)
    n = len(c) - k + 1
    if n <= 0:
        return (np.zeros(0, np.uint32), np.zeros(0, np.uint32), np.zeros(0, bool))
    key = np.zeros(n, dtype=np.uint64)
    valid = np.ones(n, dtype=bool)
    for i in range(k):
        w = c[i : i + n]
        valid &= (w >= 1) & (w <= 4)
        key = (key << np.uint64(2)) | ((w - 1) & 3).astype(np.uint64)
    hi = (key >> np.uint64(32)).astype(np.uint32)
    lo = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo, valid
