"""Single-buffer wire format for host<->device transfers (single-end).

Port of rapmap_tpu.ops.wire: the host halves are copies, the device halves
are PyTorch. The format is unchanged — it is the port's parity surface:

wire_in  (uint8): per read block, 2-bit packed bases [ceil(L/4) B] +
                  non-ACGT mask bits [ceil(L/8) B]; then lens uint16 LE [2B]
                  | n_valid int32 [4B].
wire_out (int32): [0] total records | [1] overflowed | [2:8] counters
                  (reads_total, reads_mapped, too_ambiguous, over_budget,
                  records, out_truncated) | [8:8+B] per-read record counts
                  | [8+B:8+2B] per-read outcome flag bits (FLAG_*)
                  | [8+2B:] records row-major, 4 fields each (pack_out).
                  The CHUNKED path holds one block per chunk of
                  [counts | flags | records] after the header: counts ride
                  uint16 pairs, flags 8-per-word nibbles (when the chunk
                  allows), and records pack into 2 words whenever the
                  index's static stats bound the fields (rec_spec_se).

The per-read flags let the host apply a targeted oracle remap to exactly the
reads whose device results were degraded by a static budget.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rapmap_tpu_torch.ops.bits import as_i32

HDR = 8

FLAG_OVER_BUDGET = 1
FLAG_OUT_TRUNCATED = 2
FLAG_TOO_AMBIGUOUS = 4
FLAG_MAPPED = 8
FLAG_DEGRADED = FLAG_OVER_BUDGET | FLAG_OUT_TRUNCATED  # host fallback trigger


def encode_read_flags(over_budget, out_truncated, too_ambiguous, mapped) -> torch.Tensor:
    """(B,) bool each -> (B,) int32 flag bits (see FLAG_* constants)."""
    return (
        over_budget.to(torch.int32)
        | (out_truncated.to(torch.int32) << 1)
        | (too_ambiguous.to(torch.int32) << 2)
        | (mapped.to(torch.int32) << 3)
    )


def _in_sizes(L: int) -> tuple[int, int]:
    """(2-bit bytes, N-mask bytes) per read row."""
    return (L + 3) // 4, (L + 7) // 8


def _pack_codes_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B, L) int8 codes -> 2-bit packed bytes + non-ACGT mask bytes (host)."""
    B, L = codes.shape
    nb2, nbm = _in_sizes(L)
    valid = (codes >= 1) & (codes <= 4)
    two = np.where(valid, (codes - 1) & 3, 0).astype(np.uint8)
    t4 = np.zeros((B, nb2 * 4), np.uint8)
    t4[:, :L] = two
    t4 = t4.reshape(B, nb2, 4)
    b2 = t4[:, :, 0] | (t4[:, :, 1] << 2) | (t4[:, :, 2] << 4) | (t4[:, :, 3] << 6)
    m8 = np.zeros((B, nbm * 8), np.uint8)
    m8[:, :L] = (~valid).astype(np.uint8)
    m8 = m8.reshape(B, nbm, 8)
    bm = np.zeros((B, nbm), np.uint8)
    for j in range(8):
        bm |= m8[:, :, j] << j
    return b2, bm


def _unpack_codes_dev(b2: torch.Tensor, bm: torch.Tensor, L: int) -> torch.Tensor:
    """Device inverse of _pack_codes_np -> (B, L) int8 codes (non-ACGT -> 5)."""
    B, nb2 = b2.shape
    b2 = b2.to(torch.int32)
    bm = bm.to(torch.int32)
    nibs = torch.stack([(b2 >> (2 * j)) & 3 for j in range(4)], dim=-1)
    nibs = nibs.reshape(B, nb2 * 4)[:, :L]
    bits = torch.stack([(bm >> j) & 1 for j in range(8)], dim=-1)
    bits = bits.reshape(B, bm.shape[1] * 8)[:, :L]
    return torch.where(bits != 0, 5, nibs + 1).to(torch.int8)


def pack_in_se(codes: np.ndarray, lens: np.ndarray, n_valid: int) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.int8)
    b2, bm = _pack_codes_np(codes)
    return np.concatenate([
        b2.reshape(-1), bm.reshape(-1),
        np.ascontiguousarray(lens, dtype=np.uint16).view(np.uint8),
        np.array([n_valid], dtype=np.int32).view(np.uint8),
    ])


def unpack_in_se(wire: torch.Tensor, B: int, L: int):
    """Device: uint8 wire_in -> (codes (B, L) int8, lens (B,) int64,
    n_valid scalar int64 tensor)."""
    nb2, nbm = _in_sizes(L)
    o = 0
    b2 = wire[o : o + B * nb2].reshape(B, nb2); o += B * nb2
    bm = wire[o : o + B * nbm].reshape(B, nbm); o += B * nbm
    codes = _unpack_codes_dev(b2, bm, L)
    lb = wire[o : o + 2 * B].reshape(B, 2).to(torch.int64); o += 2 * B
    lens = lb[:, 0] | (lb[:, 1] << 8)
    nb = wire[o : o + 4].to(torch.int64)
    n_valid = nb[0] | (nb[1] << 8) | (nb[2] << 16) | (nb[3] << 24)
    return codes, lens, n_valid


class RecSpec(NamedTuple):
    """Static bit layout packing one mapping record into 2 int32 words.

    SE rows (t, pos, strand, score) pack MSB-first in field order, positions
    biased by `bias` so they are non-negative (pos >= -(L-1) > -pad_tail).
    None -> unpacked int32."""

    kind: str            # "se"
    bits: tuple          # per-field bit widths, same order as the row fields
    bias: int


def rec_spec_se(st, cfg) -> RecSpec | None:
    if st is None or getattr(st, "n_txps", 0) <= 0:
        return None
    if cfg.mapping_score:
        raise NotImplementedError("mapping_score (--mappingScore) is not ported yet")
    tb = (st.n_txps + 1).bit_length()
    bias = st.pad_tail
    pb = (st.max_tpos + bias + 1).bit_length()
    scb = (2 * cfg.max_hits_per_strand + 1).bit_length()
    if tb + pb + 1 + scb > 64:
        return None
    return RecSpec("se", (tb, pb, 1, scb), bias)


def pack_rec_fields(spec: RecSpec, fields: list[torch.Tensor]):
    """Device: SE field list -> (hi, lo) int32 words per the spec; the
    position field gets the bias added."""
    from rapmap_tpu_torch.ops.collate import _pack2

    fs = list(fields)
    fs[1] = fs[1] + spec.bias
    hi, lo = _pack2(list(zip(fs, spec.bits)))
    return as_i32(hi), as_i32(lo)


def unpack_rec_rows(spec: RecSpec, rows: np.ndarray) -> np.ndarray:
    """Host: (n, 2) int32 packed rows -> (n, len(spec.bits)) int32 fields."""
    v = (rows[:, 0].astype(np.int64) & 0xFFFFFFFF) << 32 | (
        rows[:, 1].astype(np.int64) & 0xFFFFFFFF
    )
    out = np.empty((len(rows), len(spec.bits)), np.int32)
    off = sum(spec.bits)
    for i, nb in enumerate(spec.bits):
        off -= nb
        out[:, i] = ((v >> off) & ((1 << nb) - 1)).astype(np.int32)
    out[:, 1] -= spec.bias
    return out


def pack_counts_flags(counts: torch.Tensor, fbits: torch.Tensor):
    """Device: (C,) counts -> (C/2,) uint16-pair words; (C,) 4-bit flag
    nibbles -> (C/8,) words (int32 bit patterns). Requires C % 8 == 0 and
    counts < 2^16 (counts are clamped to the record cap)."""
    C = counts.shape[0]
    c2 = counts.to(torch.int64).reshape(C // 2, 2)
    cw = c2[:, 0] | (c2[:, 1] << 16)
    f8 = fbits.to(torch.int64).reshape(C // 8, 8)
    fw = f8[:, 0]
    for j in range(1, 8):
        fw = fw | (f8[:, j] << (4 * j))
    return as_i32(cw), as_i32(fw)


def unpack_counts_flags(cw: np.ndarray, fw: np.ndarray, C: int):
    counts = np.empty(C, np.int32)
    counts[0::2] = cw & 0xFFFF
    counts[1::2] = (cw >> 16) & 0xFFFF
    flags = np.empty(C, np.int32)
    for j in range(8):
        flags[j::8] = (fw >> (4 * j)) & 0xF
    return counts, flags


def pack_out(recsd, ctr, flags: torch.Tensor) -> torch.Tensor:
    """SERecords + Counters + per-read flags -> one int32 vector."""
    hdr = torch.stack([
        recsd.total, recsd.overflowed.to(torch.int64),
        ctr.reads_total, ctr.reads_mapped, ctr.too_ambiguous,
        ctr.over_budget, ctr.records, ctr.out_truncated,
    ]).to(torch.int32)
    return torch.cat([
        hdr, recsd.counts.to(torch.int32), flags.to(torch.int32),
        recsd.recs.reshape(-1),
    ])


class WireResult(NamedTuple):
    recs: np.ndarray     # (n_records, F)
    counts: np.ndarray   # (B,)
    flags: np.ndarray    # (B,) int32 FLAG_* bits
    total: int
    overflowed: bool
    counters: dict


def unpack_out(
    wire: np.ndarray, B: int, fields: int, chunk: int = 0, capc: int = 0,
    rec_spec: RecSpec | None = None, packed_cf: bool = False,
) -> WireResult:
    """chunk/capc > 0: after the header the buffer holds one block per chunk
    of [counts | flags | (capc, W) records]; re-densify by concatenating each
    chunk's written prefix (per-read counts are already clamped per chunk).
    With packed_cf, counts ride uint16 pairs and flags 8-per-word nibbles;
    with rec_spec, records are 2-word packed (unpack_rec_rows)."""
    hdr = wire[:HDR]
    total = int(hdr[0])
    rw = 2 if rec_spec is not None else fields
    if chunk:
        C = chunk
        nch = B // C
        ncw = C // 2 if packed_cf else C
        nfw = C // 8 if packed_cf else C
        blk = ncw + nfw + capc * rw
        blocks = wire[HDR:].reshape(nch, blk)
        counts = np.empty(B, np.int32)
        flags = np.empty(B, np.int32)
        recs_parts = []
        for c in range(nch):
            b = blocks[c]
            if packed_cf:
                cc, ff = unpack_counts_flags(b[:ncw], b[ncw : ncw + nfw], C)
            else:
                cc, ff = b[:C], b[C : 2 * C]
            counts[c * C : (c + 1) * C] = cc
            flags[c * C : (c + 1) * C] = ff
            rows = b[ncw + nfw :].reshape(capc, rw)[: int(cc.sum())]
            recs_parts.append(rows)
        rows = np.concatenate(recs_parts, axis=0)
        recs = unpack_rec_rows(rec_spec, rows) if rec_spec is not None else rows
    else:
        counts = wire[HDR : HDR + B]
        flags = wire[HDR + B : HDR + 2 * B]
        recs = wire[HDR + 2 * B :].reshape(-1, fields)
        recs = recs[: min(total, recs.shape[0])]
    return WireResult(
        recs=recs,
        counts=counts,
        flags=flags,
        total=total,
        overflowed=bool(hdr[1]),
        counters=dict(
            reads_total=int(hdr[2]), reads_mapped=int(hdr[3]),
            too_ambiguous=int(hdr[4]), over_budget=int(hdr[5]), records=int(hdr[6]),
            out_truncated=int(hdr[7]),
        ),
    )
