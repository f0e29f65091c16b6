"""Vectorized k-mer -> SA-interval lookup through the canonical-class CHD.

Port of rapmap_tpu.ops.lookup's perfect-hash probe: a displacement-directory
gather plus one class-row gather per window answers BOTH strands. Hash
arithmetic is uint32 in int64 (ops.bits) and must match native/chd.cpp and
index/chd.py bit for bit, or every probe misses.
"""

from __future__ import annotations

import torch

from rapmap_tpu_torch.ops.bits import M32, mul32, u32
from rapmap_tpu_torch.ops.device_index import DeviceQuasiIndex, EngineStatic
from rapmap_tpu_torch.ops.gather import flat_gather, row_gather_nd


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def chd_slot(st: EngineStatic, g: torch.Tensor, hb: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Displacement -> table slot; must match native/chd.cpp exactly.

    Partitioned tables (st.chd_p_bits > 0) prefix the slot with the bucket's
    partition stripe. p_bits == 0 is the single-stripe formula."""
    s = _mix32((hb + d) & M32)
    pb = st.chd_p_bits
    if pb:
        stb = st.chd_t_bits - pb
        stripe = (g >> (st.chd_m_bits - pb)) << stb
        return stripe | (s & ((1 << stb) - 1))
    return s & ((1 << st.chd_t_bits) - 1)


def _chd_probe_canonical(
    didx: DeviceQuasiIndex, st: EngineStatic, can_hi: torch.Tensor, can_lo: torch.Tensor
) -> torch.Tensor:
    """Canonical-key probe -> the 6-column class row (unverified)."""
    sa_ = (st.chd_seed * 0x9E3779B9 + 1) & M32
    sb_ = (st.chd_seed * 0x85EBCA6B + 2) & M32
    g = _mix32(can_hi ^ _mix32(can_lo ^ sa_)) & ((1 << st.chd_m_bits) - 1)
    hb = _mix32(can_hi ^ _mix32(can_lo ^ sb_))
    d = u32(flat_gather(didx.chd_dir, g))
    return row_gather_nd(didx.chd_rows, chd_slot(st, g, hb, d))


def kmer_lookup_2str(
    didx: DeviceQuasiIndex, st: EngineStatic, key_hi: torch.Tensor, key_lo: torch.Tensor
):
    """One canonical probe -> BOTH strands of each window.

    key arrays are the FORWARD window keys; returns
    (found_f, b_f, e_f, found_r, b_r, e_r) where the *_r triple describes the
    reverse-complement k-mer of the same window. Requires st.chd_canonical."""
    from rapmap_tpu_torch.ops.encode import rc_keys_batch

    rhi, rlo = rc_keys_batch(key_hi, key_lo, st.k)
    is_can = (key_hi < rhi) | ((key_hi == rhi) & (key_lo <= rlo))
    can_hi = torch.where(is_can, key_hi, rhi)
    can_lo = torch.where(is_can, key_lo, rlo)
    row = _chd_probe_canonical(didx, st, can_hi, can_lo).to(torch.int64)
    hit = ((row[..., 0] & M32) == can_hi) & ((row[..., 1] & M32) == can_lo)
    # row cols 2,3 = canonical orientation's interval; 4,5 = its rc
    b_can, e_can = row[..., 2], row[..., 3]
    b_alt, e_alt = row[..., 4], row[..., 5]
    b_f = torch.where(is_can, b_can, b_alt)
    e_f = torch.where(is_can, e_can, e_alt)
    b_r = torch.where(is_can, b_alt, b_can)
    e_r = torch.where(is_can, e_alt, e_can)
    found_f = hit & (e_f - b_f > 0)
    found_r = hit & (e_r - b_r > 0)
    return (
        found_f, torch.where(found_f, b_f, 0), torch.where(found_f, e_f, 0),
        found_r, torch.where(found_r, b_r, 0), torch.where(found_r, e_r, 0),
    )
