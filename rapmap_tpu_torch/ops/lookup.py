"""Vectorized k-mer -> SA-interval lookup (port of rapmap_tpu.ops.lookup).

Three probes over the same sorted k-mer table:

* the canonical-class CHD: a displacement-directory gather plus one
  class-row gather per window answers BOTH strands (`kmer_lookup_2str`);
* a legacy per-strand CHD: the same two gathers, one strand per probe
  (`_chd_lookup`);
* binary search narrowed to a prefix-LUT bucket, for indexes without a CHD:
  one LUT-row gather, then `st.lookup_steps` row gathers of kmer_rows. The
  trip count is static (it covers the largest LUT bucket), so the search is
  eager PyTorch with converged lanes masked and no host sync.

Hash arithmetic is uint32 in int64 (ops.bits) and must match native/chd.cpp
and index/chd.py bit for bit, or every probe misses. Interval bounds are
read as uint32 values too: big-occ pseudo tables carry occurrence ids in
[0, 2^32) as int32 bit patterns, so a sign-extended bound would turn an
interval that straddles 2^31 into a negative width. With the values, every
width is exact and equals the reference's wrapped int32 width wherever that
is below 2^31.

The probes take a quasi upload (DeviceQuasiIndex, EngineStatic) or a pseudo
one (models.pseudo.DevicePseudoIndex, PseudoStatic): they read only the
fields the two share.
"""

from __future__ import annotations

import torch

from rapmap_tpu_torch.ops.bits import M32, mul32, shl32, u32
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


def _prefix_of(hi: torch.Tensor, lo: torch.Tensor, k: int, p: int) -> torch.Tensor:
    """First-p-bases value of the (hi, lo) split key; static shift tree."""
    shift = 2 * k - 2 * p
    if shift == 0:
        return lo
    if shift >= 32:
        return hi >> (shift - 32)
    return shl32(hi, 32 - shift) | (lo >> shift)


def _chd_hash(st: EngineStatic, didx: DeviceQuasiIndex, key_hi, key_lo) -> torch.Tensor:
    """The CHD table slot of each key (both CHD kinds hash alike)."""
    sa_ = (st.chd_seed * 0x9E3779B9 + 1) & M32
    sb_ = (st.chd_seed * 0x85EBCA6B + 2) & M32
    g = _mix32(key_hi ^ _mix32(key_lo ^ sa_)) & ((1 << st.chd_m_bits) - 1)
    hb = _mix32(key_hi ^ _mix32(key_lo ^ sb_))
    d = u32(flat_gather(didx.chd_dir, g))
    return chd_slot(st, g, hb, d)


def _chd_lookup(
    didx: DeviceQuasiIndex, st: EngineStatic, key_hi: torch.Tensor, key_lo: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2-gather perfect-hash probe of a legacy per-strand CHD (4-column rows
    [hi, lo, b, e]). Alien keys land on an arbitrary (or sentinel) slot and
    simply fail the key compare."""
    row = row_gather_nd(didx.chd_rows, _chd_hash(st, didx, key_hi, key_lo))
    # The empty-slot sentinel key (-1, -1) equals the poly-T k-mer when k == 32;
    # requiring a non-empty interval (sentinel rows carry b == e == 0) keeps an
    # absent T^32 probe from false-hitting.
    rb, re_ = u32(row[..., 2]), u32(row[..., 3])
    found = (u32(row[..., 0]) == key_hi) & (u32(row[..., 1]) == key_lo) & (re_ - rb > 0)
    return found, torch.where(found, rb, 0), torch.where(found, re_, 0)


def _chd_probe_canonical(
    didx: DeviceQuasiIndex, st: EngineStatic, can_hi: torch.Tensor, can_lo: torch.Tensor
) -> torch.Tensor:
    """Canonical-key probe -> the 6-column class row (unverified)."""
    return row_gather_nd(didx.chd_rows, _chd_hash(st, didx, can_hi, can_lo))


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
    row = u32(_chd_probe_canonical(didx, st, can_hi, can_lo))
    hit = (row[..., 0] == can_hi) & (row[..., 1] == can_lo)
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


def kmer_lookup(
    didx: DeviceQuasiIndex, st: EngineStatic, key_hi: torch.Tensor, key_lo: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Any-shaped key words (uint32 values in int64) -> (found, b, e) of the
    same shape (bool, int64, int64): the canonical CHD, the legacy CHD or the
    prefix-LUT binary search, whichever the index and `st` allow."""
    if st.use_chd and didx.chd_dir is not None and st.chd_canonical:
        f, b, e, _, _, _ = kmer_lookup_2str(didx, st, key_hi, key_lo)
        return f, b, e
    if st.use_chd and didx.chd_dir is not None:
        return _chd_lookup(didx, st, key_hi, key_lo)
    if didx.kmer_rows is None or didx.lut_rows is None:
        raise ValueError("the binary-search probe needs the full upload "
                         "(upload_index(lean=False)): kmer_rows and lut_rows")
    Kc = max(didx.kmer_rows.shape[0] - 1, 0)
    bounds = row_gather_nd(didx.lut_rows, _prefix_of(key_hi, key_lo, st.k, st.prefix_bases))
    lo = bounds[..., 0].to(torch.int64)
    hi_i = bounds[..., 1].to(torch.int64)
    hi = hi_i
    for _ in range(st.lookup_steps):
        mid = (lo + hi) >> 1
        row = row_gather_nd(didx.kmer_rows, mid.clamp(0, Kc))
        vh, vl = u32(row[..., 0]), u32(row[..., 1])
        less = (vh < key_hi) | ((vh == key_hi) & (vl < key_lo))
        cont = lo < hi
        lo, hi = torch.where(cont & less, mid + 1, lo), torch.where(cont & ~less, mid, hi)
    row = row_gather_nd(didx.kmer_rows, lo.clamp(0, Kc))
    found = (lo < hi_i) & (u32(row[..., 0]) == key_hi) & (u32(row[..., 1]) == key_lo)
    return found, torch.where(found, u32(row[..., 2]), 0), torch.where(found, u32(row[..., 3]), 0)
