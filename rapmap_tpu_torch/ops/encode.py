"""Device-side read preprocessing: reverse complement, k-mer keys, N scanning.

Port of rapmap_tpu.ops.encode.
Shape-static and batched over an (R, L) int8 code array (SEMANTICS.md §1
codes); key words are uint32 values carried in int64 (ops.bits).
"""

from __future__ import annotations

import torch

from rapmap_tpu_torch.ops.bits import M32, shl32

NCODE = 5


def revcomp_batch(reads: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(R, L) int8, per-row lengths -> per-row reverse complement, LEFT-aligned
    (rc position p at column p), padded with NCODE."""
    R, L = reads.shape
    i = torch.arange(L, dtype=torch.int64, device=reads.device)[None, :]
    src = lens.to(torch.int64)[:, None] - 1 - i
    vals = torch.gather(reads, 1, src.clamp(0, L - 1).expand(R, L))
    comp = torch.where((vals >= 1) & (vals <= 4), 5 - vals, NCODE).to(torch.int8)
    return torch.where(src >= 0, comp, NCODE).to(torch.int8)


def comp_flip_batch(reads: torch.Tensor) -> torch.Tensor:
    """(R, L) int8 -> RIGHT-ALIGNED reverse complement: flip of the
    complemented full row (a static permutation — no per-row gather). A row
    of length `len` occupies columns [L-len, L); rc position p lives at
    column p + (L - len). Pad/N codes flip to NCODE."""
    comp = torch.where((reads >= 1) & (reads <= 4), 5 - reads, NCODE).to(torch.int8)
    return torch.flip(comp, dims=[1])


def kmer_keys_batch(reads: torch.Tensor, k: int):
    """(R, L) -> (hi, lo, valid) each (R, S) with S = L - k + 1: big-endian
    2-bit keys built one base at a time (the charwise path's keys; equal to
    kmer_keys_from_packed's); valid iff the window is pure ACGT."""
    R, L = reads.shape
    S = L - k + 1
    if S < 1:
        raise ValueError("reads shorter than k")
    hi = torch.zeros((R, S), dtype=torch.int64, device=reads.device)
    lo = torch.zeros_like(hi)
    valid = torch.ones((R, S), dtype=torch.bool, device=reads.device)
    for i in range(k):
        c = reads[:, i : i + S].to(torch.int64)
        valid = valid & (c >= 1) & (c <= 4)
        hi = shl32(hi, 2) | (lo >> 30)
        lo = shl32(lo, 2) | ((c - 1) & 3)
    return hi, lo, valid


def kmer_keys_from_packed(
    preads: torch.Tensor,    # (R, L) packed words (extend_packed.pack_reads)
    next_bad: torch.Tensor,  # (R, L) (next_bad_batch)
    k: int,
    S: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, lo, valid) each (R, S): the 2k-bit big-endian key of every
    window, from the packed words — word[p] holds bases p..p+15, so the key
    at p is the 64-bit pair (word[p], word[p+16]) >> (64-2k). Non-ACGT bases
    contribute arbitrary bits; validity comes from next_bad."""
    w0 = preads[:, :S]
    s = 64 - 2 * k
    if s == 0:
        hi, lo = w0, preads[:, 16 : 16 + S]
    elif s < 32:
        w1 = preads[:, 16 : 16 + S]
        hi = w0 >> s
        lo = shl32(w0, 32 - s) | (w1 >> s)
    elif s == 32:
        hi, lo = torch.zeros_like(w0), w0
    else:
        hi = torch.zeros_like(w0)
        lo = w0 >> (s - 32)
    pos = torch.arange(S, dtype=torch.int64, device=preads.device)[None, :]
    valid = next_bad[:, :S] >= pos + k
    return hi, lo, valid


def next_bad_batch(reads: torch.Tensor, L_sentinel: int) -> torch.Tensor:
    """next_bad[r, p] = smallest q >= p with code outside 1..4, else L_sentinel."""
    R, L = reads.shape
    i = torch.arange(L, dtype=torch.int64, device=reads.device)[None, :]
    bad_at = torch.where((reads < 1) | (reads > 4), i, L_sentinel)
    run = torch.cummin(torch.flip(bad_at, dims=[1]), dim=1).values
    return torch.flip(run, dims=[1])


def _rev2_32(w: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit groups within each 32-bit word."""
    m2, m4, m8 = 0x33333333, 0x0F0F0F0F, 0x00FF00FF
    w = shl32(w & m2, 2) | ((w >> 2) & m2)
    w = shl32(w & m4, 4) | ((w >> 4) & m4)
    w = shl32(w & m8, 8) | ((w >> 8) & m8)
    return shl32(w, 16) | (w >> 16)


def rc_keys_batch(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """Reverse-complement keys from (hi, lo) word pairs without touching the
    reads: complement the 2k bits, reverse the 2-bit groups, re-align. Must
    match index.chd.rc_key64_np exactly."""
    nb = 2 * k
    ch = (~hi) & (M32 if nb >= 64 else (1 << max(nb - 32, 0)) - 1)
    cl = (~lo) & (M32 if nb >= 32 else (1 << nb) - 1)
    # reverse all 32 groups of the 64-bit pair: words swap and self-reverse
    rhi = _rev2_32(cl)
    rlo = _rev2_32(ch)
    # shift right by s = 64 - 2k to re-align low
    s = 64 - nb
    if s == 0:
        return rhi, rlo
    if s < 32:
        return rhi >> s, (rlo >> s) | shl32(rhi, 32 - s)
    if s == 32:
        return torch.zeros_like(rhi), rhi
    return torch.zeros_like(rhi), rhi >> (s - 32)
