"""MMP search with NIP skipping — the compute core (SACollector rebuild).

Port of rapmap_tpu.ops.mmp's canonical-CHD strand-paired scan, two phases:

  1. *Dense lookup*: one canonical CHD probe per forward window answers both
     strands of every (read, strand) lane at once — no loop.
  2. *Anchor walk*: the NIP-skipping scan, in lockstep across lanes; each
     trip lands directly on the next anchor (precomputed next-anchor table).

The walk runs max_hits_per_strand + 1 trips with finished lanes masked:
every trip of an active lane either records a hit or sets `truncated`, so
that many trips finish every lane, and per-lane results are identical to
the reference's loop-until-done. The reference's dead-lane compaction and
narrow tail only change the lockstep width (its docstring says the output
is bit-identical) and are not carried over.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.ops import encode as denc
from rapmap_tpu_torch.ops.device_index import DeviceQuasiIndex, EngineStatic
from rapmap_tpu_torch.ops.extend_packed import extend_packed, pack_reads
from rapmap_tpu_torch.ops.gather import row_gather
from rapmap_tpu_torch.ops.lookup import kmer_lookup_2str


class ScanHits(NamedTuple):
    q: torch.Tensor      # (R, H) query positions
    l: torch.Tensor      # (R, H) MMP lengths
    b: torch.Tensor      # (R, H) interval begins
    e: torch.Tensor      # (R, H) interval ends
    n: torch.Tensor      # (R,)  hit counts
    truncated: torch.Tensor  # (R,) bool — hit buffer overflowed (over_budget)


def scan_batch_paired(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads: torch.Tensor,  # (B, L) int8 — FORWARD reads only
    lens: torch.Tensor,   # (B,) int64
    cfg: MapConfig,
) -> ScanHits:
    """SEMANTICS.md §3 scan over [fwd; rc] lanes with a SHARED dense lookup:
    the rc lane's window at position s' is the reverse complement of the fwd
    window at lens-k-s', so one canonical probe per forward window answers
    both. The rc lane's anchor walk runs in its own coordinates; dense-array
    accesses map through col = lens - k - pos, and its next-anchor table is a
    prev-anchor scan in fwd coordinates. Rows [0, B) of the result are
    forward lanes, [B, 2B) rc."""
    B, L = reads.shape
    k = st.k
    H = cfg.max_hits_per_strand
    S = L - k + 1
    if L >= st.pad_tail:
        raise ValueError("read length must stay below the text tail pad")
    dev = reads.device
    eff_w = min(cfg.max_interval, st.max_interval_idx)
    ext_steps = max(1, math.ceil(math.log2(eff_w + 1)) + 1)

    lens = lens.to(torch.int64)
    lens2 = torch.cat([lens, lens])
    R = 2 * B
    # rc lanes RIGHT-ALIGNED by a static flip: rc data position p lives at
    # column p + (L - len), threaded into the extension as col_off
    lanes = torch.cat([reads, denc.comp_flip_batch(reads)], dim=0)
    col_off2 = torch.cat([torch.zeros_like(lens), L - lens])
    next_bad = denc.next_bad_batch(lanes, L)
    preads = pack_reads(lanes)

    # ---- dense phase: ONE canonical probe per forward window ---------------
    key_hi, key_lo, kvalid = denc.kmer_keys_from_packed(preads[:B], next_bad[:B], k, S)
    ff, bf, ef, fr, br, er = kmer_lookup_2str(didx, st, key_hi, key_lo)
    s_ix = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    ok = kvalid & ((s_ix + k) <= lens[:, None])
    anch_f = ff & ok & ((ef - bf) <= cfg.max_interval)
    anch_rF = fr & ok & ((er - br) <= cfg.max_interval)  # rc anchors, fwd coords

    nf = torch.where(anch_f, s_ix, S)  # next anchor >= s (fwd lanes)
    next_f = torch.flip(torch.cummin(torch.flip(nf, dims=[1]), dim=1).values, dims=[1])
    pv = torch.where(anch_rF, s_ix, -1)  # prev anchor <= s (rc lanes)
    prev_rF = torch.cummax(pv, dim=1).values

    # lane-aligned stacks: row r < B = fwd arrays, row r >= B = rc arrays
    db2 = torch.cat([bf, br], dim=0)
    de2 = torch.cat([ef, er], dim=0)
    anc2 = torch.cat([next_f, prev_rF], dim=0)
    is_rc = torch.arange(R, device=dev) >= B

    def at2(arr2d, col):
        return row_gather(arr2d, col.clamp(0, S - 1)[:, None])[:, 0]

    def next_anchor_pos(nxt):
        """Smallest lane-local anchor position >= nxt, else S (full width)."""
        col = torch.where(is_rc, lens2 - k - nxt, nxt)
        v = at2(anc2, col)
        fwd_next = torch.where(nxt < S, v, S)
        rc_next = torch.where((col >= 0) & (v >= 0), lens2 - k - v, S)
        return torch.where(is_rc, rc_next, fwd_next)

    # ---- anchor walk ---------------------------------------------------------
    pos = next_anchor_pos(torch.zeros_like(lens2))
    n = torch.zeros_like(lens2)
    trunc = torch.zeros_like(is_rc)
    buf = torch.zeros((R, H, 4), dtype=torch.int64, device=dev)
    lane = torch.arange(R, device=dev)
    for _ in range(H + 1):
        act = (pos < S) & ~trunc
        posc = pos.clamp(0, S - 1)
        col = torch.where(is_rc, lens2 - k - posc, posc)
        b1, e1, mlen = extend_packed(
            didx, preads, next_bad, lens2, at2(db2, col), at2(de2, col), posc,
            act, k, ext_steps, L, col_off=col_off2,
        )
        slot = n.clamp(0, H - 1)
        overflow = act & (n >= H)
        write = act & ~overflow
        rows4 = torch.stack([posc, mlen, b1, e1], dim=-1)
        buf[lane, slot] = torch.where(write[:, None], rows4, buf[lane, slot])
        pos = torch.where(act, next_anchor_pos(posc + (mlen - k + 1).clamp(min=1)), pos)
        n = n + write
        trunc = trunc | overflow
    return ScanHits(
        q=buf[..., 0], l=buf[..., 1], b=buf[..., 2], e=buf[..., 3],
        n=n, truncated=trunc,
    )


def scan_dispatch(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads: torch.Tensor,  # (B, L) int8 — FORWARD reads
    lens: torch.Tensor,   # (B,)
    cfg: MapConfig,
) -> ScanHits:
    """Strand-paired scan of forward reads -> (2B, H) lane hits. Only the
    canonical-CHD scan is ported; indexes without a canonical CHD (the
    reference's `scan_batch` binary-search path) are refused."""
    if not st.chd_canonical:
        raise NotImplementedError(
            "the binary-search probe path (indexes without a canonical CHD) "
            "is not ported yet"
        )
    return scan_batch_paired(didx, st, reads, lens, cfg)
