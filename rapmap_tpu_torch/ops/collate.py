"""Hit collation: SA intervals -> per-transcript mappings (HitManager rebuild).

Port of rapmap_tpu.ops.collate: the direct-compaction path of the chunked
single-end wire and the slotted MapOut layout of the unchunked one; the
paired-end merge (ops.pairs) joins two mates' collate cores.
SEMANTICS.md §4 with a GLOBAL slot pool: hits from all reads expand into one
(CAPG,) pool sized cfg.expand_budget slots per read on average.

Pipeline:
  1. global exclusive cumsum over hit widths -> each hit's slot range
     (read-major, so each read's slots are contiguous)
  2. slot -> hit assignment by scatter-max of hit ids at range starts + a
     running-max scan
  3. one row-gather resolves hit fields; one sa_meta row-gather resolves
     (transcript, position)
  4. voting: one sort by the packed (read, t*2+strand, tpos) key + run-length
     support counts
  5. per-(read, t, strand) best position by segment argmax; consistency /
     strict filters
  6. winners compact into the dense record buffer (collate_records_se) or
     scatter into the (B, MAX_OUT) MapOut layout (collate_batch)

Budget overflow (pool exhausted) sets those reads' over_budget flags.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.ops.bits import M32, as_i32, shl32, u32
from rapmap_tpu_torch.ops.device_index import DeviceQuasiIndex, EngineStatic
from rapmap_tpu_torch.ops.gather import row_gather_nd
from rapmap_tpu_torch.ops.mmp import ScanHits

BIG = 2**31 - 1
INT32_MIN = -(2**31)
INT64_MAX = 2**63 - 1


def _pack2(fields):
    """MSB-first [(nonneg int val, nbits), ...] -> (hi, lo) 32-bit words
    (uint32 in int64) of the 64-bit concatenation; total bits <= 64. Each
    value is first cut to its low 32 bits, as the reference's uint32 cast."""
    hi = None
    lo = None
    off = 0
    for val, nb in reversed(fields):
        v = val.to(torch.int64) & M32
        if off < 32:
            c = shl32(v, off)
            lo = c if lo is None else lo | c
            if off + nb > 32:
                c2 = v >> (32 - off)
                hi = c2 if hi is None else hi | c2
        else:
            c2 = shl32(v, off - 32)
            hi = c2 if hi is None else hi | c2
        off += nb
    if off > 64:
        raise ValueError("packed sort key exceeds 64 bits")
    zero = torch.zeros_like(fields[0][0], dtype=torch.int64)
    return (zero if hi is None else hi), (zero if lo is None else lo)


def _unpack2(hi, lo, off: int, nb: int) -> torch.Tensor:
    """Bits [off, off+nb) of the 64-bit (hi, lo) word pair."""
    mask = (1 << nb) - 1 if nb < 32 else M32
    if off >= 32:
        return (hi >> (off - 32)) & mask
    if off + nb <= 32:
        return (lo >> off) & mask
    return ((lo >> off) | (hi << (32 - off))) & mask


def _segment_sum(val, seg, num: int):
    return torch.zeros(num, dtype=torch.int64, device=val.device).index_add_(
        0, seg, val.to(torch.int64)
    )


def _segment_max(val, seg, num: int):
    """jax.ops.segment_max: empty segments hold INT32_MIN."""
    out = torch.full((num,), INT32_MIN, dtype=torch.int64, device=val.device)
    return out.scatter_reduce_(0, seg, val.to(torch.int64), "amax", include_self=False)


def _lexsort(keys):
    """Permutation sorting rows by keys[0], then keys[1], ... (stable sorts
    from the last key back)."""
    order = torch.argsort(keys[-1], stable=True)
    for key in reversed(keys[:-1]):
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _sort_packed(hi0, lo0, cfg: MapConfig):
    """Ascending sort of the packed (hi, lo) key pairs."""
    NEL = hi0.shape[0]
    if cfg.bitonic_sort and NEL >= 2 and (NEL & (NEL - 1)) == 0:
        # no payload rides this sort (both words are keys), so the unstable
        # bitonic network is output-identical to a stable sort
        from rapmap_tpu_torch.ops.sort2 import bitonic_sort_pairs

        khi, klo = bitonic_sort_pairs(as_i32(hi0), as_i32(lo0))
        return u32(khi), u32(klo)
    # one int64 key; valid keys use < 62 bits, the invalid slot
    # (0xFFFFFFFF, 0xFFFFFFFF) maps to INT64_MAX so it still sorts last
    inval = (hi0 == M32) & (lo0 == M32)
    key = torch.where(inval, INT64_MAX, (hi0 << 32) | lo0)
    key = torch.sort(key).values
    inval = key == INT64_MAX
    return (
        torch.where(inval, M32, key >> 32),
        torch.where(inval, M32, key & M32),
    )


class MapOut(NamedTuple):
    t: torch.Tensor        # (B, MAX_OUT) int32, -1 = none
    pos: torch.Tensor      # (B, MAX_OUT) int32
    strand: torch.Tensor   # (B, MAX_OUT) int32, 0 = fwd, 1 = rc
    score: torch.Tensor    # (B, MAX_OUT) int32 (MMP support)
    n_mappings: torch.Tensor   # (B,) pre-cap mapping count
    mapped: torch.Tensor       # (B,) bool
    too_ambiguous: torch.Tensor  # (B,) bool
    over_budget: torch.Tensor    # (B,) bool — expansion pool or hit buffer blown
    out_truncated: torch.Tensor  # (B,) bool — winners > max_out emitted slots


class CollateCore(NamedTuple):
    """Winner rows in global (read, t*2+strand) sorted order + per-read flags."""

    keep: torch.Tensor      # (CAPG,) bool — row is an emitted mapping
    rclip: torch.Tensor     # (CAPG,) read id (clipped; only valid where keep)
    k2s: torch.Tensor       # (CAPG,) t*2+strand
    p2: torch.Tensor        # (CAPG,) transcript position
    sup2: torch.Tensor      # (CAPG,) MMP support score
    rank: torch.Tensor      # (CAPG,) winner rank within its read
    counts: torch.Tensor    # (B,) winner count per read (pre-cap)
    too_ambiguous: torch.Tensor
    over_budget: torch.Tensor


def _collate_core(
    didx: DeviceQuasiIndex | None,
    st: EngineStatic | None,
    hits: ScanHits,
    lens: torch.Tensor,  # (B,) read lengths
    cfg: MapConfig,
    expand_fn=None,
) -> CollateCore:
    """expand_fn(slot p, query pos q) -> (t, tpos) resolves one expanded
    occurrence; None is the quasi resolution through didx.sa_meta. The pseudo
    path passes its CSR resolver (models.pseudo.csr_expand_fn) with didx and
    st None: then there is no pair pool and no packed key (the vote sorts
    through _lexsort). The sharded engine's GLOBAL int64 slots (slot64) need
    no path of their own: the int64 carriers here resolve wide begins."""
    R, H = hits.q.shape
    B = R // 2
    H2 = 2 * H
    NH = B * H2
    CAPG = cfg.expand_budget * B
    dev = hits.q.device
    lens = lens.to(torch.int64)

    # ---- per-strand coverage gate (quasi_coverage) --------------------------
    hvalid_rows = torch.arange(H, device=dev)[None, :] < hits.n[:, None]  # (R, H)
    if cfg.quasi_coverage > 0.0:
        cov = torch.where(hvalid_rows, hits.l, 0).sum(dim=1)  # (R,)
        lens2 = torch.cat([lens, lens])
        # exact integer threshold matching the oracle's f64 `cov >= qc * L`
        _LMAX = 4096  # reads beyond this never reach the device engines
        thr_tab = np.ceil(
            np.float64(cfg.quasi_coverage) * np.arange(_LMAX + 1, dtype=np.float64)
        ).astype(np.int64)
        thr = torch.from_numpy(thr_tab).to(dev)[lens2.clamp(0, _LMAX)]
        strand_ok = cov >= thr
    else:
        strand_ok = torch.ones_like(hits.truncated)
    hvalid_rows = hvalid_rows & strand_ok[:, None]

    # ---- fold (fwd, rc) rows into (B, 2H) hit tables ------------------------
    def fold(x):
        return torch.cat([x[:B], x[B:]], dim=1)  # (B, 2H), fwd hits first

    hq, hb, he = fold(hits.q), fold(hits.b), fold(hits.e)
    hv = fold(hvalid_rows)
    n_fwd = torch.where(strand_ok[:B], hits.n[:B], 0)
    n_rc = torch.where(strand_ok[B:], hits.n[B:], 0)

    # ---- global expansion pool ---------------------------------------------
    # pair mode: each pool slot covers TWO adjacent SA positions resolved by
    # one sa_meta pair-row gather (device_index meta_pairs)
    pairs = (cfg.expand_pairs and expand_fn is None and didx is not None
             and didx.sa_meta.shape[1] >= 4)
    P = 2 if pairs else 1
    CAPP = (CAPG + P - 1) // P      # pool size in slot units (pairs or singles)
    w_el = torch.where(hv, he - hb, 0).reshape(-1)  # (NH,)
    w = (w_el + (P - 1)) // P if pairs else w_el  # per-hit pool-slot demand
    cs = torch.cumsum(w, dim=0)
    sg = cs - w                     # global start of each hit's slot range
    total_global = cs[-1]
    ends_r = cs.reshape(B, H2)[:, -1]
    starts_r = torch.cat([torch.zeros_like(ends_r[:1]), ends_r[:-1]])
    over_budget = (ends_r > CAPP) & (ends_r > starts_r)
    over_budget = over_budget | hits.truncated[:B] | hits.truncated[B:]

    # slot -> hit: scatter hit ids at their range starts, then running max
    hit_ids = torch.arange(NH, device=dev)
    valid_hit = (w > 0) & (sg < CAPP)
    scat_idx = torch.where(valid_hit, sg, CAPP)
    pool_hit = torch.full((CAPP + 1,), -1, dtype=torch.int64, device=dev)
    pool_hit = pool_hit.scatter_reduce_(
        0, scat_idx, torch.where(valid_hit, hit_ids, -1), "amax", include_self=True
    )[:CAPP]
    pool_hit = torch.cummax(pool_hit, dim=0).values
    g = torch.arange(CAPP, device=dev)
    slot_valid = (g < torch.clamp(total_global, max=CAPP)) & (pool_hit >= 0)
    ph = pool_hit.clamp(0, NH - 1)

    # one multi-column row-gather resolves the hit fields for every slot
    read_of_hit = torch.arange(B, device=dev).repeat_interleave(H2)
    hstrand = (torch.arange(H2, device=dev) >= H).to(torch.int64).repeat(B)
    cols = [hb.reshape(-1), sg, hq.reshape(-1), read_of_hit * 2 + hstrand]
    if pairs:
        cols.append(w_el)  # element width: bounds the pair's 2nd position
    g4 = torch.stack(cols, dim=-1)[ph]  # (CAPP, 4 or 5)
    p = g4[:, 0] + P * (g - g4[:, 1])
    hq_slot = g4[:, 2]
    read = g4[:, 3] >> 1
    strand = g4[:, 3] & 1
    if expand_fn is not None:
        t, tpos = expand_fn(p, hq_slot)
    elif pairs:
        meta = row_gather_nd(didx.sa_meta, p).to(torch.int64)

        # unzip pair rows -> element arrays (length 2*CAPP >= CAPG); the
        # element order equals the single-slot pool's SA-position order
        def z2(a, b):
            return torch.stack([a, b], dim=1).reshape(-1)

        second_ok = slot_valid & (P * (g - g4[:, 1]) + 1 < g4[:, 4])
        t = z2(meta[:, 0], meta[:, 2])
        tpos = z2(meta[:, 1] - hq_slot, meta[:, 3] - hq_slot)
        read = z2(read, read)
        strand = z2(strand, strand)
        slot_valid = z2(slot_valid, second_ok)
    else:
        meta = row_gather_nd(didx.sa_meta, p).to(torch.int64)
        t = meta[:, 0]
        tpos = meta[:, 1] - hq_slot
    NEL = P * CAPP                  # voting element count (== CAPG up to round-up)

    # sort-key packing: (read, t*2+strand, tpos) fit one 2-word key
    # whenever the index's static stats bound the fields
    ts_val = t * 2 + strand
    packed = False
    if expand_fn is None and st is not None and st.n_txps > 0:
        rb = (B + 1).bit_length()
        tb = (2 * st.n_txps + 1).bit_length()
        sb = (2 * H + 1).bit_length()
        bias = st.pad_tail  # tpos >= -(L-1) > -pad_tail
        pb = max(1, (st.max_tpos + bias + 1).bit_length())
        packed = (rb + tb + sb + pb) <= 62

    # ---- vote: sort by (read, t*2+strand, tpos), count equal runs -----------
    if packed:
        hi0, lo0 = _pack2([(read, rb), (ts_val, tb), (tpos + bias, pb)])
        hi0 = torch.where(slot_valid, hi0, M32)
        lo0 = torch.where(slot_valid, lo0, M32)
        khi, klo = _sort_packed(hi0, lo0, cfg)
        valid1 = khi != M32  # valid keys keep hi's top bits clear
        k1 = torch.where(valid1, _unpack2(khi, klo, tb + pb, rb), BIG)
        k2 = torch.where(valid1, _unpack2(khi, klo, pb, tb), BIG)
        p1 = _unpack2(khi, klo, 0, pb) - bias
        prev_same = (khi[1:] == khi[:-1]) & (klo[1:] == klo[:-1])
    else:
        key1 = torch.where(slot_valid, read, BIG)
        key2 = torch.where(slot_valid, ts_val, BIG)
        order = _lexsort([key1, key2, tpos])
        k1, k2, p1 = key1[order], key2[order], tpos[order]
        prev_same = (k1[1:] == k1[:-1]) & (k2[1:] == k2[:-1]) & (p1[1:] == p1[:-1])
        valid1 = k1 != BIG
    first = torch.ones(1, dtype=torch.bool, device=dev)
    run_start = valid1 & torch.cat([first, ~prev_same])
    run_id = torch.cumsum(run_start, dim=0) - 1
    run_c = run_id.clamp(0, NEL - 1)
    seg = _segment_sum(valid1, run_c, NEL)
    support = torch.where(run_start, seg[run_c], 0)

    # ---- per-(read,t,strand) best position -----------------------------------
    if packed and (sb + pb) <= 31:
        # runs already sit in (read, ts, tpos) order, so the per-group best
        # (max support, ties -> smallest tpos) is a segment ARGMAX over
        # consecutive (read, ts) groups — no second sort. val packs
        # (support, pmax - tpos) into one positive int32; tpos is unique
        # within a group's runs, so the group max is unique.
        k1s, k2s, p2, sup2 = k1, k2, p1, support
        new_grp = run_start & torch.cat(
            [first, (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])]
        )
        gidc = (torch.cumsum(new_grp, dim=0) - 1).clamp(0, NEL - 1)
        pmax = (1 << pb) - 1
        val = torch.where(run_start, (support << pb) | (pmax - (p1 + bias)), 0)
        gmax = _segment_max(val, gidc, NEL)
        grp_start = run_start & (val == gmax[gidc])
    else:
        k1r = torch.where(run_start, k1, BIG)
        k2r = torch.where(run_start, k2, BIG)
        order = _lexsort([k1r, k2r, -support, p1])
        k1s, k2s, p2, sup2 = k1r[order], k2r[order], p1[order], support[order]
        grp_start = (k1s != BIG) & torch.cat(
            [first, (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])]
        )
    s2 = k2s & 1
    rclip = k1s.clamp(0, B - 1)
    # consistency filter (SEMANTICS.md §4)
    if cfg.consistent_hits:
        need = torch.where(s2 == 0, n_fwd[rclip], n_rc[rclip]) - (1 if cfg.fuzzy else 0)
        keep = grp_start & (sup2 >= need)
    else:
        keep = grp_start
    if cfg.strict_check:
        # orientation-bias curb (SEMANTICS.md §3): keep only the strand(s)
        # whose best kept score equals the read's overall best. (Rows with
        # k1s == BIG land in another segment than the reference's int32
        # wrap puts them, but they carry value 0 and are never kept.)
        sid = (k1s * 2 + s2).clamp(0, 2 * B - 1)
        m_rs = _segment_max(torch.where(keep, sup2, 0), sid, 2 * B).clamp(min=0)
        best = torch.maximum(m_rs[0::2], m_rs[1::2])  # (B,)
        keep = keep & (m_rs[sid] == best[rclip])

    # ---- per-read winner counts / ranks -------------------------------------
    counts = _segment_sum(keep, rclip, B)  # rclip only counts real reads
    base = torch.cumsum(counts, dim=0) - counts  # exclusive per-read winner base
    gks = torch.cumsum(keep, dim=0) - 1
    rank = gks - base[rclip]
    return CollateCore(
        keep=keep, rclip=rclip, k2s=k2s, p2=p2, sup2=sup2, rank=rank,
        counts=counts, too_ambiguous=counts > cfg.max_num_hits,
        over_budget=over_budget,
    )


def collate_batch(
    didx: DeviceQuasiIndex | None,
    st: EngineStatic | None,
    hits: ScanHits,
    lens: torch.Tensor,
    cfg: MapConfig,
    expand_fn=None,
) -> MapOut:
    """Winners scattered into the slotted (B, MAX_OUT) MapOut layout (used by
    the unchunked wire path, the library API and the sharded engine)."""
    B = hits.q.shape[0] // 2
    MO = cfg.out_slots
    c = _collate_core(didx, st, hits, lens, cfg, expand_fn)
    emit = c.keep & ~c.too_ambiguous[c.rclip] & (c.rank < MO)
    # rows that are not emitted go to the sink row B * MO, which is cut off;
    # emitted rows have distinct (read, rank) slots
    flatpos = torch.where(emit, c.rclip * MO + c.rank, B * MO)
    rows = torch.stack(
        [c.k2s >> 1, c.p2, c.k2s & 1, c.sup2], dim=-1
    ).to(torch.int32)
    buf = torch.zeros((B * MO + 1, 4), dtype=torch.int32, device=rows.device)
    buf[:, 0] = -1
    out = buf.index_put_((flatpos,), rows)[: B * MO].reshape(B, MO, 4)
    n_map = c.counts
    return MapOut(
        t=out[..., 0], pos=out[..., 1], strand=out[..., 2], score=out[..., 3],
        n_mappings=n_map, mapped=(n_map >= 1) & ~c.too_ambiguous,
        too_ambiguous=c.too_ambiguous, over_budget=c.over_budget,
        out_truncated=(n_map > MO) & ~c.too_ambiguous,
    )


class MapFlags(NamedTuple):
    """Per-read outcome flags (MapOut minus the record payload)."""

    n_mappings: torch.Tensor
    mapped: torch.Tensor
    too_ambiguous: torch.Tensor
    over_budget: torch.Tensor
    out_truncated: torch.Tensor


def collate_records_se(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    hits: ScanHits,
    lens: torch.Tensor,
    cfg: MapConfig,
    cap: int,
    rec_spec=None,
    reads=None,
    expand_fn=None,
):
    """Winners compacted DIRECTLY into a dense (cap, W) int32 record buffer.

    The core's winner rows already sit in (read, t*2+strand) sorted order —
    the row-major layout of the records — so one cumsum + scatter compacts
    them. With rec_spec (wire.RecSpec), rows pack into W=2 words instead of
    4 (t, pos, strand, score). With cfg.mapping_score (and `reads`), the
    score field carries the banded alignment score (ops.align, computed on
    the compacted cap rows) instead of the MMP support. expand_fn as in
    _collate_core (the pseudo path: 4-word records, no rec_spec). Returns
    (SERecords, MapFlags)."""
    from rapmap_tpu_torch.ops.compact import SERecords

    B = hits.q.shape[0] // 2
    c = _collate_core(didx, st, hits, lens, cfg, expand_fn)
    emit = c.keep & ~c.too_ambiguous[c.rclip]
    gidx = torch.cumsum(emit, dim=0) - 1
    # non-emitted rows (and any past the cap) go to the sink row `cap`,
    # which is cut off; emitted rows below the cap have distinct indices
    dest = torch.where(emit, gidx.clamp(max=cap), cap)
    fields = [c.k2s >> 1, c.p2, c.k2s & 1, c.sup2]
    scoring = cfg.mapping_score and reads is not None
    if scoring:
        # scatter the unpacked columns + read id first, score the dense cap
        # rows (the pool's CAPG rows would be ~expand_budget/rec_slots times
        # more DP lanes), then pack the columns
        from rapmap_tpu_torch.ops.align import score_records

        cols = torch.stack([f.to(torch.int32) for f in fields[:3] + [c.rclip]], dim=-1)
        buf = torch.zeros((cap + 1, 4), dtype=torch.int32, device=cols.device)
        raw = buf.index_put_((dest,), cols)[:cap]
        # the live-row mask comes from the device-side total: no host sync
        row_live = torch.arange(cap, device=raw.device) < emit.sum().clamp(max=cap)
        sc = score_records(didx, cfg, reads, lens, raw[:, 3], raw[:, 0], raw[:, 1],
                           raw[:, 2], row_live)
        fields = [raw[:, 0], raw[:, 1], raw[:, 2], sc]
    if rec_spec is not None:
        from rapmap_tpu_torch.ops.wire import pack_rec_fields

        fields = list(pack_rec_fields(rec_spec, fields))
    rows = torch.stack([f.to(torch.int32) for f in fields], dim=-1)
    if scoring:  # already the dense cap rows
        recs = rows
    else:
        buf = torch.zeros((cap + 1, len(fields)), dtype=torch.int32, device=rows.device)
        recs = buf.index_put_((dest,), rows)[:cap]
    emitted = _segment_sum(emit, c.rclip, B)
    ends = torch.cumsum(emitted, dim=0)
    counts = ends.clamp(max=cap) - (ends - emitted).clamp(max=cap)
    total = emit.sum()
    se = SERecords(recs=recs, counts=counts, total=total, overflowed=total > cap)
    mapped = (c.counts >= 1) & ~c.too_ambiguous
    flags = MapFlags(
        n_mappings=c.counts, mapped=mapped, too_ambiguous=c.too_ambiguous,
        over_budget=c.over_budget, out_truncated=mapped & (emitted < c.counts),
    )
    return se, flags

