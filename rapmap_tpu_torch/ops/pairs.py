"""Paired-end merge on the device (mergeLeftRightHits rebuild, SEMANTICS.md §5).

Port of rapmap_tpu.ops.pairs. Two forms, with the same records:

- `merge_pairs_batch` joins the two mates' slotted (B, MAX_OUT) MapOut rows.
  Each mate's rows are unique per (t, strand) and sorted by (t, strand), so
  the concordant join is a per-slot lower-bound search of `t*2 + (1-strand)`
  in the mate's key row. The unchunked wire and `map_pe` take it.
- `collate_records_pe` merges the two mates' collate cores directly into a
  dense record buffer: one sort of both mates' winner rows by a (read, t,
  left strand) join key makes concordant partners adjacent. The chunked
  wire takes it whenever `pe_direct_eligible`; with the mapping score it
  scores both mates of its rows (ops.align) before they pack.

The join key is a uint32 word of the reference; here it rides an int64
tensor (ops/bits.py), so no product wraps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.ops.collate import (
    BIG, MapFlags, MapOut, _collate_core, _segment_sum,
)
from rapmap_tpu_torch.ops.gather import row_gather

FULLW = 0xFFFFFFFF  # join key of an empty row


class PairOut(NamedTuple):
    t: torch.Tensor    # (B, MO) int32, -1 = empty slot
    p1: torch.Tensor   # (B, MO) int32 left-mate pos (valid iff has1)
    s1: torch.Tensor   # (B, MO) int32 strand
    has1: torch.Tensor  # (B, MO) bool
    p2: torch.Tensor
    s2: torch.Tensor
    has2: torch.Tensor
    concordant: torch.Tensor     # (B,) bool
    n_records: torch.Tensor      # (B,) pre-cap record count
    too_ambiguous: torch.Tensor  # (B,) bool
    any_record: torch.Tensor     # (B,) bool
    out_truncated: torch.Tensor  # (B,) bool


def pe_direct_eligible(st, cfg: MapConfig, C: int) -> bool:
    """collate_records_pe packs (read, t*2+strand) into one uint32 join key;
    needs the index stats known and C * 2 * n_txps to fit 32 bits."""
    return (
        st is not None
        and getattr(st, "n_txps", 0) > 0
        and C * (2 * st.n_txps) < (1 << 32)
    )


def _scatter_rows(buf: torch.Tensor, dest: torch.Tensor, fields, rec_spec) -> torch.Tensor:
    """Write one row per dest index into buf (cap + 1, W); dest == cap is the
    sink row, cut off by the caller, so rows sent there may collide. With
    rec_spec the 7 fields pack into 2 words."""
    if rec_spec is not None:
        from rapmap_tpu_torch.ops.wire import pack_rec_fields

        fields = list(pack_rec_fields(rec_spec, fields))
    rows = torch.stack([f.to(torch.int32) for f in fields], dim=-1)
    return buf.index_put_((dest.clamp(max=buf.shape[0] - 1),), rows)


def collate_records_pe(didx, st, hits1, lens1, hits2, lens2, cfg: MapConfig, cap: int,
                       rec_spec=None, reads1=None, reads2=None):
    """PE merge DIRECTLY from the two mates' collate cores into a dense
    (cap, W) record buffer. Each mate's winner rows (already (read, t*2+s)
    sorted, unique per key) compact to a dense (cap,) list; one sort of the
    2*cap concatenation by the join key makes concordant partners adjacent
    rows. Orphan records come from the per-side lists (left mappings, then
    right). Records equal merge_pairs_batch -> compact_pe's, capped only by
    `cap` (overflow flagged). With cfg.mapping_score (and `reads1`,
    `reads2`) the rows scatter unpacked (W = 7), both mates are scored in
    one pass over the dense cap rows (ops.align.score_pe_rows), and the 9
    fields (+ sc1, sc2) pack only then.

    Returns (PERecords, pair MapFlags, per-read concordant bool)."""
    from rapmap_tpu_torch.ops.compact import PERecords, rid_from_counts

    C = hits1.q.shape[0] // 2
    KT = 2 * st.n_txps
    c1 = _collate_core(didx, st, hits1, lens1, cfg)
    c2 = _collate_core(didx, st, hits2, lens2, cfg)
    dev = c1.keep.device

    # mate-level ambiguity blanks that mate's list (SEMANTICS §5)
    emit1 = c1.keep & ~c1.too_ambiguous[c1.rclip]
    emit2 = c2.keep & ~c2.too_ambiguous[c2.rclip]

    # join keys: left rows at (r, 2t+s); right rows at (r, 2t+(1-s)) so a
    # concordant pair shares one key whose LOW BIT is the left strand
    jk1 = c1.rclip * KT + c1.k2s
    jk2 = c2.rclip * KT + (c2.k2s ^ 1)

    def side_compact(emit, jk, pos):
        """Sparse (CAPG,) winner rows -> dense (cap,) key/pos lists."""
        gidx = torch.cumsum(emit, dim=0) - 1
        dest = torch.where(emit, gidx.clamp(max=cap), cap)
        kd = torch.full((cap + 1,), FULLW, dtype=torch.int64, device=dev)
        kd = kd.index_put_((dest,), torch.where(emit, jk, FULLW))[:cap]
        pd = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
        pd = pd.index_put_((dest,), torch.where(emit, pos, 0))[:cap]
        return kd, pd

    k1d, p1d = side_compact(emit1, jk1, c1.p2)
    k2d, p2d = side_compact(emit2, jk2, c2.p2)

    # ---- one sort makes concordant partners adjacent ------------------------
    # (k, side) is unique on live rows, and the FULLW rows of one side all
    # carry position 0, so sorting by k*2 + side orders the payload exactly
    # as the reference's two-key sort does
    side = (torch.arange(2 * cap, device=dev) >= cap).to(torch.int64)
    key_s, order = torch.sort(torch.cat([k1d, k2d]) * 2 + side)
    k_s, side_s = key_s >> 1, key_s & 1
    pos_s = torch.cat([p1d, p2d])[order]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    valid_s = k_s != FULLW
    nxt_same = torch.cat([k_s[1:] == k_s[:-1], zero.bool()])
    conc = valid_s & nxt_same & (side_s == 0) & (torch.cat([side_s[1:], zero]) == 1)
    pp2 = torch.cat([pos_s[1:], zero])  # partner pos
    s1_s = k_s & 1
    # [REF-VERIFY] optional PE fidelity constraints (config.py notes)
    if cfg.max_frag_len:
        conc = conc & ((pos_s - pp2).abs() <= cfg.max_frag_len)
    if cfg.pair_order:
        fwd_pos = torch.where(s1_s == 0, pos_s, pp2)
        rc_pos = torch.where(s1_s == 0, pp2, pos_s)
        conc = conc & (fwd_pos <= rc_pos)

    r_s = torch.where(valid_s, k_s // KT, C)
    r_sc = r_s.clamp(0, C - 1)
    # invalid rows carry conc=False, so clipping them onto read C-1 adds 0
    n_pairs = _segment_sum(conc, r_sc, C)
    concordant = n_pairs >= 1

    # ---- per-read record counts / flags -------------------------------------
    n_left = torch.where(c1.too_ambiguous, 0, _segment_sum(emit1, c1.rclip, C))
    n_right = torch.where(c2.too_ambiguous, 0, _segment_sum(emit2, c2.rclip, C))
    n_orph = n_left * 0 if cfg.no_orphans else n_left + n_right
    n_rec = torch.where(concordant, n_pairs, n_orph)
    too_amb = n_rec > cfg.max_num_hits
    emit_n = torch.where(too_amb, 0, n_rec)
    base = torch.cumsum(emit_n, dim=0) - emit_n  # per-read record base

    # ---- assemble records: three masked scatter sources ---------------------
    # with the mapping score the rows scatter UNPACKED, are scored on the
    # dense cap rows (both mates in one pass), then pack elementwise
    scoring = cfg.mapping_score and reads1 is not None
    row_spec = None if scoring else rec_spec
    W = 2 if row_spec is not None else 7
    buf = torch.zeros((cap + 1, W), dtype=torch.int32, device=dev)

    # (a) concordant pair rows, in join-key order == left hit order
    w_conc = conc & concordant[r_sc] & ~too_amb[r_sc]
    g_conc = torch.cumsum(conc, dim=0) - 1
    conc_base = n_pairs.cumsum(dim=0) - n_pairs  # global pair base per read
    rank_c = g_conc - conc_base[r_sc]
    dest_c = torch.where(w_conc, base[r_sc] + rank_c, cap)
    t_s = torch.where(valid_s, (k_s % KT) >> 1, 0)
    one = torch.ones_like(t_s)
    buf = _scatter_rows(buf, dest_c, [t_s, pos_s, s1_s, one, pp2, 1 - s1_s, one], row_spec)

    # (b) left orphan rows (mate order preserved by c1.rank), then (c) right
    # orphan rows after the read's left rows; with no_orphans there are none
    if not cfg.no_orphans:
        for c, emit, left in ((c1, emit1, True), (c2, emit2, False)):
            orph = emit & ~concordant[c.rclip] & ~too_amb[c.rclip]
            first = base[c.rclip] if left else base[c.rclip] + n_left[c.rclip]
            dest = torch.where(orph, first + c.rank, cap)
            t = (c.k2s >> 1).clamp(min=0)
            s = c.k2s & 1
            z = torch.zeros_like(t)
            fields = [t, c.p2, s, z + 1, z, z, z] if left else [t, z, z, z, c.p2, s, z + 1]
            buf = _scatter_rows(buf, dest, fields, row_spec)

    recs = buf[:cap]
    total = emit_n.sum()
    ends = torch.cumsum(emit_n, dim=0)
    counts = ends.clamp(max=cap) - (ends - emit_n).clamp(max=cap)
    if scoring:
        from rapmap_tpu_torch.ops.align import score_pe_rows

        rid = rid_from_counts(counts, cap)
        live = torch.arange(cap, device=dev) < total.clamp(max=cap)
        sc1, sc2 = score_pe_rows(didx, cfg, reads1, lens1, reads2, lens2, rid,
                                 *(recs[:, j] for j in range(7)), live)
        cols = [recs[:, j] for j in range(7)] + [sc1, sc2]
        if rec_spec is not None:
            from rapmap_tpu_torch.ops.wire import pack_rec_fields

            cols = list(pack_rec_fields(rec_spec, cols))
        recs = torch.stack([x.to(torch.int32) for x in cols], dim=-1)
    pe = PERecords(recs=recs, counts=counts, total=total, overflowed=total > cap)
    mapped = (n_rec >= 1) & ~too_amb
    flags = MapFlags(
        n_mappings=n_rec, mapped=mapped, too_ambiguous=too_amb,
        over_budget=c1.over_budget | c2.over_budget,
        out_truncated=mapped & (counts < emit_n),
    )
    return pe, flags, concordant & ~too_amb


def _sort_rows_by(order: torch.Tensor, payload: list[torch.Tensor]) -> list[torch.Tensor]:
    """Stable row-wise ascending sort by `order`, carrying the payloads along:
    lax.sort with num_keys=1 (stable) of the reference. Tied rows (the BIG
    of empty slots) keep their order, and so their payloads."""
    idx = torch.sort(order, dim=1, stable=True).indices
    return [torch.gather(x, 1, idx) for x in payload]


def merge_pairs_batch(out1: MapOut, out2: MapOut, cfg: MapConfig) -> PairOut:
    B, MO = out1.t.shape
    dev = out1.t.device
    # right keys: ascending t*2 + strand, empty slots pushed to BIG
    t1, t2 = out1.t.to(torch.int64), out2.t.to(torch.int64)
    k2 = torch.where(t2 == -1, BIG, t2 * 2 + out2.strand)

    # ---- concordant join: for each left entry, find (t, 1-strand) on right --
    # (a row-wise lower bound, as the reference's fixed-trip binary search)
    want = torch.where(t1 == -1, BIG - 1, t1 * 2 + (1 - out1.strand))
    loc = torch.searchsorted(k2, want)
    loc_c = loc.clamp(0, MO - 1)
    hit = (loc < MO) & (torch.gather(k2, 1, loc_c) == want) & (t1 != -1)

    def g2(x):
        return row_gather(x, loc_c)

    # [REF-VERIFY] optional PE fidelity constraints (config.py notes); each
    # left row has at most one opposite-strand candidate, so filtering the
    # join predicate matches the oracle exactly
    if cfg.max_frag_len or cfg.pair_order:
        cand_p2 = g2(out2.pos)
        if cfg.max_frag_len:
            hit = hit & ((out1.pos - cand_p2).abs() <= cfg.max_frag_len)
        if cfg.pair_order:
            fwd_pos = torch.where(out1.strand == 0, out1.pos, cand_p2)
            rc_pos = torch.where(out1.strand == 0, cand_p2, out1.pos)
            hit = hit & (fwd_pos <= rc_pos)

    pair_t = torch.where(hit, out1.t, -1)
    pair_p2 = torch.where(hit, g2(out2.pos), 0)
    pair_s2 = torch.where(hit, g2(out2.strand), 0)
    n_pairs = hit.sum(dim=1)
    concordant = n_pairs >= 1

    # compact pairs to slot front (stable sort by hit order)
    seq = torch.arange(MO, device=dev)[None, :]
    order = torch.where(hit, seq, BIG)
    ct, cp1, cs1, cp2, cs2 = _sort_rows_by(
        order, [pair_t, out1.pos, out1.strand, pair_p2, pair_s2]
    )
    cvalid = ct != -1

    # ---- orphan fallback ----------------------------------------------------
    if cfg.no_orphans:
        o_t = torch.full((B, MO), -1, dtype=torch.int32, device=dev)
        o_p = torch.zeros((B, MO), dtype=torch.int32, device=dev)
        o_s = torch.zeros_like(o_p)
        o_is1 = torch.zeros((B, MO), dtype=torch.bool, device=dev)
        n_orph = out1.n_mappings * 0
    else:
        ordL = torch.where(out1.t != -1, seq, BIG)
        ordR = torch.where(out2.t != -1, seq + MO, BIG)
        cat_is1 = (torch.arange(2 * MO, device=dev) < MO).expand(B, 2 * MO)
        o_t, o_p, o_s, o_is1 = (x[:, :MO] for x in _sort_rows_by(
            torch.cat([ordL, ordR], dim=1),
            [torch.cat([out1.t, out2.t], dim=1), torch.cat([out1.pos, out2.pos], dim=1),
             torch.cat([out1.strand, out2.strand], dim=1), cat_is1],
        ))
        n_orph = (out1.t != -1).sum(dim=1) + (out2.t != -1).sum(dim=1)

    # ---- select concordant vs orphan per read -------------------------------
    c = concordant[:, None]
    t = torch.where(c, torch.where(cvalid, ct, -1), o_t)
    p1 = torch.where(c, cp1, torch.where(o_is1, o_p, 0))
    s1 = torch.where(c, cs1, torch.where(o_is1, o_s, 0))
    has1 = torch.where(c, cvalid, o_is1 & (o_t != -1))
    p2 = torch.where(c, cp2, torch.where(~o_is1, o_p, 0))
    s2 = torch.where(c, cs2, torch.where(~o_is1, o_s, 0))
    has2 = torch.where(c, cvalid, ~o_is1 & (o_t != -1))

    # mates that were individually too-ambiguous already arrive blanked (t=-1),
    # so they simply contribute no entries here — matching the oracle.
    n_rec = torch.where(concordant, n_pairs, n_orph)
    too_amb = n_rec > cfg.max_num_hits
    blank = too_amb[:, None]
    return PairOut(
        t=torch.where(blank, -1, t), p1=p1, s1=s1, has1=has1 & ~blank,
        p2=p2, s2=s2, has2=has2 & ~blank,
        concordant=concordant & ~too_amb,
        n_records=n_rec,
        too_ambiguous=too_amb,
        any_record=(n_rec >= 1) & ~too_amb,
        out_truncated=(n_rec > MO) & ~too_amb,
    )
