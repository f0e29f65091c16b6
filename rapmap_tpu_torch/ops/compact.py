"""Device-side record compaction: pack sparse per-read mapping slots into a
dense record buffer before the device->host transfer.

Port of rapmap_tpu.ops.compact. The (B, MAX_OUT) MapOut and PairOut layouts
are mostly empty (-1) slots; one cumsum + scatter packs the valid records
row-major, so the host SAM writer walks a dense array. With the mapping
score on, `rid_from_counts` gives each dense row its read and the rows are
scored (ops.align) before they pack."""

from __future__ import annotations

from typing import NamedTuple

import torch


def rid_from_counts(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """(B,) per-read record counts -> (cap,) read id of each dense record row
    (rows past the written total get the last writing read; callers mask by
    row < total). Read ids scatter (max) at each read's start offset, reads
    without records and starts past the cap into a sink row, then a running
    max fills the runs — the slot-assignment trick of the collate pool."""
    B = counts.shape[0]
    dev = counts.device
    counts = counts.to(torch.int64)
    starts = torch.cumsum(counts, dim=0) - counts
    scat = torch.where(counts > 0, starts.clamp(max=cap), cap)
    buf = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    rid = buf.scatter_reduce_(0, scat, torch.arange(B, device=dev), "amax",
                              include_self=True)[:cap]
    rid = torch.cummax(rid, dim=0).values
    return rid.clamp(0, B - 1)


class SERecords(NamedTuple):
    recs: torch.Tensor       # (cap, W) int32: t, pos, strand, score (row-major
    #                          by read), or 2 packed words per wire.RecSpec
    counts: torch.Tensor     # (B,) records per read
    total: torch.Tensor      # scalar
    overflowed: torch.Tensor  # scalar bool — cap exceeded, tail dropped


class PERecords(NamedTuple):
    recs: torch.Tensor       # (cap, W) int32: t, p1, s1, has1, p2, s2, has2
    #                          (+ sc1, sc2 with the mapping score), or 2
    #                          packed words per wire.RecSpec
    counts: torch.Tensor
    total: torch.Tensor
    overflowed: torch.Tensor


def _compact(fields: list[torch.Tensor], valid: torch.Tensor, cap: int):
    """fields: (B, MO) each; valid: (B, MO) bool -> dense (cap, len(fields))."""
    fv = valid.reshape(-1)
    dest = torch.cumsum(fv, dim=0) - 1
    dest = torch.where(fv, dest.clamp(max=cap), cap)  # invalid/overflow -> row cap
    stacked = torch.stack([f.reshape(-1) for f in fields], dim=-1).to(torch.int32)
    buf = torch.zeros((cap + 1, len(fields)), dtype=torch.int32, device=fv.device)
    recs = buf.index_put_((dest,), stacked)[:cap]
    total = fv.sum()
    # clamp per-read counts to what was actually written, so host writers
    # walking recs by counts never index past the cap on overflow
    raw = valid.sum(dim=1)
    ends = torch.cumsum(raw, dim=0)
    counts = ends.clamp(max=cap) - (ends - raw).clamp(max=cap)
    return recs, counts, total, total > cap


def compact_se(out, cap: int) -> SERecords:
    """collate.MapOut -> SERecords."""
    recs, counts, total, ovf = _compact(
        [out.t, out.pos, out.strand, out.score], out.t != -1, cap
    )
    return SERecords(recs, counts, total, ovf)


def compact_pe(po, cap: int, rec_spec=None, score_args=None) -> PERecords:
    """pairs.PairOut -> PERecords; with rec_spec the rows pack into 2 words.
    score_args = (didx, cfg, reads1, lens1, reads2, lens2) appends per-mate
    alignment scores (cfg.mapping_score, SEMANTICS.md §9) as fields 7-8,
    computed on the compacted rows, both mates in one scoring pass."""
    fields = [po.t, po.p1, po.s1, po.has1.to(torch.int32), po.p2, po.s2,
              po.has2.to(torch.int32)]
    if score_args is not None and score_args[1].mapping_score:
        from rapmap_tpu_torch.ops.align import score_pe_rows

        didx, cfg, r1, l1, r2, l2 = score_args
        raw, counts, total, ovf = _compact(fields, po.t != -1, cap)
        rid = rid_from_counts(counts, cap)
        live = torch.arange(cap, device=raw.device) < total.clamp(max=cap)
        sc1, sc2 = score_pe_rows(didx, cfg, r1, l1, r2, l2, rid,
                                 *(raw[:, j] for j in range(7)), live)
        cols = [raw[:, j] for j in range(7)] + [sc1, sc2]
        if rec_spec is not None:
            from rapmap_tpu_torch.ops.wire import pack_rec_fields

            cols[0] = cols[0].clamp(min=0)
            cols = list(pack_rec_fields(rec_spec, cols))
        recs = torch.stack([c.to(torch.int32) for c in cols], dim=-1)
        return PERecords(recs, counts, total, ovf)
    if rec_spec is not None:
        from rapmap_tpu_torch.ops.wire import pack_rec_fields

        # t = -1 on empty slots would wreck the unsigned packing; the rows
        # are dropped by the valid mask anyway, so clamp them to 0 first
        fields[0] = fields[0].clamp(min=0)
        fields = list(pack_rec_fields(rec_spec, fields))
    recs, counts, total, ovf = _compact(fields, po.t != -1, cap)
    return PERecords(recs, counts, total, ovf)
