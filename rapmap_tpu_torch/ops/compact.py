"""Device-side record compaction: pack sparse per-read mapping slots into a
dense record buffer before the device->host transfer.

Port of rapmap_tpu.ops.compact. The (B, MAX_OUT) MapOut and PairOut layouts
are mostly empty (-1) slots; one cumsum + scatter packs the valid records
row-major, so the host SAM writer walks a dense array. `rid_from_counts` and
the score fields come with the mapping-score engine."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SERecords(NamedTuple):
    recs: torch.Tensor       # (cap, W) int32: t, pos, strand, score (row-major
    #                          by read), or 2 packed words per wire.RecSpec
    counts: torch.Tensor     # (B,) records per read
    total: torch.Tensor      # scalar
    overflowed: torch.Tensor  # scalar bool — cap exceeded, tail dropped


class PERecords(NamedTuple):
    recs: torch.Tensor       # (cap, W) int32: t, p1, s1, has1, p2, s2, has2,
    #                          or 2 packed words per wire.RecSpec
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


def compact_pe(po, cap: int, rec_spec=None) -> PERecords:
    """pairs.PairOut -> PERecords; with rec_spec the rows pack into 2 words."""
    fields = [po.t, po.p1, po.s1, po.has1.to(torch.int32), po.p2, po.s2,
              po.has2.to(torch.int32)]
    if rec_spec is not None:
        from rapmap_tpu_torch.ops.wire import pack_rec_fields

        # t = -1 on empty slots would wreck the unsigned packing; the rows
        # are dropped by the valid mask anyway, so clamp them to 0 first
        fields[0] = fields[0].clamp(min=0)
        fields = list(pack_rec_fields(rec_spec, fields))
    recs, counts, total, ovf = _compact(fields, po.t != -1, cap)
    return PERecords(recs, counts, total, ovf)
