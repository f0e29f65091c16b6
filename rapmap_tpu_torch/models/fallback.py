"""Host-side oracle remap of budget-degraded reads.

Port of rapmap_tpu.models.fallback. Static device budgets
(expansion pool, hit buffers, record caps) can truncate results for
pathological reads — heavy multimappers on repetitive transcriptomes. Instead
of silently degrading, the command line remaps EXACTLY the reads whose wire
flags carry FLAG_DEGRADED with the numpy oracle (the executable spec,
SEMANTICS.md) and splices the corrected records into the dense batch output. Budgets
auto-size from index stats so this stays rare; correctness never depends on
the budget. Under --mappingScore a remapped record carries its banded
alignment score (oracle.align, equal to the device kernel's) where it
would carry the MMP support, and a pair record one score a mate.
"""

from __future__ import annotations

import numpy as np

from rapmap_tpu_torch.ops.wire import FLAG_DEGRADED, FLAG_MAPPED, WireResult
from rapmap_tpu_torch.utils.timers import span


def _splice(recsd: WireResult, n: int, new_rows: dict[int, np.ndarray]) -> WireResult:
    """Replace flagged reads' record runs inside the dense row-major buffer."""
    counts = np.asarray(recsd.counts).astype(np.int64)
    offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    recs = np.asarray(recsd.recs)
    parts = []
    new_counts = counts.copy()
    prev = 0
    for i in sorted(new_rows):
        parts.append(recs[prev : offsets[i]])
        parts.append(new_rows[i])
        new_counts[i] = len(new_rows[i])
        prev = offsets[i + 1]
    parts.append(recs[prev:])
    out = np.concatenate(parts, axis=0) if parts else recs
    return recsd._replace(recs=out, counts=new_counts.astype(np.int32),
                          total=int(new_counts.sum()))


def _update_counters(recsd: WireResult, n: int, bad, mapped_after) -> None:
    ctr = recsd.counters
    mapped_before = (np.asarray(recsd.flags)[bad] & FLAG_MAPPED) != 0
    ctr["reads_mapped"] += int(mapped_after.sum()) - int(mapped_before.sum())
    ctr["records"] = int(np.asarray(recsd.counts)[:n].sum())
    ctr["host_fallback"] = ctr.get("host_fallback", 0) + len(bad)


def _rec_score(idx, cfg, rcodes, t, pos, fwd, support) -> int:
    """Record score field: MMP support normally; the banded alignment score
    (oracle.align — identical to the device kernel) under --mappingScore."""
    if not getattr(cfg, "mapping_score", False):
        return support
    from rapmap_tpu_torch.oracle.align import score_mapping_np

    return score_mapping_np(
        idx, rcodes, int(t), int(pos), 0 if fwd else 1, cfg.align_band,
        cfg.align_ma, cfg.align_mp, cfg.align_go, cfg.align_ge,
    )


def remap_se(recsd: WireResult, codes, lens, n: int, idx, cfg, oracle) -> WireResult:
    """Re-resolve FLAG_DEGRADED single-end reads with oracle.map_read; the
    record score field is the MMP support, or the alignment score."""
    with span("tqm.fallback"):
        return _remap_se(recsd, codes, lens, n, idx, cfg, oracle)


def _remap_se(recsd: WireResult, codes, lens, n: int, idx, cfg, oracle) -> WireResult:
    flags = np.asarray(recsd.flags)
    bad = np.flatnonzero((flags[:n] & FLAG_DEGRADED) != 0)
    if bad.size == 0:
        return recsd
    new_rows: dict[int, np.ndarray] = {}
    mapped_after = np.zeros(len(bad), bool)
    for j, i in enumerate(bad):
        rcodes = np.asarray(codes[i][: lens[i]])
        ms = oracle.map_read(idx, rcodes, cfg)
        if len(ms) > cfg.max_num_hits:
            ms = []
        new_rows[int(i)] = np.array(
            [[m.txp, m.pos, 0 if m.fwd else 1,
              _rec_score(idx, cfg, rcodes, m.txp, m.pos, m.fwd, m.score)]
             for m in ms], np.int32
        ).reshape(-1, 4)
        mapped_after[j] = bool(ms)
    recsd = _splice(recsd, n, new_rows)
    _update_counters(recsd, n, bad, mapped_after)
    return recsd


def remap_pe(recsd: WireResult, c1, l1, c2, l2, n: int, idx, cfg, oracle) -> WireResult:
    """Re-resolve FLAG_DEGRADED pairs with oracle.map_pair; rows are
    (t, p1, s1, has1, p2, s2, has2), a missing mate's fields 0, plus the
    per-mate scores (sc1, sc2; 0 for a missing mate) under --mappingScore."""
    with span("tqm.fallback"):
        return _remap_pe(recsd, c1, l1, c2, l2, n, idx, cfg, oracle)


def _remap_pe(recsd: WireResult, c1, l1, c2, l2, n: int, idx, cfg, oracle) -> WireResult:
    flags = np.asarray(recsd.flags)
    bad = np.flatnonzero((flags[:n] & FLAG_DEGRADED) != 0)
    if bad.size == 0:
        return recsd
    new_rows: dict[int, np.ndarray] = {}
    mapped_after = np.zeros(len(bad), bool)
    W = 9 if getattr(cfg, "mapping_score", False) else 7
    for j, i in enumerate(bad):
        r1 = np.asarray(c1[i][: l1[i]])
        r2 = np.asarray(c2[i][: l2[i]])
        ms, _ = oracle.map_pair(idx, r1, r2, cfg)
        rows = []
        for m in ms:
            row = [m.txp,
                   m.pos1 if m.pos1 is not None else 0, 0 if m.fwd1 else 1, int(m.pos1 is not None),
                   m.pos2 if m.pos2 is not None else 0, 0 if m.fwd2 else 1, int(m.pos2 is not None)]
            if W == 9:
                row.append(_rec_score(idx, cfg, r1, m.txp, m.pos1, m.fwd1, 0)
                           if m.pos1 is not None else 0)
                row.append(_rec_score(idx, cfg, r2, m.txp, m.pos2, m.fwd2, 0)
                           if m.pos2 is not None else 0)
            rows.append(row)
        new_rows[int(i)] = np.array(rows, np.int32).reshape(-1, W)
        mapped_after[j] = bool(ms)
    recsd = _splice(recsd, n, new_rows)
    _update_counters(recsd, n, bad, mapped_after)
    return recsd
