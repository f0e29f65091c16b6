"""Host-side oracle remap of budget-degraded reads.

Port of rapmap_tpu.models.fallback (single-end). Static device budgets
(expansion pool, hit buffers, record caps) can truncate results for
pathological reads — heavy multimappers on repetitive transcriptomes. Instead
of silently degrading, the command line remaps EXACTLY the reads whose wire
flags carry FLAG_DEGRADED with the numpy oracle (the executable spec,
SEMANTICS.md) and splices the corrected records into the dense batch output. Budgets
auto-size from index stats so this stays rare; correctness never depends on
the budget. `remap_pe` and the alignment-score branch of the record score
come with the paired-end and mapping-score engines.
"""

from __future__ import annotations

import numpy as np

from rapmap_tpu_torch.ops.wire import FLAG_DEGRADED, FLAG_MAPPED, WireResult


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


def remap_se(recsd: WireResult, codes, lens, n: int, idx, cfg, oracle) -> WireResult:
    """Re-resolve FLAG_DEGRADED single-end reads with oracle.map_read; the
    record score field is the MMP support."""
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
            [[m.txp, m.pos, 0 if m.fwd else 1, m.score] for m in ms], np.int32
        ).reshape(-1, 4)
        mapped_after[j] = bool(ms)
    recsd = _splice(recsd, n, new_rows)
    _update_counters(recsd, n, bad, mapped_after)
    return recsd
