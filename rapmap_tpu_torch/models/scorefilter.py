"""Host-side --minScoreFraction record filter (SEMANTICS.md §9).

Copy of rapmap_tpu.models.scorefilter. With --mappingScore on, every
record carries a banded alignment score; a record is suppressed when its
score falls below ceil(F * ma * readLen) (per mate for pairs — a pair
record survives only if every present mate passes). A read whose every
record is suppressed is reported unmapped. Applied on the host after
fetch/fallback: the device computes scores, the filter is a cheap numpy
pass, and flags/counters are re-derived so the mapping-rate log and
--statsJson stay truthful.
"""

from __future__ import annotations

import math

import numpy as np

from rapmap_tpu_torch.ops.align import SCORE_BITS
from rapmap_tpu_torch.ops.wire import FLAG_MAPPED, WireResult

# Scores ride the wire clamped to SCORE_BITS; thresholds above the clamp would
# suppress even perfect alignments (ma * readLen > 4095), so clamp them too.
_SCORE_MAX = (1 << SCORE_BITS) - 1


def _thresholds(lens: np.ndarray, cfg) -> np.ndarray:
    f = float(cfg.min_score_fraction)
    ma = int(cfg.align_ma)
    thr = np.ceil(f * ma * np.asarray(lens, dtype=np.float64)).astype(np.int64)
    return np.minimum(thr, _SCORE_MAX)


def _apply(recsd: WireResult, keep: np.ndarray) -> WireResult:
    counts = np.asarray(recsd.counts, dtype=np.int64)
    B = len(counts)
    rid = np.repeat(np.arange(B), counts)
    new_counts = np.bincount(rid[keep], minlength=B).astype(counts.dtype)
    flags = np.asarray(recsd.flags).copy()
    newly_unmapped = (counts > 0) & (new_counts == 0)
    flags[newly_unmapped] &= ~FLAG_MAPPED
    ctr = dict(recsd.counters)
    ctr["reads_mapped"] = ctr.get("reads_mapped", 0) - int(newly_unmapped.sum())
    ctr["records"] = ctr.get("records", 0) - int((~keep).sum())
    ctr["score_filtered"] = ctr.get("score_filtered", 0) + int((~keep).sum())
    return recsd._replace(
        recs=recsd.recs[keep], counts=new_counts.astype(np.int32),
        flags=flags, total=int(keep.sum()), counters=ctr,
    )


def filter_se(recsd: WireResult, lens: np.ndarray, cfg) -> WireResult:
    """SE recs (N, 4) [t, pos, strand, score]."""
    if not cfg.mapping_score or cfg.min_score_fraction <= 0.0 or len(recsd.recs) == 0:
        return recsd
    counts = np.asarray(recsd.counts, dtype=np.int64)
    rid = np.repeat(np.arange(len(counts)), counts)
    thr = _thresholds(lens, cfg)[np.minimum(rid, len(lens) - 1)]
    keep = np.asarray(recsd.recs[:, 3], dtype=np.int64) >= thr
    return _apply(recsd, keep)


def filter_pe(recsd: WireResult, lens1: np.ndarray, lens2: np.ndarray, cfg) -> WireResult:
    """PE recs (N, 9) [t, p1, s1, has1, p2, s2, has2, sc1, sc2]."""
    if not cfg.mapping_score or cfg.min_score_fraction <= 0.0 or len(recsd.recs) == 0:
        return recsd
    counts = np.asarray(recsd.counts, dtype=np.int64)
    rid = np.repeat(np.arange(len(counts)), counts)
    r = recsd.recs
    t1 = _thresholds(lens1, cfg)[np.minimum(rid, len(lens1) - 1)]
    t2 = _thresholds(lens2, cfg)[np.minimum(rid, len(lens2) - 1)]
    ok1 = (r[:, 3] == 0) | (np.asarray(r[:, 7], dtype=np.int64) >= t1)
    ok2 = (r[:, 6] == 0) | (np.asarray(r[:, 8], dtype=np.int64) >= t2)
    return _apply(recsd, ok1 & ok2)


def min_score_of(cfg, read_len: int) -> int:
    """Threshold for one read (oracle/fallback paths), clamped to the wire max."""
    thr = int(math.ceil(float(cfg.min_score_fraction) * cfg.align_ma * read_len))
    return min(thr, _SCORE_MAX)
