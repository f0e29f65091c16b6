"""Numpy brute-force quasi-mapping oracle — the executable spec (SEMANTICS.md).

Copy of rapmap_tpu.oracle.quasimap on this package's QuasiIndex; the host
fallback (models.fallback) calls it. Every device path must agree with this
module exactly. Deliberately simple and
slow; used by tests and by the parity harness. Mirrors the reference call stack
SACollector -> HitManager -> mergeLeftRightHits (SURVEY.md §3.2-3.4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.encode import revcomp_codes
from rapmap_tpu_torch.index.format import QuasiIndex


@dataclass
class SAHit:
    q: int       # query pos (in the scanned strand's coordinates)
    length: int  # MMP length
    b: int
    e: int


@dataclass
class Mapping:
    txp: int
    pos: int       # transcript-local leftmost position (may be <0 / overhang)
    fwd: bool
    score: int     # support = agreeing MMP count


def _key64(idx: QuasiIndex) -> np.ndarray:
    """Combined (hi << 32 | lo) sorted key array, built once per index object
    (rebuilding it per probe made the oracle ~2700x slower on a 20 Mbase
    index — 27 s/read — which also starved the over_budget host fallback)."""
    keys = getattr(idx, "_key64_cache", None)
    if keys is None or len(keys) != len(idx.kmer_hi):
        keys = (idx.kmer_hi.astype(np.uint64) << np.uint64(32)) | idx.kmer_lo.astype(
            np.uint64
        )
        object.__setattr__(idx, "_key64_cache", keys)
    return keys


_KEY64_CACHE_MAX = 1 << 28  # past this, the 8 B/key cache is a memory bomb


def _lookup(idx: QuasiIndex, key: int) -> tuple[int, int] | None:
    if len(idx.kmer_hi) > _KEY64_CACHE_MAX:
        # genome-scale tables (2e9+ keys, usually mmap'd): materializing the
        # combined key array costs ~18 GB (+ a ~3x evaluation peak — it
        # OOM-killed the 2.2 Gbase oracle-parity pass at 130 GB anon RSS).
        # The table is sorted by (hi, lo), so probe the columns directly:
        # hi-run by two searchsorteds, then lo within the run — ~60 touched
        # pages per probe, zero allocation.
        hi = np.uint32(key >> 32)
        lo = np.uint32(key & 0xFFFFFFFF)
        i0 = int(np.searchsorted(idx.kmer_hi, hi, side="left"))
        i1 = int(np.searchsorted(idx.kmer_hi, hi, side="right"))
        if i0 == i1:
            return None
        j = i0 + int(np.searchsorted(idx.kmer_lo[i0:i1], lo))
        if j < i1 and idx.kmer_lo[j] == lo:
            return int(idx.kmer_b[j]), int(idx.kmer_e[j])
        return None
    keys = _key64(idx)
    i = int(np.searchsorted(keys, np.uint64(key)))
    if i < len(keys) and keys[i] == np.uint64(key):
        return int(idx.kmer_b[i]), int(idx.kmer_e[i])
    return None


def _extend(idx: QuasiIndex, b: int, e: int, read: np.ndarray, pos: int, k: int) -> tuple[int, int, int]:
    """Per-depth narrowing (SEMANTICS.md §3 extend). Returns (b', e', mmp_len)."""
    text = idx.text
    sa = idx.sa  # int32 or int64; slice arithmetic upcasts as needed
    L = len(read)
    d = k
    while pos + d < L:
        c = int(read[pos + d])
        if c < 1 or c > 4:
            break
        col = text[sa[b:e] + d]  # non-decreasing within the current group
        lo = b + int(np.searchsorted(col, c, side="left"))
        hi = b + int(np.searchsorted(col, c, side="right"))
        if lo == hi:
            break
        b, e, d = lo, hi, d + 1
    return b, e, d


def scan_strand(idx: QuasiIndex, read: np.ndarray, cfg: MapConfig) -> list[SAHit]:
    """The SACollector loop: MMP search with NIP skipping (SEMANTICS.md §3)."""
    k = idx.k
    L = len(read)
    hits: list[SAHit] = []
    pos = 0
    while pos + k <= L:
        window = read[pos : pos + k]
        bad = np.nonzero((window < 1) | (window > 4))[0]
        if len(bad):
            pos = pos + int(bad[0]) + 1
            continue
        key = 0
        for c in window:
            key = (key << 2) | (int(c) - 1)
        iv = _lookup(idx, key)
        if iv is None:
            pos += 1
            continue
        b, e = iv
        if e - b > cfg.max_interval:
            pos += 1
            continue
        b2, e2, mlen = _extend(idx, b, e, read, pos, k)
        hits.append(SAHit(q=pos, length=mlen, b=b2, e=e2))
        pos += max(1, mlen - k + 1)
    return hits


def collate(idx: QuasiIndex, hits_fwd: list[SAHit], hits_rc: list[SAHit], L: int, cfg: MapConfig) -> list[Mapping]:
    """HitManager role: SA intervals -> per-transcript mappings (SEMANTICS.md §4)."""
    sa = idx.sa
    results: list[Mapping] = []
    if cfg.quasi_coverage > 0.0:
        if sum(h.length for h in hits_fwd) < cfg.quasi_coverage * L:
            hits_fwd = []
        if sum(h.length for h in hits_rc) < cfg.quasi_coverage * L:
            hits_rc = []
    for fwd, hits in ((True, hits_fwd), (False, hits_rc)):
        if not hits:
            continue
        support: dict[tuple[int, int], int] = {}
        for h in hits:
            for p in range(h.b, h.e):
                g = int(sa[p])
                t = int(idx.sa_txp[p])
                tpos = g - int(idx.txp_offsets[t]) - h.q
                support[(t, tpos)] = support.get((t, tpos), 0) + 1
        # per transcript: best position = max support, ties -> smallest tpos
        best: dict[int, tuple[int, int]] = {}  # t -> (score, tpos)
        for (t, tpos), s in support.items():
            cur = best.get(t)
            if cur is None or (s, -tpos) > (cur[0], -cur[1]):
                best[t] = (s, tpos)
        need = len(hits) - (1 if cfg.fuzzy else 0)
        for t, (s, tpos) in best.items():
            if cfg.consistent_hits and s < need:
                continue
            results.append(Mapping(txp=t, pos=tpos, fwd=fwd, score=s))
    if cfg.strict_check and results:
        # orientation-bias curb (SEMANTICS.md §3): drop the weaker strand
        m_fwd = max((m.score for m in results if m.fwd), default=0)
        m_rc = max((m.score for m in results if not m.fwd), default=0)
        best_s = max(m_fwd, m_rc)
        results = [m for m in results if (m_fwd if m.fwd else m_rc) == best_s]
    results.sort(key=lambda m: (m.txp, not m.fwd))
    return results


def map_read(idx: QuasiIndex, read: np.ndarray, cfg: MapConfig | None = None) -> list[Mapping]:
    """Map a single-end read (int8 codes). Returns [] if unmapped or too ambiguous."""
    cfg = cfg or MapConfig(k=idx.k)
    read = np.asarray(read, dtype=np.int8)
    hits_fwd = scan_strand(idx, read, cfg)
    hits_rc = scan_strand(idx, revcomp_codes(read), cfg)
    mappings = collate(idx, hits_fwd, hits_rc, len(read), cfg)
    if len(mappings) > cfg.max_num_hits:
        return []  # too ambiguous (counted by callers)
    return mappings


@dataclass
class PairMapping:
    txp: int
    pos1: int | None  # None => this mate unmapped (orphan record on other side)
    fwd1: bool
    pos2: int | None
    fwd2: bool


def merge_pairs(
    left: list[Mapping], right: list[Mapping], cfg: MapConfig
) -> tuple[list[PairMapping], bool]:
    """mergeLeftRightHits role (SEMANTICS.md §5). Returns (records, concordant)."""
    pairs: list[PairMapping] = []
    by_t_right: dict[int, list[Mapping]] = {}
    for m in right:
        by_t_right.setdefault(m.txp, []).append(m)
    for ml in left:
        for mr in by_t_right.get(ml.txp, []):
            if ml.fwd == mr.fwd:
                continue
            # [REF-VERIFY] optional fidelity constraints (config.py notes)
            if cfg.max_frag_len and abs(ml.pos - mr.pos) > cfg.max_frag_len:
                continue
            if cfg.pair_order:
                fwd_pos, rc_pos = (ml.pos, mr.pos) if ml.fwd else (mr.pos, ml.pos)
                if fwd_pos > rc_pos:
                    continue
            pairs.append(PairMapping(ml.txp, ml.pos, ml.fwd, mr.pos, mr.fwd))
    if pairs:
        pairs.sort(key=lambda p: (p.txp, not p.fwd1))
        return pairs, True
    if cfg.no_orphans:
        return [], False
    orphans = [PairMapping(m.txp, m.pos, m.fwd, None, True) for m in left]
    orphans += [PairMapping(m.txp, None, True, m.pos, m.fwd) for m in right]
    return orphans, False


def map_pair(
    idx: QuasiIndex, read1: np.ndarray, read2: np.ndarray, cfg: MapConfig | None = None
) -> tuple[list[PairMapping], bool]:
    cfg = cfg or MapConfig(k=idx.k)
    left = map_read(idx, read1, cfg)
    right = map_read(idx, read2, cfg)
    recs, conc = merge_pairs(left, right, cfg)
    if len(recs) > cfg.max_num_hits:
        return [], False
    return recs, conc
