"""Numpy pseudo-mapping oracle (SEMANTICS.md §7) — spec for the pseudo engine.

Copy of rapmap_tpu.oracle.pseudomap with this package's imports: the spec of
the port's pseudo path and the host-oracle fallback's remap of its degraded
reads.
"""

from __future__ import annotations

import numpy as np

from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.encode import revcomp_codes
from rapmap_tpu_torch.index.format import PseudoIndex
from rapmap_tpu_torch.oracle.quasimap import Mapping, SAHit, merge_pairs


def _lookup(idx: PseudoIndex, key: int) -> tuple[int, int] | None:
    from rapmap_tpu_torch.oracle.quasimap import _KEY64_CACHE_MAX

    if len(idx.kmer_hi) > _KEY64_CACHE_MAX:
        # genome-scale CSR: probe the sorted (hi, lo) columns directly —
        # the combined-key cache costs 8 B/key (see quasimap._lookup)
        hi = np.uint32(key >> 32)
        lo = np.uint32(key & 0xFFFFFFFF)
        i0 = int(np.searchsorted(idx.kmer_hi, hi, side="left"))
        i1 = int(np.searchsorted(idx.kmer_hi, hi, side="right"))
        if i0 == i1:
            return None
        j = i0 + int(np.searchsorted(idx.kmer_lo[i0:i1], lo))
        if j < i1 and idx.kmer_lo[j] == lo:
            return int(idx.kmer_off[j]), int(idx.kmer_off[j + 1])
        return None
    keys = getattr(idx, "_key64_cache", None)
    if keys is None or len(keys) != len(idx.kmer_hi):
        keys = (idx.kmer_hi.astype(np.uint64) << np.uint64(32)) | idx.kmer_lo.astype(
            np.uint64
        )
        object.__setattr__(idx, "_key64_cache", keys)
    i = int(np.searchsorted(keys, np.uint64(key)))
    if i < len(keys) and keys[i] == np.uint64(key):
        return int(idx.kmer_off[i]), int(idx.kmer_off[i + 1])
    return None


def scan_strand(idx: PseudoIndex, read: np.ndarray, cfg: MapConfig) -> list[SAHit]:
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
        hits.append(SAHit(q=pos, length=k, b=b, e=e))
        pos += k  # jump-ahead
    return hits


def collate(idx: PseudoIndex, hits_fwd, hits_rc, L: int, cfg: MapConfig) -> list[Mapping]:
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
                t = int(idx.occ_txp[p])
                tpos = int(idx.occ_pos[p]) - h.q
                support[(t, tpos)] = support.get((t, tpos), 0) + 1
        best: dict[int, tuple[int, int]] = {}
        for (t, tpos), s in support.items():
            cur = best.get(t)
            if cur is None or (s, -tpos) > (cur[0], -cur[1]):
                best[t] = (s, tpos)
        need = len(hits) - (1 if cfg.fuzzy else 0)
        for t, (s, tpos) in best.items():
            if cfg.consistent_hits and s < need:
                continue
            results.append(Mapping(txp=t, pos=tpos, fwd=fwd, score=s))
    results.sort(key=lambda m: (m.txp, not m.fwd))
    return results


def map_read(idx: PseudoIndex, read: np.ndarray, cfg: MapConfig | None = None) -> list[Mapping]:
    cfg = cfg or MapConfig(k=idx.k)
    read = np.asarray(read, dtype=np.int8)
    hits_fwd = scan_strand(idx, read, cfg)
    hits_rc = scan_strand(idx, revcomp_codes(read), cfg)
    mappings = collate(idx, hits_fwd, hits_rc, len(read), cfg)
    if len(mappings) > cfg.max_num_hits:
        return []
    return mappings


def map_pair(idx: PseudoIndex, read1, read2, cfg: MapConfig | None = None):
    cfg = cfg or MapConfig(k=idx.k)
    left = map_read(idx, read1, cfg)
    right = map_read(idx, read2, cfg)
    recs, conc = merge_pairs(left, right, cfg)
    if len(recs) > cfg.max_num_hits:
        return [], False
    return recs, conc
