"""Numpy oracle for the banded affine-gap mapping score (SEMANTICS.md §9).

Copy of rapmap_tpu.oracle.align on this package's QuasiIndex: a direct,
loop-per-cell Gotoh DP over the same band, the executable spec of
ops.align. The host fallback (models.fallback) scores its records with it
when --mappingScore is on, and chip_smoke.py recomputes sampled AS:i tags
with it. Scoring model matches the ksw2-era defaults of the reference
lineage (upstream:include/ksw2pp — STRETCH component, SURVEY.md §2.2).
"""

from __future__ import annotations

import numpy as np

NEG = -(1 << 20)


def banded_score_np(
    rcodes: np.ndarray,  # (l,) int read codes 0..3 (>=4 never matches)
    wcodes: np.ndarray,  # (l + 2*band,) int window codes (5 = invalid)
    band: int,
    ma: int, mp: int, go: int, ge: int,
) -> int:
    """Score of one read against one window; read end-to-end, window
    ends free. Explicit three-state Gotoh over the band (no prefix-max
    shortcut — independently validates the kernel's closed form)."""
    l = len(rcodes)
    Wb = 2 * band + 1
    assert len(wcodes) == l + 2 * band
    H = np.zeros(Wb, dtype=np.int64)
    E = np.full(Wb, NEG, dtype=np.int64)
    for i in range(1, l + 1):
        Hn = np.full(Wb, NEG, dtype=np.int64)
        En = np.full(Wb, NEG, dtype=np.int64)
        Fn = np.full(Wb, NEG, dtype=np.int64)
        r = int(rcodes[i - 1])
        for d in range(Wb):
            j = i + d  # window position (1-based)
            w = int(wcodes[j - 1])
            s = ma if (r == w and r <= 3) else mp
            best = H[d] + s  # diagonal (same d, previous row)
            if d + 1 < Wb:
                En[d] = max(H[d + 1] - go, E[d + 1] - ge)
                best = max(best, En[d])
            if d - 1 >= 0:
                Fn[d] = max(Hn[d - 1] - go, Fn[d - 1] - ge)
                best = max(best, Fn[d])
            Hn[d] = best
        H, E = Hn, En
    return int(H.max())


def score_mapping_np(
    idx,
    read_codes: np.ndarray,  # (l,) SEMANTICS codes 1..4 (5 = N) — FORWARD read
    t: int,
    pos: int,
    strand: int,
    band: int,
    ma: int, mp: int, go: int, ge: int,
    clamp_bits: int = 12,
) -> int:
    """Score one quasi-mapping against QuasiIndex `idx` (host arrays);
    mirrors ops.align.score_records row-for-row, including the rc
    orientation, out-of-transcript masking, and the wire clamp."""
    rc = np.asarray(read_codes, dtype=np.int64)
    if strand == 1:
        rc = np.where((rc >= 1) & (rc <= 4), 5 - rc, 5)[::-1]
    r03 = np.where((rc >= 1) & (rc <= 4), rc - 1, 4)
    l = len(r03)
    off = int(np.asarray(idx.txp_offsets)[t])
    tlen = int(np.asarray(idx.txp_lens)[t])
    text = np.asarray(idx.text)
    W = l + 2 * band
    p = pos - band + np.arange(W)
    g = off + np.clip(p, 0, max(tlen - 1, 0))
    w = np.asarray(text[np.clip(g, 0, len(text) - 1)], dtype=np.int64) - 1
    w = np.where((p >= 0) & (p < tlen), w, 5)
    sc = banded_score_np(r03, w, band, ma, mp, go, ge)
    return int(min(max(sc, 0), (1 << clamp_bits) - 1))
