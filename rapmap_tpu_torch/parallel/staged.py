"""Host-staged sharded quasi-mapping for indexes past one card's memory.

Port of rapmap_tpu.parallel.staged. The index is cut at prefix boundaries
into shards, and each shard visits the card ONCE per group of queued read
batches:

  stage A (device, per shard): dense per-lane k-mer lookups over the shard's
      local sorted table (the prefix-LUT binary search of ops.lookup), then
      the anchor-parallel packed extension of the shard's anchors
      (ops.extend_packed.extend_anchors: csrc/walk.cu's
      tqm_extend_packed_lanes on the card), compacted to (src, mlen, b, e).
      Each window's k-mer lives in exactly one shard, so the partials union
      on the host by position, after the shard has left the card.
  stage B (host, numpy): the NIP walk over the unioned dense anchor/mlen
      maps (`walk_hits_np`), which reconstructs exactly the anchors the
      reference's serial loop visits (SEMANTICS.md §3).
  stage C (host, numpy): interval expansion through the host's
      sa_txp/sa_tpos, the vote and the flag surface (-c/-f/-s/-z,
      `collate_np`), the pair merge (the oracle's `merge_pairs`) and the
      banded alignment score (`score_mappings_np`).

The anchor-parallel extension extends windows the walk would skip (the cost
of one visit a shard); the visited subset and every result are bit-identical
to the replicated engine and the oracle. The numpy host halves are copies of
the reference's, which lives in a module that imports JAX.

On the card, a shard's arrays go up as row slices copied into one
preallocated tensor each (`_chunked_upload`, TQM_STAGED_XFER_MB a slice).
With `upload_overlap` the next shard goes up on a side CUDA stream from
pinned host memory while the current one runs; its tensors are marked as
used on the mapping stream (`record_stream`), so no block is reused while a
copy or kernel may still touch it, and at most two shards are resident.
"""

from __future__ import annotations

import logging
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import QuasiIndex
from rapmap_tpu_torch.ops.device_index import (
    SA_CMP_WORDS, DeviceQuasiIndex, EngineStatic, sa_cmp_rows,
)

log = logging.getLogger("tqm.staged")

# bytes of one host-to-device copy when a shard goes up (TQM_STAGED_XFER_MB;
# the tests force it tiny so that every shard array goes up in pieces)
_MAX_XFER = int(os.environ.get("TQM_STAGED_XFER_MB", "256")) << 20

# Per-shard local occurrence offsets ride int32 on the device: a pseudo
# shard's occurrence span must stay below this (a module constant so that
# the occurrence-skew re-cut of staged_geometry_pseudo is testable small).
_S_PAD_LIMIT = 2**31

_TORCH_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool}


def _chunked_upload(arr: np.ndarray, device, pinned: list | None = None) -> torch.Tensor:
    """`arr` as a tensor on `device`: row slices of at most _MAX_XFER bytes
    copied into one preallocated tensor (no concatenate, no second copy).
    With `pinned` (a list the caller keeps until the copies are done) each
    slice is staged in pinned host memory and copied without blocking on the
    current stream."""
    a = np.ascontiguousarray(arr)
    out = torch.empty(a.shape, dtype=_TORCH_DTYPES[a.dtype], device=device)
    step = max(1, _MAX_XFER // max(1, a.nbytes // len(a)))
    for i in range(0, len(a), step):
        part = a[i : i + step]
        src = torch.from_numpy(part if part.flags.writeable else part.copy())
        if pinned is not None:
            src = src.pin_memory()
            pinned.append(src)
            out[i : i + step].copy_(src, non_blocking=True)
        else:
            out[i : i + step].copy_(src)
    return out


class StagedGeometry(NamedTuple):
    row_cuts: list[int]   # k-mer table row ranges per shard
    slot_cuts: list[int]  # SA slot ranges per shard (prefix-aligned)
    K_pad: int
    S_pad: int
    lookup_steps: int     # max over shards (one step bound serves all)
    prefix_bases: int
    max_interval_idx: int


def staged_geometry(idx: QuasiIndex, n_shards: int) -> StagedGeometry:
    """Prefix-boundary cuts (as parallel/sharded.py): every k-mer's interval
    — and anything extension narrows it to — lies wholly inside one shard."""
    lut = np.asarray(idx.prefix_lut, dtype=np.int64)
    kb = np.asarray(idx.kmer_b)
    K = len(kb)
    n = len(idx.sa)
    targets = [round(i * K / n_shards) for i in range(n_shards + 1)]
    pv = [int(np.searchsorted(lut, t, side="left")) for t in targets]
    pv[0], pv[-1] = 0, len(lut) - 1
    row_cuts = [int(lut[v]) for v in pv]
    slot_cuts = [int(kb[r]) if r < K else n for r in row_cuts]
    slot_cuts[0], slot_cuts[-1] = 0, n
    K_pad = max(row_cuts[i + 1] - row_cuts[i] for i in range(n_shards)) or 1
    S_pad = max(slot_cuts[i + 1] - slot_cuts[i] for i in range(n_shards)) or 1
    # per-shard local prefix LUTs share one step bound (max local bucket)
    lut_d = np.diff(lut)
    steps = max(1, int(math.ceil(math.log2(int(lut_d.max()) + 1))) + 1) if len(lut_d) else 1
    # mapping-only artifacts store interval widths (uint32); the full index
    # derives them from the two slot columns
    w = getattr(idx, "kmer_w", None)
    widths = np.asarray(w) if w is not None else (
        np.asarray(idx.kmer_e) - np.asarray(idx.kmer_b)
    )
    max_w = int(widths.max()) if len(widths) else 1
    return StagedGeometry(row_cuts, slot_cuts, K_pad, S_pad, steps, idx.prefix_bases, max_w)


def shard_device_arrays(idx: QuasiIndex, geo: StagedGeometry, p: int):
    """Shard p's device arrays, as numpy (the caller uploads and frees them
    shard by shard) -> (DeviceQuasiIndex of numpy arrays, EngineStatic, s0).

    The k-mer table slice keeps LOCAL int32 interval slots; sa_cmp rows are
    derived for the slice only. text2q is a 1-row placeholder: a compare
    never reads past the fused sa_cmp words when L <= k + 16 SA_CMP_WORDS,
    which the staged mapper enforces and ops.extend_packed.extend_anchors
    checks. All widening to int64 happens here, before any offset
    arithmetic (a mapping-only artifact stores sa and kmer_b as uint32)."""
    from rapmap_tpu_torch.index.kmer_table import build_prefix_lut

    r0, r1 = geo.row_cuts[p], geo.row_cuts[p + 1]
    s0, s1 = geo.slot_cuts[p], geo.slot_cuts[p + 1]
    khi = np.asarray(idx.kmer_hi[r0:r1], dtype=np.uint32)
    klo = np.asarray(idx.kmer_lo[r0:r1], dtype=np.uint32)
    kb = (np.asarray(idx.kmer_b[r0:r1], dtype=np.int64) - s0).astype(np.int32)
    ke = (np.asarray(idx.kmer_e[r0:r1], dtype=np.int64) - s0).astype(np.int32)
    kmer_rows = np.zeros((geo.K_pad, 4), np.int32)
    kmer_rows[: r1 - r0, 0] = khi.view(np.int32)
    kmer_rows[: r1 - r0, 1] = klo.view(np.int32)
    kmer_rows[: r1 - r0, 2] = kb
    kmer_rows[: r1 - r0, 3] = ke
    # pad rows: all-ones keys (> any real key), empty intervals — filled
    # unconditionally so an EMPTY shard (possible with duplicate prefix-
    # boundary cuts) rejects probes by key mismatch rather than depending on
    # the all-zero local LUT collapsing every probe to lo == hi
    kmer_rows[r1 - r0 :, 0] = -1
    kmer_rows[r1 - r0 :, 1] = -1
    lut = build_prefix_lut(khi, klo, idx.k, geo.prefix_bases).astype(np.int64)
    lut_rows = np.stack([lut[:-1], lut[1:]], axis=1).astype(np.int32)
    sa_sl = np.asarray(idx.sa[s0:s1], dtype=np.int64)
    sa_txp = np.asarray(idx.sa_txp[s0:s1], dtype=np.int64)
    off = np.asarray(idx.txp_offsets, dtype=np.int64)
    tl = np.asarray(idx.txp_lens, dtype=np.int64)
    tend = off[sa_txp] + tl[sa_txp]
    cmp_rows = sa_cmp_rows(sa_sl, tend, idx.k, np.asarray(idx.text2b, dtype=np.uint32))
    if len(cmp_rows) < geo.S_pad:
        pad = np.zeros((geo.S_pad - len(cmp_rows), cmp_rows.shape[1]), np.int32)
        cmp_rows = np.concatenate([cmp_rows, pad])
    didx = DeviceQuasiIndex(
        text2q=np.zeros((1, 4), np.int32),
        sa_meta=np.zeros((1, 2), np.int32),  # expansion happens on the host
        sa_cmp=cmp_rows,
        kmer_rows=kmer_rows,
        lut_rows=lut_rows,
    )
    st = EngineStatic(
        k=idx.k, prefix_bases=geo.prefix_bases, lookup_steps=geo.lookup_steps,
        pad_tail=len(idx.text) - idx.n_text, max_interval_idx=geo.max_interval_idx,
        n_txps=int(idx.n_txps), use_chd=False,
    )
    return didx, st, s0


def _dense_anchors(didx, st: EngineStatic, cfg: MapConfig, lanes, lens2, A_max: int):
    """Stage A's dense phase and compaction: packed words, keys, the local
    probe, the anchor mask, then the mask's positions compacted into A_max
    slots by a cumulative sum and a scatter with a sink row ->
    (preads, next_bad, live, src, db, de, n_anch); src is lane * S + pos on
    live slots."""
    from rapmap_tpu_torch.ops import encode as denc
    from rapmap_tpu_torch.ops.extend_packed import pack_reads
    from rapmap_tpu_torch.ops.lookup import kmer_lookup

    R, L = lanes.shape
    k = st.k
    S = L - k + 1
    dev = lanes.device
    next_bad = denc.next_bad_batch(lanes, L)
    preads = pack_reads(lanes)
    key_hi, key_lo, kvalid = denc.kmer_keys_from_packed(preads, next_bad, k, S)
    found, db, de = kmer_lookup(didx, st, key_hi, key_lo)
    s_ix = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    anch = found & kvalid & ((s_ix + k) <= lens2[:, None]) & ((de - db) <= cfg.max_interval)
    flat = anch.reshape(-1)
    ia = torch.cumsum(flat.to(torch.int64), 0) - 1
    n_anch = ia[-1] + 1
    dest = torch.where(flat, ia.clamp(max=A_max - 1), A_max)
    src = torch.zeros(A_max + 1, dtype=torch.int64, device=dev).scatter_(
        0, dest, torch.arange(R * S, dtype=torch.int64, device=dev))[:A_max]
    live = torch.arange(A_max, device=dev) < torch.clamp(n_anch, max=A_max)
    return preads, next_bad, live, src, db.reshape(-1), de.reshape(-1), n_anch


def stage_a(didx, st: EngineStatic, cfg: MapConfig, lanes, lens2, A_max: int):
    """One shard's stage A on (2C, L) int8 lanes and their (2C,) lengths ->
    (src, mlen, b1, e1 (A_max,) int64, n_anch): the shard's anchors
    COMPACTED, src holding flat lane * S + pos (2C * S on dead slots) and b1,
    e1 the extended intervals in LOCAL slots; the host scatters them into
    its dense union maps. When n_anch > A_max the slots are clamped and the
    caller reruns at the full width."""
    from rapmap_tpu_torch.ops.extend_packed import extend_anchors

    R, L = lanes.shape
    k = st.k
    S = L - k + 1
    eff_w = min(cfg.max_interval, st.max_interval_idx)
    ext_steps = max(1, math.ceil(math.log2(eff_w + 1)) + 1)
    preads, next_bad, live, src, db, de, n_anch = _dense_anchors(
        didx, st, cfg, lanes, lens2, A_max)
    lane = torch.where(live, src // S, R).clamp(0, R - 1)
    pos = torch.where(live, src % S, 0)
    srcc = src.clamp(0, R * S - 1)
    b1, e1, mlen = extend_anchors(
        didx, preads, next_bad, lens2, torch.where(live, db[srcc], 0),
        torch.where(live, de[srcc], 0), pos, live, lane, k=k, ext_steps=ext_steps)
    return (torch.where(live, lane * S + pos, R * S), torch.where(live, mlen, 0),
            torch.where(live, b1, 0), torch.where(live, e1, 0), n_anch)


def stage_a_pseudo(didx, st: EngineStatic, cfg: MapConfig, lanes, lens2, A_max: int):
    """The pseudo stage A: the found windows compacted to the same sparse
    form as `stage_a` -> (src, b, e (A_max,) int64, n_anch), b/e LOCAL
    occurrence offsets; no extension."""
    R, L = lanes.shape
    S = L - st.k + 1
    _, _, live, src, db, de, n_anch = _dense_anchors(didx, st, cfg, lanes, lens2, A_max)
    srcc = src.clamp(0, R * S - 1)
    return (torch.where(live, src, R * S), torch.where(live, db[srcc], 0),
            torch.where(live, de[srcc], 0), n_anch)


def walk_hits_np(anch, mlen, k: int, S: int, H: int):
    """Host NIP walk over the unioned dense anchor/mlen maps.

    anch (R, S) bool, mlen (R, S) int32 -> (q (R, H), n (R,), trunc (R,))
    listing, per lane, the anchor positions the reference's serial loop
    visits (SEMANTICS.md §3): pos starts at the first anchor; each visit
    records, then jumps to the next anchor >= pos + max(1, mlen - k + 1)."""
    R = anch.shape[0]
    # next_anchor[l, s] = smallest anchor position >= s (else S)
    na = np.where(anch, np.arange(S, dtype=np.int32)[None, :], S)
    na = np.minimum.accumulate(na[:, ::-1], axis=1)[:, ::-1]
    na = np.concatenate([na, np.full((R, 1), S, np.int32)], axis=1)  # pos S -> S
    q = np.zeros((R, H), np.int32)
    n = np.zeros(R, np.int32)
    trunc = np.zeros(R, bool)
    pos = na[:, 0].copy()
    lanes = np.arange(R)
    while True:
        act = (pos < S) & ~trunc
        if not act.any():
            break
        overflow = act & (n >= H)
        trunc |= overflow
        write = act & ~overflow
        q[lanes[write], n[write]] = pos[write]
        n[write] += 1
        m = mlen[lanes, np.clip(pos, 0, S - 1)]
        nxt = np.clip(pos + np.maximum(1, m - k + 1), 0, S)
        pos = np.where(write, na[lanes, nxt], pos)
    return q, n, trunc


def _rc_lanes(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Length-aware reverse-complement lanes: row i holds revcomp of
    codes[i, :lens[i]] left-aligned (0 pad past the length) — per-row
    index.encode.revcomp_codes, vectorized."""
    B, L = codes.shape
    j = lens[:, None].astype(np.int64) - 1 - np.arange(L, dtype=np.int64)[None, :]
    g = codes[np.arange(B)[:, None], np.clip(j, 0, L - 1)]
    rc = np.where((g >= 1) & (g <= 4), 5 - g, 5)
    return np.where(j >= 0, rc, 0).astype(np.int8)


def collate_np(q, n, b, e, mlen_at, lens, sa_txp, sa_tpos, cfg: MapConfig):
    """SEMANTICS.md §4 collation in numpy (host expansion via the full
    sa_txp/sa_tpos arrays), covering the FULL flag surface: -z coverage,
    -c/-f consensus, -s strand curb. Returns (per-read lists [(t, tpos,
    strand, support)] in (t*2+strand) order, too_ambiguous flags)."""
    R, H = q.shape
    B = R // 2
    hv = np.arange(H)[None, :] < n[:, None]
    if cfg.quasi_coverage > 0.0:
        # -z: a strand-lane's VISITED MMP lengths must cover >= z * readLen
        # (oracle: sum(h.length) < z*L drops the strand). Exact f64 compare —
        # both sides are small-int-valued products, so this matches the
        # oracle's Python-float comparison bit for bit.
        cov = np.where(hv, mlen_at, 0).sum(axis=1).astype(np.float64)
        L2 = np.concatenate([lens, lens]).astype(np.float64)
        hv &= (cov >= cfg.quasi_coverage * L2)[:, None]
    w = np.where(hv, e - b, 0)
    flat_w = w.reshape(-1)
    tot = int(flat_w.sum())
    hit_read = np.tile(np.repeat(np.arange(B, dtype=np.int32), H), 2)
    hit_strand = np.repeat(np.array([0, 1], np.int32), B * H)
    starts = np.repeat(b.reshape(-1), flat_w)
    offs = np.arange(tot, dtype=np.int64) - np.repeat(
        np.cumsum(flat_w) - flat_w, flat_w
    )
    slots = starts + offs
    sq = np.repeat(q.reshape(-1), flat_w)
    sread = np.repeat(hit_read, flat_w)
    sstrand = np.repeat(hit_strand, flat_w)
    t = sa_txp[slots].astype(np.int64)
    tpos = sa_tpos[slots].astype(np.int64) - sq
    ts = t * 2 + sstrand
    order = np.lexsort((tpos, ts, sread))
    rs, tss, ps = sread[order], ts[order], tpos[order]
    newrun = np.concatenate([[True], (rs[1:] != rs[:-1]) | (tss[1:] != tss[:-1]) | (ps[1:] != ps[:-1])])
    rid = np.cumsum(newrun) - 1
    support = np.bincount(rid)
    rr, rts, rp = rs[newrun], tss[newrun], ps[newrun]
    # best per (read, ts): max support, tie -> smallest tpos
    o2 = np.lexsort((rp, -support, rts, rr))
    r2, ts2, p2, s2 = rr[o2], rts[o2], rp[o2], support[o2]
    grp = np.concatenate([[True], (r2[1:] != r2[:-1]) | (ts2[1:] != ts2[:-1])])
    wr, wts, wp, wsup = r2[grp], ts2[grp], p2[grp], s2[grp]
    ordw = np.lexsort((wts, wr))  # read-major, ts order (device/oracle order)
    wr, wts, wp, wsup = wr[ordw], wts[ordw], wp[ordw], wsup[ordw]
    keep = np.ones(len(wr), bool)
    if cfg.consistent_hits and len(wr):
        # -c: a mapping survives only with support >= (visited hits on its
        # strand) - fuzzy (oracle: need = len(hits) - fuzzy)
        lane = wr + (wts & 1).astype(wr.dtype) * B
        need = n[lane].astype(np.int64) - (1 if cfg.fuzzy else 0)
        keep &= wsup.astype(np.int64) >= need
    if cfg.strict_check and len(wr):
        # -s: keep only the strand(s) whose best surviving support equals the
        # read's overall best (oracle collate strand curb)
        key = (wr * 2 + (wts & 1)).astype(np.int64)
        smax = np.zeros(2 * B, np.int64)
        np.maximum.at(smax, key[keep], wsup[keep].astype(np.int64))
        best = np.maximum(smax[0::2], smax[1::2])
        keep &= smax[key] == best[wr]
    wr, wts, wp, wsup = wr[keep], wts[keep], wp[keep], wsup[keep]
    counts = np.bincount(wr, minlength=B)
    too_amb = counts > cfg.max_num_hits
    out = [[] for _ in range(B)]
    for r_, ts_, p_, su in zip(wr, wts, wp, wsup):
        if not too_amb[r_]:
            out[r_].append((int(ts_ // 2), int(p_), int(ts_ & 1), int(su)))
    return out, too_amb


# ---- host banded alignment scorer (SEMANTICS.md §9, --mappingScore) --------
# Batched transliteration of ops.align.banded_scores (same closed form:
# three-state Gotoh over the band, within-row F as an exclusive prefix-max,
# valid for go >= ge).

_NEG = -(1 << 20)


def _banded_scores_np(rcodes, rlens, wcodes, band, ma, mp, go, ge):
    N, L = rcodes.shape
    Wb = 2 * band + 1
    dge = (np.arange(Wb, dtype=np.int64) * ge)[None, :]
    H = np.zeros((N, Wb), np.int64)
    E = np.full((N, Wb), _NEG, np.int64)
    negc = np.full((N, 1), _NEG, np.int64)
    for i in range(L):
        r = rcodes[:, i : i + 1]
        w = wcodes[:, i : i + Wb]
        sub = np.where((w == r) & (r <= 3), ma, mp)
        Hs = np.concatenate([H[:, 1:], negc], axis=1)
        Es = np.concatenate([E[:, 1:], negc], axis=1)
        E2 = np.maximum(Hs - go, Es - ge)
        Hnf = np.maximum(H + sub, E2)
        a = Hnf + dge
        p = np.concatenate([negc, a[:, :-1]], axis=1)
        s = 1
        while s < Wb:
            p = np.maximum(
                p, np.concatenate([np.full((N, s), _NEG, np.int64), p[:, :-s]], axis=1)
            )
            s <<= 1
        F = p - dge - (go - ge)
        Hn = np.maximum(Hnf, F)
        act = (i < rlens)[:, None]
        H = np.where(act, Hn, H)
        E = np.where(act, E2, E)
    return H.max(axis=1)


def score_mappings_np(idx, cfg: MapConfig, codes, lens, rid, t, pos, strand):
    """AS:i scores of host-collated records — mirrors ops.align.score_records
    (window extraction, rc orientation, out-of-transcript masking, the wire
    clamp) against the host text arrays. -> (N,) int64 in [0, 2^12 - 1]."""
    from rapmap_tpu_torch.ops.align import SCORE_BITS

    N = len(t)
    if N == 0:
        return np.zeros(0, np.int64)
    band = cfg.align_band
    L = codes.shape[1]
    rc = _rc_lanes(codes, lens)
    rrow = np.where((strand == 1)[:, None], rc[rid], codes[rid]).astype(np.int64)
    r03 = np.where((rrow >= 1) & (rrow <= 4), rrow - 1, 4)
    off = np.asarray(idx.txp_offsets, dtype=np.int64)[t]
    tl = np.asarray(idx.txp_lens, dtype=np.int64)[t]
    W = L + 2 * band
    p = (np.asarray(pos, np.int64) - band)[:, None] + np.arange(W, dtype=np.int64)[None, :]
    g = off[:, None] + np.clip(p, 0, np.maximum(tl - 1, 0)[:, None])
    text = idx.text
    w = np.asarray(text[np.clip(g, 0, len(text) - 1)], dtype=np.int64) - 1
    w = np.where((p >= 0) & (p < tl[:, None]), w, 5)
    sc = _banded_scores_np(
        r03, np.asarray(lens, np.int64)[rid], w, band,
        cfg.align_ma, cfg.align_mp, cfg.align_go, cfg.align_ge,
    )
    return np.clip(sc, 0, (1 << SCORE_BITS) - 1)


def _score_lists_np(idx, cfg, codes, lens, lists):
    """Replace each (t, pos, strand, support) record's 4th field with its
    banded AS score (the replicated wire engine's --mappingScore contract)."""
    nrec = [len(x) for x in lists]
    if sum(nrec) == 0:
        return lists
    rid = np.repeat(np.arange(len(lists)), nrec)
    flat = [rec for lst in lists for rec in lst]
    t = np.array([r[0] for r in flat], np.int64)
    pos = np.array([r[1] for r in flat], np.int64)
    strand = np.array([r[2] for r in flat], np.int64)
    sc = score_mappings_np(idx, cfg, codes, lens, rid, t, pos, strand)
    out = []
    i = 0
    for lst in lists:
        out.append([(r[0], r[1], r[2], int(sc[i + j])) for j, r in enumerate(lst)])
        i += len(lst)
    return out


def _device(device) -> torch.device:
    """A staged engine's device: None means the CUDA card (it raises without
    one rather than run on the CPU)."""
    from rapmap_tpu_torch.models.quasi import cuda_or

    return cuda_or(device, "the host-staged engine")


class StagedMapper:
    """Sequential-shard quasi mapper on one card.

    Shard residency: uploads shard p once, runs stage A for EVERY queued
    batch, frees it and moves on — the index is bounded by host RAM, not by
    the card's memory. device=None means the CUDA card; pass device="cpu"
    to run stage A's plain versions on the CPU. Sweep options, set as
    attributes: checkpoint_path / checkpoint_every (a resumable sweep) and
    upload_overlap (the next shard goes up while the current one runs)."""

    checkpoint_path: str | None = None
    checkpoint_every = 4
    upload_overlap = False
    shard_timings: list[dict] = []  # the last sweep's, one row a shard

    def __init__(self, idx: QuasiIndex, cfg: MapConfig, n_shards: int,
                 read_len: int, batch: int, anchor_budget: int | None = None,
                 device=None):
        if read_len > idx.k + 16 * SA_CMP_WORDS:
            raise ValueError(
                f"staged mapper reads cap at k+{16 * SA_CMP_WORDS} bases "
                "(suffix compares must stay inside the fused sa_cmp rows)"
            )
        self.device = _device(device)
        self.idx = idx
        self.cfg = cfg
        if cfg.mapping_score and not hasattr(idx.text, "__getitem__"):
            raise ValueError(
                "--mappingScore needs the transcript text: the mapping-only "
                "artifact (index_type quasi_map) drops it — use the full index"
            )
        self.geo = staged_geometry(idx, n_shards)
        self.n_shards = n_shards
        self.L = read_len
        self.C = batch
        S = read_len - idx.k + 1
        # each window's k-mer lives in exactly ONE shard, so a shard sees
        # ~1/n of a batch's anchors: budget 4x that average (floor 4096)
        # instead of the worst case. Stage A counts anchors exactly; on
        # overflow the shard reruns at the full width, bit-identically (the
        # extensions are independent, the union positional).
        self.A_full = 2 * batch * S
        self.A_max = anchor_budget or min(
            self.A_full, max(4096, (4 * self.A_full) // max(1, n_shards))
        )
        self.sa_txp = np.asarray(idx.sa_txp)
        self.sa_tpos = np.asarray(idx.sa_tpos)
        self._st = EngineStatic(
            k=idx.k, prefix_bases=self.geo.prefix_bases,
            lookup_steps=self.geo.lookup_steps,
            pad_tail=len(idx.text) - idx.n_text,
            max_interval_idx=self.geo.max_interval_idx, n_txps=int(idx.n_txps),
        )

    # ---- stage A sweep: every shard visits the card once per group --------

    def _acc_init(self, R: int, S: int) -> dict:
        return dict(
            anch=np.zeros((R, S), bool),
            mlen=np.zeros((R, S), np.int32),
            b=np.zeros((R, S), np.int64),
            e=np.zeros((R, S), np.int64),
        )

    def _shard_arrays(self, p: int):
        didx_np, _st, s0 = shard_device_arrays(self.idx, self.geo, p)
        return didx_np, s0

    def _stage_a(self, didx, lanes, lens2, A: int):
        return stage_a(didx, self._st, self.cfg, lanes, lens2, A)

    def _compact(self, didx, lanes, lens2):
        """Stage A at the budget, rerun at the full width when the shard's
        anchors overflow it -> (host int32 rows of the live anchors' fields
        (src first), reruns)."""
        out = self._stage_a(didx, lanes, lens2, self.A_max)
        n = int(out[-1])
        reruns = 0
        if n > self.A_max:
            out = self._stage_a(didx, lanes, lens2, self.A_full)
            n = int(out[-1])
            assert n <= self.A_full
            reruns = 1
        rows = torch.stack([t[:n] for t in out[:-1]]).to(torch.int32).cpu().numpy()
        return rows, reruns

    def _stage_a_union(self, didx, lanes, lens2, a: dict, s0: int) -> int:
        """Run stage A on the resident shard, union into acc entry `a`.
        Returns the number of full-width reruns (budget escalations); the
        results are complete either way."""
        (src, mlen, b1, e1), reruns = self._compact(didx, lanes, lens2)
        a["anch"].reshape(-1)[src] = True
        a["mlen"].reshape(-1)[src] = mlen
        a["b"].reshape(-1)[src] = b1.astype(np.int64) + s0
        a["e"].reshape(-1)[src] = e1.astype(np.int64) + s0
        return reruns

    def _upload(self, didx_np, side=None, consumer=None):
        """A shard's numpy arrays on the device. With `side` (a CUDA stream)
        the copies run on it from pinned memory; the call returns once they
        are done, with every tensor marked as used on `consumer`."""
        if side is None:
            return DeviceQuasiIndex(*(None if a is None else _chunked_upload(a, self.device)
                                      for a in didx_np))
        pinned: list = []
        with torch.cuda.stream(side):
            didx = DeviceQuasiIndex(*(None if a is None
                                      else _chunked_upload(a, self.device, pinned)
                                      for a in didx_np))
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()  # the copies are done: the pinned buffers may go
        for t in didx:
            if t is not None:
                t.record_stream(consumer)
        return didx

    def _load_checkpoint(self, ckpt, acc, n_batches: int, R: int, S: int):
        """-> (first shard, overflow so far); a snapshot of another geometry
        or one that fails to load gives a fresh sweep."""
        try:
            z = np.load(ckpt, allow_pickle=False)
            if (int(z["n_shards"]) == self.n_shards and int(z["n_batches"]) == n_batches
                    and int(z["R"]) == R and int(z["S"]) == S):
                for bi, a in enumerate(acc):
                    for key in a:
                        a[key][...] = z[f"acc{bi}_{key}"]
                start = int(z["next_shard"])
                log.info("sweep RESUMED at shard %d/%d from %s", start, self.n_shards, ckpt)
                return start, int(z["overflow"])
            log.warning("checkpoint %s geometry mismatch; fresh sweep", ckpt)
        except Exception as exc:  # a torn or foreign file: start over
            log.warning("checkpoint load failed (%s); fresh sweep", exc)
        return 0, 0

    def _sweep(self, lane_batches: list[tuple[np.ndarray, np.ndarray]]):
        """lane_batches: [(codes (C, L), lens (C,)), ...]. Returns per entry
        the host-unioned dense maps (dict from _acc_init) plus the
        anchor-overflow count."""
        k = self.idx.k
        S = self.L - k + 1
        R = 2 * self.C
        dev = self.device
        # read lanes serve EVERY shard: upload once and keep them resident
        lanes_dev, lens2_dev = [], []
        for codes, lens in lane_batches:
            lanes = np.concatenate([codes, _rc_lanes(codes, lens)], axis=0)
            lanes_dev.append(torch.from_numpy(np.ascontiguousarray(lanes, np.int8)).to(dev))
            lens2_dev.append(torch.from_numpy(
                np.concatenate([lens, lens]).astype(np.int64)).to(dev))
        acc = [self._acc_init(R, S) for _ in lane_batches]
        overflow = 0
        self.shard_timings = []
        ckpt = self.checkpoint_path
        every = max(1, int(self.checkpoint_every))
        start_shard = 0
        if ckpt and os.path.exists(ckpt):
            start_shard, overflow = self._load_checkpoint(ckpt, acc, len(lane_batches), R, S)

        def save_ckpt(next_shard: int):
            t = time.time()
            tmp = ckpt + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(
                    f, next_shard=next_shard, overflow=overflow,
                    n_shards=self.n_shards, n_batches=len(lane_batches), R=R, S=S,
                    **{f"acc{bi}_{key}": a[key] for bi, a in enumerate(acc) for key in a},
                )
            os.replace(tmp, ckpt)
            log.info("checkpoint @ shard %d (%.1fs)", next_shard, time.time() - t)

        # one-deep shard prefetch: slicing shard p+1 on the host overlaps
        # shard p's upload and device pass. With upload_overlap an upload
        # thread also puts shard p+1 on the card (a side stream on CUDA)
        # while shard p's stage A runs: slice(p+2) || upload(p+1) ||
        # device+union(p), two shards resident at most.
        overlap = bool(self.upload_overlap)
        cuda = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if overlap and cuda else None
        consumer = torch.cuda.current_stream(dev) if cuda else None

        def timed_slice(pp: int):
            t0 = time.time()
            didx_np, s0 = self._shard_arrays(pp)
            return didx_np, s0, time.time() - t0

        def upload_stage(slice_fut):
            didx_np, s0, t_slice = slice_fut.result()
            t1 = time.time()
            up_bytes = sum(a.nbytes for a in didx_np if a is not None)
            didx = self._upload(didx_np, side, consumer)
            return didx, s0, up_bytes, t_slice, time.time() - t1

        ex = ThreadPoolExecutor(max_workers=1)
        ex_up = ThreadPoolExecutor(max_workers=1) if overlap else None
        try:
            if overlap:
                sfut = ex.submit(timed_slice, start_shard)
                fut = ex_up.submit(upload_stage, sfut)
                sfut = (ex.submit(timed_slice, start_shard + 1)
                        if start_shard + 1 < self.n_shards else None)
            else:
                fut = ex.submit(self._shard_arrays, start_shard)
            for p in range(start_shard, self.n_shards):
                t0 = time.time()
                if overlap:
                    didx, s0, up_bytes, t_slice, t_up = fut.result()
                    if sfut is not None:
                        fut = ex_up.submit(upload_stage, sfut)
                        sfut = (ex.submit(timed_slice, p + 2)
                                if p + 2 < self.n_shards else None)
                    t2 = time.time()
                else:
                    didx_np, s0 = fut.result()
                    if p + 1 < self.n_shards:
                        fut = ex.submit(self._shard_arrays, p + 1)
                    t1 = time.time()
                    up_bytes = sum(a.nbytes for a in didx_np if a is not None)
                    didx = self._upload(didx_np)
                    if cuda:
                        torch.cuda.synchronize(dev)
                    del didx_np
                    t2 = time.time()
                    t_slice, t_up = t1 - t0, t2 - t1
                td = time.time()
                for bi, lanes in enumerate(lanes_dev):
                    overflow += self._stage_a_union(didx, lanes, lens2_dev[bi], acc[bi], s0)
                t_dev = time.time() - td
                del didx
                self.shard_timings.append(dict(
                    shard=p, slice_s=t_slice, upload_s=t_up, device_union_s=t_dev,
                    upload_mb=up_bytes / 2**20,
                    exposed_wait_s=(t2 - t0) if overlap else None,
                ))
                if overlap:
                    log.info("shard %d: slice %.1fs upload %.1fs (exposed wait %.1fs) "
                             "device+union %.1fs", p, t_slice, t_up, t2 - t0, t_dev)
                else:
                    log.info("shard %d: slice %.1fs upload %.1fs device+union %.1fs",
                             p, t_slice, t_up, t_dev)
                if ckpt and p + 1 < self.n_shards and (p + 1 - start_shard) % every == 0:
                    save_ckpt(p + 1)
        finally:
            ex.shutdown(wait=True)
            if ex_up is not None:
                ex_up.shutdown(wait=True)
        if ckpt and os.path.exists(ckpt):
            os.remove(ckpt)  # completed sweep: the snapshot is stale
        return acc, overflow

    def _collate_one(self, a: dict, lens: np.ndarray):
        """Walk + expand + vote one lane batch -> (lists, too_amb, trunc)."""
        k = self.idx.k
        S = self.L - k + 1
        R = 2 * self.C
        H = self.cfg.max_hits_per_strand
        q, n, trunc = walk_hits_np(a["anch"], a["mlen"], k, S, H)
        lanesix = np.arange(R)[:, None]
        qc = np.clip(q, 0, S - 1)
        hb = a["b"][lanesix, qc]
        he = a["e"][lanesix, qc]
        hm = a["mlen"][lanesix, qc]
        out, too_amb = collate_np(
            q, n, hb, he, hm, lens, self.sa_txp, self.sa_tpos, self.cfg
        )
        trunc_read = trunc[: self.C] | trunc[self.C :]
        return out, too_amb, trunc_read

    # ---- public entry points -------------------------------------------------

    def map_batches(self, batches: list[np.ndarray], lens: list[np.ndarray] | None = None):
        """batches: list of (C, L) int8 code arrays (lens default: full L).
        Returns (mappings per batch — list of per-read
        [(t, pos, strand, support-or-AS)] — and stats)."""
        items = [
            ("se", codes, (lens[i] if lens is not None
                           else np.full(self.C, self.L, np.int32)))
            for i, codes in enumerate(batches)
        ]
        results = self.map_group(items)
        stats = dict(anchor_overflow=results[-1]["anchor_overflow"]) if results else {}
        return [r["recs"] for r in results], stats

    def map_group(self, items: list[tuple]):
        """items: ("se", codes, lens) | ("pe", c1, l1, c2, l2); all code
        arrays (C, L). One shard sweep serves every mate of every item.
        Returns per-item dicts:
          SE: recs (per-read record lists), too_amb, trunc
          PE: recs (per-read [(t,p1,s1,has1,p2,s2,has2[,sc1,sc2])]),
              conc, too_amb, trunc
        plus anchor_overflow on each."""
        lane_batches = []
        backref = []  # per item: indices into lane_batches
        for it in items:
            if it[0] == "se":
                backref.append((len(lane_batches),))
                lane_batches.append((it[1], it[2]))
            else:
                backref.append((len(lane_batches), len(lane_batches) + 1))
                lane_batches.append((it[1], it[2]))
                lane_batches.append((it[3], it[4]))
        acc, overflow = self._sweep(lane_batches)
        results = []
        for it, refs in zip(items, backref):
            if it[0] == "se":
                lists, too_amb, trunc = self._collate_one(acc[refs[0]], it[2])
                if self.cfg.mapping_score:
                    lists = _score_lists_np(self.idx, self.cfg, it[1], it[2], lists)
                results.append(dict(
                    recs=lists, too_amb=too_amb, trunc=trunc,
                    anchor_overflow=overflow,
                ))
            else:
                _, c1, l1, c2, l2 = it
                lists1, _, trunc1 = self._collate_one(acc[refs[0]], l1)
                lists2, _, trunc2 = self._collate_one(acc[refs[1]], l2)
                recs, conc, too_amb = self._merge_pe(lists1, lists2)
                if self.cfg.mapping_score:
                    recs = self._score_pe(recs, c1, l1, c2, l2)
                results.append(dict(
                    recs=recs, conc=conc, too_amb=too_amb,
                    trunc=trunc1 | trunc2, anchor_overflow=overflow,
                ))
        return results

    def _merge_pe(self, lists1, lists2):
        """SEMANTICS.md §5 pair merge, read by read, via the oracle's own
        merge (parity with the spec by construction)."""
        from rapmap_tpu_torch.oracle.quasimap import Mapping, merge_pairs

        B = self.C
        recs = []
        conc = np.zeros(B, bool)
        too_amb = np.zeros(B, bool)
        for r in range(B):
            left = [Mapping(t, p, s == 0, su) for t, p, s, su in lists1[r]]
            right = [Mapping(t, p, s == 0, su) for t, p, s, su in lists2[r]]
            ms, c = merge_pairs(left, right, self.cfg)
            if len(ms) > self.cfg.max_num_hits:
                too_amb[r] = True
                ms, c = [], False
            conc[r] = c
            recs.append([
                (m.txp,
                 m.pos1 if m.pos1 is not None else 0, 0 if m.fwd1 else 1,
                 int(m.pos1 is not None),
                 m.pos2 if m.pos2 is not None else 0, 0 if m.fwd2 else 1,
                 int(m.pos2 is not None))
                for m in ms
            ])
        return recs, conc, too_amb

    def _score_pe(self, recs, c1, l1, c2, l2):
        """Append per-mate AS fields to PE rows (absent mate scores 0)."""
        nrec = [len(x) for x in recs]
        rid = np.repeat(np.arange(len(recs)), nrec)
        flat = [row for lst in recs for row in lst]
        if not flat:
            return recs
        t = np.array([r[0] for r in flat], np.int64)
        sc1 = np.zeros(len(flat), np.int64)
        sc2 = np.zeros(len(flat), np.int64)
        for codes, lens, pcol, scol, hcol, out in ((c1, l1, 1, 2, 3, sc1),
                                                    (c2, l2, 4, 5, 6, sc2)):
            has = np.array([r[hcol] for r in flat], bool)
            if has.any():
                pos = np.array([r[pcol] for r in flat], np.int64)[has]
                strand = np.array([r[scol] for r in flat], np.int64)[has]
                out[has] = score_mappings_np(
                    self.idx, self.cfg, codes, lens, rid[has], t[has], pos, strand
                )
        out = []
        i = 0
        for lst in recs:
            out.append([
                row + (int(sc1[i + j]), int(sc2[i + j]))
                for j, row in enumerate(lst)
            ])
            i += len(lst)
        return out


def staged_shards(idx) -> int:
    """The quasi engine's shard count: device bytes of a shard's arrays
    (sa_cmp rows and k-mer rows) over TQM_STAGED_SHARD_GB (default 2)."""
    per = float(os.environ.get("TQM_STAGED_SHARD_GB", "2")) * 2**30
    dev_bytes = len(idx.sa) * (3 + SA_CMP_WORDS) * 4 + len(idx.kmer_b) * 16
    return max(1, math.ceil(dev_bytes / per))


class StagedQuasiMapper:
    """The command line's adapter: QuasiMapper's async interface over the
    host-staged engine, so `quasimap` maps an index past the card's memory
    (or a mapping-only artifact) with the same command.

    map_*_async enqueues; the first fetch() of an uncomputed batch maps EVERY
    queued batch in one shard sweep — with the command line's depth-D
    pipeline the index streams over the card once per D batches. device=None
    means the CUDA card; pass device="cpu" for the plain versions."""

    def __init__(self, idx: QuasiIndex, cfg: MapConfig, batch: int,
                 read_len: int, n_shards: int | None = None, device=None):
        cap = idx.k + 16 * SA_CMP_WORDS
        if read_len > cap:
            raise ValueError(
                f"staged engine caps reads at {cap} bases for k={idx.k} "
                f"(--maxReadLen {read_len}); pass --maxReadLen <= {cap}"
            )
        if n_shards is None:
            n_shards = staged_shards(idx)
        self.sm = StagedMapper(idx, cfg, n_shards=n_shards, read_len=read_len,
                               batch=batch, device=device)
        self._init_adapter(idx, cfg)

    def _init_adapter(self, idx, cfg: MapConfig):
        self._apply_sweep_env()
        self.cfg = cfg
        self.device = self.sm.device
        self.host_index = idx
        self.txp_names = idx.txp_names
        self.txp_lens = np.asarray(idx.txp_lens)
        self._pending: dict[int, tuple] = {}
        self._done: dict[int, object] = {}
        self._next = 0

    def _apply_sweep_env(self):
        """The sweep's options for command-line users (a script sets the
        engine's attributes): TQM_SWEEP_CKPT=<path> makes every sweep
        resumable (TQM_SWEEP_CKPT_EVERY shards apart); TQM_SWEEP_OVERLAP=1
        uploads the next shard while the current one runs."""
        ckpt = os.environ.get("TQM_SWEEP_CKPT")
        if ckpt:
            self.sm.checkpoint_path = ckpt
            self.sm.checkpoint_every = int(os.environ.get("TQM_SWEEP_CKPT_EVERY", "4"))
        if os.environ.get("TQM_SWEEP_OVERLAP", "") not in ("", "0"):
            self.sm.upload_overlap = True

    def _pad(self, codes: np.ndarray, lens: np.ndarray):
        codes = np.asarray(codes, np.int8)
        lens = np.asarray(lens, np.int32)
        B, L = codes.shape
        C, Ls = self.sm.C, self.sm.L
        if L > Ls:
            if int(lens.max(initial=0)) > Ls:
                raise ValueError(
                    f"read of length {int(lens.max())} exceeds the staged "
                    f"engine's {Ls}-base cap"
                )
            codes = codes[:, :Ls]
        elif L < Ls:
            codes = np.pad(codes, ((0, 0), (0, Ls - L)))
        if B > C:
            raise ValueError(f"batch of {B} reads exceeds the staged batch size {C}")
        if B < C:
            codes = np.pad(codes, ((0, C - B), (0, 0)))
            lens = np.pad(lens, (0, C - B))
        return codes, lens

    def map_se_async(self, codes, lens, n_valid: int | None = None):
        B = codes.shape[0]
        nv = n_valid if n_valid is not None else B
        pc, pl = self._pad(codes, lens)
        h = self._next
        self._next += 1
        self._pending[h] = ("se", pc, pl, B, nv)
        return h

    def map_pe_async(self, c1, l1, c2, l2, n_valid: int | None = None):
        B = c1.shape[0]
        nv = n_valid if n_valid is not None else B
        p1, q1 = self._pad(c1, l1)
        p2, q2 = self._pad(c2, l2)
        h = self._next
        self._next += 1
        self._pending[h] = ("pe", p1, q1, p2, q2, B, nv)
        return h

    def _flush(self):
        from rapmap_tpu_torch.ops.wire import (
            FLAG_MAPPED, FLAG_OVER_BUDGET, FLAG_TOO_AMBIGUOUS, WireResult,
        )

        handles = sorted(self._pending)
        items = []
        for h in handles:
            p = self._pending[h]
            if p[0] == "se":
                items.append(("se", p[1], p[2]))
            else:
                items.append(("pe", p[1], p[2], p[3], p[4]))
        group = self.sm.map_group(items)
        for h, res in zip(handles, group):
            p = self._pending.pop(h)
            kind, B, nv = p[0], p[-2], p[-1]
            lists = res["recs"][:B]
            counts = np.array([len(x) for x in lists], np.int32)
            width = (4 if kind == "se" else (9 if self.cfg.mapping_score else 7))
            flat = [row for lst in lists for row in lst]
            recs = np.array(flat, np.int32).reshape(-1, width)
            too_amb = res["too_amb"][:B]
            # anchor_overflow counts full-width stage-A reruns (results are
            # complete either way); only the walk's H-budget truncation
            # degrades a read into the host-oracle fallback
            trunc = res["trunc"][:B]
            flags = (
                trunc.astype(np.int32) * FLAG_OVER_BUDGET
                | too_amb.astype(np.int32) * FLAG_TOO_AMBIGUOUS
                | (counts > 0).astype(np.int32) * FLAG_MAPPED
            )
            valid = np.arange(B) < nv
            counters = dict(
                reads_total=int(nv),
                reads_mapped=int(((counts > 0) & valid).sum()),
                too_ambiguous=int((too_amb & valid).sum()),
                over_budget=int((trunc & valid).sum()),
                records=int(counts[valid].sum()),
                out_truncated=0,
            )
            self._done[h] = WireResult(
                recs=recs, counts=counts, flags=flags,
                total=int(counts.sum()), overflowed=False, counters=counters,
            )

    def fetch(self, handle: int):
        if handle not in self._done:
            self._flush()
        return self._done.pop(handle)


# ---- host-staged PSEUDO mapping (SEMANTICS.md §7) ----------------------------
# The pseudo walk's NIP rule is "jump k on hit" — it never reads an extension
# result — so stage A is the dense k-mer lookup ALONE (no suffix compares, no
# sa_cmp rows: shards are k-mer table slices, 16 B a k-mer), the walk is
# walk_hits_np driven by a synthetic mlen map (mlen = 2k-1 makes its advance
# rule pos + max(1, mlen-k+1) = pos + k), and collation is collate_np over
# the host CSR occurrence arrays (occ_txp/occ_pos play sa_txp/sa_tpos; every
# visited hit adds length k to the -z coverage sum).


def staged_geometry_pseudo(idx, n_shards: int) -> StagedGeometry:
    """Prefix-boundary row cuts over the pseudo k-mer table, balanced by ROW
    count (upload cost is the k-mer rows; occurrences never upload). Local
    occ offsets must fit int32: asserted per shard — raise n_shards if hit."""
    from rapmap_tpu_torch.index.kmer_table import build_prefix_lut

    khi = np.asarray(idx.kmer_hi, dtype=np.uint32)
    klo = np.asarray(idx.kmer_lo, dtype=np.uint32)
    off = np.asarray(idx.kmer_off, dtype=np.int64)
    K = len(khi)
    p = max(4, min(idx.k, 12, math.ceil(math.log(max(K, 2), 4)) + 1))
    lut = build_prefix_lut(khi, klo, idx.k, p).astype(np.int64)

    def cuts(at, total):
        targets = [round(i * total / n_shards) for i in range(n_shards + 1)]
        pv = [int(np.searchsorted(at, t, side="left")) for t in targets]
        pv[0], pv[-1] = 0, len(lut) - 1
        row_cuts = [int(lut[v]) for v in pv]
        slot_cuts = [int(off[r]) for r in row_cuts]
        slot_cuts[0], slot_cuts[-1] = 0, int(off[-1])
        K_pad = max(row_cuts[i + 1] - row_cuts[i] for i in range(n_shards)) or 1
        S_pad = max(slot_cuts[i + 1] - slot_cuts[i] for i in range(n_shards)) or 1
        return row_cuts, slot_cuts, K_pad, S_pad

    row_cuts, slot_cuts, K_pad, S_pad = cuts(lut, K)
    if S_pad >= _S_PAD_LIMIT:
        # occurrence-skewed CSR: re-cut the SAME prefix boundaries balanced
        # by OCCURRENCE count instead of row count, so the int32 local-offset
        # bound depends on total skew at prefix granularity, not row balance
        row_cuts, slot_cuts, K_pad, S_pad = cuts(off[lut], int(off[-1]))
    assert S_pad < _S_PAD_LIMIT, (
        f"a pseudo shard holds {S_pad:,} occurrences (>= 2^31) even after "
        "occurrence-balanced prefix cuts: local int32 occ offsets overflow — "
        "raise n_shards"
    )
    lut_d = np.diff(lut)
    steps = max(1, int(math.ceil(math.log2(int(lut_d.max()) + 1))) + 1) if len(lut_d) else 1
    widths = off[1:] - off[:-1]
    max_w = int(widths.max()) if len(widths) else 1
    return StagedGeometry(row_cuts, slot_cuts, K_pad, S_pad, steps, p, max_w)


def pseudo_shard_device_arrays(idx, geo: StagedGeometry, p: int):
    """Shard p's device arrays for the pseudo lookup, as numpy: the k-mer
    table slice with LOCAL int32 occurrence offsets and its local prefix
    LUT; no suffix-compare rows (expansion happens on the host CSR) ->
    (DeviceQuasiIndex of numpy arrays, s0)."""
    from rapmap_tpu_torch.index.kmer_table import build_prefix_lut

    r0, r1 = geo.row_cuts[p], geo.row_cuts[p + 1]
    s0 = geo.slot_cuts[p]
    khi = np.asarray(idx.kmer_hi[r0:r1], dtype=np.uint32)
    klo = np.asarray(idx.kmer_lo[r0:r1], dtype=np.uint32)
    off = np.asarray(idx.kmer_off[r0 : r1 + 1], dtype=np.int64) - s0
    kmer_rows = np.zeros((geo.K_pad, 4), np.int32)
    kmer_rows[: r1 - r0, 0] = khi.view(np.int32)
    kmer_rows[: r1 - r0, 1] = klo.view(np.int32)
    kmer_rows[: r1 - r0, 2] = off[:-1].astype(np.int32)
    kmer_rows[: r1 - r0, 3] = off[1:].astype(np.int32)
    # pad rows: all-ones keys, empty intervals, filled unconditionally (an
    # empty shard must not rely on the all-zero LUT)
    kmer_rows[r1 - r0 :, 0] = -1
    kmer_rows[r1 - r0 :, 1] = -1
    lut = build_prefix_lut(khi, klo, idx.k, geo.prefix_bases).astype(np.int64)
    lut_rows = np.stack([lut[:-1], lut[1:]], axis=1).astype(np.int32)
    didx = DeviceQuasiIndex(
        text2q=np.zeros((1, 4), np.int32),
        sa_meta=np.zeros((1, 2), np.int32),
        sa_cmp=None,  # no extension: nothing reads suffix rows
        kmer_rows=kmer_rows,
        lut_rows=lut_rows,
    )
    return didx, s0


class StagedPseudoEngine(StagedMapper):
    """Sequential-shard PSEUDO mapper on one card (the staged counterpart of
    models/pseudo.PseudoMapper)."""

    def __init__(self, idx, cfg: MapConfig, n_shards: int, read_len: int, batch: int,
                 anchor_budget: int | None = None, device=None):
        assert not cfg.mapping_score, "--mappingScore is quasimap-only"
        self.device = _device(device)
        self.idx = idx
        self.cfg = cfg
        self.geo = staged_geometry_pseudo(idx, n_shards)
        self.n_shards = n_shards
        self.L = read_len
        self.C = batch
        S = read_len - idx.k + 1
        self.A_full = 2 * batch * S
        self.A_max = anchor_budget or min(
            self.A_full, max(4096, (4 * self.A_full) // max(1, n_shards))
        )
        self.occ_txp = np.asarray(idx.occ_txp)
        self.occ_pos = np.asarray(idx.occ_pos)
        self._st = EngineStatic(
            k=idx.k, prefix_bases=self.geo.prefix_bases,
            lookup_steps=self.geo.lookup_steps, pad_tail=1,
            max_interval_idx=self.geo.max_interval_idx,
            n_txps=int(len(idx.txp_lens)), use_chd=False,
        )

    def _acc_init(self, R: int, S: int) -> dict:
        return dict(
            anch=np.zeros((R, S), bool),
            b=np.zeros((R, S), np.int64),
            e=np.zeros((R, S), np.int64),
        )

    def _shard_arrays(self, p: int):
        return pseudo_shard_device_arrays(self.idx, self.geo, p)

    def _stage_a(self, didx, lanes, lens2, A: int):
        return stage_a_pseudo(didx, self._st, self.cfg, lanes, lens2, A)

    def _stage_a_union(self, didx, lanes, lens2, a: dict, s0: int) -> int:
        (src, b1, e1), reruns = self._compact(didx, lanes, lens2)
        a["anch"].reshape(-1)[src] = True
        a["b"].reshape(-1)[src] = b1.astype(np.int64) + s0
        a["e"].reshape(-1)[src] = e1.astype(np.int64) + s0
        return reruns

    def _collate_one(self, a: dict, lens: np.ndarray):
        k = self.idx.k
        S = self.L - k + 1
        R = 2 * self.C
        H = self.cfg.max_hits_per_strand
        # synthetic mlen = 2k-1 turns walk_hits_np's advance rule
        # pos + max(1, mlen - k + 1) into the pseudo jump-ahead pos + k
        mlen_syn = np.where(a["anch"], np.int32(2 * k - 1), np.int32(0))
        q, n, trunc = walk_hits_np(a["anch"], mlen_syn, k, S, H)
        lanesix = np.arange(R)[:, None]
        qc = np.clip(q, 0, S - 1)
        hb = a["b"][lanesix, qc]
        he = a["e"][lanesix, qc]
        hm = np.full((R, H), k, np.int32)  # every pseudo hit covers k chars
        out, too_amb = collate_np(
            q, n, hb, he, hm, lens, self.occ_txp, self.occ_pos, self.cfg
        )
        trunc_read = trunc[: self.C] | trunc[self.C :]
        return out, too_amb, trunc_read


def staged_shards_pseudo(idx) -> int:
    """The pseudo engine's shard count: k-mer rows and the local LUT (the
    prefix formula of staged_geometry_pseudo) over TQM_STAGED_SHARD_GB, and
    enough shards that local occurrence offsets fit int32."""
    per = float(os.environ.get("TQM_STAGED_SHARD_GB", "2")) * 2**30
    K = len(idx.kmer_hi)
    p = max(4, min(idx.k, 12, math.ceil(math.log(max(K, 2), 4)) + 1))
    n_shards = max(1, math.ceil((K * 16 + 4**p * 8) / per))
    n_occ = int(np.asarray(idx.kmer_off)[-1])
    return max(n_shards, math.ceil(n_occ / (2**30)))


class StagedPseudoMapper(StagedQuasiMapper):
    """The command line's adapter for `pseudomap` over the host-staged pseudo
    engine, when the CSR exceeds the card's memory."""

    def __init__(self, idx, cfg: MapConfig, batch: int, read_len: int,
                 n_shards: int | None = None, device=None):
        if n_shards is None:
            n_shards = staged_shards_pseudo(idx)
        self.sm = StagedPseudoEngine(idx, cfg, n_shards=n_shards, read_len=read_len,
                                     batch=batch, device=device)
        self._init_adapter(idx, cfg)
