"""SA-sharded index over a 2-D (data, idx) mesh (BASELINE config 5).

Port of rapmap_tpu.parallel.sharded (docs/DESIGN_SA_SHARDING.md): the suffix
array is cut at prefix-bucket boundaries, so every k-mer's SA interval (and
anything extension narrows it to) lives wholly inside one shard. Reads split
over the data axis; each idx shard answers lookups and extensions for its
k-mer range, and per-window results and expansion candidates union across
the idx axis by a sum (each window or slot is non-zero on exactly one shard:
the reference's psum over "idx", exact in one process).

`shard_quasi_index` cuts the index on the host into numpy arrays equal to
the reference's field for field. `upload_sharded` puts each data row of the
mesh on its devices, in one of two layouts:

  - a row whose idx shards share one device gets a `ShardStack`: the
    per-shard tables stacked on that device, one upload serving every row
    there, with one copy of the replicated text2q and txp_align;
  - a row whose shards lie on different devices (the reference's layout:
    `make_mesh_2d` gives it when the process has n_data x n_idx devices), or
    any row with split_idx=True, gets a `ShardSet`: shard p uploaded to the
    row's p-th device as a single-device index, text2q and txp_align once a
    device; shard 0's device is the row's home.

The engine of a data row (`map_batch_se_sharded`, `map_batch_pe_sharded`)
runs on either layout

  1. the dense phase shard by shard, unioned into GLOBAL slot coordinates on
     the row's home device (each shard probes on its own device, its keys
     copied there once a program, and its terms come home to be summed):
     the canonical-class CHD probe (classes sharded by class space, rows
     carrying global intervals) or the per-strand CHD / prefix-LUT binary
     search over explicit [fwd; revcomp] lanes (shard-local rows, rebased);
  2. the lockstep NIP walk (`sharded_walk`): each trip's extension runs on
     the shard that owns the anchor's global interval, b0 in
     [slot_base[p, 0], slot_base[p, 0] + slot_base[p, 1]) with the TRUE slot
     count, and the step's (b, e, mlen) is the sum over owners (zero where
     no shard owns it). On a ShardStack on the card: one launch of
     csrc/walk.cu's sharded build over the stacked shard tables (K8,
     counters `sharded_walk`, paired lanes, and `sharded_walk_lanes`,
     explicit lanes). On a ShardSet: the trip loop on the home device
     (`trip_loop`), H + 1 lockstep trips, each trip's (b0, e0, pos, act)
     copied to every shard's device, one launch of the sharded trip there
     (K10, `sharded_trip`) for that shard's term in a (P, 3, R) buffer at
     home, then one launch of the trip's home half (K11,
     `sharded_advance`): the terms summed (the reference's three psums),
     the hit written and the lane advanced, with no eager op inside a trip.
     On CPU tensors both take the plain trip (`sharded_trip_plain`,
     `sharded_advance_plain`; `sharded_walk_plain` for a stack);
  3. the collate with an expand_fn that resolves a global slot on its owning
     shard's sa_meta rows (the slots sent to each shard's device, the
     answers summed at home), and with --mappingScore the banded scores of
     every MapOut slot on shard 0's view (text2q and txp_align are
     replicated, so no union).

Global slots ride int64 on the device, which carries the reference's int32
global slots (below 2^31) and its int64 ones (slot64, past 2^31 total SA
slots) alike; slot_base keeps the numpy dtype, int64 under slot64. The
reference's module-global shard base and count holders are explicit
arguments here (the host copy `bases` of either layout, read without a
device sync).

Copies between devices are `.to()` on the current streams, which torch
orders against the work that made and that reads them. The reference runs
its sharded engine in one process's mesh; so does this one.
"""

from __future__ import annotations

import ctypes
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import QuasiIndex
from rapmap_tpu_torch.models.quasi import Counters, mapout_counters, pair_counters
from rapmap_tpu_torch.ops import encode as denc
from rapmap_tpu_torch.ops.bits import u32
from rapmap_tpu_torch.ops.collate import MapOut, collate_batch
from rapmap_tpu_torch.ops.device_index import DeviceQuasiIndex, EngineStatic
from rapmap_tpu_torch.ops.extend_packed import ext_words, extend_packed, pack_reads
from rapmap_tpu_torch.ops.gather import row_gather_nd
from rapmap_tpu_torch.ops.lookup import _chd_hash, kmer_lookup
from rapmap_tpu_torch.ops.mmp import (
    WALK_FUSED_WORDS_MAX, ScanHits, WalkInputs, WalkState, WalkTables, _cols, _walk_plain,
    anchor_tables, next_anchor_table, walk_advance, walk_begin, walk_hits, walk_params,
)
from rapmap_tpu_torch.ops.pairs import PairOut, merge_pairs_batch
from rapmap_tpu_torch.parallel.dp import _join, _n_valid, _sum, norm_device


class ShardedIndexArrays(NamedTuple):
    """Stacked per-shard arrays; leading axis = idx shard (padded equal sizes)."""

    text2q: np.ndarray    # (P, nw, 4) — replicated content
    sa_cmp: np.ndarray    # (P, S_pad, 3+F) — device_index.sa_cmp_rows layout
    sa_meta: np.ndarray   # (P, S_pad, 2)
    kmer_rows: np.ndarray  # (P, K_pad, 4) — b/e rebased to shard-local slots
    lut_rows: np.ndarray  # (P, 4^p, 2) — rows outside shard range are empty
    slot_base: np.ndarray  # (P, 2) int32 [global slot offset, true slot count]
    # (true count matters: shards are padded to S_pad, and ownership tests must
    # use the real count or a short shard also claims the next shard's slots)
    # Per-shard CHD perfect hash: common (m_bits, t_bits, seed) geometry
    # across shards; None = binary search. Two variants (st.chd_canonical):
    #   per-strand: chd_rows (P, 2^t, 4) [hi, lo, b_loc, e_loc] — rows live
    #     with their owning SA shard, intervals shard-LOCAL;
    #   canonical-class: chd_rows (P, 2^t, 6) [chi, clo, bf, ef, br, er] —
    #     classes sharded by CLASS space, intervals GLOBAL, one probe answers
    #     both strands of a window. int64 rows in the slot64 regime.
    chd_dir: np.ndarray | None = None   # (P, 2^m_bits) int32
    chd_rows: np.ndarray | None = None  # (P, 2^t_bits, 4|6)
    # (P, n_txps, 3) replicated ops.align.make_txp_align rows
    txp_align: np.ndarray | None = None


def _build_shard_chds(khi_u32, klo_u32, row_cuts, seed0: int):
    """Common-geometry CHD per shard over that shard's k-mer subset, with
    (m_bits, t_bits) sized for the largest shard and ONE seed retried until
    the displacement search succeeds on every shard. Returns (dirs (P, 2^m),
    perms (P, 2^t), seed, m_bits, t_bits, p_bits) or None when the native
    library is unavailable or placement keeps failing (binary search then,
    as the reference falls back)."""
    try:
        from rapmap_tpu_torch.native import bindings as nat

        if not nat.available():
            return None
    except Exception:  # pragma: no cover - import/runtime issues
        return None
    from rapmap_tpu_torch.index.chd import MAXD, chd_params

    P_ = len(row_cuts) - 1
    n_max = max(row_cuts[i + 1] - row_cuts[i] for i in range(P_))
    if n_max == 0:
        return None
    m_bits, t_bits, p_bits = chd_params(n_max)
    for attempt in range(16):
        seed = (seed0 + attempt * 1000003) & 0xFFFFFFFF
        dirs, perms, ok = [], [], True
        for p in range(P_):
            r0, r1 = row_cuts[p], row_cuts[p + 1]
            if r1 == r0:  # empty shard: every probe lands on a sentinel row
                dirs.append(np.zeros(1 << m_bits, np.int32))
                perms.append(np.full(1 << t_bits, -1, np.int32))
                continue
            res = nat.chd_build(
                khi_u32[r0:r1], klo_u32[r0:r1], m_bits, t_bits, seed, MAXD, p_bits
            )
            if res is None:
                ok = False
                break
            dirs.append(res[0])
            perms.append(res[1])
        if ok:
            return np.stack(dirs), np.stack(perms), seed, m_bits, t_bits, p_bits
    return None


def _build_class_shard_chds(idx: QuasiIndex, n_shards: int, seed0: int, slot_dt):
    """Canonical-class CHD per shard, sharded by CLASS space: shard i owns
    the classes in its contiguous slice of the class-key-sorted idx.chd_cls.
    Rows carry GLOBAL [bf, ef, br, er] intervals (slot_dt), so the probe's
    union feeds the walk directly. Returns (dirs (P, 2^m) int32, rows
    (P, 2^t, 6) slot_dt, seed, m_bits, t_bits, p_bits) or None (no class
    section, no native library, placement failure)."""
    if getattr(idx, "chd_cls", None) is None:
        return None
    try:
        from rapmap_tpu_torch.native import bindings as nat

        if not nat.available():
            return None
    except Exception:  # pragma: no cover - import/runtime issues
        return None
    from rapmap_tpu_torch.index.chd import MAXD, chd_params, key64_of, rc_key64_np

    cls = np.asarray(idx.chd_cls, dtype=np.int64)  # (n_cls, 2) [fwd_row, rc_row]
    n_cls = len(cls)
    if n_cls == 0:
        return None
    kb = np.asarray(idx.kmer_b, dtype=np.int64)
    ke = np.asarray(idx.kmer_e, dtype=np.int64)
    key64 = key64_of(idx.kmer_hi, idx.kmer_lo)
    fwd_r, rc_r = cls[:, 0], cls[:, 1]
    ck = np.where(
        fwd_r >= 0,
        key64[np.clip(fwd_r, 0, None)],
        rc_key64_np(key64[np.clip(rc_r, 0, None)], idx.k),
    )
    chi = (ck >> np.uint64(32)).astype(np.uint32)
    clo = (ck & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def iv(rowsel):
        ok = rowsel >= 0
        r = np.clip(rowsel, 0, None)
        return np.where(ok, kb[r], 0), np.where(ok, ke[r], 0)

    bf, ef = iv(fwd_r)
    br, er = iv(rc_r)
    P_ = n_shards
    cuts = [round(i * n_cls / P_) for i in range(P_ + 1)]
    n_max = max(cuts[i + 1] - cuts[i] for i in range(P_))
    if n_max == 0:
        return None
    m_bits, t_bits, p_bits = chd_params(n_max)
    for attempt in range(16):
        seed = (seed0 + attempt * 1000003) & 0xFFFFFFFF
        dirs, rows, ok = [], [], True
        for p in range(P_):
            c0, c1 = cuts[p], cuts[p + 1]
            if c1 == c0:
                dirs.append(np.zeros(1 << m_bits, np.int32))
                rows.append(
                    np.tile(np.array([-1, -1, 0, 0, 0, 0], slot_dt), (1 << t_bits, 1))
                )
                continue
            res = nat.chd_build(chi[c0:c1], clo[c0:c1], m_bits, t_bits, seed, MAXD, p_bits)
            if res is None:
                ok = False
                break
            dirv, perm = res
            pg = np.clip(perm.astype(np.int64) + c0, 0, n_cls - 1)
            # uint32 keys zero-extend into the row dtype (int32 bitcast view
            # for the narrow layout, plain widening for int64)
            if slot_dt == np.int64:
                r6 = np.stack(
                    [chi[pg].astype(np.int64), clo[pg].astype(np.int64),
                     bf[pg], ef[pg], br[pg], er[pg]], axis=1,
                )
            else:
                r6 = np.stack(
                    [chi[pg].view(np.int32), clo[pg].view(np.int32),
                     bf[pg].astype(np.int32), ef[pg].astype(np.int32),
                     br[pg].astype(np.int32), er[pg].astype(np.int32)], axis=1,
                )
            sentinel = np.array([-1, -1, 0, 0, 0, 0], slot_dt)
            rows.append(np.where((perm >= 0)[:, None], r6, sentinel[None, :]))
            dirs.append(dirv)
        if ok:
            return np.stack(dirs), np.stack(rows), seed, m_bits, t_bits, p_bits
    return None


def shard_quasi_index(
    idx: QuasiIndex, n_shards: int, use_chd: bool = True, slot64: bool | None = None,
    canonical: bool | None = None,
):
    """Cut the index at prefix-bucket boundaries into n_shards slot ranges
    -> (ShardedIndexArrays as numpy, EngineStatic).

    slot64: carry GLOBAL slot coordinates (slot_base, the class rows'
    intervals) as int64 — required past 2^31 total SA slots; per-shard
    tables stay int32-local either way. None = automatic by index size; True
    exercises the wide path small. With use_chd and the native library each
    shard gets its own perfect-hash probe table: by default the canonical
    both-strands-per-probe variant sharded by CLASS space; canonical=False
    the per-strand per-shard layout; without a CHD, the prefix-LUT binary
    search."""
    lut = np.asarray(idx.prefix_lut, dtype=np.int64)
    kb = np.asarray(idx.kmer_b, dtype=np.int64)
    ke = np.asarray(idx.kmer_e, dtype=np.int64)
    K = len(kb)
    n = len(idx.sa)
    # choose prefix cut values so each shard holds ~K/n_shards k-mer rows
    targets = [round(i * K / n_shards) for i in range(n_shards + 1)]
    pv = [int(np.searchsorted(lut, t, side="left")) for t in targets]
    pv[0], pv[-1] = 0, len(lut) - 1
    row_cuts = [int(lut[v]) for v in pv]
    # shard slot ranges: from the first owned k-mer's b to the next cut's b
    slot_cuts = []
    for r in row_cuts:
        slot_cuts.append(int(kb[r]) if r < K else n)
    slot_cuts[0] = 0
    slot_cuts[-1] = n

    S_pad = max(slot_cuts[i + 1] - slot_cuts[i] for i in range(n_shards)) or 1
    K_pad = max(row_cuts[i + 1] - row_cuts[i] for i in range(n_shards)) or 1
    from rapmap_tpu_torch.ops.align import make_txp_align
    from rapmap_tpu_torch.ops.device_index import sa_cmp_rows

    sa_txp = np.asarray(idx.sa_txp, dtype=np.int32)
    sa_tpos = np.asarray(idx.sa_tpos, dtype=np.int32)
    off = np.asarray(idx.txp_offsets, dtype=np.int64)
    tl = np.asarray(idx.txp_lens, dtype=np.int32)
    khi_u32 = np.asarray(idx.kmer_hi, dtype=np.uint32)
    klo_u32 = np.asarray(idx.kmer_lo, dtype=np.uint32)
    khi = khi_u32.view(np.int32)
    klo = klo_u32.view(np.int32)

    t2b = np.asarray(idx.text2b, dtype=np.uint32)
    cmp_all = sa_cmp_rows(idx.sa, off[sa_txp] + tl[sa_txp], idx.k, t2b)
    FC = cmp_all.shape[1]
    nw = len(t2b)
    t2p = np.concatenate([t2b, np.zeros(4, np.uint32)])
    text2q1 = np.stack([t2p[i : i + nw] for i in range(4)], axis=1)

    if slot64 is None:
        slot64 = n >= 2**31
    P_ = n_shards
    text2q = np.broadcast_to(text2q1, (P_, nw, 4)).copy()
    sa_cmp = np.zeros((P_, S_pad, FC), np.int32)
    sa_meta = np.zeros((P_, S_pad, 2), np.int32)
    kmer_rows = np.zeros((P_, K_pad, 4), np.int32)
    lut_rows = np.zeros((P_, len(lut) - 1, 2), np.int32)
    bases = np.zeros((P_, 2), np.int64 if slot64 else np.int32)
    for p in range(P_):
        s0, s1 = slot_cuts[p], slot_cuts[p + 1]
        r0, r1 = row_cuts[p], row_cuts[p + 1]
        ns, nr = s1 - s0, r1 - r0
        if ns >= 2**31 or nr >= 2**31:
            raise ValueError("per-shard slot/row counts must stay int32-local; use more shards")
        bases[p, 0] = s0
        bases[p, 1] = ns
        sa_cmp[p, :ns] = cmp_all[s0:s1]
        sa_meta[p, :ns, 0] = sa_txp[s0:s1]
        sa_meta[p, :ns, 1] = sa_tpos[s0:s1]
        kmer_rows[p, :nr, 0] = khi[r0:r1]
        kmer_rows[p, :nr, 1] = klo[r0:r1]
        kmer_rows[p, :nr, 2] = (kb[r0:r1] - s0).astype(np.int32)
        kmer_rows[p, :nr, 3] = (ke[r0:r1] - s0).astype(np.int32)
        # LUT rebased to shard-local rows; buckets outside [pv[p], pv[p+1]) empty
        lr = np.clip(lut, r0, r1) - r0
        lut_rows[p, :, 0] = lr[:-1]
        lut_rows[p, :, 1] = lr[1:]

    ta1 = make_txp_align(off, tl)
    txp_align_p = np.broadcast_to(ta1, (P_,) + ta1.shape).copy()
    st = EngineStatic.for_index(idx)
    chd_dir = chd_rows = None
    if canonical is None:
        canonical = use_chd
    cres = (
        _build_class_shard_chds(
            idx, n_shards, idx.seed + 13, np.int64 if slot64 else np.int32
        )
        if (use_chd and canonical)
        else None
    )
    if cres is not None:
        dirs_c, rows_c, seed_c, mb_c, tb_c, pb_c = cres
        st = replace(
            st, use_chd=True, chd_canonical=True,
            chd_seed=int(seed_c), chd_m_bits=mb_c, chd_t_bits=tb_c,
            chd_p_bits=pb_c,
        )
        arrays = ShardedIndexArrays(
            text2q=text2q, sa_cmp=sa_cmp, sa_meta=sa_meta,
            kmer_rows=kmer_rows, lut_rows=lut_rows,
            slot_base=bases, chd_dir=dirs_c, chd_rows=rows_c,
            txp_align=txp_align_p,
        )
        return arrays, st
    chd = _build_shard_chds(khi_u32, klo_u32, row_cuts, idx.seed + 7) if use_chd else None
    if chd is not None:
        dirs, perms, seed, m_bits, t_bits, p_bits = chd
        sentinel = np.array([-1, -1, 0, 0], dtype=np.int32)
        chd_rows = np.empty((P_, 1 << t_bits, 4), np.int32)
        for p in range(P_):
            r0, r1 = row_cuts[p], row_cuts[p + 1]
            local = kmer_rows[p]  # rows already rebased to shard-local slots
            perm = perms[p]
            pc = np.clip(perm, 0, max(r1 - r0 - 1, 0))
            chd_rows[p] = np.where((perm >= 0)[:, None], local[pc], sentinel[None, :])
        chd_dir = dirs
        st = replace(
            st, use_chd=True, chd_canonical=False,
            chd_seed=int(seed), chd_m_bits=m_bits, chd_t_bits=t_bits,
            chd_p_bits=p_bits,
        )
    else:
        st = replace(st, use_chd=False, chd_canonical=False)
    arrays = ShardedIndexArrays(
        text2q=text2q, sa_cmp=sa_cmp, sa_meta=sa_meta,
        kmer_rows=kmer_rows, lut_rows=lut_rows,
        slot_base=bases, chd_dir=chd_dir, chd_rows=chd_rows,
        txp_align=txp_align_p,
    )
    return arrays, st


# ---- the device side ------------------------------------------------------------


class ShardStack(NamedTuple):
    """One device's upload of a sharded index: the per-shard tables stacked
    on a leading shard axis (P), the replicated text2q and txp_align once,
    and `bases`, a host copy of slot_base ((global offset, true count) a
    shard) for the unions and ownership tests, which read it without a
    device sync."""

    text2q: torch.Tensor       # (nw, 4) int32
    sa_cmp: torch.Tensor       # (P, S_pad, 3 + F) int32
    sa_meta: torch.Tensor      # (P, S_pad, 2) int32
    kmer_rows: torch.Tensor    # (P, K_pad, 4) int32
    lut_rows: torch.Tensor     # (P, 4^p, 2) int32
    slot_base: torch.Tensor    # (P, 2) int32, int64 under slot64
    chd_dir: torch.Tensor | None
    chd_rows: torch.Tensor | None  # (P, 2^t, 4) int32 or (P, 2^t, 6) int32/int64
    txp_align: torch.Tensor    # (n_txps, 3) int32
    bases: tuple

    @property
    def slot64(self) -> bool:
        return self.slot_base.dtype == torch.int64

    @property
    def home(self) -> torch.device:
        return self.sa_cmp.device

    def local(self, p: int) -> DeviceQuasiIndex:
        """Shard p as a single-device index (the reference's _local_didx)."""
        return DeviceQuasiIndex(
            text2q=self.text2q, sa_meta=self.sa_meta[p], sa_cmp=self.sa_cmp[p],
            chd_dir=None if self.chd_dir is None else self.chd_dir[p],
            chd_rows=None if self.chd_rows is None else self.chd_rows[p],
            kmer_rows=self.kmer_rows[p], lut_rows=self.lut_rows[p],
            txp_align=self.txp_align,
        )


class ShardSet(NamedTuple):
    """A data row whose idx shards lie on their own devices (or are made to,
    split_idx=True): shard p's tables as a single-device index on its
    device, sharing that device's one copy of text2q and txp_align, and
    `bases`, the host copy of slot_base. Shard 0's device is the row's home:
    the dense unions, the walk's trip loop, the collate and the score run
    there."""

    shards: tuple  # (P,) DeviceQuasiIndex, shard p on the row's p-th device
    bases: tuple

    @property
    def home(self) -> torch.device:
        return self.shards[0].sa_cmp.device

    def local(self, p: int) -> DeviceQuasiIndex:
        return self.shards[p]


def make_mesh_2d(n_data: int, n_idx: int, devices=None) -> list[list[torch.device]]:
    """(n_data, n_idx) devices in mesh order. With at least n_data x n_idx
    devices, the reference's layout: data row d takes devices[d * n_idx :
    (d + 1) * n_idx], one a shard (a ShardSet when they differ). With fewer,
    each data row's shards share one device, devices[d % len(devices)] (a
    ShardStack; on one card every shard is on it). Default: every CUDA
    device (no card: an error, not a CPU run)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh_2d: no CUDA device; pass devices=['cpu'] to run "
                               "the shards on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [norm_device(d) for d in devices]
    if len(devices) >= n_data * n_idx:
        return [devices[d * n_idx : (d + 1) * n_idx] for d in range(n_data)]
    return [[devices[d % len(devices)]] * n_idx for d in range(n_data)]


def _to_dev(a, dev: torch.device) -> torch.Tensor | None:
    """A host array on `dev` (uint32 as its int32 bit pattern), None as None."""
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _upload(arrays: ShardedIndexArrays, dev: torch.device) -> ShardStack:
    t = lambda a: _to_dev(a, dev)  # noqa: E731
    return ShardStack(
        text2q=t(arrays.text2q[0]), sa_cmp=t(arrays.sa_cmp), sa_meta=t(arrays.sa_meta),
        kmer_rows=t(arrays.kmer_rows), lut_rows=t(arrays.lut_rows),
        slot_base=t(arrays.slot_base), chd_dir=t(arrays.chd_dir), chd_rows=t(arrays.chd_rows),
        txp_align=t(arrays.txp_align[0]),
        bases=_bases(arrays),
    )


def _bases(arrays: ShardedIndexArrays) -> tuple:
    return tuple((int(b), int(n)) for b, n in np.asarray(arrays.slot_base))


def _upload_shard(arrays: ShardedIndexArrays, p: int, dev: torch.device,
                  replicated: dict) -> DeviceQuasiIndex:
    """Shard p alone on `dev`, with the device's text2q and txp_align from
    `replicated` ({device: (text2q, txp_align)}, filled at first use)."""
    if dev not in replicated:
        ta = arrays.txp_align
        replicated[dev] = (_to_dev(arrays.text2q[0], dev),
                           None if ta is None else _to_dev(ta[0], dev))
    text2q, txp_align = replicated[dev]
    t = lambda a: None if a is None else _to_dev(a[p], dev)  # noqa: E731
    return DeviceQuasiIndex(
        text2q=text2q, sa_meta=t(arrays.sa_meta), sa_cmp=t(arrays.sa_cmp),
        chd_dir=t(arrays.chd_dir), chd_rows=t(arrays.chd_rows), kmer_rows=t(arrays.kmer_rows),
        lut_rows=t(arrays.lut_rows), txp_align=txp_align,
    )


def upload_sharded(arrays: ShardedIndexArrays, mesh: list[list],
                   split_idx: bool | None = None) -> list[ShardStack | ShardSet]:
    """One upload per data row of the mesh, whose rows name P devices, one
    a shard: a ShardStack on the row's device when its shards share one (the
    walk K8), else a ShardSet with shard p on row[p] (the trip loop with
    K10). Rows share what lies on a common device: one stack a device, one
    upload a (device, shard), text2q and txp_align once a device.

    split_idx: None splits a row exactly when its devices differ. True makes
    every row a ShardSet, even one whose shards all lie on one device: that
    is how one card, or the CPU, runs the split path (each shard uploaded on
    its own, so a forced split beside a stack of the same index holds the
    shard tables twice). False refuses a row whose devices differ."""
    P_ = arrays.sa_cmp.shape[0]
    stacks: dict = {}
    shards: dict = {}
    replicated: dict = {}
    out = []
    for row in mesh:
        devs = [norm_device(d) for d in row]
        if len(devs) != P_:
            raise ValueError(f"upload_sharded: mesh rows of {len(devs)} for {P_} shards")
        split = len(set(devs)) > 1 if split_idx is None else split_idx
        if not split:
            if len(set(devs)) > 1:
                raise ValueError("upload_sharded: split_idx=False, but a data row's shards lie "
                                 "on several devices")
            if devs[0] not in stacks:
                stacks[devs[0]] = _upload(arrays, devs[0])
            out.append(stacks[devs[0]])
            continue
        for p, dev in enumerate(devs):
            if (dev, p) not in shards:
                shards[dev, p] = _upload_shard(arrays, p, dev, replicated)
        out.append(ShardSet(shards=tuple(shards[dev, p] for p, dev in enumerate(devs)),
                            bases=_bases(arrays)))
    return out


def _copier(*tensors):
    """-> at(dev): the tensors on `dev`, contiguous, copied there at the first
    call for that device (no copy on the device they lie on)."""
    cache: dict = {}

    def at(dev):
        if dev not in cache:
            cache[dev] = tuple(t.to(dev).contiguous() for t in tensors)
        return cache[dev]

    return at


# ---- dense phase ------------------------------------------------------------------


def _probe_class_rows(didx: DeviceQuasiIndex, st: EngineStatic, can_hi, can_lo):
    """Shard-local canonical-class probe -> (hit, row (..., 6) int64 values).
    Hash math of ops.lookup; int64 rows (slot64) compare their keys as the
    zero-extended values they hold, int32 rows as uint32 bit patterns."""
    row = row_gather_nd(didx.chd_rows, _chd_hash(st, didx, can_hi, can_lo))
    wide = row.dtype == torch.int64
    row = row.to(torch.int64)
    khi, klo = (row[..., 0], row[..., 1]) if wide else (u32(row[..., 0]), u32(row[..., 1]))
    return (khi == can_hi) & (klo == can_lo), row


def dense_paired(shards: ShardStack | ShardSet, st: EngineStatic, reads, lens,
                 cfg: MapConfig) -> WalkInputs:
    """The canonical-class sharded dense phase (the reference's
    _sharded_scan_paired up to its walk): ONE class probe per forward window
    on every shard, on the shard's device, the strand-resolved 4-tuple
    summed over shards on the reads' device (a class is non-rejected on one
    shard at most, and its row carries global intervals). The lanes are laid
    out as ops.mmp.dense_phase lays them: [fwd; rc] with rc lanes
    right-aligned (col_off) and mirrored columns."""
    B, L = reads.shape
    k = st.k
    S = L - k + 1
    lens = lens.to(torch.int64)
    lens2 = torch.cat([lens, lens])
    lanes = torch.cat([reads, denc.comp_flip_batch(reads)], dim=0)
    col_off2 = torch.cat([torch.zeros_like(lens), L - lens])
    next_bad = denc.next_bad_batch(lanes, L)
    preads = pack_reads(lanes)
    key_hi, key_lo, kvalid = denc.kmer_keys_batch(reads, k)
    rhi, rlo = denc.rc_keys_batch(key_hi, key_lo, k)
    is_can = (key_hi < rhi) | ((key_hi == rhi) & (key_lo <= rlo))
    can_hi = torch.where(is_can, key_hi, rhi)
    can_lo = torch.where(is_can, key_lo, rlo)
    bf = ef = br = er = torch.zeros_like(key_hi)
    hitn = torch.zeros_like(kvalid)
    keys = _copier(can_hi, can_lo)
    for p in range(len(shards.bases)):
        didx = shards.local(p)
        hit, row = _probe_class_rows(didx, st, *keys(didx.sa_cmp.device))
        b_can, e_can, b_alt, e_alt = (torch.where(hit, row[..., c], 0).to(reads.device)
                                      for c in range(2, 6))
        hit = hit.to(reads.device)
        bf = bf + torch.where(is_can, b_can, b_alt)
        ef = ef + torch.where(is_can, e_can, e_alt)
        br = br + torch.where(is_can, b_alt, b_can)
        er = er + torch.where(is_can, e_alt, e_can)
        hitn = hitn | hit
    ok = kvalid & ((_cols(S, reads.device) + k) <= lens[:, None]) & hitn
    anch_f = ok & (ef > bf) & ((ef - bf) <= cfg.max_interval)
    anch_rF = ok & (er > br) & ((er - br) <= cfg.max_interval)  # fwd coords
    return WalkInputs(preads=preads, next_bad=next_bad, lens2=lens2, col_off2=col_off2,
                      bf=bf, ef=ef, br=br, er=er, anch_f=anch_f, anch_rF=anch_rF)


def dense_lanes(shards: ShardStack | ShardSet, st: EngineStatic, lanes, lens2,
                cfg: MapConfig) -> WalkInputs:
    """The per-strand sharded dense phase (the reference's _sharded_scan up
    to its walk) over explicit lanes: each shard probes its own k-mer range
    on its device (legacy CHD or binary search, shard-local intervals), and
    its hits come to the lanes' device, rebased by its slot offset and
    summed into global coordinates."""
    R, L = lanes.shape
    k = st.k
    S = L - k + 1
    lens2 = lens2.to(torch.int64)
    next_bad = denc.next_bad_batch(lanes, L)
    preads = pack_reads(lanes)
    key_hi, key_lo, kvalid = denc.kmer_keys_batch(lanes, k)
    live = kvalid & ((_cols(S, lanes.device) + k) <= lens2[:, None])
    b2 = e2 = torch.zeros_like(key_hi)
    nf = torch.zeros_like(live)
    keys = _copier(key_hi, key_lo)
    for p, (base, _) in enumerate(shards.bases):
        didx = shards.local(p)
        found, db, de = (t.to(lanes.device)
                         for t in kmer_lookup(didx, st, *keys(didx.sa_cmp.device)))
        found = found & live
        b2 = b2 + torch.where(found, db + base, 0)
        e2 = e2 + torch.where(found, de + base, 0)
        nf = nf | found
    anch = nf & ((e2 - b2) <= cfg.max_interval)
    return WalkInputs(preads=preads, next_bad=next_bad, lens2=lens2,
                      col_off2=torch.zeros_like(lens2), bf=b2, ef=e2, br=b2, er=e2,
                      anch_f=anch, anch_rF=anch)


# ---- the walk: K8 on a stack, the trip loop with K10 on a split row -------------

SHARDED_WALK_MAX_SHARDS = 1024  # csrc/walk.cu kMaxShards: the shard table in shared memory


def sharded_trip_plain(didx: DeviceQuasiIndex, base: int, n_local: int, preads, next_bad,
                       lens2, col_off2, b0, e0, pos, act, *, k: int, ext_steps: int,
                       out=None) -> tuple:
    """One shard's term of one trip of the sharded walk, in PyTorch (the
    reference's trip body on one idx shard up to its three psums,
    rapmap_tpu/parallel/sharded.py :583-600 and :433-451): the active lanes
    whose GLOBAL b0 the shard owns, b0 - base in [0, n_local) with the TRUE
    slot count, tested before the rebase, extend over the shard's rows at
    local slots (ops.extend_packed) -> (b + base, e + base, mlen) int64 on
    those lanes and (0, 0, 0) on the others; copied into `out`, three (R,)
    tensors, when given."""
    lb = b0 - base
    mine = act & (lb >= 0) & (lb < n_local)
    bl, el, ml = extend_packed(
        didx, preads, next_bad, lens2, lb.clamp(0, n_local), (e0 - base).clamp(0, n_local),
        pos, mine, k, ext_steps, preads.shape[1], col_off=col_off2,
    )
    res = (torch.where(mine, bl + base, 0), torch.where(mine, el + base, 0),
           torch.where(mine, ml, 0))
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return out


def trip_terms(shards: ShardStack | ShardSet, w: WalkInputs, trip, *, k: int,
               ext_steps: int):
    """A trip's per-shard terms over a data row's shards -> terms(b0, e0,
    pos, act, out=None) -> (P, 3, R) int64 on the lanes' device, [p] =
    shard p's (b, e, mlen): the trip's lane values go to every shard's
    device (copied once a device a trip; the lane inputs preads, next_bad,
    lens2 and col_off2 once a device a program), trip(..., out=) gives that
    shard's term there (sharded_trip_plain, or sharded_trip), written
    straight into out[p] on the lanes' device and copied there from any
    other. `out` is the buffer to reuse, else a new one."""
    home = w.lens2.device
    lanes = _copier(w.preads, w.next_bad, w.lens2, w.col_off2)
    shape = (len(shards.bases), 3, w.lens2.shape[0])

    def terms(b0, e0, pos, act, out=None):
        out = torch.empty(shape, dtype=torch.int64, device=home) if out is None else out
        at = _copier(b0, e0, pos, act)
        for p, (base, n_local) in enumerate(shards.bases):
            didx = shards.local(p)
            dev = didx.sa_cmp.device
            if dev == home:
                trip(didx, base, n_local, *lanes(dev), *at(dev), k=k, ext_steps=ext_steps,
                     out=out[p].unbind(0))
            else:
                out[p].copy_(torch.stack(trip(didx, base, n_local, *lanes(dev), *at(dev), k=k,
                                              ext_steps=ext_steps)))
        return out

    return terms


def trip_extension(shards: ShardStack | ShardSet, w: WalkInputs, trip, *, k: int,
                   ext_steps: int):
    """The walk's extension over a data row's shards -> extend(b0, e0, pos,
    act) -> (b, e, mlen): the sum of trip_terms' shard terms, the
    reference's three psums over the idx axis."""
    terms = trip_terms(shards, w, trip, k=k, ext_steps=ext_steps)
    return lambda b0, e0, pos, act: tuple(terms(b0, e0, pos, act).sum(0))


def walk_tables(w: WalkInputs, paired: bool) -> WalkTables:
    """The walk's lane-aligned tables, as the plain walks build them:
    strand-paired lanes through anchor_tables (rc lanes [R/2, R)), explicit
    lanes through the next-anchor table, all forward."""
    R = w.lens2.shape[0]
    if paired:
        db2, de2, anc2 = anchor_tables(w.bf, w.ef, w.br, w.er, w.anch_f, w.anch_rF)
        is_rc = torch.arange(R, device=w.lens2.device) >= R // 2
    else:
        db2, de2, anc2 = w.bf, w.ef, next_anchor_table(w.anch_f)
        is_rc = torch.zeros(w.lens2.shape, dtype=torch.bool, device=w.lens2.device)
    return WalkTables(db2, de2, anc2, is_rc, w.lens2)


def trip_loop(shards: ShardStack | ShardSet, w: WalkInputs, trip, advance, *, k: int, H: int,
              ext_steps: int, paired: bool) -> ScanHits:
    """H + 1 lockstep trips of the sharded walk on the lanes' device, as the
    reference's while_loop runs them (finished lanes masked; a trip with no
    lane active changes nothing): advance(tables, None, None) begins the
    walk, and each trip is the shards' terms (trip_terms(shards, w, trip),
    one reused (P, 3, R) buffer) and then advance(tables, state, terms).
    The trip count is fixed, so the loop does not wait on the device."""
    t = walk_tables(w, paired)
    terms = trip_terms(shards, w, trip, k=k, ext_steps=ext_steps)
    s = advance(t, None, None, k=k, H=H)
    buf = None
    for _ in range(H + 1):
        buf = terms(s.b0, s.e0, s.posc, s.act, out=buf)
        s = advance(t, s, buf, k=k, H=H)
    return walk_hits(s)


def sharded_walk_plain(shards: ShardStack | ShardSet, preads, next_bad, lens2, col_off2, bf,
                       ef, br, er, anch_f, anch_rF, *, k: int, H: int, ext_steps: int,
                       paired: bool) -> ScanHits:
    """The sharded walk in PyTorch, trip by trip as the reference's
    while_loop runs it (H + 1 lockstep trips, finished lanes masked): every
    shard extends the active lanes whose global anchor interval it owns
    (sharded_trip_plain), and the step's (b, e, mlen) is the sum over
    shards of the owners' results, rebased to global slots — 0 for a lane
    no shard owns."""
    w = WalkInputs(preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f, anch_rF)
    extend = trip_extension(shards, w, sharded_trip_plain, k=k, ext_steps=ext_steps)
    return _walk_plain(*walk_tables(w, paired), extend, k, H)


def _check_shard_table(bases) -> None:
    """Raise unless the stack holds 1..SHARDED_WALK_MAX_SHARDS shards whose
    slot ranges [offset, offset + true count) ascend and do not overlap: the
    kernel keeps the table in shared memory and takes the last shard whose
    offset is <= b0 as the only possible owner, which is exact only then
    (overlapping owners would be summed by the plain version)."""
    if not 1 <= len(bases) <= SHARDED_WALK_MAX_SHARDS:
        raise ValueError(f"sharded_walk: {len(bases)} shards; the kernel takes 1 to "
                         f"{SHARDED_WALK_MAX_SHARDS}")
    for p, (base, n) in enumerate(bases):
        nxt = bases[p + 1][0] if p + 1 < len(bases) else None
        if n < 0 or (nxt is not None and base + n > nxt):
            raise ValueError(f"sharded_walk: shard {p}'s slots [{base}, {base + n}) do not "
                             f"end at or before the next shard's offset {nxt}: the shards' "
                             "ranges must ascend and not overlap")


def _check_sharded_inputs(stack: ShardStack, w: WalkInputs, paired: bool) -> None:
    """Raise on what tqm_sharded_walk does not take: anything but contiguous
    int64 lanes and intervals, bool masks, an int32 (P, S_pad, 3 + F) sa_cmp
    stack of whole 8-byte rows with F <= WALK_FUSED_WORDS_MAX, a (nw, 4)
    text2q and an int32/int64 (P, 2) slot_base, all on one CUDA device; or a
    shard table the kernel cannot search (_check_shard_table)."""
    dev = w.lens2.device
    named = {**w._asdict(), "sa_cmp": stack.sa_cmp, "text2q": stack.text2q,
             "slot_base": stack.slot_base}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"sharded_walk: {name} lies on {t.device}, lens2 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"sharded_walk: {name} must be contiguous")
        want = ((torch.bool,) if name.startswith("anch")
                else (torch.int32,) if name in ("sa_cmp", "text2q")
                else (torch.int32, torch.int64) if name == "slot_base" else (torch.int64,))
        if t.dtype not in want:
            raise TypeError(f"sharded_walk: {name} must be {want[-1]}, got {t.dtype}")
    R, L = w.preads.shape
    if R == 0 or (paired and R % 2) or w.next_bad.shape != (R, L) or w.lens2.shape != (R,) \
            or w.col_off2.shape != (R,):
        raise ValueError("sharded_walk: preads and next_bad must be (R, L), lens2 and col_off2 "
                         "(R,), R >= 1 and R = 2B when paired")
    B = R // 2 if paired else R
    if w.bf.dim() != 2 or w.bf.shape[0] != B or any(t.shape != w.bf.shape for t in w[5:]):
        raise ValueError("sharded_walk: bf, ef, br, er, anch_f and anch_rF must share one "
                         "(B, S) shape")
    P_, _, FC = stack.sa_cmp.shape
    if FC % 2 or not 3 < FC <= 3 + WALK_FUSED_WORDS_MAX or stack.sa_cmp.data_ptr() % 8:
        raise ValueError("sharded_walk: sa_cmp must be (P, S_pad, 3 + F), F odd and "
                         f"<= {WALK_FUSED_WORDS_MAX}, on an 8-byte boundary")
    if stack.text2q.dim() != 2 or stack.text2q.shape[1] != 4 or \
            stack.slot_base.shape != (P_, 2) or len(stack.bases) != P_:
        raise ValueError("sharded_walk: text2q must be (nw, 4), slot_base (P, 2) and bases "
                         "P pairs")
    _check_shard_table(stack.bases)
    if dev.type != "cuda":
        raise ValueError(f"sharded_walk: no kernel for device {dev}")


def sharded_walk_args(stack: ShardStack, w: WalkInputs, out, *, k: int, H: int,
                      ext_steps: int, paired: bool) -> tuple[list, list]:
    """tqm_sharded_walk's ctypes argument types and values up to its stream,
    writing into out = (hits (R, H, 4) int64, n (R,) int64, truncated (R,)
    one byte each); the counting build tqm_sharded_walk_traffic takes its
    own three after these."""
    R, L = w.preads.shape
    P_, S_pad, FC = stack.sa_cmp.shape
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    types = [vp] * 11 + [i32, i64, i32, vp, i64, vp, i32, i64, i64] + [i32] * 6 + [vp] * 3
    vals = [*(t.data_ptr() for t in w), stack.sa_cmp.data_ptr(), P_, S_pad, FC - 3,
            stack.text2q.data_ptr(), stack.text2q.shape[0], stack.slot_base.data_ptr(),
            int(stack.slot64), R, R // 2 if paired else R, L, w.bf.shape[1], k, H, ext_steps,
            ext_words(L, k), *(t.data_ptr() for t in out)]
    return types, vals


def sharded_walk(shards: ShardStack | ShardSet, w: WalkInputs, *, k: int, H: int,
                 ext_steps: int, paired: bool) -> ScanHits:
    """The sharded walk after a sharded dense phase; hits carry global slots
    in int64. Over a ShardStack (a row's shards on one device): on CUDA
    tensors one launch of csrc/walk.cu's sharded build over the stack's
    shard tables (K8; one thread a lane, every output byte written by the
    kernel; counter `sharded_walk` for strand-paired lanes,
    `sharded_walk_lanes` for explicit ones), on CPU tensors
    `sharded_walk_plain`. The kernel takes at most SHARDED_WALK_MAX_SHARDS
    shards whose slot ranges ascend and do not overlap (as
    shard_quasi_index cuts them); the wrapper raises on any other table,
    with no fallback. Over a ShardSet (the shards on their own devices): the
    H + 1 lockstep trips on the lanes' device, each trip's extension one
    `sharded_trip` a shard on the shard's device, K10 on CUDA tensors
    (the plain extension never runs on the card) and
    sharded_trip_plain on CPU ones, and the trip's home half one
    `sharded_advance` on the lanes' device, K11 on CUDA tensors and
    sharded_advance_plain on CPU ones (trip_loop: no eager element-wise op
    inside a trip). The trip count is fixed, so the loop does not wait on
    the device."""
    if isinstance(shards, ShardSet):
        return trip_loop(shards, w, sharded_trip, sharded_advance, k=k, H=H,
                         ext_steps=ext_steps, paired=paired)
    stack = shards
    if all(t.device.type == "cpu" for t in (*w, stack.sa_cmp, stack.text2q)):
        return sharded_walk_plain(stack, *w, k=k, H=H, ext_steps=ext_steps, paired=paired)
    _check_sharded_inputs(stack, w, paired)
    R, L = w.preads.shape
    S = w.bf.shape[1]
    if S != L - k + 1 or H < 1:
        raise ValueError("sharded_walk: need S == L - k + 1 and H >= 1")
    dev = w.lens2.device
    buf = torch.empty((R, H, 4), dtype=torch.int64, device=dev)
    n = torch.empty((R,), dtype=torch.int64, device=dev)
    trunc = torch.empty((R,), dtype=torch.bool, device=dev)
    types, vals = sharded_walk_args(stack, w, (buf, n, trunc), k=k, H=H, ext_steps=ext_steps,
                                    paired=paired)
    fn = kernels.library("walk").tqm_sharded_walk
    fn.argtypes = types + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*vals, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tqm_sharded_walk launch failed: CUDA error {rc}")
    kernels.LAUNCHES["sharded_walk" if paired else "sharded_walk_lanes"] += 1
    return ScanHits(q=buf[..., 0], l=buf[..., 1], b=buf[..., 2], e=buf[..., 3],
                    n=n, truncated=trunc)


TRIP_INPUTS = ("preads", "next_bad", "lens2", "col_off2", "b0", "e0", "pos", "act")


def _check_trip_inputs(didx: DeviceQuasiIndex, lanes: tuple, n_local: int, out=()) -> None:
    """Raise on what tqm_sharded_trip does not take: anything but contiguous
    int64 lane tensors (preads and next_bad (R, L), lens2, col_off2, b0,
    e0 and pos (R,)) and a bool (R,) act, an int32 (n, 3 + F) sa_cmp of
    whole 8-byte rows on an 8-byte boundary with F <= WALK_FUSED_WORDS_MAX
    and an int32 (nw, 4) text2q, all on one CUDA device with the three
    int64 (R,) outputs `out` where given, and a true slot count in [0, n]."""
    named = {**dict(zip(TRIP_INPUTS, lanes)), "sa_cmp": didx.sa_cmp, "text2q": didx.text2q,
             **{f"out_{f}": o for f, o in zip(("b", "e", "mlen"), out)}}
    dev = lanes[0].device
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"sharded_trip: {name} lies on {t.device}, preads on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"sharded_trip: {name} must be contiguous")
        want = (torch.bool if name == "act" else torch.int32 if name in ("sa_cmp", "text2q")
                else torch.int64)
        if t.dtype != want:
            raise TypeError(f"sharded_trip: {name} must be {want}, got {t.dtype}")
    preads = lanes[0]
    if preads.dim() != 2 or preads.shape[0] == 0 or lanes[1].shape != preads.shape or any(
            t.shape != preads.shape[:1] for t in (*lanes[2:], *out)):
        raise ValueError("sharded_trip: preads and next_bad must be (R, L) and the other lane "
                         "inputs and the outputs (R,), R >= 1")
    if out and len(out) != 3:
        raise ValueError("sharded_trip: out must be three (R,) tensors (b, e, mlen)")
    if didx.sa_cmp.dim() != 2 or not didx.sa_cmp.shape[0] or didx.sa_cmp.shape[1] % 2 \
            or not 3 < didx.sa_cmp.shape[1] <= 3 + WALK_FUSED_WORDS_MAX \
            or didx.sa_cmp.data_ptr() % 8:
        raise ValueError("sharded_trip: sa_cmp must be (n, 3 + F), n >= 1, F odd and "
                         f"<= {WALK_FUSED_WORDS_MAX}, on an 8-byte boundary")
    if didx.text2q.dim() != 2 or didx.text2q.shape[1] != 4:
        raise ValueError("sharded_trip: text2q must be (nw, 4)")
    if not 0 <= n_local <= didx.sa_cmp.shape[0]:
        raise ValueError(f"sharded_trip: a true slot count of {n_local} for "
                         f"{didx.sa_cmp.shape[0]} sa_cmp rows")
    if dev.type != "cuda":
        raise ValueError(f"sharded_trip: no kernel for device {dev}")


def sharded_trip_args(didx: DeviceQuasiIndex, base: int, n_local: int, lanes: tuple, out, *,
                      k: int, ext_steps: int) -> tuple[list, list]:
    """tqm_sharded_trip's ctypes argument types and values up to its stream,
    for `lanes` in TRIP_INPUTS order, writing into out = (b, e, mlen) (R,)
    int64; the counting build tqm_sharded_trip_traffic takes its own three
    after these."""
    R, L = lanes[0].shape
    n, FC = didx.sa_cmp.shape
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    types = [vp] * 9 + [i64, i32, vp] + [i64] * 4 + [i32] * 4 + [vp] * 3
    vals = [*(t.data_ptr() for t in lanes), didx.sa_cmp.data_ptr(), n, FC - 3,
            didx.text2q.data_ptr(), didx.text2q.shape[0], base, n_local, R, L, k, ext_steps,
            ext_words(L, k), *(t.data_ptr() for t in out)]
    return types, vals


def sharded_trip(didx: DeviceQuasiIndex, base: int, n_local: int, preads, next_bad, lens2,
                 col_off2, b0, e0, pos, act, *, k: int, ext_steps: int, out=None) -> tuple:
    """One shard's term of one trip of the sharded walk (the split path's
    extension) -> (b, e, mlen), into `out` (three contiguous (R,) int64
    tensors on the lanes' device, e.g. a shard's slice of trip_terms'
    buffer) when given: on CUDA tensors one launch of csrc/walk.cu's
    tqm_sharded_trip on the shard's device (K10; one thread a lane, every
    output byte written by the kernel; counter `sharded_trip`), on CPU
    tensors sharded_trip_plain. Raises, with no fallback, on inputs the
    kernel does not take and when the build or the launch fails."""
    lanes = (preads, next_bad, lens2, col_off2, b0, e0, pos, act)
    if all(t.device.type == "cpu" for t in (*lanes, *(out or ()), didx.sa_cmp, didx.text2q)):
        return sharded_trip_plain(didx, base, n_local, *lanes, k=k, ext_steps=ext_steps,
                                  out=out)
    _check_trip_inputs(didx, lanes, n_local, tuple(out or ()))
    dev = preads.device
    if out is None:
        out = tuple(torch.empty(lens2.shape, dtype=torch.int64, device=dev) for _ in range(3))
    types, vals = sharded_trip_args(didx, base, n_local, lanes, out, k=k, ext_steps=ext_steps)
    fn = kernels.library("walk").tqm_sharded_trip
    fn.argtypes = types + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*vals, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tqm_sharded_trip launch failed: CUDA error {rc}")
    kernels.LAUNCHES["sharded_trip"] += 1
    return out


# ---- the trip's home half (K11) --------------------------------------------------


def sharded_advance_plain(t: WalkTables, s: WalkState | None, terms, *, k: int,
                          H: int) -> WalkState:
    """The split walk's trip at home, in PyTorch: with no state, the walk's
    begin (walk_begin: every lane at its first anchor, the first trip's
    inputs); else the P shards' terms (P, 3, R) summed into the step's (b,
    e, mlen), the reference's three psums (an active lane no shard owns gets
    (0, 0, 0)), and walk_advance: the hit written, the NIP skip, the next
    trip's inputs. The plain walks run the same two functions
    (ops/mmp.py _walk_plain)."""
    if s is None:
        return walk_begin(t, k=k, H=H)
    b1, e1, mlen = terms.sum(0)
    return walk_advance(t, s, b1, e1, mlen, k=k, H=H)


def _check_advance_inputs(t: WalkTables, s: WalkState, terms) -> None:
    """Raise on what tqm_sharded_advance does not take: anything but
    contiguous tables db2, de2, anc2 (R, S) int64 and lens2 (R,) int64 with
    a bool (R,) is_rc; a state of (R,) int64 pos, n, posc, b0, e0, bool
    trunc and act, and an (R, H, 4) int64 buf, H >= 1; and, after the
    begin, int64 terms (P, 3, R) with 1 <= P <= SHARDED_WALK_MAX_SHARDS,
    all on one CUDA device."""
    named = {**t._asdict(), **s._asdict(), **({} if terms is None else {"terms": terms})}
    dev = t.lens2.device
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"sharded_advance: {name} lies on {x.device}, lens2 on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"sharded_advance: {name} must be contiguous")
        want = torch.bool if name in ("is_rc", "trunc", "act") else torch.int64
        if x.dtype != want:
            raise TypeError(f"sharded_advance: {name} must be {want}, got {x.dtype}")
    if t.db2.dim() != 2 or 0 in t.db2.shape or t.de2.shape != t.db2.shape \
            or t.anc2.shape != t.db2.shape:
        raise ValueError("sharded_advance: db2, de2 and anc2 must share one (R, S) shape, "
                         "R, S >= 1")
    R = t.db2.shape[0]
    if any(x.shape != (R,) for x in (t.is_rc, t.lens2, *s[:3], *s[4:])):
        raise ValueError("sharded_advance: is_rc, lens2 and the state's lane tensors must "
                         "be (R,)")
    if s.buf.dim() != 3 or s.buf.shape[0] != R or s.buf.shape[1] < 1 or s.buf.shape[2] != 4:
        raise ValueError("sharded_advance: buf must be (R, H, 4), H >= 1")
    if terms is not None and (terms.dim() != 3 or terms.shape[1:] != (3, R)
                              or not 1 <= terms.shape[0] <= SHARDED_WALK_MAX_SHARDS):
        raise ValueError("sharded_advance: terms must be (P, 3, R), 1 <= P <= "
                         f"{SHARDED_WALK_MAX_SHARDS}")
    if dev.type != "cuda":
        raise ValueError(f"sharded_advance: no kernel for device {dev}")


def sharded_advance_args(t: WalkTables, s: WalkState, terms, *, k: int) -> tuple[list, list]:
    """tqm_sharded_advance's ctypes argument types and values up to its
    stream (terms None: the begin, which reads no terms)."""
    R, S = t.db2.shape
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    types = [vp, i32] + [vp] * 5 + [i64] + [i32] * 3 + [vp] * 8
    vals = [None if terms is None else terms.data_ptr(),
            0 if terms is None else terms.shape[0], *(x.data_ptr() for x in t), R, S, k,
            s.buf.shape[1], *(x.data_ptr() for x in s)]
    return types, vals


def sharded_advance(t: WalkTables, s: WalkState | None, terms, *, k: int,
                    H: int) -> WalkState:
    """The split walk's trip at home (its begin with s None, else the trip
    after its terms): on CUDA tensors one launch of csrc/walk.cu's
    tqm_sharded_advance on the lanes' device (K11; one thread a lane;
    counter `sharded_advance`), which begins into a new state (every byte,
    the hit buffer's zeros included, written by the kernel) or advances `s`
    IN PLACE and returns it; on CPU tensors sharded_advance_plain. Raises,
    with no fallback, on inputs the kernel does not take and when the build
    or the launch fails."""
    if all(x.device.type == "cpu" for x in (*t, *(s or ()),
                                            *(() if terms is None else (terms,)))):
        return sharded_advance_plain(t, s, terms, k=k, H=H)
    if (s is None) != (terms is None):
        raise ValueError("sharded_advance: the begin takes neither a state nor terms, a trip "
                         "both")
    if s is None:
        dev = t.lens2.device
        R = t.lens2.shape[0]

        def lane(dt):
            return torch.empty((R,), dtype=dt, device=dev)

        s = WalkState(pos=lane(torch.int64), n=lane(torch.int64), trunc=lane(torch.bool),
                      buf=torch.empty((R, H, 4), dtype=torch.int64, device=dev),
                      act=lane(torch.bool), posc=lane(torch.int64), b0=lane(torch.int64),
                      e0=lane(torch.int64))
    if s.buf.dim() == 3 and s.buf.shape[1] != H:
        raise ValueError(f"sharded_advance: buf holds {s.buf.shape[1]} hit slots, H = {H}")
    _check_advance_inputs(t, s, terms)
    types, vals = sharded_advance_args(t, s, terms, k=k)
    fn = kernels.library("walk").tqm_sharded_advance
    fn.argtypes = types + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = t.lens2.device
    with torch.cuda.device(dev):
        rc = fn(*vals, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tqm_sharded_advance launch failed: CUDA error {rc}")
    kernels.LAUNCHES["sharded_advance"] += 1
    return s


def scan_inputs(shards: ShardStack | ShardSet, st: EngineStatic, reads, lens, cfg: MapConfig):
    """A data row's dense phase -> (WalkInputs, the keyword arguments of
    `sharded_walk`): the canonical-class probe over strand-paired lanes, or
    explicit [fwd; revcomp] lanes through the per-strand CHD or the binary
    search."""
    kw = walk_params(st, cfg)
    if st.chd_canonical:
        return dense_paired(shards, st, reads, lens, cfg), dict(kw, paired=True)
    lanes = torch.cat([reads, denc.revcomp_batch(reads, lens)], dim=0)
    lens2 = torch.cat([lens, lens])
    return dense_lanes(shards, st, lanes, lens2, cfg), dict(kw, paired=False)


# ---- collate, score, counters -----------------------------------------------------


def _expand_fn(shards: ShardStack | ShardSet):
    """The collate's slot resolver: a GLOBAL slot (int64) goes to every
    shard's device and is resolved on the shard that owns it (ownership
    tested wide, the gather index local), and the shards' answers are summed
    on the slots' device, t carried as t + 1 so that 0 is "not mine"."""

    def expand_fn(p, q):
        slots = _copier(p)
        t1 = tp = torch.zeros_like(p)
        for s, (base, n_local) in enumerate(shards.bases):
            sa_meta = shards.local(s).sa_meta
            local = slots(sa_meta.device)[0] - base
            mine = (local >= 0) & (local < n_local)
            meta = row_gather_nd(sa_meta, local.clamp(0, sa_meta.shape[0] - 1)).to(torch.int64)
            t1 = t1 + torch.where(mine, meta[..., 0] + 1, 0).to(p.device)
            tp = tp + torch.where(mine, meta[..., 1], 0).to(p.device)
        return t1 - 1, tp - q

    return expand_fn


def _score_mapout(didx: DeviceQuasiIndex, cfg: MapConfig, reads, lens, out: MapOut) -> MapOut:
    """MapOut.score <- banded alignment scores (--mappingScore) of every
    slot of the slotted layout, masked (text2q and txp_align are replicated,
    so any shard's view scores it)."""
    from rapmap_tpu_torch.ops.align import score_records

    B, MO = out.t.shape
    rid = torch.arange(B, device=out.t.device).repeat_interleave(MO)
    valid = (out.t != -1).reshape(-1)
    sc = score_records(
        didx, cfg, reads, lens, rid, out.t.reshape(-1).clamp(min=0),
        torch.where(valid, out.pos.reshape(-1), 0), out.strand.reshape(-1), valid,
    )
    return out._replace(score=torch.where(valid, sc, 0).reshape(B, MO).to(out.score.dtype))


def _map_rows(shards: ShardStack | ShardSet, st: EngineStatic, reads, lens,
              cfg: MapConfig) -> MapOut:
    """One data row's slice of reads, on the row's home device, through the
    sharded engine -> MapOut."""
    w, kw = scan_inputs(shards, st, reads, lens, cfg)
    hits = sharded_walk(shards, w, **kw)
    out = collate_batch(None, None, hits, lens, cfg, expand_fn=_expand_fn(shards))
    if cfg.mapping_score:
        out = _score_mapout(shards.local(0), cfg, reads, lens, out)
    return out


def _rows(sharr, mesh, B: int):
    uploads = sharr if isinstance(sharr, list) else upload_sharded(sharr, mesh)
    if B % len(uploads):
        raise ValueError(f"batch of {B} rows does not split over {len(uploads)} data rows")
    per = B // len(uploads)
    return [(u, slice(d * per, (d + 1) * per)) for d, u in enumerate(uploads)]


def map_batch_se_sharded(
    sharr: ShardedIndexArrays | list[ShardStack | ShardSet],
    st: EngineStatic,
    reads: torch.Tensor,       # (B_total, L) int8
    lens: torch.Tensor,        # (B_total,)
    n_valid_local,             # (n_data,) valid rows per data shard
    cfg: MapConfig,
    mesh: list[list[torch.device]],
) -> tuple[MapOut, Counters]:
    """Single-end mapping on the sharded index -> (MapOut in data-row
    order, summed Counters) on the first row's home device. sharr: the host
    arrays (uploaded for this call, upload_sharded's layouts) or
    upload_sharded's uploads."""
    outs, ctrs = [], []
    for d, (shards, rows) in enumerate(_rows(sharr, mesh, reads.shape[0])):
        dev = shards.home
        r, ln, nv = reads[rows].to(dev), lens[rows].to(dev), _n_valid(n_valid_local, d, dev)
        out = _map_rows(shards, st, r, ln, cfg)
        outs.append(out)
        ctrs.append(mapout_counters(out, nv))
    home = outs[0].t.device
    return _join(outs, home), _sum(ctrs, home)


def map_batch_pe_sharded(
    sharr: ShardedIndexArrays | list[ShardStack | ShardSet], st: EngineStatic,
    reads1, lens1, reads2, lens2, n_valid_local, cfg: MapConfig,
    mesh: list[list[torch.device]],
) -> tuple[MapOut, MapOut, PairOut, Counters]:
    """Paired-end mapping on the sharded index: both mates of each data
    row's slice through the engine, then the pair merge."""
    o1s, o2s, pos, ctrs = [], [], [], []
    for d, (shards, rows) in enumerate(_rows(sharr, mesh, reads1.shape[0])):
        dev = shards.home
        nv = _n_valid(n_valid_local, d, dev)
        o1 = _map_rows(shards, st, reads1[rows].to(dev), lens1[rows].to(dev), cfg)
        o2 = _map_rows(shards, st, reads2[rows].to(dev), lens2[rows].to(dev), cfg)
        pairs = merge_pairs_batch(o1, o2, cfg)
        o1s.append(o1)
        o2s.append(o2)
        pos.append(pairs)
        ctrs.append(pair_counters(o1, o2, pairs, nv))
    home = o1s[0].t.device
    return _join(o1s, home), _join(o2s, home), _join(pos, home), _sum(ctrs, home)
