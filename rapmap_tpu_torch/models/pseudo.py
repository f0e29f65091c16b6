"""PseudoMapper — kallisto-style k-mer-only mapping engine (SEMANTICS.md §7).

Port of rapmap_tpu.models.pseudo: no suffix array; each k-mer hit yields its
CSR occurrence list directly, with jump-ahead of k on a hit. It reuses the
quasi engine's probes (the canonical-class CHD, where one probe answers both
strands of a window, or the legacy CHD / prefix-LUT binary search over
explicit [fwd; revcomp] lanes), the anchor masks, the walk kernel of
csrc/walk.cu built without an extension (ops.mmp.pseudo_walk) and the
global-pool collation through the collate's expand_fn hook:

  wire_in -> reads -> pseudo dense phase -> pseudo walk -> collation with
  the CSR resolver [-> pair merge] -> wire_out

Occurrence ids ride the tables as the reference's int32 bit patterns; the
probes read them as uint32 values (ops.lookup), so a big-occ table's ids in
[2^31, 2^32) are exact here and every interval width is its true width.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from rapmap_tpu_torch.config import MapConfig, auto_expand_budget
from rapmap_tpu_torch.index.format import PseudoIndex
from rapmap_tpu_torch.index.kmer_table import build_prefix_lut
from rapmap_tpu_torch.models.quasi import (
    Counters, MapOut, _chunk_block, _chunk_counters, _host, _join_chunks, _Mapper,
    _packed_cf, _pe_flags, cuda_or, mapout_counters, pair_counters,
)
from rapmap_tpu_torch.ops import encode as denc
from rapmap_tpu_torch.ops.bits import M32
from rapmap_tpu_torch.ops.collate import collate_batch, collate_records_se
from rapmap_tpu_torch.ops.compact import compact_pe, compact_se
from rapmap_tpu_torch.ops.extend_packed import pack_reads
from rapmap_tpu_torch.ops.gather import row_gather_nd
from rapmap_tpu_torch.ops.lookup import kmer_lookup, kmer_lookup_2str
from rapmap_tpu_torch.ops.mmp import PseudoWalkInputs, ScanHits, pseudo_walk
from rapmap_tpu_torch.ops.pairs import PairOut, merge_pairs_batch
from rapmap_tpu_torch.ops.wire import encode_read_flags, pack_out, unpack_in_pe, unpack_in_se


class DevicePseudoIndex(NamedTuple):
    """Tensors the pseudo path gathers from, int32, on one device."""

    kmer_rows: torch.Tensor  # (K, 4) [hi, lo, occ_b, occ_e]
    lut_rows: torch.Tensor   # (4^p, 2)
    # [txp, pos] occurrence rows: (NOcc, 2) normally; in the big-occ layout
    # (st.occ_pairs) TWO occurrences a row, (ceil(NOcc/2), 4)
    occ_rows: torch.Tensor
    # CHD (2-gather probe); None = binary-search path
    chd_dir: torch.Tensor | None = None   # (2^m_bits,)
    chd_rows: torch.Tensor | None = None  # (2^t_bits, 6) canonical or (2^t_bits, 4) legacy


@dataclass(frozen=True)
class PseudoStatic:
    k: int
    prefix_bases: int
    lookup_steps: int
    use_chd: bool = False
    chd_seed: int = 0
    chd_m_bits: int = 0
    chd_t_bits: int = 0
    chd_p_bits: int = 0  # partitioned slot formula (ops.lookup.chd_slot)
    chd_canonical: bool = False
    occ_pairs: bool = False  # big-occ (>= 2^31) layout: occ ids are uint32
    # bit patterns riding int32 arrays, occ_rows pairs


def _u32_i32(a: np.ndarray) -> np.ndarray:
    """Values in [0, 2^32) -> their uint32 bit pattern as int32 (the
    reference's device arrays carry big-occ ids so)."""
    return (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _occ_rows(idx: PseudoIndex, occ_pairs: bool) -> np.ndarray:
    if len(idx.occ_txp) == 0:
        return np.zeros((1, 4 if occ_pairs else 2), np.int32)
    ot = np.asarray(idx.occ_txp, np.int32)
    op = np.asarray(idx.occ_pos, np.int32)
    if not occ_pairs:
        return np.stack([ot, op], axis=1)
    n2 = (len(ot) + 1) // 2
    rows = np.zeros((n2, 4), np.int32)
    rows[:, 0], rows[:, 1] = ot[0::2], op[0::2]
    rows[: len(ot) // 2, 2], rows[: len(ot) // 2, 3] = ot[1::2], op[1::2]
    return rows


def _chd_rows(idx: PseudoIndex, kmer_rows: np.ndarray, off: np.ndarray,
              canonical: bool) -> np.ndarray:
    """The CHD's slot rows: canonical class rows [chi, clo, b_fwd, e_fwd,
    b_rc, e_rc] over CSR occurrence ranges (an orientation absent from the
    text gets b = e = 0: empty, not found), or legacy per-strand rows."""
    perm = np.asarray(idx.chd_perm, dtype=np.int64)
    if not canonical:
        sentinel = np.array([-1, -1, 0, 0], dtype=np.int32)
        return np.where((perm >= 0)[:, None], kmer_rows[np.clip(perm, 0, len(kmer_rows) - 1)],
                        sentinel[None, :]).astype(np.int32)
    from rapmap_tpu_torch.index.chd import key64_of, rc_key64_np

    khi = np.asarray(idx.kmer_hi, dtype=np.uint32)
    klo = np.asarray(idx.kmer_lo, dtype=np.uint32)
    cls = np.asarray(idx.chd_cls, dtype=np.int64)  # (n_cls, 2)
    fwd_r, rc_r = cls[:, 0], cls[:, 1]
    key64 = key64_of(khi, klo)
    Kc = max(len(khi) - 1, 0)
    ck = np.where(fwd_r >= 0, key64[np.clip(fwd_r, 0, Kc)],
                  rc_key64_np(key64[np.clip(rc_r, 0, Kc)], idx.k))

    def iv(r):
        rcl = np.clip(r, 0, Kc)
        valid = r >= 0
        return (_u32_i32(np.where(valid, off[:-1][rcl], 0)),
                _u32_i32(np.where(valid, off[1:][rcl], 0)))

    bf, ef = iv(fwd_r)
    br, er = iv(rc_r)
    cls_rows = np.stack([
        (ck >> np.uint64(32)).astype(np.uint32).view(np.int32),
        (ck & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32),
        bf, ef, br, er,
    ], axis=1)
    sentinel = np.array([-1, -1, 0, 0, 0, 0], dtype=np.int32)
    return np.where((perm >= 0)[:, None], cls_rows[np.clip(perm, 0, len(cls_rows) - 1)],
                    sentinel[None, :]).astype(np.int32)


def upload_pseudo_index(
    idx: PseudoIndex, device, force_pairs: bool = False
) -> tuple[DevicePseudoIndex, PseudoStatic]:
    """The pseudo index's device tables (equal, element for element, to the
    reference's DevicePseudoIndex) on `device`, and its static facts. The
    big-occ layout (two occurrences a row, ids as uint32 bit patterns) is
    taken at >= 2^31 occurrences or with force_pairs."""
    n_occ = int(np.asarray(idx.kmer_off)[-1])
    if n_occ >= 2**32:
        raise ValueError(
            "pseudo index with >= 2^32 occurrences exceeds the single-device "
            "big-occ layout; the index must be sharded"
        )
    occ_pairs = force_pairs or n_occ >= 2**31
    khi = np.asarray(idx.kmer_hi, dtype=np.uint32)
    klo = np.asarray(idx.kmer_lo, dtype=np.uint32)
    off = np.asarray(idx.kmer_off, dtype=np.int64)
    K = len(khi)
    p = max(4, min(idx.k, 12, math.ceil(math.log(max(K, 2), 4)) + 1))
    lut = build_prefix_lut(khi, klo, idx.k, p)
    lut_rows = np.stack([lut[:-1], lut[1:]], axis=1).astype(np.int32)
    max_bucket = int(np.max(np.diff(lut))) if len(lut) > 1 else 1
    steps = max(1, math.ceil(math.log2(max_bucket + 1)) + 1)
    kmer_rows = np.stack(
        [khi.view(np.int32), klo.view(np.int32), _u32_i32(off[:-1]), _u32_i32(off[1:])], axis=1,
    ) if K else np.zeros((1, 4), np.int32)
    chd = idx.meta.get("chd") if getattr(idx, "chd_dir", None) is not None else None
    canonical = bool(chd.get("canonical")) if chd else False

    def dev(a):
        a = np.ascontiguousarray(a)  # a read-only (memory-mapped) array is copied
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)

    didx = DevicePseudoIndex(
        kmer_rows=dev(kmer_rows), lut_rows=dev(lut_rows), occ_rows=dev(_occ_rows(idx, occ_pairs)),
        chd_dir=dev(np.asarray(idx.chd_dir, dtype=np.int32)) if chd else None,
        chd_rows=dev(_chd_rows(idx, kmer_rows, off, canonical)) if chd else None,
    )
    return didx, PseudoStatic(
        k=idx.k, prefix_bases=p, lookup_steps=steps,
        use_chd=chd is not None,
        chd_seed=int(chd["seed"]) if chd else 0,
        chd_m_bits=int(chd["m_bits"]) if chd else 0,
        chd_t_bits=int(chd["t_bits"]) if chd else 0,
        chd_p_bits=int(chd.get("p_bits", 0)) if chd else 0,
        chd_canonical=canonical,
        occ_pairs=occ_pairs,
    )


def csr_expand_fn(didx: DevicePseudoIndex, st: PseudoStatic):
    """The collate's expand hook: occurrence id p, query pos q -> (txp,
    tpos). Big-occ layout (st.occ_pairs): p is a uint32 value (the reference
    wraps it through int32); p >> 1 is its row and the parity bit selects the
    row half."""
    if st.occ_pairs:
        def fn(p, q):
            pu = p & M32
            meta = row_gather_nd(didx.occ_rows, pu >> 1).to(torch.int64)
            odd = (pu & 1) == 1
            t = torch.where(odd, meta[..., 2], meta[..., 0])
            pos = torch.where(odd, meta[..., 3], meta[..., 1])
            return t, pos - q

        return fn

    def fn(p, q):
        meta = row_gather_nd(didx.occ_rows, p).to(torch.int64)
        return meta[..., 0], meta[..., 1] - q

    return fn


def _window_keys(reads: torch.Tensor, k: int):
    """(hi, lo, valid) of every k-window of each row, (R, S), from the
    packed words (the keys ops.encode.kmer_keys_batch builds base by base,
    in a few launches instead of ~8 a base)."""
    R, L = reads.shape
    S = L - k + 1
    if S < 1:
        raise ValueError("reads shorter than k")
    return denc.kmer_keys_from_packed(pack_reads(reads), denc.next_bad_batch(reads, L), k, S)


def _cols(S: int, dev) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int64, device=dev)[None, :]


def pseudo_dense_lanes(didx, st: PseudoStatic, reads, lens, cfg: MapConfig) -> PseudoWalkInputs:
    """Every window of every explicit lane probed through kmer_lookup (legacy
    CHD or prefix-LUT binary search); anchors are found windows of pure ACGT
    inside the read whose interval is at most cfg.max_interval wide."""
    k = st.k
    lens = lens.to(torch.int64)
    key_hi, key_lo, kvalid = _window_keys(reads, k)
    found, db, de = kmer_lookup(didx, st, key_hi, key_lo)
    in_len = (_cols(db.shape[1], reads.device) + k) <= lens[:, None]
    anchor = found & kvalid & in_len & ((de - db) <= cfg.max_interval)
    return PseudoWalkInputs(lens, db, de, db, de, anchor, anchor)


def pseudo_dense_paired(didx, st: PseudoStatic, reads, lens,
                        cfg: MapConfig) -> PseudoWalkInputs:
    """One canonical probe per forward window answers both strands: the rc
    lane's window at position p is the reverse complement of the forward
    window at column lens - k - p. Requires st.chd_canonical."""
    k = st.k
    lens = lens.to(torch.int64)
    key_hi, key_lo, kvalid = _window_keys(reads, k)
    ff, bf, ef, fr, br, er = kmer_lookup_2str(didx, st, key_hi, key_lo)
    ok = kvalid & ((_cols(bf.shape[1], reads.device) + k) <= lens[:, None])
    anch_f = ff & ok & ((ef - bf) <= cfg.max_interval)
    anch_rF = fr & ok & ((er - br) <= cfg.max_interval)  # rc anchors, fwd columns
    return PseudoWalkInputs(torch.cat([lens, lens]), bf, ef, br, er, anch_f, anch_rF)


def pseudo_scan_batch(didx, st: PseudoStatic, reads, lens, cfg: MapConfig) -> ScanHits:
    """k-mer walk with jump-ahead k on a hit (SEMANTICS.md §7) over explicit
    lanes, each walked forward: the dense lookup of every window, then one
    launch of the pseudo walk (misses cost no trip)."""
    w = pseudo_dense_lanes(didx, st, reads, lens, cfg)
    return pseudo_walk(*w, k=st.k, H=cfg.max_hits_per_strand, paired=False)


def pseudo_scan_batch_paired(didx, st: PseudoStatic, reads, lens, cfg: MapConfig) -> ScanHits:
    """Both strands' jump-ahead-k walks from one canonical probe per forward
    window. Rows [0, B) are forward lanes, [B, 2B) rc."""
    w = pseudo_dense_paired(didx, st, reads, lens, cfg)
    return pseudo_walk(*w, k=st.k, H=cfg.max_hits_per_strand, paired=True)


def pseudo_scan_dispatch(didx, st: PseudoStatic, reads, lens, cfg: MapConfig) -> ScanHits:
    """The canonical paired scan when the index carries a canonical CHD,
    else the explicit [fwd; rc]-lane scan. Rows [0, B) fwd, [B, 2B) rc."""
    if st.chd_canonical:
        return pseudo_scan_batch_paired(didx, st, reads, lens, cfg)
    lens = lens.to(torch.int64)
    lanes = torch.cat([reads, denc.revcomp_batch(reads, lens)], dim=0)
    return pseudo_scan_batch(didx, st, lanes, torch.cat([lens, lens]), cfg)


def pseudo_map_batch_se(didx, st, reads, lens, n_valid, cfg: MapConfig
                        ) -> tuple[MapOut, Counters]:
    hits = pseudo_scan_dispatch(didx, st, reads, lens, cfg)
    out = collate_batch(None, None, hits, lens, cfg, expand_fn=csr_expand_fn(didx, st))
    return out, mapout_counters(out, n_valid)


def pseudo_map_batch_pe(didx, st, r1, l1, r2, l2, n_valid, cfg: MapConfig):
    o1, _ = pseudo_map_batch_se(didx, st, r1, l1, n_valid, cfg)
    o2, _ = pseudo_map_batch_se(didx, st, r2, l2, n_valid, cfg)
    pairs = merge_pairs_batch(o1, o2, cfg)
    return o1, o2, pairs, pair_counters(o1, o2, pairs, n_valid)


def pseudo_map_batch_se_wire(didx, st, wire_in, cfg: MapConfig, cap: int, B: int,
                             L: int) -> torch.Tensor:
    """Single-buffer in/out pseudo SE step, one program over the batch."""
    reads, lens, n_valid = unpack_in_se(wire_in, B, L)
    out, ctr = pseudo_map_batch_se(didx, st, reads, lens, n_valid, cfg)
    flags = encode_read_flags(out.over_budget, out.out_truncated, out.too_ambiguous, out.mapped)
    return pack_out(compact_se(out, cap), ctr, flags)


def pseudo_map_batch_se_wire_chunked(didx, st, wire_in, cfg: MapConfig, capc: int, B: int,
                                     L: int, C: int) -> torch.Tensor:
    """Pseudo SE wire step over fixed (C)-read chunks, laid out as the quasi
    one: the direct-compact collate with the CSR expand_fn (records stay 4
    words: PseudoStatic has no field-bound stats for packing)."""
    if B % C:
        raise ValueError("batch must be a multiple of the chunk size")
    packed_cf = _packed_cf(cfg, C)
    reads, lens, n_valid = unpack_in_se(wire_in, B, L)
    expand_fn = csr_expand_fn(didx, st)
    blocks = []
    for c in range(B // C):
        r, ln = reads[c * C : (c + 1) * C], lens[c * C : (c + 1) * C]
        nv = (n_valid - c * C).clamp(0, C)
        hits = pseudo_scan_dispatch(didx, st, r, ln, cfg)
        se, flags = collate_records_se(None, None, hits, ln, cfg, capc, expand_fn=expand_fn)
        fbits = encode_read_flags(
            flags.over_budget, flags.out_truncated, flags.too_ambiguous, flags.mapped
        )
        blocks.append(_chunk_block(se, _chunk_counters(flags, nv, C), fbits, packed_cf))
    return _join_chunks(blocks)


def pseudo_map_batch_pe_wire(didx, st, wire_in, cfg: MapConfig, cap: int, B: int,
                             L: int) -> torch.Tensor:
    """Single-buffer in/out pseudo PE step, one program over the batch (the
    reference has no chunked pseudo PE program)."""
    r1, l1, r2, l2, n_valid = unpack_in_pe(wire_in, B, L)
    o1, o2, pairs, ctr = pseudo_map_batch_pe(didx, st, r1, l1, r2, l2, n_valid, cfg)
    return pack_out(compact_pe(pairs, cap), ctr, _pe_flags(o1, o2, pairs))


class PseudoMapper(_Mapper):
    """Host-side owner of the pseudo index and its mapping loop (the
    interface of QuasiMapper).

    device=None means the CUDA card; without one it raises instead of
    running on the CPU. Pass device="cpu" to run the plain PyTorch versions
    of every kernel on the CPU."""

    def __init__(self, idx: PseudoIndex, cfg: MapConfig | None = None,
                 force_big_occ: bool = False, device=None):
        self.device = cuda_or(device, "PseudoMapper")
        if cfg is None:
            cfg = MapConfig(k=idx.k)
        if cfg.k != idx.k:
            raise ValueError(f"config k={cfg.k} != index k={idx.k}")
        if cfg.expand_budget == 0:
            cfg = replace(cfg, expand_budget=auto_expand_budget(np.diff(np.asarray(idx.kmer_off))))
        self.cfg = cfg
        self.didx, self.st = upload_pseudo_index(idx, self.device, force_pairs=force_big_occ)
        self.host_index = idx  # oracle fallback for budget-degraded reads
        self.txp_names = idx.txp_names
        self.txp_lens = np.asarray(idx.txp_lens)

    def map_se(self, codes, lens, n_valid: int | None = None):
        """-> (MapOut, Counters) as numpy (int32 fields, bool flags)."""
        out, ctr = pseudo_map_batch_se(
            self.didx, self.st, self._codes(codes), self._lens(lens),
            self._n_valid(n_valid, len(lens)), self.cfg,
        )
        return MapOut(*map(_host, out)), Counters(*map(_host, ctr))

    def map_pe(self, c1, l1, c2, l2, n_valid: int | None = None):
        """-> (MapOut left, MapOut right, PairOut, Counters) as numpy."""
        o1, o2, pairs, ctr = pseudo_map_batch_pe(
            self.didx, self.st, self._codes(c1), self._lens(l1), self._codes(c2),
            self._lens(l2), self._n_valid(n_valid, len(l1)), self.cfg,
        )
        return (MapOut(*map(_host, o1)), MapOut(*map(_host, o2)),
                PairOut(*map(_host, pairs)), Counters(*map(_host, ctr)))

    def _program(self, kind: str, win: torch.Tensor, B: int, L: int):
        """SE: chunked when the batch allows, else one program; PE: one
        program over the batch."""
        C = self._chunk_of(B) if kind == "se" else 0
        if C:
            capc = self._cap(C)
            out = pseudo_map_batch_se_wire_chunked(self.didx, self.st, win, self.cfg, capc,
                                                   B, L, C)
            return out, C, capc, None
        fn = pseudo_map_batch_se_wire if kind == "se" else pseudo_map_batch_pe_wire
        return fn(self.didx, self.st, win, self.cfg, self._cap(B), B, L), 0, 0, None

    def _pe_width(self) -> int:
        """The pseudo path carries no alignment score: seven PE fields."""
        return 7
