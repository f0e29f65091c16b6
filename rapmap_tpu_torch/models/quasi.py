"""QuasiMapper — the end-to-end quasi-mapping engine on one device.

Port of rapmap_tpu.models.quasi (single-end and paired-end):
  wire_in -> reads -> MMP scan (ops.mmp) -> collation (ops.collate)
  [-> pair merge (ops.pairs)] -> wire_out (ops.wire)
either as one program over the whole batch (`map_batch_se_wire`,
`map_batch_pe_wire`: the slotted MapOut / PairOut of `map_batch_se` /
`map_batch_pe`, compacted by ops.compact) or, when the batch is a multiple
of two or more cfg.chunk, one chunk at a time with the direct compaction
(`map_batch_se_wire_chunked`, `map_batch_pe_wire_chunked`). `map_se` and
`map_pe` are the library calls that return the slotted layouts themselves.

`map_se_async` / `map_pe_async` enqueue the batch on the device's current
stream and start a non-blocking copy of the result into pinned host memory;
`fetch` waits for that copy alone, so a caller can hold batches in flight
while it prepares the next. Every call pins fresh buffers, and a fetched
result's records may be a view of its buffer: nothing is reused while a
result is alive. With cfg.mapping_score every record carries its banded
alignment score (ops.align, the CUDA kernel of csrc/align.cu on the card):
the SE score field, and two per-mate fields after a PE row's seven.
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from rapmap_tpu_torch.config import MapConfig, auto_expand_budget, sampled_width
from rapmap_tpu_torch.index.format import QuasiIndex
from rapmap_tpu_torch.ops.collate import MapOut, collate_batch, collate_records_se
from rapmap_tpu_torch.ops.compact import compact_pe, compact_se, rid_from_counts
from rapmap_tpu_torch.ops.device_index import DeviceQuasiIndex, EngineStatic, upload_index
from rapmap_tpu_torch.ops.mmp import scan_dispatch
from rapmap_tpu_torch.ops.pairs import (
    PairOut, collate_records_pe, merge_pairs_batch, pe_direct_eligible,
)
from rapmap_tpu_torch.ops.wire import (
    HDR, encode_read_flags, in_bytes, pack_counts_flags, pack_in_pe, pack_in_se, pack_out,
    rec_spec_pe, rec_spec_se, unpack_in_pe, unpack_in_se, unpack_out,
)
from rapmap_tpu_torch.utils.timers import span


class Counters(NamedTuple):
    """HitCounters equivalent (SURVEY.md §5.5); scalar tensors."""

    reads_total: torch.Tensor
    reads_mapped: torch.Tensor
    too_ambiguous: torch.Tensor
    over_budget: torch.Tensor
    records: torch.Tensor
    out_truncated: torch.Tensor  # reads whose records exceeded cfg.out_slots


def map_batch_se(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads: torch.Tensor,    # (B, L) int8
    lens: torch.Tensor,     # (B,)
    n_valid: torch.Tensor,  # scalar: non-pad rows
    cfg: MapConfig,
) -> tuple[MapOut, Counters]:
    hits = scan_dispatch(didx, st, reads, lens, cfg)
    with span("tqm.vote"):
        out = collate_batch(didx, st, hits, lens, cfg)
    return out, mapout_counters(out, n_valid)


def mapout_counters(out: MapOut, n_valid: torch.Tensor) -> Counters:
    """A slotted SE batch's counters over its first n_valid rows."""
    real = torch.arange(out.t.shape[0], device=out.t.device) < n_valid
    return Counters(
        reads_total=n_valid,
        reads_mapped=(out.mapped & real).sum(),
        too_ambiguous=(out.too_ambiguous & real).sum(),
        over_budget=(out.over_budget & real).sum(),
        records=((out.t != -1) & real[:, None]).sum(),
        out_truncated=(out.out_truncated & real).sum(),
    )


def map_batch_pe(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads1: torch.Tensor,
    lens1: torch.Tensor,
    reads2: torch.Tensor,
    lens2: torch.Tensor,
    n_valid: torch.Tensor,
    cfg: MapConfig,
) -> tuple[MapOut, MapOut, PairOut, Counters]:
    out1, _ = map_batch_se(didx, st, reads1, lens1, n_valid, cfg)
    out2, _ = map_batch_se(didx, st, reads2, lens2, n_valid, cfg)
    with span("tqm.merge"):
        pairs = merge_pairs_batch(out1, out2, cfg)
    return out1, out2, pairs, pair_counters(out1, out2, pairs, n_valid)


def pair_counters(out1: MapOut, out2: MapOut, pairs: PairOut, n_valid: torch.Tensor) -> Counters:
    """A slotted PE batch's counters over its first n_valid pairs."""
    real = torch.arange(pairs.t.shape[0], device=pairs.t.device) < n_valid
    return Counters(
        reads_total=n_valid,
        reads_mapped=(pairs.any_record & real).sum(),
        too_ambiguous=(pairs.too_ambiguous & real).sum(),
        over_budget=((out1.over_budget | out2.over_budget) & real).sum(),
        records=((pairs.t != -1) & real[:, None]).sum(),
        out_truncated=(
            (out1.out_truncated | out2.out_truncated | pairs.out_truncated) & real
        ).sum(),
    )


def _pe_flags(out1: MapOut, out2: MapOut, pairs: PairOut) -> torch.Tensor:
    return encode_read_flags(
        out1.over_budget | out2.over_budget,
        out1.out_truncated | out2.out_truncated | pairs.out_truncated,
        pairs.too_ambiguous, pairs.any_record,
    )


def map_batch_se_wire(
    didx: DeviceQuasiIndex, st: EngineStatic, wire_in: torch.Tensor,
    cfg: MapConfig, cap: int, B: int, L: int,
) -> torch.Tensor:
    """Single-buffer in/out SE mapping step (ops.wire format), one program
    over the whole batch -> int32 wire_out on the wire's device. With
    cfg.mapping_score the compacted rows' score column is replaced, in
    place, by their alignment scores."""
    reads, lens, n_valid = unpack_in_se(wire_in, B, L)
    out, ctr = map_batch_se(didx, st, reads, lens, n_valid, cfg)
    flags = encode_read_flags(out.over_budget, out.out_truncated, out.too_ambiguous, out.mapped)
    with span("tqm.compact"):
        se = compact_se(out, cap)
    if cfg.mapping_score:
        from rapmap_tpu_torch.ops.align import score_records

        with span("tqm.score"):
            rid = rid_from_counts(se.counts, cap)
            live = torch.arange(cap, device=se.recs.device) < se.total.clamp(max=cap)
            se.recs[:, 3] = score_records(didx, cfg, reads, lens, rid, se.recs[:, 0],
                                          se.recs[:, 1], se.recs[:, 2], live)
    with span("tqm.pack_out"):
        return pack_out(se, ctr, flags)


def map_batch_pe_wire(
    didx: DeviceQuasiIndex, st: EngineStatic, wire_in: torch.Tensor,
    cfg: MapConfig, cap: int, B: int, L: int,
) -> torch.Tensor:
    """Single-buffer in/out PE mapping step, one program over the whole
    batch -> int32 wire_out (7 fields a record, 9 with the mapping score) on
    the wire's device."""
    r1, l1, r2, l2, n_valid = unpack_in_pe(wire_in, B, L)
    out1, out2, pairs, ctr = map_batch_pe(didx, st, r1, l1, r2, l2, n_valid, cfg)
    sargs = (didx, cfg, r1, l1, r2, l2) if cfg.mapping_score else None
    with span("tqm.compact"):
        pe = compact_pe(pairs, cap, score_args=sargs)
    with span("tqm.pack_out"):
        return pack_out(pe, ctr, _pe_flags(out1, out2, pairs))


def _chunk_counters(flags, n_valid, C: int) -> Counters:
    """A chunk's counters from its MapFlags (SE, and PE's direct merge)."""
    real = torch.arange(C, device=flags.mapped.device) < n_valid
    return Counters(
        reads_total=n_valid,
        reads_mapped=(flags.mapped & real).sum(),
        too_ambiguous=(flags.too_ambiguous & real).sum(),
        over_budget=(flags.over_budget & real).sum(),
        records=torch.where(real & ~flags.too_ambiguous, flags.n_mappings, 0).sum(),
        out_truncated=(flags.out_truncated & real).sum(),
    )


def _packed_cf(cfg: MapConfig, C: int) -> bool:
    return C % 8 == 0 and cfg.rec_slots * C < (1 << 16)


def _chunk_block(recsd, ctr: Counters, fbits: torch.Tensor, packed_cf: bool) -> torch.Tensor:
    """One chunk's [header | counts | flags | records] block of a chunked
    wire_out; with packed_cf, counts ride uint16 pairs and flags nibbles."""
    hdr = torch.stack([
        recsd.total, recsd.overflowed.to(torch.int64),
        ctr.reads_total, ctr.reads_mapped, ctr.too_ambiguous,
        ctr.over_budget, ctr.records, ctr.out_truncated,
    ]).to(torch.int32)
    if packed_cf:
        cw, fw = pack_counts_flags(recsd.counts, fbits)
    else:
        cw, fw = recsd.counts.to(torch.int32), fbits
    return torch.cat([hdr, cw, fw, recsd.recs.reshape(-1)])


def _join_chunks(blocks: list[torch.Tensor]) -> torch.Tensor:
    """Chunk blocks -> one wire_out: the headers summed (overflowed: the
    max), then every block's body in chunk order."""
    with span("tqm.pack_out"):
        outs = torch.stack(blocks)
        hdrs = outs[:, :HDR]
        hdr = hdrs.sum(dim=0, dtype=torch.int32)
        hdr[1] = hdrs[:, 1].max()
        return torch.cat([hdr, outs[:, HDR:].reshape(-1)])


def map_batch_se_wire_chunked(
    didx: DeviceQuasiIndex, st: EngineStatic, wire_in: torch.Tensor,
    cfg: MapConfig, capc: int, B: int, L: int, C: int,
) -> torch.Tensor:
    """SE wire step over fixed (C)-read chunks -> int32 wire_out on the
    wire's device. Each chunk compacts its records into its own (capc)-row
    block of the output (ops.wire.unpack_out re-densifies on the host)."""
    if B % C:
        raise ValueError("batch must be a multiple of the chunk size")
    spec = rec_spec_se(st, cfg)
    packed_cf = _packed_cf(cfg, C)
    reads, lens, n_valid = unpack_in_se(wire_in, B, L)
    blocks = []
    for c in range(B // C):
        r, ln = reads[c * C : (c + 1) * C], lens[c * C : (c + 1) * C]
        nv = (n_valid - c * C).clamp(0, C)
        hits = scan_dispatch(didx, st, r, ln, cfg)
        with span("tqm.vote"):
            se, flags = collate_records_se(didx, st, hits, ln, cfg, capc, rec_spec=spec,
                                           reads=r)
        with span("tqm.compact"):
            fbits = encode_read_flags(
                flags.over_budget, flags.out_truncated, flags.too_ambiguous, flags.mapped
            )
            blocks.append(_chunk_block(se, _chunk_counters(flags, nv, C), fbits, packed_cf))
    return _join_chunks(blocks)


def map_batch_pe_wire_chunked(
    didx: DeviceQuasiIndex, st: EngineStatic, wire_in: torch.Tensor,
    cfg: MapConfig, capc: int, B: int, L: int, C: int,
) -> torch.Tensor:
    """PE wire step over fixed (C)-pair chunks, laid out as the SE one. A
    chunk merges the two mates' collate cores directly
    (ops.pairs.collate_records_pe) when `pe_direct_eligible`, else through
    the slotted (C, MAX_OUT) layout of `map_batch_pe` and `compact_pe`."""
    if B % C:
        raise ValueError("batch must be a multiple of the chunk size")
    spec = rec_spec_pe(st, cfg)
    packed_cf = _packed_cf(cfg, C)
    direct = pe_direct_eligible(st, cfg, C)
    r1, l1, r2, l2, n_valid = unpack_in_pe(wire_in, B, L)
    blocks = []
    for c in range(B // C):
        rows = slice(c * C, (c + 1) * C)
        a, la, b, lb = r1[rows], l1[rows], r2[rows], l2[rows]
        nv = (n_valid - c * C).clamp(0, C)
        if direct:
            hits1 = scan_dispatch(didx, st, a, la, cfg)
            hits2 = scan_dispatch(didx, st, b, lb, cfg)
            with span("tqm.vote"):
                pe, fl, _ = collate_records_pe(
                    didx, st, hits1, la, hits2, lb, cfg, capc, rec_spec=spec,
                    reads1=a, reads2=b,
                )
            with span("tqm.compact"):
                ctr = _chunk_counters(fl, nv, C)
                fbits = encode_read_flags(
                    fl.over_budget, fl.out_truncated, fl.too_ambiguous, fl.mapped
                )
                blocks.append(_chunk_block(pe, ctr, fbits, packed_cf))
        else:
            out1, out2, pairs, ctr = map_batch_pe(didx, st, a, la, b, lb, nv, cfg)
            sargs = (didx, cfg, a, la, b, lb) if cfg.mapping_score else None
            with span("tqm.compact"):
                pe = compact_pe(pairs, capc, rec_spec=spec, score_args=sargs)
                fbits = _pe_flags(out1, out2, pairs)
                blocks.append(_chunk_block(pe, ctr, fbits, packed_cf))
    return _join_chunks(blocks)


class MapHandle(NamedTuple):
    """Handle of one batch in flight (map_se_async / map_pe_async -> fetch)."""

    kind: str                        # "se" | "pe"
    B: int
    wire: torch.Tensor               # int32 wire_out (pinned host memory on CUDA)
    done: torch.cuda.Event | None    # recorded after the copy; None on the CPU
    C: int                           # chunk size, 0 = one program over the batch
    capc: int
    spec: object
    seq: int = -1                    # the mapper's number of the batch


def _host(x: torch.Tensor) -> np.ndarray:
    """A result tensor as numpy: bool stays bool, integers become int32."""
    x = x.cpu().numpy()
    return x if x.dtype == np.bool_ else x.astype(np.int32)


def cuda_or(device, who: str) -> torch.device:
    """A mapper's device: None means the CUDA card, and without one it
    raises instead of running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device; pass device='cpu' to run the plain PyTorch "
                "path on the CPU"
            )
        device = "cuda"
    return torch.device(device)


class _Mapper:
    """The host loop a mapper shares: batches in, wire programs enqueued on
    the device's current stream, pinned result copies out. A subclass sets
    didx, st, cfg, device and host_index and picks the program of a batch
    (`_program`)."""

    device: torch.device
    cfg: MapConfig
    _seq = -1  # number of the last batch dispatched

    def _codes(self, codes) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int8)).to(self.device)

    def _lens(self, lens) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int64)).to(self.device)

    def _n_valid(self, n_valid, B: int) -> torch.Tensor:
        return torch.tensor(n_valid if n_valid is not None else B, device=self.device)

    def _cap(self, B: int) -> int:
        return self.cfg.rec_slots * B

    def _chunk_of(self, B: int) -> int:
        C = self.cfg.chunk
        return C if (C and C < B and B % C == 0) else 0

    def _program(self, kind: str, win: torch.Tensor, B: int, L: int):
        """-> (wire_out, C, capc, rec_spec) of one batch's wire program."""
        raise NotImplementedError

    def _pe_width(self) -> int:
        """Fields of a PE record: seven, plus the per-mate AS fields 7-8
        with the mapping score."""
        return 9 if self.cfg.mapping_score else 7

    def _dispatch(self, kind: str, pack, B: int, L: int) -> MapHandle:
        """Pack one wire_in (`pack(out)`, a new batch) straight into the
        buffer that is uploaded, upload it, enqueue its program and the copy
        of its wire_out to pinned host memory. On CUDA the buffer is pinned,
        from PyTorch's caching host allocator, which hands a block out again
        only once the copy that read it has completed; on the CPU it is a
        plain array. Only `win` holds the buffer, so it is freed once
        uploaded."""
        self._seq += 1
        on_cuda = self.device.type == "cuda"
        with span("tqm.pack_in", self._seq):
            n = in_bytes(B, L, 2 if kind == "pe" else 1)
            win = torch.empty(n, dtype=torch.uint8, pin_memory=on_cuda)
            pack(win.numpy())
        with span("tqm.upload"):
            if on_cuda:
                win = win.to(self.device, non_blocking=True)
        with span("tqm.program"):
            out, C, capc, spec = self._program(kind, win, B, L)
        done = None
        if on_cuda:
            with span("tqm.copy_out"):
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            out = host
        return MapHandle(kind, B, out, done, C, capc, spec, self._seq)

    def map_se_async(self, codes, lens, n_valid: int | None = None) -> MapHandle:
        B, L = codes.shape
        nv = n_valid if n_valid is not None else B
        return self._dispatch("se", lambda out: pack_in_se(codes, lens, nv, out), B, L)

    def map_pe_async(self, c1, l1, c2, l2, n_valid: int | None = None) -> MapHandle:
        B, L = c1.shape
        nv = n_valid if n_valid is not None else B
        return self._dispatch("pe", lambda out: pack_in_pe(c1, l1, c2, l2, nv, out), B, L)

    def fetch(self, result: MapHandle):
        """-> WireResult; recs fields SE (t, pos, strand, score), PE (t, p1,
        s1, has1, p2, s2, has2 [, sc1, sc2 with the mapping score])."""
        with span("tqm.fetch_wait", result.seq):
            if result.done is not None:
                result.done.synchronize()
        with span("tqm.unpack_out"):
            return unpack_out(
                result.wire.numpy(), result.B, 4 if result.kind == "se" else self._pe_width(),
                chunk=result.C, capc=result.capc, rec_spec=result.spec,
                packed_cf=bool(result.C) and _packed_cf(self.cfg, result.C),
            )


class QuasiMapper(_Mapper):
    """Host-side owner of the device index and its mapping loop.

    device=None means the CUDA card; without one it raises instead of
    running on the CPU. Pass device="cpu" to run the plain PyTorch versions
    of every kernel on the CPU."""

    def __init__(self, idx: QuasiIndex, cfg: MapConfig | None = None, device=None):
        self.device = cuda_or(device, "QuasiMapper")
        if cfg is None:
            cfg = MapConfig(k=idx.k)
        if cfg.k != idx.k:
            raise ValueError(f"config k={cfg.k} != index k={idx.k}")
        if cfg.expand_budget == 0:
            widths = np.asarray(idx.kmer_e) - np.asarray(idx.kmer_b)
            cfg = replace(
                cfg,
                expand_budget=auto_expand_budget(widths),
                # wide-interval (repetitive) indexes expand pairwise
                expand_pairs=cfg.expand_pairs or sampled_width(widths) >= 2.0,
            )
        self.cfg = cfg
        # lean upload drops the arrays the CHD + packed-extension path never
        # gathers; the binary-search probe and the charwise extension need them
        lean = cfg.packed_extension and getattr(idx, "chd_dir", None) is not None
        self.didx, self.st = upload_index(idx, self.device, lean=lean,
                                          meta_pairs=cfg.expand_pairs)
        self.host_index = idx  # oracle fallback for budget-degraded reads
        self.txp_names = idx.txp_names
        self.txp_lens = np.asarray(idx.txp_lens)

    def map_se(self, codes: np.ndarray, lens: np.ndarray, n_valid: int | None = None):
        """-> (MapOut, Counters) as numpy (int32 fields, bool flags)."""
        out, ctr = map_batch_se(
            self.didx, self.st, self._codes(codes), self._lens(lens),
            self._n_valid(n_valid, len(lens)), self.cfg,
        )
        return MapOut(*map(_host, out)), Counters(*map(_host, ctr))

    def map_pe(self, codes1, lens1, codes2, lens2, n_valid: int | None = None):
        """-> (MapOut left, MapOut right, PairOut, Counters) as numpy."""
        o1, o2, pairs, ctr = map_batch_pe(
            self.didx, self.st, self._codes(codes1), self._lens(lens1),
            self._codes(codes2), self._lens(lens2), self._n_valid(n_valid, len(lens1)),
            self.cfg,
        )
        return (MapOut(*map(_host, o1)), MapOut(*map(_host, o2)),
                PairOut(*map(_host, pairs)), Counters(*map(_host, ctr)))

    def _program(self, kind: str, win: torch.Tensor, B: int, L: int):
        """The chunked program when the batch allows, else one over it."""
        C = self._chunk_of(B)
        if C:
            capc = self._cap(C)
            spec = (rec_spec_se if kind == "se" else rec_spec_pe)(self.st, self.cfg)
            fn = map_batch_se_wire_chunked if kind == "se" else map_batch_pe_wire_chunked
            return fn(self.didx, self.st, win, self.cfg, capc, B, L, C), C, capc, spec
        fn = map_batch_se_wire if kind == "se" else map_batch_pe_wire
        return fn(self.didx, self.st, win, self.cfg, self._cap(B), B, L), 0, 0, None
