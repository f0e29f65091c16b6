"""QuasiMapper — the end-to-end single-end mapping engine on one device.

Port of rapmap_tpu.models.quasi's single-end paths:
  wire_in -> reads -> MMP scan (ops.mmp) -> collation (ops.collate)
  -> wire_out (ops.wire)
either as one program over the whole batch (`map_batch_se_wire`: the slotted
MapOut of `map_batch_se`, compacted by ops.compact) or, when the batch is a
multiple of two or more cfg.chunk, one chunk at a time with the direct
compaction (`map_batch_se_wire_chunked`). `map_se` is the library call that
returns the MapOut itself.

`map_se_async` enqueues the batch on the device's current stream and starts
a non-blocking copy of the result into pinned host memory; `fetch` waits for
that copy alone, so a caller can hold batches in flight while it prepares the
next. Every call pins fresh buffers, and a fetched result's records may be a
view of its buffer: nothing is reused while a result is alive. Paired-end
and the mapping score are not ported yet.
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from rapmap_tpu_torch.config import MapConfig, auto_expand_budget, sampled_width
from rapmap_tpu_torch.index.format import QuasiIndex
from rapmap_tpu_torch.ops.collate import MapOut, collate_batch, collate_records_se
from rapmap_tpu_torch.ops.compact import compact_se
from rapmap_tpu_torch.ops.device_index import DeviceQuasiIndex, EngineStatic, upload_index
from rapmap_tpu_torch.ops.mmp import scan_dispatch
from rapmap_tpu_torch.ops.wire import (
    HDR, encode_read_flags, pack_counts_flags, pack_in_se, pack_out, rec_spec_se,
    unpack_in_se, unpack_out,
)


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
    out = collate_batch(didx, st, hits, lens, cfg)
    real = torch.arange(reads.shape[0], device=reads.device) < n_valid
    ctr = Counters(
        reads_total=n_valid,
        reads_mapped=(out.mapped & real).sum(),
        too_ambiguous=(out.too_ambiguous & real).sum(),
        over_budget=(out.over_budget & real).sum(),
        records=((out.t != -1) & real[:, None]).sum(),
        out_truncated=(out.out_truncated & real).sum(),
    )
    return out, ctr


def map_batch_se_wire(
    didx: DeviceQuasiIndex, st: EngineStatic, wire_in: torch.Tensor,
    cfg: MapConfig, cap: int, B: int, L: int,
) -> torch.Tensor:
    """Single-buffer in/out SE mapping step (ops.wire format), one program
    over the whole batch -> int32 wire_out on the wire's device."""
    reads, lens, n_valid = unpack_in_se(wire_in, B, L)
    out, ctr = map_batch_se(didx, st, reads, lens, n_valid, cfg)
    flags = encode_read_flags(out.over_budget, out.out_truncated, out.too_ambiguous, out.mapped)
    return pack_out(compact_se(out, cap), ctr, flags)


def _se_counters(flags, n_valid, C: int) -> Counters:
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
    outs = []
    for c in range(B // C):
        r, ln = reads[c * C : (c + 1) * C], lens[c * C : (c + 1) * C]
        nv = (n_valid - c * C).clamp(0, C)
        hits = scan_dispatch(didx, st, r, ln, cfg)
        se, flags = collate_records_se(didx, st, hits, ln, cfg, capc, rec_spec=spec)
        ctr = _se_counters(flags, nv, C)
        fbits = encode_read_flags(
            flags.over_budget, flags.out_truncated, flags.too_ambiguous, flags.mapped
        )
        hdr = torch.stack([
            se.total, se.overflowed.to(torch.int64),
            ctr.reads_total, ctr.reads_mapped, ctr.too_ambiguous,
            ctr.over_budget, ctr.records, ctr.out_truncated,
        ]).to(torch.int32)
        if packed_cf:
            cw, fw = pack_counts_flags(se.counts, fbits)
        else:
            cw, fw = se.counts.to(torch.int32), fbits
        outs.append(torch.cat([hdr, cw, fw, se.recs.reshape(-1)]))
    outs = torch.stack(outs)
    hdrs = outs[:, :HDR]
    hdr = hdrs.sum(dim=0, dtype=torch.int32)
    hdr[1] = hdrs[:, 1].max()
    return torch.cat([hdr, outs[:, HDR:].reshape(-1)])


class SEResult(NamedTuple):
    """Handle of one batch in flight (map_se_async -> fetch)."""

    B: int
    wire: torch.Tensor               # int32 wire_out (pinned host memory on CUDA)
    done: torch.cuda.Event | None    # recorded after the copy; None on the CPU
    C: int                           # chunk size, 0 = one program over the batch
    capc: int
    spec: object


class QuasiMapper:
    """Host-side owner of the device index and its mapping loop.

    device=None means the CUDA card; without one it raises instead of
    running on the CPU. Pass device="cpu" to run the plain PyTorch versions
    of every kernel on the CPU."""

    def __init__(self, idx: QuasiIndex, cfg: MapConfig | None = None, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "QuasiMapper: no CUDA device; pass device='cpu' to run "
                    "the plain PyTorch path on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        if cfg is None:
            cfg = MapConfig(k=idx.k)
        if cfg.k != idx.k:
            raise ValueError(f"config k={cfg.k} != index k={idx.k}")
        if not cfg.packed_extension:
            raise NotImplementedError(
                "the charwise extension path (packed_extension=False) is not ported"
            )
        if cfg.mapping_score:
            raise NotImplementedError("mapping_score (--mappingScore) is not ported yet")
        if cfg.expand_budget == 0:
            widths = np.asarray(idx.kmer_e) - np.asarray(idx.kmer_b)
            cfg = replace(
                cfg,
                expand_budget=auto_expand_budget(widths),
                # wide-interval (repetitive) indexes expand pairwise
                expand_pairs=cfg.expand_pairs or sampled_width(widths) >= 2.0,
            )
        self.cfg = cfg
        self.didx, self.st = upload_index(idx, self.device, meta_pairs=cfg.expand_pairs)
        self.host_index = idx  # oracle fallback for budget-degraded reads
        self.txp_names = idx.txp_names
        self.txp_lens = np.asarray(idx.txp_lens)

    def map_se(self, codes: np.ndarray, lens: np.ndarray, n_valid: int | None = None):
        """-> (MapOut, Counters) as numpy (int32 fields, bool flags)."""
        out, ctr = map_batch_se(
            self.didx, self.st,
            torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int8)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int64)).to(self.device),
            torch.tensor(n_valid if n_valid is not None else len(lens), device=self.device),
            self.cfg,
        )

        def host(x):
            x = x.cpu().numpy()
            return x if x.dtype == np.bool_ else x.astype(np.int32)

        return MapOut(*map(host, out)), Counters(*map(host, ctr))

    def _cap(self, B: int) -> int:
        return self.cfg.rec_slots * B

    def _chunk_of(self, B: int) -> int:
        C = self.cfg.chunk
        return C if (C and C < B and B % C == 0) else 0

    def map_se_async(self, codes, lens, n_valid: int | None = None) -> SEResult:
        B, L = codes.shape
        C = self._chunk_of(B)
        nv = n_valid if n_valid is not None else B
        win = torch.from_numpy(pack_in_se(np.asarray(codes), np.asarray(lens), nv))
        on_cuda = self.device.type == "cuda"
        if on_cuda:
            win = win.pin_memory().to(self.device, non_blocking=True)
        if C:
            capc, spec = self._cap(C), rec_spec_se(self.st, self.cfg)
            out = map_batch_se_wire_chunked(
                self.didx, self.st, win, self.cfg, capc, B, L, C
            )
        else:
            capc, spec = 0, None
            out = map_batch_se_wire(
                self.didx, self.st, win, self.cfg, self._cap(B), B, L
            )
        done = None
        if on_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            out = host
        return SEResult(B, out, done, C, capc, spec)

    def fetch(self, result: SEResult):
        """-> WireResult; recs fields (t, pos, strand, score)."""
        if result.done is not None:
            result.done.synchronize()
        return unpack_out(
            result.wire.numpy(), result.B, 4, chunk=result.C, capc=result.capc,
            rec_spec=result.spec,
            packed_cf=bool(result.C) and _packed_cf(self.cfg, result.C),
        )
