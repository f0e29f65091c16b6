"""Data-parallel mapping over a list of devices (SURVEY.md §2.3, §5.8).

Port of rapmap_tpu.parallel.dp. The index is replicated per device (a
transcriptome index is a few GB and fits in the card's memory); a read batch
is cut into contiguous equal slices, one per mesh entry, and each replica
runs the single-device program (models.quasi.map_batch_se / map_batch_pe) on
its slice. The outputs join in mesh order and the counters are summed, as
the reference's psums over "data" do. SAM emission stays with the caller.

A mesh is a list of torch devices: by default every CUDA device, and without
a card no mesh at all (no silent CPU run); a caller that wants the CPU passes
devices=["cpu", ...]. A list may name one device more than once (two replicas
on one card, or the CPU tests' mirror of the reference's 8-device virtual
mesh): the replicas on one device share one upload of the index and run one
after the other on its current stream.
"""

from __future__ import annotations

import numpy as np
import torch

from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.models.quasi import Counters, map_batch_pe, map_batch_se
from rapmap_tpu_torch.ops.collate import MapOut
from rapmap_tpu_torch.ops.device_index import DeviceQuasiIndex, EngineStatic
from rapmap_tpu_torch.ops.pairs import PairOut


def make_mesh(n_data: int | None = None, devices=None) -> list[torch.device]:
    """The first n_data of `devices` (default: every CUDA device)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu', ...] to run "
                               "the replicas on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [norm_device(d) for d in devices]
    n = n_data or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} replicas asked of {len(devices)} devices")
    return devices[:n]


def norm_device(dev) -> torch.device:
    """A device with its index: "cuda" names the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def replicate_index(didx: DeviceQuasiIndex, mesh: list[torch.device]) -> dict:
    """{device: the index there}: one upload per distinct device of the
    mesh, `didx` itself where it already lies."""
    out = {norm_device(didx.text2q.device): didx}
    for dev in map(norm_device, mesh):
        if dev not in out:
            out[dev] = DeviceQuasiIndex(*(None if t is None else t.to(dev) for t in didx))
    return out


def split_valid(n_valid_total: int, n_dev: int, per_shard: int) -> np.ndarray:
    """Valid-row counts per shard when a host batch is split contiguously."""
    out = np.zeros(n_dev, dtype=np.int32)
    rem = n_valid_total
    for i in range(n_dev):
        out[i] = min(per_shard, max(rem, 0))
        rem -= out[i]
    return out


def _slices(mesh, B: int):
    n = len(mesh)
    if B % n:
        raise ValueError(f"batch of {B} rows does not split over {n} replicas")
    per = B // n
    return [(dev, slice(i * per, (i + 1) * per)) for i, dev in enumerate(mesh)]


def _join(parts: list, home: torch.device):
    """Per-replica NamedTuples of tensors -> one, rows concatenated in mesh
    order on `home`."""
    return type(parts[0])(*(torch.cat([t.to(home) for t in col]) for col in zip(*parts)))


def _sum(ctrs: list[Counters], home: torch.device) -> Counters:
    return Counters(*(torch.stack([c.to(home) for c in col]).sum() for col in zip(*ctrs)))


def _n_valid(n_valid_local, i: int, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(n_valid_local)[i], dtype=torch.int64).to(dev)


def map_batch_se_dp(
    didx: DeviceQuasiIndex | dict,
    st: EngineStatic,
    reads: torch.Tensor,    # (B_total, L) int8; B_total % len(mesh) == 0
    lens: torch.Tensor,     # (B_total,)
    n_valid_local,          # (len(mesh),) valid rows per replica (split_valid)
    cfg: MapConfig,
    mesh: list[torch.device],
) -> tuple[MapOut, Counters]:
    """One replica per mesh entry on its contiguous slice of the batch ->
    (MapOut of all rows in mesh order, summed Counters), on mesh[0]. didx
    is one upload (copied to the mesh's other devices for this call) or
    replicate_index's {device: index}."""
    replicas = didx if isinstance(didx, dict) else replicate_index(didx, mesh)
    outs, ctrs = [], []
    for i, (dev, rows) in enumerate(_slices(mesh, reads.shape[0])):
        out, ctr = map_batch_se(replicas[norm_device(dev)], st, reads[rows].to(dev),
                                lens[rows].to(dev), _n_valid(n_valid_local, i, dev), cfg)
        outs.append(out)
        ctrs.append(ctr)
    return _join(outs, mesh[0]), _sum(ctrs, mesh[0])


def map_batch_pe_dp(
    didx: DeviceQuasiIndex | dict, st: EngineStatic,
    reads1, lens1, reads2, lens2, n_valid_local, cfg: MapConfig, mesh: list[torch.device],
) -> tuple[MapOut, MapOut, PairOut, Counters]:
    """Paired-end map_batch_se_dp: each replica maps both mates of its
    slice and merges the pairs (models.quasi.map_batch_pe)."""
    replicas = didx if isinstance(didx, dict) else replicate_index(didx, mesh)
    o1s, o2s, pos, ctrs = [], [], [], []
    for i, (dev, rows) in enumerate(_slices(mesh, reads1.shape[0])):
        o1, o2, po, ctr = map_batch_pe(
            replicas[norm_device(dev)], st, reads1[rows].to(dev), lens1[rows].to(dev),
            reads2[rows].to(dev), lens2[rows].to(dev), _n_valid(n_valid_local, i, dev), cfg,
        )
        o1s.append(o1)
        o2s.append(o2)
        pos.append(po)
        ctrs.append(ctr)
    home = mesh[0]
    return _join(o1s, home), _join(o2s, home), _join(pos, home), _sum(ctrs, home)
