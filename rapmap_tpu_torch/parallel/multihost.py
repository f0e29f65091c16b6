"""Multi-process distribution: per-process read shards, summed global
counters, per-process SAM shards (SURVEY.md §5.8).

Port of rapmap_tpu.parallel.multihost on torch.distributed's gloo backend:

  * work split: batch i belongs to process (i % world) — no coordination,
    deterministic, and resume-safe per process (the CLI does the split);
  * output: each process writes a complete, independently-valid SAM shard
    (<out>.<rank:04d>); the record-level union equals the single-process run;
  * counters: summed across processes with one all-reduce of float64 CPU
    tensors, so every process logs the GLOBAL mapping rate. Gloo carries
    host tensors, so ranks that share one card (each on cuda:0) reduce their
    counters on the host; nothing else crosses between processes.

The CLI calls init_distributed() right after its argument checks and
shutdown() when the run ends.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("tqm.dist")


def _seconds(name: str, default: str) -> datetime.timedelta:
    return datetime.timedelta(seconds=int(os.environ.get(name, default)))


def init_distributed(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the process group at host:port `coordinator` (process 0 listens
    there). TQM_DIST_INIT_TIMEOUT_S bounds the wait for every process, and
    every collective after it (default 300 s, as the reference's)."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=_seconds("TQM_DIST_INIT_TIMEOUT_S", "300"),
    )
    log.info("distributed init: process %d/%d (gloo)", process_id, num_processes)


def shutdown() -> None:
    """The reference's shutdown barrier, then the group's teardown: every
    process waits for the others to finish, at most
    TQM_DIST_SHUTDOWN_TIMEOUT_S (default 600 s), so no rank tears the group
    down under a straggler's last collective."""
    if not dist.is_initialized():
        return
    try:
        dist.monitored_barrier(timeout=_seconds("TQM_DIST_SHUTDOWN_TIMEOUT_S", "600"))
    finally:
        dist.destroy_process_group()


def global_counter_sum(totals: dict[str, int | float]) -> dict[str, int | float]:
    """Sum integer counters across all processes (float fields take the max —
    wall time reports the straggler). Synchronizes all processes.

    Sums ride float64, exact below 2^53, as the reference's do. A counter
    that only some processes have (one that mapped no batch has none of the
    mapping counters) counts as 0 on the others."""
    kinds: list[dict[str, bool]] = [{} for _ in range(dist.get_world_size())]
    dist.all_gather_object(kinds, {k: isinstance(v, (int, np.integer)) for k, v in totals.items()})
    merged_kinds: dict[str, bool] = {}
    for kd in kinds:
        merged_kinds.update(kd)
    keys = sorted(merged_kinds)
    ints = [k for k in keys if merged_kinds[k]]
    floats = [k for k in keys if not merged_kinds[k]]
    isum = torch.tensor([float(totals.get(k, 0)) for k in ints], dtype=torch.float64)
    fmax = torch.tensor([float(totals.get(k, float("-inf"))) for k in floats],
                        dtype=torch.float64)
    # every process holds the same key lists now, so all skip or all reduce
    if len(ints):
        dist.all_reduce(isum, op=dist.ReduceOp.SUM)
    if len(floats):
        dist.all_reduce(fmax, op=dist.ReduceOp.MAX)
    merged: dict[str, int | float] = {k: int(v) for k, v in zip(ints, isum.tolist())}
    merged.update({k: float(v) for k, v in zip(floats, fmax.tolist())})
    return merged
