"""Per-stage timing (ScopedTimer role, SURVEY.md §5.1) + torch.profiler hook.

Copy of rapmap_tpu.utils.timers; `device_trace` writes a torch.profiler
Chrome trace where the reference writes a jax.profiler one."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimers:
    """Accumulates wall time per named stage; cheap enough to leave on."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "calls": self.counts[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def log(self, logger) -> None:
        for k, v in self.summary().items():
            logger.info("stage %-12s %8.3fs over %d calls", k, v["total_s"], v["calls"])


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """torch.profiler trace (host, and the card when there is one) written as
    <trace_dir>/trace.json in Chrome format; no-op without a directory."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
