"""Per-stage timing (ScopedTimer role, SURVEY.md §5.1), the program's spans,
and a torch.profiler hook.

`StageTimers.stage` is a copy of rapmap_tpu.utils.timers'; `device_trace`
writes a torch.profiler Chrome trace where the reference writes a
jax.profiler one.

The program marks its stages with `span(name)`, which goes to the recorder
`recording(timers)` installed. With none installed, `span` returns one
shared null context: no allocation, no clock read, no device sync. A
recorder built with keep=True keeps every span (name, batch, start, end);
one whose `annotate` is set also opens a torch.profiler record_function
range of the span's name, so that a trace holds host stages and device
operations on one clock.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    batch: int     # the batch the span worked for (-1: none yet)
    start: float   # time.perf_counter() seconds
    end: float


class StageTimers:
    """Accumulates wall time per named stage; cheap enough to leave on.

    `batch` is the number the next spans carry, set by a span opened with
    one. keep=True also keeps each span, in the order they end."""

    def __init__(self, keep: bool = False) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.last: dict[str, float] = {}  # seconds of the latest span of each name
        self.keep = keep
        self.annotate = False
        self.batch = -1
        self.spans: list[Span] = []
        self._lock = threading.Lock()  # spans end on several threads

    @contextlib.contextmanager
    def stage(self, name: str, batch: int | None = None):
        if batch is not None:
            self.batch = batch
        b = self.batch
        mark = contextlib.nullcontext()
        if self.annotate:
            import torch

            mark = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        try:
            with mark:
                yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.totals[name] += t1 - t0
                self.counts[name] += 1
                self.last[name] = t1 - t0
                if self.keep:
                    self.spans.append(Span(name, b, t0, t1))

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "calls": self.counts[k]}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def log(self, logger) -> None:
        for k, v in self.summary().items():
            logger.info("stage %-12s %8.3fs over %d calls", k, v["total_s"], v["calls"])


_NULL = contextlib.nullcontext()
_recorder: StageTimers | None = None


def span(name: str, batch: int | None = None):
    """A stage of the installed recorder, or the shared null context. A
    batch number, where given, is what this span and the ones after it
    carry."""
    rec = _recorder
    if rec is None:
        return _NULL
    return rec.stage(name, batch)


def recorder() -> StageTimers | None:
    """The installed recorder, or None."""
    return _recorder


@contextlib.contextmanager
def recording(timers: StageTimers | None):
    """Installs `timers` as the recorder of `span` (None: none) for the
    block, on every thread; the one installed before comes back after it."""
    global _recorder
    before, _recorder = _recorder, timers
    try:
        yield timers
    finally:
        _recorder = before


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
