"""The device's side of a traced stretch of the window: torch.profiler's
events reduced to busy time, kernel launches, the top device operations,
and the device's idle gaps by what the host was doing meanwhile.

The host's spans (dispatch, fetch, fallback, harness) ride the trace as
record_function ranges, and the stretch itself as one named `STRETCH`, so
host and device times are read on the profiler's one clock."""

from __future__ import annotations

from dataclasses import dataclass

STRETCH = "bench_stretch"
PRIMER = "spin_kernel"  # torch.cuda._sleep, run first: a session drops its first device events


@dataclass
class Event:
    name: str
    start: float  # seconds, the profiler's clock
    end: float
    on_device: bool


def events_of(prof) -> list[Event]:
    """A finished torch.profiler session's events, times in seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [Event(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6,
                  e.device_type == cuda) for e in prof.events()]


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events: list[Event], host_spans: set[str], batches: int, top: int = 10) -> dict | None:
    """-> busy_s, window_s, kernels, batches, device_ops and idle_gaps of the
    stretch, or None when the trace holds no stretch or no device operation
    inside it."""
    marks = [e for e in events if e.name == STRETCH and not e.on_device]
    if not marks or batches < 1:
        return None
    s0, s1 = marks[0].start, marks[0].end
    dev = [e for e in events if e.on_device and e.name not in host_spans
           and e.name != STRETCH and PRIMER not in e.name and e.end > s0 and e.start < s1]
    if not dev:
        return None
    busy = _union([(max(e.start, s0), min(e.end, s1)) for e in dev])
    busy_s = sum(e - s for s, e in busy)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + min(e.end, s1) - max(e.start, s0)
    kernels = sum(1 for e in dev if s0 <= e.start < s1
                  and not e.name.startswith(("Memcpy", "Memset")))
    host = sorted((e.start, e.end, e.name) for e in events
                  if not e.on_device and e.name in host_spans)
    gaps: dict[str, float] = {}
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        doing = "other"
        for h0, h1, name in host:
            if h0 > mid:
                break
            if h1 >= mid:
                doing = name
        gaps[doing] = gaps.get(doing, 0.0) + g1 - g0
    return dict(
        busy_s=busy_s, window_s=s1 - s0, kernels=kernels, batches=batches,
        device_ops=sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:top],
        idle_gaps=sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:top],
    )
