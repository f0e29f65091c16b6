#!/usr/bin/env python3
"""The program's stages in a traced stretch of the window: torch.profiler's
events reduced by the `tqm.*` spans of rapmap_tpu_torch's recorder
(rapmap_tpu_torch/utils/timers.py), and a run of a cell with that recorder
installed.

    python3 benchgpu/progtrace.py --workload isoform_6k.pe --seed 7 --seconds 10

The program marks its stages with `span(name)`, which records into a
recorder installed with `recording(StageTimers(keep=True))` and does
nothing without one. A batch's
dispatch is `tqm.pack_in` (the wire's numpy pack), `tqm.upload`,
`tqm.program` (every launch of its wire program, holding `tqm.dense`,
`tqm.walk`, `tqm.vote`, `tqm.merge`, `tqm.compact`, `tqm.score` and
`tqm.pack_out`) and `tqm.copy_out`; its drain `tqm.fetch_wait`,
`tqm.unpack_out` and `tqm.fallback`; the index build `tqm.build.concat`,
`.native` (the native library's load, and its build on first use), `.sa`,
`.kmers`, `.derive`, `.chd` (on a worker thread), `.save` and `.chd_join`.
Spans carry the mapper's batch number. The harness
installs no recorder: the benchmark's own runs time the program with its
spans off.

A device operation is put down to the innermost `tqm.*` range that holds
the PyTorch op it was launched under (its `linked_correlation_id` is the
op's `id`), or, for a kernel launched outside any op (the hand kernels,
through ctypes), the runtime call that started it (the call's `id` is the
operation's; the op comes first, as it shares the ranges' clock). An idle
gap of the device is put down to the innermost range holding its midpoint,
with devtrace.reduce's gap edges. A record_function range leaves a
device-side shadow of its name, which is not an operation.

`run_cell` and `main` are scaffolding, to be deleted once harness.run_cell
installs the recorder and keeps its record: the run is harness.run_cell's
set-up, warm batches and window with a
StageTimers(keep=True) installed from the start, and its `annotate` set
while the profiler records (the window's start to the traced stretch's
end, so that a kernel launched before the stretch and run in it finds its
range; the harness's own spans annotate the stretch alone); it makes no
comparison with the reference. The last line of standard output is one
JSON object: the readers of the program's spans in metrics/ (`pack_ms`,
`launch_ms`, `idle_pack_share`, `idle_launch_share`, `dense_dev_ms`,
`walk_dev_ms`, `vote_dev_ms`, `compact_dev_ms`, `merge_dev_ms`,
`sa_build_s`, `kmer_table_s`, `chd_build_s`; each None
on a record without the program's spans) beside the harness's own, the
stretch's stages (`breakdown.stages`: device ms, kernels, host ms and idle
ms a batch by range), and `checks`: the share of busy time put down to a
range, and the stages' device time over devtrace's busy time. The readers
are in no entry of BENCHMARK.json: harness.run_cell has to install the
recorder and keep its record first.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:  # run as a script
    sys.path.insert(0, ROOT)

from benchgpu import devtrace, harness  # noqa: E402

PREFIX = "tqm."
# tqm.program and the stages inside it: every launch of a batch's wire program
PROGRAM = ("tqm.program", "tqm.dense", "tqm.walk", "tqm.vote", "tqm.merge", "tqm.compact",
           "tqm.score", "tqm.pack_out")
NONE = "unattributed"
RUNTIME = "cu"  # the host calls of the CUDA runtime (cuda*) and driver (cu*)


@dataclass
class Op:
    """A torch.profiler event with the ids that link a device operation to
    the host event it was launched under."""

    name: str
    start: float  # seconds, the profiler's clock
    end: float
    on_device: bool
    thread: int
    id: int
    linked: int  # on the device: the id of the host event active at launch


@dataclass
class ProgramRecord(harness.RunRecord):
    """harness.RunRecord with the program's spans (`program_record`)."""

    program: dict | None = None


def ops_of(prof) -> list[Op]:
    """A finished torch.profiler session's events, times in seconds from
    its first. Read from the session's raw (kineto) events, which carry the
    linked id on every PyTorch version; its FunctionEvents do on few."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    t0 = min((e.start_ns() for e in raw), default=0)
    return [Op(e.name(), (e.start_ns() - t0) / 1e9, (e.start_ns() + e.duration_ns() - t0) / 1e9,
               e.device_type() == cuda, e.start_thread_id(), e.correlation_id(),
               e.linked_correlation_id()) for e in raw]


def harness_events(ops: list[Op]) -> list[devtrace.Event]:
    """The events devtrace.reduce reads, without the device shadows of the
    program's ranges: its busy time, launches, idle share and idle gaps by
    the harness's spans read as on a trace without them."""
    return [devtrace.Event(o.name, o.start, o.end, o.on_device) for o in ops
            if not (o.on_device and o.name.startswith(PREFIX))]


class Innermost:
    """The innermost of a thread's nested ranges at a time: the ranges cut
    into segments, each with the range that holds it (None: no range)."""

    def __init__(self, ranges: list[tuple[float, float, str]]) -> None:
        self.times: list[float] = []
        self.names: list[str | None] = []
        stack: list[tuple[float, str]] = []
        for s, e, n in sorted(ranges, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][0] <= s:
                self._close(stack)
            stack.append((e, n))
            self._mark(s, n)
        while stack:
            self._close(stack)

    def _mark(self, t: float, name: str | None) -> None:
        if self.times and self.times[-1] == t:
            self.names[-1] = name
        else:
            self.times.append(t)
            self.names.append(name)

    def _close(self, stack) -> None:
        end, _ = stack.pop()
        self._mark(end, stack[-1][1] if stack else None)

    def at(self, t: float) -> str | None:
        i = bisect.bisect_right(self.times, t) - 1
        return self.names[i] if i >= 0 else None


def reduce(ops: list[Op], host_spans: set[str], batches: int) -> dict | None:
    """-> per batch of the stretch, by `tqm.*` range: device ms, kernels,
    host ms and idle ms; the share of busy time put down to a range
    (`attributed_share`, %), `window_ms` and the operations put down to
    none, the most device ms first. None without a stretch, or
    when a traced tqm.program range has no device operation (a trace that
    lost events must not read as idle)."""
    marks = [o for o in ops if o.name == devtrace.STRETCH and not o.on_device]
    if not marks or batches < 1:
        return None
    s0, s1, main = marks[0].start, marks[0].end, marks[0].thread
    host = [o for o in ops if not o.on_device]
    every = [o for o in host if o.name.startswith(PREFIX)]
    ranges = [o for o in every if o.end > s0 and o.start < s1]
    by_thread: dict[int, list] = {}
    for o in every:  # those before the stretch too: their kernels may run in it
        by_thread.setdefault(o.thread, []).append((o.start, o.end, o.name))
    inner = {t: Innermost(r) for t, r in by_thread.items()}
    # the runtime's and driver's calls (cudaLaunchKernel, cudaMemcpyAsync,
    # cuLaunchKernel) carry the id of the device operation they started;
    # the ops and ranges, ids of another count that may equal those
    calls = {o.id: o for o in host if o.name.startswith(RUNTIME)}
    by_id = {o.id: o for o in host if not o.linked and not o.name.startswith(RUNTIME)}
    dev = [o for o in ops if o.on_device and o.name not in host_spans
           and not o.name.startswith(PREFIX) and o.name != devtrace.STRETCH
           and devtrace.PRIMER not in o.name and o.end > s0 and o.start < s1]
    if not dev:
        return None

    stages: dict[str, dict] = {}

    def stage(name):
        return stages.setdefault(name, dict(device_ms=0.0, kernels=0, host_ms=0.0, idle_ms=0.0))

    launched = []  # host start of each operation put down to a program range
    held = []  # the stretch's part of each operation put down to a range
    stray: dict[str, float] = {}  # ms of the operations put down to none, by name
    for o in dev:
        name = None
        h = (by_id.get(o.linked) if o.linked else None) or calls.get(o.id)
        if h is not None:
            on = inner.get(h.thread) or inner.get(main)
            name = on.at(h.start) if on else None
        part = (max(o.start, s0), min(o.end, s1))
        st = stage(name or NONE)
        st["device_ms"] += 1e3 * (part[1] - part[0])
        if s0 <= o.start < s1 and not o.name.startswith(("Memcpy", "Memset")):
            st["kernels"] += 1
        if name is not None:
            held.append(part)
        else:
            stray[o.name[:80]] = stray.get(o.name[:80], 0.0) + 1e3 * (part[1] - part[0])
        if name in PROGRAM:
            launched.append(h.start)
    launched.sort()
    for o in ranges:
        if o.name == "tqm.program" and s0 <= o.start and o.end <= s1:
            i = bisect.bisect_left(launched, o.start)
            if i == len(launched) or launched[i] > o.end:
                return None
        stage(o.name)["host_ms"] += 1e3 * (min(o.end, s1) - max(o.start, s0))

    busy = devtrace._union([(max(o.start, s0), min(o.end, s1)) for o in dev])
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    on_main = inner.get(main)
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            name = on_main.at((g0 + g1) / 2) if on_main else None
            stage(name or "other")["idle_ms"] += 1e3 * (g1 - g0)
    busy_s = sum(e - s for s, e in busy)
    held_s = sum(e - s for s, e in devtrace._union(held))
    per = {n: {k: v / batches for k, v in st.items()} for n, st in sorted(stages.items())}
    return dict(ranges=per, attributed_share=100.0 * held_s / busy_s,
                window_ms=1e3 * (s1 - s0) / batches, batches=batches,
                unattributed_ops=sorted(([n, v / batches] for n, v in stray.items()),
                                        key=lambda x: -x[1])[:5])


def program_record(timers, first: int, stretch: tuple[int, int]) -> dict:
    """The recorder's kept spans -> `setup` (seconds by span before index
    `first`) and `batch_ms` (each span's per-batch sum, mean over the
    window's batches with no span inside the stretch, the spans at indices
    [stretch))."""
    spans = timers.spans
    setup: dict[str, float] = {}
    for s in spans[:first]:
        setup[s.name] = setup.get(s.name, 0.0) + s.end - s.start
    window = spans[first:]
    traced = {s.batch for s in spans[stretch[0]:stretch[1]]}
    sums: dict[str, dict[int, float]] = {}
    for s in window:
        if s.batch not in traced:
            per = sums.setdefault(s.name, {})
            per[s.batch] = per.get(s.batch, 0.0) + s.end - s.start
    return dict(setup=setup,
                batch_ms={n: 1e3 * sum(v.values()) / len(v) for n, v in sums.items()})


def run_cell(config: dict, mix: dict, seed: int, seconds: float, t_start: float,
             device: str = "cuda"):
    """Scaffolding (see the module's docstring): harness.run_cell's set-up,
    warm batches and window, with the program's recorder installed throughout -> (the record the readers
    read, the window, the pool). device "cpu" (tests only) runs the plain
    versions and traces nothing."""
    import torch

    from rapmap_tpu_torch.utils.timers import StageTimers, recording

    class Spans(harness.Spans):
        """The harness's spans; setting `annotate` notes the index of the
        recorder's next span (the stretch's bounds), and its end ends the
        recorder's ranges."""

        def __init__(self, timers):
            self.timers, self.bounds, self.on = timers, [], False
            super().__init__()
            self.bounds = []

        @property
        def annotate(self):
            return self.on

        @annotate.setter
        def annotate(self, on):
            self.on = on
            if not on:
                self.timers.annotate = False
            self.bounds.append(len(self.timers.spans))

    torch.set_num_threads(harness.TORCH_THREADS)
    cuda = device == "cuda"
    timers = StageTimers(keep=True)
    spans = Spans(timers)
    entry = harness.entry_of(config)
    with recording(timers):
        with spans("traffic"):
            transcripts, pool = harness.setup_traffic(config, mix, seed)
        prog = entry.setup(transcripts, config, device, spans, pool.batch)
        depth = int(config["pipeline_depth"])
        with spans("warm"):
            harness.drive(entry, prog, pool, depth, 0.0, harness.Spans(),
                          min_batches=harness.WARM_BATCHES)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.time() - t_start
        setup = {n: v[0] for n, v in spans.times.items()}
        spans.times = {}
        first = len(timers.spans)
        profiler = harness.start_profiler() if cuda else None
        # ranges from the profiler's start: a kernel launched in a batch
        # before the stretch may run inside it
        timers.annotate = profiler is not None
        win = harness.drive(entry, prog, pool, depth, seconds, spans, profiler=profiler)
    trace = None
    if profiler is not None:
        ops = ops_of(profiler)
        trace = devtrace.reduce(harness_events(ops), set(spans.stretch), harness.TRACE_BATCHES)
        if trace:
            trace["stages"] = reduce(ops, set(spans.stretch), harness.TRACE_BATCHES)
    batch_spans = {}
    for n, v in spans.times.items():
        lo, hi = spans.stretch.get(n, (len(v), len(v)))
        batch_spans[n] = v[:lo] + v[hi:]
    rec = ProgramRecord(rows_per_s=win.attempted / win.seconds if win.seconds else 0.0,
                        cut_share=100.0 * win.cut / win.attempted if win.attempted else 0.0,
                        setup_s=setup_s, setup=setup, batch_spans=batch_spans, trace=trace,
                        program=program_record(timers, first, tuple(spans.bounds) or (0, 0)))
    return rec, win, pool


# the metrics of the program's spans, by the cells' kind of read
METRICS = ("pack_ms", "launch_ms", "idle_pack_share", "idle_launch_share", "dense_dev_ms",
           "walk_dev_ms", "vote_dev_ms", "compact_dev_ms")
SETUP_METRICS = ("sa_build_s", "kmer_table_s", "chd_build_s")
# the accepted metrics beside them, read from the same run
ACCEPTED = ("dispatch_ms", "device_ms", "idle_share", "launches", "fetch_ms", "fallback_ms")


def main(argv: list[str] | None = None) -> int:
    """Scaffolding, as run_cell is."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from benchgpu import run

    if not torch.cuda.is_available():
        run.log("progtrace needs a CUDA card")
        return 2
    cell, _, _ = run.plan(run.load_json(ROOT, "BENCHMARK.json"), args.workload)
    config = run.load_json(HERE, "configs", f"{cell['config']}.json")
    mix = run.load_json(HERE, "mixes", f"{cell['traffic']}.json")
    rec, win, pool = run_cell(config, mix, args.seed, args.seconds, T_START)
    kind = ".pe" if pool.paired else ".se"
    names = [m + kind for m in METRICS + ACCEPTED] + list(SETUP_METRICS)
    if pool.paired:
        names.append("merge_dev_ms.pe")
    metrics = {}
    for name in names:
        v = run.reader(name)(rec)
        if v is not None:
            metrics[name] = v
    st = (rec.trace or {}).get("stages")
    checks = {}
    if st:
        dev_ms = 1e3 * rec.trace["busy_s"] / rec.trace["batches"]
        checks = dict(attributed_share=st["attributed_share"],
                      stages_over_device_ms=sum(v["device_ms"] for v in st["ranges"].values())
                      / dev_ms)
    breakdown = {k: rec.trace[k] for k in ("device_ops", "idle_gaps")} if rec.trace else {}
    breakdown["stages"] = st
    out = dict(workload=args.workload, seed=args.seed, batches=win.batches,
               window_s=win.seconds, metrics=metrics,
               device=dict(kind=torch.cuda.get_device_name(0)),
               program=rec.program, breakdown=breakdown, checks=checks)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
