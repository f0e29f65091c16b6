"""One run of one cell: set-up, the measured window, the check of its
answers against the reference, and the per-layer readings.

The configuration names the program's entry that the window drives
(`entry`: benchgpu/entries/<name>.py). An entry module holds

- `setup(transcripts, config, device, spans, batch)` -> the program, built
  from the transcripts under set-up spans;
- `submit(program, batch)` -> a handle, for one batch of the read model's
  arrays (benchgpu/traffic.py), timed as the host span `dispatch`;
- `drain(program, batch, handle, spans)` -> (per-row record counts, the
  records, rows in a region the program's capacity cut, the rows there
  whose answers it cut), under host spans of its own;
- `reference(transcripts, config, paired)` and `control(...)`: objects with
  `prepare(reads)` and `answer(read)`, the plain reference's answer to a
  read (pair) in the program's record layout, and the control's.

The window is a closed loop, as a mapping job is: `pipeline_depth` batches
in flight, the next dispatched when the oldest is drained. It closes at the
first drained batch at or past `seconds`; its rate is the rows of the
batches drained by then over that time. The batches still in flight are
drained after it and judged, not counted. The run's `failed` are the rows
of counted batches that got no answer back (a drain that returns fewer rows
than the batch has). Rows whose answers the program's capacity cut are
counted apart (`cut_share`, a per-layer reading): they did get an answer,
which must be a strict prefix of the reference's; every other sampled
answer must equal it.

PyTorch runs on TORCH_THREADS CPU threads, set before the program is built,
so that a thread count the program sets itself holds.
"""

from __future__ import annotations

import gc
import importlib
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np

from benchgpu import devtrace, traffic, worlds

WARM_BATCHES = 12  # drained before the window: the pipeline's allocations reach steady state
TORCH_THREADS = 1  # the host path packs and launches on one thread; idle threads only contend
TRACE_AFTER = 8  # batches drained before the traced stretch starts
TRACE_BATCHES = 12  # batches drained inside it


class Spans:
    """Host spans of the harness's and the entry's calls: durations by name,
    each also a record_function range while a profiler records."""

    def __init__(self) -> None:
        self.times: dict[str, list[float]] = {}
        self.annotate = False
        self.stretch: dict = {}  # span -> (first, end) of its entries in the traced stretch

    @contextmanager
    def __call__(self, name: str):
        mark = nullcontext()
        if self.annotate:
            import torch

            mark = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with mark:
            yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)


@dataclass
class RunRecord:
    """What a metric reader (benchgpu/metrics/<name>.py) reads."""

    rows_per_s: float              # reads (pairs) drained in the window a second
    cut_share: float               # % of the window's rows whose answers a capacity cut
    setup_s: float
    setup: dict                    # set-up spans, seconds
    batch_spans: dict              # host span -> per-batch seconds, untraced window batches
    trace: dict | None = None      # devtrace.reduce of the traced stretch

    def span_mean_ms(self, name: str) -> float | None:
        v = self.batch_spans.get(name)
        return 1e3 * float(np.mean(v)) if v else None


@dataclass
class Window:
    """The window's tally: drained batches, failures, cut rows and sampled answers.
    A pool batch's sampled answers are kept the first time it drains (its
    rows' counts and records, and which lie in a cut region); a later cycle
    whose answers are the same adds one to that observation's count, and one
    that differs is kept as an observation of its own."""

    attempted: int = 0
    failed: int = 0
    cut: int = 0
    batches: int = 0
    seconds: float = 0.0
    obs: list = field(default_factory=list)  # [pool batch, counts, records, in cut, times seen]
    first: dict = field(default_factory=dict)  # pool batch -> its first observation's index

    def observe(self, b: int, rows: np.ndarray, counts: np.ndarray, recs: np.ndarray,
                cut: np.ndarray) -> None:
        """Pool batch b's answers: per-read `counts` and dense `recs`; keep those of `rows`."""
        off = np.cumsum(counts, dtype=np.int64) - counts  # each read's first record
        n = counts[rows].astype(np.int64)
        idx = np.repeat(off[rows] - (np.cumsum(n) - n), n) + np.arange(n.sum())
        got = [b, counts[rows].copy(), recs[idx], cut[rows].copy(), 1]
        i = self.first.get(b)
        if i is not None and all(np.array_equal(x, y) for x, y in zip(got[1:4], self.obs[i][1:4])):
            self.obs[i][4] += 1
            return
        self.first.setdefault(b, len(self.obs))
        self.obs.append(got)


def entry_of(config: dict):
    """The module of the configuration's entry."""
    return importlib.import_module(f"benchgpu.entries.{config['entry']}")


def drive(entry, prog, pool: traffic.Pool, depth: int, seconds: float, spans: Spans,
          min_batches: int = 0, profiler=None) -> Window:
    """The closed loop over the pool (see the module's docstring), closing at
    the first drained batch past `seconds` and `min_batches`."""
    win = Window()
    stretch = None  # the traced stretch's range while open, False once closed

    def drain(b, handle, counted):
        counts, recs, cut, capped = entry.drain(prog, pool.batches[b], handle, spans)
        with spans("harness"):
            win.observe(b, pool.sample[b], counts, recs, cut)
            if counted:
                win.attempted += pool.batch
                win.failed += max(0, pool.batch - len(counts))
                win.cut += int(np.count_nonzero(capped))

    q: deque = deque()
    t0 = time.perf_counter()
    while True:
        if profiler is not None and win.batches == TRACE_AFTER and stretch is None:
            stretch = _start_stretch(spans)
        b = (win.batches + len(q)) % len(pool.batches)
        with spans("dispatch"):
            q.append((b, entry.submit(prog, pool.batches[b])))
        if len(q) >= depth:
            drain(*q.popleft(), True)
            win.batches += 1
            if stretch and win.batches == TRACE_AFTER + TRACE_BATCHES:
                _stop_stretch(profiler, spans, stretch)
                stretch = False
            elapsed = time.perf_counter() - t0
            if (elapsed >= seconds and win.batches >= min_batches
                    and (profiler is None or stretch is False)):
                win.seconds = elapsed
                break
    while q:
        drain(*q.popleft(), False)
    return win


def start_profiler():
    """A torch.profiler session on the host and the card, started before the
    window so that its start-up cost stays out of it; short primer kernels
    first, since a session drops its first device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(8):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return prof


def _start_stretch(spans: Spans):
    import torch

    spans.annotate = True
    mark = torch.profiler.record_function(devtrace.STRETCH)
    mark.__enter__()
    spans.stretch = {n: len(v) for n, v in spans.times.items()}
    return mark


def _stop_stretch(profiler, spans: Spans, mark) -> None:
    mark.__exit__(None, None, None)
    spans.annotate = False
    spans.stretch = {n: (spans.stretch.get(n, 0), len(v)) for n, v in spans.times.items()}
    profiler.stop()


def judge(win: Window, pool: traffic.Pool, answers) -> dict:
    """Every sampled answer of every drained batch against `answers` (the
    entry's reference): equal, or (in a cut region) a strict prefix of it,
    else unequal."""
    t0 = time.perf_counter()
    rows = sorted({(b, int(r)) for b in win.first for r in pool.sample[b]})
    answers.prepare([pool.reads_of(b, r) for b, r in rows])
    want = {(b, r): answers.answer(pool.reads_of(b, r)) for b, r in rows}
    out = dict(checked=0, equal=0, cut=0, unequal=0, examples=[])
    for b, counts, recs, in_cut, times in win.obs:
        ends = np.cumsum(counts)
        for r, got, c in zip(pool.sample[b], np.split(recs, ends[:-1]), in_cut):
            w = want[(b, int(r))]
            out["checked"] += times
            if got.shape == w.shape and np.array_equal(got, w):
                out["equal"] += times
            elif c and len(got) < len(w) and np.array_equal(got, w[: len(got)]):
                out["cut"] += times
            else:
                out["unequal"] += times
                if len(out["examples"]) < 3:
                    out["examples"].append(dict(batch=b, row=int(r), got=got[:4].tolist(),
                                                want=w[:4].tolist()))
    out["reference_s"] = time.perf_counter() - t0
    out["distinct_answers"] = len(rows)
    return out


def setup_traffic(config: dict, mix: dict, seed: int):
    """-> (transcripts, pool) of this seed."""
    transcripts = worlds.make(config, seed)
    pool = traffic.make_pool(mix, worlds.text_codes(transcripts), seed)
    return transcripts, pool


def run_cell(config: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> tuple[RunRecord, Window, dict, dict]:
    """One run: -> (the record the readers read, the window, the judgement,
    the device's record)."""
    import torch

    torch.set_num_threads(TORCH_THREADS)
    cuda = device == "cuda"
    entry = entry_of(config)
    spans = Spans()
    with spans("traffic"):
        transcripts, pool = setup_traffic(config, mix, seed)
    prog = entry.setup(transcripts, config, device, spans, pool.batch)
    depth = int(config["pipeline_depth"])
    with spans("warm"):
        drive(entry, prog, pool, depth, 0.0, Spans(), min_batches=WARM_BATCHES)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    setup = {n: v[0] for n, v in spans.times.items()}
    spans.times = {}

    profiler = start_profiler() if trace and cuda else None
    win = drive(entry, prog, pool, depth, seconds, spans, profiler=profiler)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu", count=1,
               memory_peak_bytes=int(torch.cuda.max_memory_allocated()) if cuda else 0)
    batch_spans = {}
    for n, v in spans.times.items():
        lo, hi = spans.stretch.get(n, (len(v), len(v)))
        batch_spans[n] = v[:lo] + v[hi:]
    reduced = None
    if profiler is not None:
        reduced = devtrace.reduce(devtrace.events_of(profiler), set(spans.stretch),
                                  TRACE_BATCHES)
        if reduced:
            dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    del prog, profiler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = judge(win, pool, entry.reference(transcripts, config, pool.paired))
    rec = RunRecord(rows_per_s=win.attempted / win.seconds if win.seconds else 0.0,
                    cut_share=100.0 * win.cut / win.attempted if win.attempted else 0.0,
                    setup_s=setup_s, setup=setup, batch_spans=batch_spans, trace=reduced)
    return rec, win, verdict, dev
