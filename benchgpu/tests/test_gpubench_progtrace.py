"""The reduction of a traced stretch by the program's `tqm.*` ranges
(benchgpu/progtrace.py) on a made-up trace with linked ids, the record of
the recorder's spans, and the readers of the program's metrics."""

import pytest

from benchgpu import devtrace, harness, progtrace, run
from benchgpu.progtrace import Op
from rapmap_tpu_torch.utils.timers import StageTimers, recording, span

HOST = {"dispatch", "fetch", "fallback", "harness"}
MS = 1e-3
MAIN = 1


def _host(name, t0, t1, id_=0):
    return Op(name, t0 * MS, t1 * MS, False, MAIN, id_, 0)


def _dev(name, t0, t1, id_, linked):
    return Op(name, t0 * MS, t1 * MS, True, 0, id_, linked)


def _base():
    """The harness's side: the stretch, its dispatch span, PyTorch's ops,
    the runtime's calls, the device's operations (one launched under no
    program range) and a shadow. A call's id is its operation's; ops count
    ids of their own, which may equal a call's."""
    return [
        _host(devtrace.STRETCH, 0, 20),
        _host("dispatch", 0, 10),
        _host("aten::copy_", 2.2, 2.8, 10), _host("aten::index", 3.1, 3.4, 11),
        _host("aten::sort", 6.5, 6.9, 12), _host("aten::add", 8.5, 8.6, 13),
        _host("aten::copy_", 9.2, 9.3, 14), _host("aten::mul", 12, 12.1, 15),
        _host("aten::gather", -2.5, -2.4, 16),
        Op("cudaMemcpyAsync", 2.5 * MS, 2.6 * MS, False, MAIN, 101, 10),
        Op("cudaLaunchKernel", 5.5 * MS, 5.6 * MS, False, MAIN, 13, 0),  # a ctypes launch
        Op("cudaLaunchKernel", 6.7 * MS, 6.8 * MS, False, MAIN, 11, 12),
        _dev("Memcpy HtoD (Pinned -> Device)", 3.0, 3.5, 101, 10),
        _dev("index_kernel", 4.0, 5.0, 102, 11),  # its call left out: found by its op
        _dev("walk_kernel", 6.0, 8.0, 13, 0),
        _dev("sort_kernel", 8.0, 9.0, 11, 12),
        _dev("add_kernel", 9.0, 9.5, 103, 13),
        _dev("Memcpy DtoH (Device -> Pinned)", 9.5, 10.5, 104, 14),
        _dev("mul_kernel", 15.0, 16.0, 105, 15),
        _dev("gather_kernel", -0.2, 0.4, 106, 16),  # launched before the stretch
        _dev("dispatch", 1.0, 2.0, 0, 0),
    ]


def _ranges():
    """The program's ranges and their device shadows."""
    ranges = [("tqm.vote", -3, -2), ("tqm.pack_in", 0, 2), ("tqm.upload", 2, 3),
              ("tqm.program", 3, 9),
              ("tqm.dense", 3, 5), ("tqm.walk", 5, 6), ("tqm.vote", 6, 8),
              ("tqm.copy_out", 9, 10)]
    return ([_host(n, a, b, 1 + i) for i, (n, a, b) in enumerate(ranges)]
            + [_dev(n, a, b, 0, 0) for n, a, b in ranges])


def _trace():
    return _base() + _ranges()


def test_attribution_by_stage():
    t = progtrace.reduce(_trace(), HOST, batches=2)
    r = t["ranges"]
    dev = {n: v["device_ms"] for n, v in r.items() if v["device_ms"]}
    assert dev == pytest.approx({"tqm.upload": 0.25, "tqm.dense": 0.5, "tqm.walk": 1.0,
                                 "tqm.vote": 0.7, "tqm.program": 0.25, "tqm.copy_out": 0.5,
                                 "unattributed": 0.5})
    kernels = {n: v["kernels"] for n, v in r.items() if v["kernels"]}
    assert kernels == pytest.approx({"tqm.dense": 0.5, "tqm.walk": 0.5, "tqm.vote": 0.5,
                                     "tqm.program": 0.5, "unattributed": 0.5})
    assert r["tqm.program"]["host_ms"] == pytest.approx(3.0)
    assert r["tqm.pack_in"]["host_ms"] == pytest.approx(1.0)
    assert t["attributed_share"] == pytest.approx(100.0 * 6.4 / 7.4)
    assert t["window_ms"] == pytest.approx(10.0)
    assert t["unattributed_ops"] == [["mul_kernel", pytest.approx(0.5)]]
    busy = devtrace.reduce(progtrace.harness_events(_trace()), HOST, 2)["busy_s"]
    assert sum(dev.values()) == pytest.approx(1e3 * busy / 2)


def test_idle_gaps_by_stage():
    r = progtrace.reduce(_trace(), HOST, batches=2)["ranges"]
    idle = {n: v["idle_ms"] for n, v in r.items() if v["idle_ms"]}
    assert idle == pytest.approx({"tqm.pack_in": 1.3, "tqm.dense": 0.25, "tqm.walk": 0.5,
                                  "other": 4.25})


def test_a_lost_trace_reads_nothing():
    lost = [o for o in _trace() if o.name not in ("index_kernel", "walk_kernel",
                                                  "sort_kernel", "add_kernel")]
    assert progtrace.reduce(lost, HOST, 2) is None
    assert progtrace.reduce(_trace()[1:], HOST, 2) is None  # no stretch
    assert progtrace.reduce([o for o in _trace() if not o.on_device], HOST, 2) is None


def test_devtrace_reads_the_same_with_program_ranges():
    plain = devtrace.reduce(progtrace.harness_events(_base()), HOST, 2)
    ranged = devtrace.reduce(progtrace.harness_events(_trace()), HOST, 2)
    assert ranged == plain
    names = HOST | {o.name for o in _ranges()}
    events = [devtrace.Event(o.name, o.start, o.end, o.on_device) for o in _trace()]
    named = devtrace.reduce(events, names, 2)
    for k in ("busy_s", "window_s", "kernels", "device_ops"):
        assert named[k] == plain[k], k
    shadowed = devtrace.reduce(events, HOST, 2)  # the shadows taken for operations
    assert shadowed["kernels"] > plain["kernels"] and shadowed["busy_s"] > plain["busy_s"]


def test_program_record():
    """Set-up spans before the window; per-batch sums over the window's
    batches that have no span in the stretch."""
    rec = StageTimers(keep=True)
    with recording(rec):
        with span("tqm.build.sa"):
            pass
        first = len(rec.spans)
        bounds = []
        for b in range(4):
            if b == 1:
                bounds.append(len(rec.spans))
            with span("tqm.pack_in", b):
                pass
            for _ in range(2):
                with span("tqm.dense"):
                    pass
            if b == 1:
                bounds.append(len(rec.spans))
    p = progtrace.program_record(rec, first, tuple(bounds))
    assert set(p["setup"]) == {"tqm.build.sa"}
    spans = {b: [s for s in rec.spans[first:] if s.batch == b] for b in (0, 2, 3)}
    want = 1e3 * sum(s.end - s.start for v in spans.values() for s in v
                     if s.name == "tqm.dense") / 3
    assert p["batch_ms"]["tqm.dense"] == pytest.approx(want)


def _record(trace, program):
    return progtrace.ProgramRecord(rows_per_s=5.0, cut_share=0.0, setup_s=3.0, setup={},
                                   batch_spans={}, trace=trace, program=program)


def test_readers():
    trace = devtrace.reduce(progtrace.harness_events(_trace()), HOST, 2)
    trace["stages"] = progtrace.reduce(_trace(), HOST, 2)
    program = dict(setup={"tqm.build.sa": 1.5, "tqm.build.kmers": 0.5, "tqm.build.chd": 2.0},
                   batch_ms={"tqm.pack_in": 4.0, "tqm.program": 30.0})
    rec = _record(trace, program)
    want = {"pack_ms.se": 4.0, "launch_ms.pe": 30.0, "idle_pack_share.se": 13.0,
            "idle_launch_share.pe": 7.5, "dense_dev_ms.se": 0.5, "walk_dev_ms.pe": 1.0,
            "vote_dev_ms.se": 0.7, "sa_build_s": 1.5,
            "kmer_table_s": 0.5, "chd_build_s": 2.0, "device_ms.se": 3.7}
    for name, v in want.items():
        assert run.reader(name)(rec) == pytest.approx(v), name
    for name in ("compact_dev_ms.se", "merge_dev_ms.pe"):  # no such range in the trace
        assert run.reader(name)(rec) is None, name
    bare = harness.RunRecord(rows_per_s=5.0, cut_share=0.0, setup_s=3.0, setup={},
                             batch_spans={}, trace=devtrace.reduce(
                                 progtrace.harness_events(_trace()), HOST, 2))
    for rec in (bare, _record(None, None)):
        for name in list(want)[:-1] + ["compact_dev_ms.se", "merge_dev_ms.pe"]:
            assert run.reader(name)(rec) is None, name


@pytest.mark.parametrize("mix", ["se76_b64k", "pe76_b64k"])
def test_a_toy_run_keeps_the_program_record(mix):
    """progtrace.run_cell on the CPU (the plain versions; no trace): the
    set-up's build spans and the window's per-batch spans."""
    from benchgpu.tests import gpubench_toy as toy

    rec, win, pool = progtrace.run_cell(toy.config(), toy.mix(mix), 3141592653589, 0.3, 0.0,
                                        device="cpu")
    p = rec.program
    assert win.batches > 0 and rec.trace is None
    assert {"tqm.build.sa", "tqm.build.kmers", "tqm.build.derive", "tqm.build.chd"} <= set(
        p["setup"])
    for name in ("tqm.pack_in", "tqm.upload", "tqm.program", "tqm.dense", "tqm.fetch_wait"):
        assert p["batch_ms"][name] > 0, name
    assert p["batch_ms"]["tqm.dense"] < p["batch_ms"]["tqm.program"]
    kind = ".pe" if pool.paired else ".se"
    for name in ("pack_ms", "launch_ms"):
        assert run.reader(name + kind)(rec) is not None, name
    assert run.reader("sa_build_s")(rec) > 0
