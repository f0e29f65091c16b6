"""The reduction of a traced stretch (benchgpu/devtrace.py) on a made-up
trace, and the per-layer readers on its result."""

import pytest

from benchgpu import devtrace, harness, run
from benchgpu.devtrace import Event

HOST = {"dispatch", "fetch", "fallback", "harness"}


def _trace():
    ms = 1e-3
    return [
        Event(devtrace.STRETCH, 0.0, 10 * ms, False),
        Event("dispatch", 0.0, 4 * ms, False),
        Event("fetch", 4 * ms, 9 * ms, False),
        Event("spin_kernel", -1 * ms, -0.5 * ms, True),  # the primer, before the stretch
        Event("walk_kernel", -1 * ms, 1 * ms, True),  # runs into the stretch
        Event("vote_kernel", 2 * ms, 3 * ms, True),
        Event("Memcpy DtoH (Device -> Pinned)", 2.5 * ms, 5 * ms, True),
        Event("dispatch", 2 * ms, 3 * ms, True),  # the range's device shadow: not an op
        Event("walk_kernel", 8 * ms, 12 * ms, True),
    ]


def test_reduce():
    t = devtrace.reduce(_trace(), HOST, batches=2)
    assert t["window_s"] == pytest.approx(0.010)
    assert t["busy_s"] == pytest.approx(0.001 + 0.003 + 0.002)
    assert t["kernels"] == 2  # vote_kernel and the second walk start inside
    assert t["device_ops"][0] == ["walk_kernel", pytest.approx(0.003)]
    gaps = dict(t["idle_gaps"])
    assert gaps["dispatch"] == pytest.approx(0.001) and gaps["fetch"] == pytest.approx(0.003)


def test_no_stretch_or_no_device_op_reads_nothing():
    assert devtrace.reduce(_trace()[1:], HOST, 2) is None
    host_only = [e for e in _trace() if not e.on_device]
    assert devtrace.reduce(host_only, HOST, 2) is None


def test_readers():
    t = devtrace.reduce(_trace(), HOST, batches=2)
    rec = harness.RunRecord(rows_per_s=5.0, cut_share=1.25, setup_s=3.0,
                            setup={"index_build": 1.5, "mapper_init": 0.5},
                            batch_spans={"dispatch": [0.002, 0.004]}, trace=t)
    want = {"launches.se": 1.0, "device_ms.pe": 3.0, "idle_share.se": 40.0,
            "dispatch_ms.se": 3.0, "reads_per_s": 5.0, "pairs_per_s": 5.0, "setup_s": 3.0,
            "index_build_s": 1.5, "mapper_init_s": 0.5, "cut_share.se": 1.25}
    for name, v in want.items():
        assert run.reader(name)(rec) == pytest.approx(v), name
    assert run.reader("fetch_ms.se")(rec) is None  # no fetch span to read
    untraced = harness.RunRecord(rows_per_s=5.0, cut_share=0.0, setup_s=3.0, setup={},
                                 batch_spans={})
    for name in ("launches.pe", "device_ms.se", "idle_share.train", "index_build_s"):
        assert run.reader(name)(untraced) is None, name


def test_a_dotted_metric_takes_its_own_reader_first(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "HERE", str(tmp_path))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "launches.py").write_text("def read(run):\n    return 1\n")
    (tmp_path / "metrics" / "launches.pe.py").write_text("def read(run):\n    return 2\n")
    assert run.reader("launches.pe")(None) == 2 and run.reader("launches.se")(None) == 1
