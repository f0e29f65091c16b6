"""A whole run of each mix through the harness at toy size on the CPU (the
program's plain versions): the window, the tally of failures, and the
comparison with the reference; and that the comparison fails where the
timed path is broken underneath it, and for the control."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchgpu import control, harness, run
from benchgpu.entries import quasimap
from benchgpu.reference import Reference
from benchgpu.tests import gpubench_toy as toy

CELLS = [("isoform_6k.se", "isoform_6k", "se76_b64k"),
         ("txome_100m.se", "txome_100m", "se76_b64k"),
         ("isoform_6k.pe", "isoform_6k", "pe76_b64k")]


def _run(workload, config, mix, seed=3141592653589):
    code, out = run.run_workload(workload, seed, 0.3, False, device="cpu",
                                 config=toy.config(config), mix=toy.mix(mix))
    assert code == 0
    return out


@pytest.mark.parametrize("workload,config,mix", CELLS)
def test_toy_run_is_correct(workload, config, mix):
    out = _run(workload, config, mix)
    assert out["correct"], out["run"]
    assert out["run"]["checked"] >= 256 and out["attempted"] >= 256
    assert list(out)[-1] == "checks" and out["checks"]["unequal_answers"]["value"] == 0
    name = "pairs_per_s" if mix.startswith("pe") else "reads_per_s"
    assert set(out["metrics"]) == {name, "setup_s"} and out["metrics"][name]["value"] > 0


def test_isoform_cut_reads_are_counted_apart_and_prefixes():
    """At 4 record slots the isoform world overflows the record buffer: its
    rows past the cut still get answers, judged as prefixes, and are counted
    in the per-layer `cut_share`, not in `failed`."""
    out = _run("isoform_6k.se", "isoform_6k", "se76_b64k")
    assert out["failed"] == 0 and out["run"]["cut"] > 0 and out["run"]["unequal"] == 0
    code, traced = run.run_workload("isoform_6k.se", 3141592653589, 0.3, True, device="cpu",
                                    config=toy.config("isoform_6k"), mix=toy.mix("se76_b64k"))
    assert code == 0 and traced["failed"] == 0
    assert 0 < traced["metrics"]["cut_share.se"]["value"] < 100


def _half_left_out(fetch):
    def fetch_half(self, handle):
        wr = fetch(self, handle)
        counts = np.asarray(wr.counts).copy()
        keep = int(counts[: len(counts) // 2].sum())
        counts[len(counts) // 2 :] = 0
        return wr._replace(recs=wr.recs[:keep], counts=counts, total=keep)
    return fetch_half


def _first_answer_altered(compact):
    def altered(fields, valid, cap):
        recs, counts, total, ovf = compact(fields, valid, cap)
        recs = recs.clone()
        recs[0, 1] += 1
        return recs, counts, total, ovf
    return altered


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
@pytest.mark.parametrize("workload,config,mix", [CELLS[0], CELLS[2]])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, workload, config, mix):
    from rapmap_tpu_torch.models import quasi
    from rapmap_tpu_torch.ops import compact

    if fault == "half_left_out":
        monkeypatch.setattr(quasi._Mapper, "fetch", _half_left_out(quasi._Mapper.fetch))
    else:
        monkeypatch.setattr(compact, "_compact", _first_answer_altered(compact._compact))
    out = _run(workload, config, mix)
    assert not out["correct"] and out["checks"]["unequal_answers"]["value"] > 0


@pytest.mark.parametrize("workload,config,mix", CELLS)
def test_control_is_not_correct(workload, config, mix):
    cfg, m = toy.config(config), toy.mix(mix)
    transcripts, pool = harness.setup_traffic(cfg, m, 271828182845)
    verdict = harness.judge(control.control_window(cfg, pool, transcripts), pool,
                            quasimap.reference(transcripts, cfg, pool.paired))
    assert verdict["checked"] == m["batch"] * m["pool_batches"]
    assert verdict["unequal"] > 0


def test_control_breaks_only_the_vote():
    ctl = quasimap.VoteSkipped([("t", b"ACGT" * 10)], k=3)
    hits = [(0, 5, np.array([0, 4])), (2, 4, np.array([2]))]
    assert ctl.vote(hits) == {0: (1, 0)}
    assert Reference([("t", b"ACGT" * 10)], k=3).vote(hits) == {0: (2, 0)}


def test_cut_rows():
    counts = np.array([3, 3, 3, 0, 1, 1, 1, 1])
    assert quasimap.cut_rows(counts, 4, 2).tolist() == [0, 0, 1, 1, 0, 0, 0, 0]
    assert quasimap.cut_rows(counts, 8, 1).tolist() == [0, 0, 1, 1, 1, 1, 1, 1]
    assert quasimap.program_rows(65536, 0) == 65536 and quasimap.program_rows(16, 8) == 8


def test_without_a_card_no_result():
    r = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
                        "isoform_6k.se", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 2 and r.stdout == ""


def test_benchmark_file_names_its_files():
    """Every configuration, mix, metric and cell resolves to files by name:
    the world maker, the read model, the entry and the metric readers."""
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(run.reader_file(m["name"])), m["name"]
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(run.ROOT, c["file"])))
        assert all(k in cfg["world"] for k in c["reduced"])
        assert os.path.exists(os.path.join(run.HERE, "worlds", f"{cfg['world']['kind']}.py"))
        entry = harness.entry_of(cfg)
        assert all(callable(getattr(entry, f)) for f in
                   ("setup", "submit", "drain", "reference", "control"))
    for w in bench["workloads"]:
        cell, e2e, layer = run.plan(bench, w["name"])
        m = run.load_json(run.HERE, "mixes", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(run.HERE, "reads", f"{m['reads']}.py"))
        assert "setup_s" in {x["name"] for x in e2e} and len(e2e) >= 2 and layer


def test_pool_reads_carry_their_own_lengths():
    """A read model may give every row its own length; a row's answer is
    asked for its codes up to that length."""
    text = np.tile(np.array([1, 2, 3, 4, 4, 3, 2, 1], np.uint8), 64)
    pool = harness.traffic.make_pool(dict(toy.mix("se76_b64k", batch=8, pool_batches=1),
                                          read_len=20), text, 5)
    codes, lens = pool.batches[0]
    assert codes.shape == (8, 20) and lens.tolist() == [20] * 8
    pool.batches[0] = (codes, np.arange(8, dtype=np.int32) + 10)
    assert len(pool.reads_of(0, 3)) == 13
    pe = harness.traffic.make_pool(dict(toy.mix("pe76_b64k", batch=4, pool_batches=1),
                                        read_len=20, fragment_len=50), text, 6)
    assert pe.paired and [len(x) for x in pe.reads_of(0, 1)] == [20, 20]


@pytest.mark.card
def test_a_cell_on_the_card(card):
    r = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
                        "isoform_6k.se", "--seed", "4294967311", "--seconds", "2"],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


def test_window_keeps_each_distinct_answer_set():
    win = harness.Window()
    counts = np.array([2, 0, 1, 3])
    recs = np.arange(24, dtype=np.int32).reshape(6, 4)
    rows = np.array([0, 2, 3])
    cut = np.zeros(4, bool)
    win.observe(0, rows, counts, recs, cut)
    win.observe(0, rows, counts, recs, cut)
    assert len(win.obs) == 1 and win.obs[0][4] == 2
    assert win.obs[0][2].tolist() == recs[[0, 1, 2, 3, 4, 5]].tolist()
    other = recs.copy()
    other[4, 1] += 1
    win.observe(0, rows, counts, other, cut)
    assert len(win.obs) == 2 and win.first[0] == 0
    win.observe(0, np.array([2]), counts, recs, cut)
    assert win.obs[-1][2].tolist() == [recs[2].tolist()]
