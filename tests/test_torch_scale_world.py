"""scripts/scale_world_torch.py, the port's production-scale transcriptome
(BASELINE.json config 4), on the CPU at a toy size: its world byte for byte
against scripts/bench_scale.py's (the reference's build_scale_world and
build_scale_pe taken out with ast and run at 0.05 Mbase and 512 reads), the
port's SE and PE wire results on that world under the scale config (chunk
cut to 128) against rapmap_tpu's, the script's whole run (oracle parity,
the plain batches, the command line's replicated engine and every SAM line,
the slot64 sharded reads), its fallback path, its preflight's refusal and
its refusal to run without a card; and the upload's tables made in pieces
(ops/device_index.py), equal to one piece and with a traced host peak near
the tables themselves."""

import ast
import importlib.util
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from tests.test_torch_pe import jax_cache_off  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MBASE, N_READS, BATCH = 0.05, 512, 256
SMALL = ["--device", "cpu", "--mbase", str(MBASE), "--reads", str(N_READS),
         "--batch", str(BATCH)]


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sw():
    return _load("scale_world_torch", os.path.join(REPO, "scripts", "scale_world_torch.py"))


def reference_builders(cache: str) -> dict:
    """build_scale_world and build_scale_pe out of scripts/bench_scale.py
    (its module configures JAX and imports bench.py when imported), bound
    to CACHE = cache, TARGET_MBASE = MBASE and N_READS."""
    with open(os.path.join(REPO, "scripts", "bench_scale.py")) as f:
        tree = ast.parse(f.read())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("build_scale_world", "build_scale_pe")]
    import sys
    import time

    ns = {"np": np, "os": os, "sys": sys, "time": time, "CACHE": cache,
          "TARGET_MBASE": MBASE, "N_READS": N_READS, "READ_LEN": 76}
    exec(compile(ast.Module(body=fns, type_ignores=[]), "bench_scale.py", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def worlds(sw, tmp_path_factory):
    """The reference's world (its index by rapmap_tpu) and the script's (by
    rapmap_tpu_torch), each in its own cache."""
    ref_cache = str(tmp_path_factory.mktemp("ref"))
    ns = reference_builders(ref_cache)
    ridx, rcodes = ns["build_scale_world"]()
    rc1, rc2 = ns["build_scale_pe"](ridx)
    port_cache = str(tmp_path_factory.mktemp("port"))
    rec = {}
    idx, codes = sw.build_scale_world(port_cache, MBASE, N_READS, rec)
    c1, c2 = sw.build_scale_pe(idx, port_cache, N_READS)
    return dict(ref=(ridx, rcodes, rc1, rc2, ref_cache), port=(idx, codes, c1, c2, port_cache),
                rec=rec)


def test_world_equals_reference(worlds):
    """The FASTA, the SE reads and the pairs equal bench_scale.py's byte for
    byte, and so do the two builders' texts they are drawn from; the port's
    index carries the canonical CHD."""
    ridx, rcodes, rc1, rc2, ref_cache = worlds["ref"]
    idx, codes, c1, c2, port_cache = worlds["port"]
    with open(os.path.join(ref_cache, "txome_scale.fa"), "rb") as a, \
            open(os.path.join(port_cache, "txome_scale.fa"), "rb") as b:
        assert a.read() == b.read()
    assert codes.shape == (N_READS, 76) and c1.shape == (N_READS // 2, 76)
    for x, y in ((rcodes, codes), (rc1, c1), (rc2, c2)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(np.asarray(ridx.text), np.asarray(idx.text))
    assert np.array_equal(np.asarray(ridx.sa), np.asarray(idx.sa))
    assert idx.meta["chd"]["canonical"] and worlds["rec"]["build_stages"]["sa_s"] >= 0


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_wire_equals_reference(sw, worlds, kind):
    """The scale config (bench_cfg, chunk cut to 128) on that world: the
    port's wire buffer and WireResult of one batch of 256 reads (pairs)
    equal rapmap_tpu.models.quasi.QuasiMapper's, int32 for int32, flags and
    overflow included."""
    from rapmap_tpu.config import MapConfig as RefConfig
    from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
    from rapmap_tpu_torch.models.quasi import QuasiMapper

    ridx, rcodes, rc1, rc2, _ = worlds["ref"]
    idx, codes, c1, c2, _ = worlds["port"]
    cfg = sw.bench_cfg(idx, chunk=128)
    ref = RefMapper(ridx, RefConfig(**{f: getattr(cfg, f) for f in (
        "k", "chunk", "max_hits_per_strand", "expand_budget", "rec_slots", "max_out")}))
    port = QuasiMapper(idx, cfg, device="cpu")
    lens = np.full(BATCH, 76, np.int32)
    if kind == "se":
        rh, ph = ref.map_se_async(rcodes[:BATCH], lens), port.map_se_async(codes[:BATCH], lens)
    else:
        rh = ref.map_pe_async(rc1[:BATCH], lens, rc2[:BATCH], lens)
        ph = port.map_pe_async(c1[:BATCH], lens, c2[:BATCH], lens)
    assert np.array_equal(ph.wire.numpy(), np.asarray(rh[2]))
    want, got = ref.fetch(rh), port.fetch(ph)
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    assert want.counters["reads_total"] == BATCH and want.counters["reads_mapped"] > 0.9 * BATCH


def test_script_on_cpu(sw, tmp_path):
    """The whole run at 0.05 Mbase with --sharded --cli: full oracle parity,
    the CPU batches equal, the bitonic pass equal to its twin, the command
    line's replicated engine writing every read's and pair's SAM lines as
    the library's records give them, the 96 slot64 sharded reads equal to
    the oracle, and the kernels' plain versions equal."""
    rc, rec = sw.run(sw.parser(), [*SMALL, "--sharded", "--cli", "--workdir", str(tmp_path)])
    assert rc == 0 and rec["failed"] == []
    assert rec["oracle"]["oracle_se"]["parity"] == "512/512"
    assert rec["oracle"]["oracle_pe"]["parity"] == "256/256"
    assert rec["cpu_plain"]["se_equal"] and rec["cpu_plain"]["pe_equal"]
    assert rec["bitonic_pass"]["equal_twin"] and rec["bitonic_pass"]["voting_pool"] == 1024
    assert rec["se"]["rows"] == N_READS and rec["pe"]["rows"] == N_READS // 2
    for kind, n in (("se", N_READS), ("pe", N_READS // 2)):
        c = rec["cli"][kind]
        assert c["rc"] == 0 and c["engine"] == "replicated"
        assert c["checked"] == n and c["unequal"] == 0 and c["extra"] == 0
    sh = rec["sharded"]
    assert sh["parity"] == "96/96" and sh["slot_base_dtype"] == "int64" and sh["k8_equal_plain"]
    assert rec["kernels"]["anchor_walk"]["equal_plain"]
    assert rec["kernels"]["bitonic_sort_pairs"]["equal_plain"]
    assert rec["device_bytes_estimate"] >= rec["device_index_bytes"]


def test_script_fallback_path(sw, tmp_path, monkeypatch):
    """Under buffers too tight for the world (1 hit slot, 1 record a read,
    expansion budget 1) reads and pairs are flagged; after the host
    fallback every sampled one equals the oracle."""
    import dataclasses

    tight = sw.bench_cfg
    monkeypatch.setattr(sw, "bench_cfg", lambda idx, chunk=sw.CHUNK: dataclasses.replace(
        tight(idx, chunk), max_hits_per_strand=1, max_out=1, expand_budget=1))
    rc, rec = sw.run(sw.parser(), ["--device", "cpu", "--mbase", str(MBASE), "--reads", "256",
                                   "--batch", "128", "--workdir", str(tmp_path)])
    assert rc == 0 and rec["failed"] == []
    assert rec["se"]["flagged"] > 0 and rec["pe"]["flagged"] > 0
    orc = rec["oracle"]
    assert orc["fallback_reads"] == rec["se"]["flagged"]
    assert orc["fallback_pairs"] == rec["pe"]["flagged"]
    assert orc["oracle_se"]["flagged"] > 0 and orc["oracle_se"]["unequal"] == 0
    assert orc["oracle_pe"]["flagged"] > 0 and orc["oracle_pe"]["unequal"] == 0


def test_preflight_refuses_short_host(sw, tmp_path, monkeypatch, capsys):
    """With MemAvailable made short, the script prints one "skipped" JSON
    line with the figures and the plan, exits 2 and writes no FASTA."""
    monkeypatch.setattr(sw, "mem_available_bytes", lambda: 1 << 20)
    work = str(tmp_path / "w")
    assert sw.main([*SMALL, "--workdir", work]) == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["skipped"] == "not enough host memory" and line["short"] == ["host memory"]
    assert line["mem_available_bytes"] == 1 << 20 and line["plan"]["host_total"] > 1 << 20
    assert not any(f.endswith(".fa") for _, _, fs in os.walk(work) for f in fs)


def test_no_card_fails(sw, tmp_path, monkeypatch):
    """--device cuda (the default) without a card returns 1 before any
    work; it never turns to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = str(tmp_path / "w")
    assert sw.main(["--mbase", str(MBASE), "--workdir", work]) == 1
    assert not os.path.exists(work)


# ---- the upload's tables in pieces (ops/device_index.py) ---------------------------


@pytest.mark.parametrize("lean,pairs", [(True, False), (True, True), (False, False)])
def test_upload_in_pieces_equals_one_piece(worlds, monkeypatch, lean, pairs):
    """Every table of the upload made in pieces of 1,000 rows over 4
    threads equals the same table made in one piece."""
    import rapmap_tpu_torch.ops.device_index as di

    idx = worlds["port"][0]
    monkeypatch.setattr(di, "_PIECE_ROWS", 1 << 40)
    whole, st = di.upload_index(idx, "cpu", lean=lean, meta_pairs=pairs)
    monkeypatch.setattr(di, "_PIECE_ROWS", 1000)
    monkeypatch.setattr(di, "_PIECE_THREADS", 4)
    cut, st2 = di.upload_index(idx, "cpu", lean=lean, meta_pairs=pairs)
    assert st2 == st and len(idx.chd_perm) > 50 * 1000
    for f in whole._fields:
        a, b = getattr(whole, f), getattr(cut, f)
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f


def test_upload_traced_peak(worlds, monkeypatch):
    """The canonical class rows and the lean upload hold little beside the
    tables they make: made in pieces of 1,024 rows on 2 threads, their
    traced peaks stay within 1.25x the tables (one whole-table pass held
    4.1x and 3.1x: the gathered rows, the sentinel select and its copy)."""
    import rapmap_tpu_torch.ops.device_index as di

    idx = worlds["port"][0]
    monkeypatch.setattr(di, "_PIECE_ROWS", 1024)
    monkeypatch.setattr(di, "_PIECE_THREADS", 2)
    tracemalloc.start()
    try:
        rows = di.canonical_class_rows(idx)
        _, rows_peak = tracemalloc.get_traced_memory()
        del rows
        tracemalloc.reset_peak()
        didx, _ = di.upload_index(idx, "cpu", lean=True)
        _, up_peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert rows_peak <= 1.25 * 24 * len(idx.chd_perm)
    tables = sum(t.numel() * t.element_size() for t in didx if t is not None)
    assert up_peak <= 1.25 * tables
