"""The isoform transcriptome, bench.py's primary regime, and the accuracy
protocol on the CPU at a toy size: scripts/isoform_world_torch.py's world
byte for byte against bench.py's (the reference's build_isoform_world and
build_pe_reads taken out with ast and run on 40 genes and 4,096 reads), the
port's SE and PE wire results under the isoform config (chunk cut to 512)
against rapmap_tpu's, the pair pool on and the record buffer overflowing in
both, and the PE merge's winner lists cut where they overflow (a fault
shared with the reference); scripts/eval_accuracy_torch.py's last line against
scripts/eval_accuracy.py's on the same flags; and the script's whole run."""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_pe import jax_cache_off  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
GENES, N_READS, CHUNK = 40, 4096, 512


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread while a test runs, in this process and in the
    processes it starts: the suite's workers already fill every core, and
    these toy shapes run no faster on more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def iso():
    return _load("isoform_world_torch", os.path.join(SCRIPTS, "isoform_world_torch.py"))


def reference_builders(cache: str) -> dict:
    """build_isoform_world and build_pe_reads out of bench.py (which
    configures JAX when imported), bound to CACHE = cache and N_READS."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("build_isoform_world", "build_pe_reads")]
    ns = {"np": np, "os": os, "sys": sys, "REPO": REPO, "CACHE": cache,
          "N_READS": N_READS, "READ_LEN": 76}
    exec(compile(ast.Module(body=fns, type_ignores=[]), "bench.py", "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def worlds(iso, tmp_path_factory):
    """The reference's world (its index by rapmap_tpu) and the script's (by
    rapmap_tpu_torch), each in its own cache, with gen_isoform_txome cut to
    GENES genes while they are built."""
    import txome_sim

    full = txome_sim.gen_isoform_txome
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(txome_sim, "gen_isoform_txome",
                   lambda rng, n_genes=0, **kw: full(rng, n_genes=GENES, **kw))
        ref_cache = str(tmp_path_factory.mktemp("ref"))
        ns = reference_builders(ref_cache)
        ridx, rcodes = ns["build_isoform_world"]()
        rc1, rc2 = ns["build_pe_reads"](ridx, tag="pe_iso_v1")
        port_cache = str(tmp_path_factory.mktemp("port"))
        idx, codes = iso.build_isoform_world(port_cache, GENES, N_READS, {})
        c1, c2 = iso.build_pe_reads(idx, port_cache, N_READS)
    return dict(ref=(ridx, rcodes, rc1, rc2, ref_cache), port=(idx, codes, c1, c2, port_cache))


@pytest.fixture(scope="module")
def mappers(iso, worlds):
    """One mapper a package under the isoform config, chunk cut to CHUNK."""
    from rapmap_tpu.config import MapConfig as RefConfig
    from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
    from rapmap_tpu_torch.models.quasi import QuasiMapper

    cfg = iso.isoform_cfg(worlds["port"][0], chunk=CHUNK)
    ref = RefMapper(worlds["ref"][0], RefConfig(**{f: getattr(cfg, f) for f in (
        "k", "chunk", "max_hits_per_strand", "expand_budget", "rec_slots", "max_out")}))
    return ref, QuasiMapper(worlds["port"][0], cfg, device="cpu")


def test_world_equals_reference(worlds):
    """The FASTA, the SE reads and the pairs equal bench.py's byte for byte,
    and so do the two builders' texts and SAs; the port's index carries the
    canonical CHD."""
    ridx, rcodes, rc1, rc2, ref_cache = worlds["ref"]
    idx, codes, c1, c2, port_cache = worlds["port"]
    with open(os.path.join(ref_cache, "txome_iso.fa"), "rb") as a, \
            open(os.path.join(port_cache, "txome_iso.fa"), "rb") as b:
        fa = a.read()
        assert fa == b.read() and fa.count(b">") > 4 * GENES
    assert codes.shape == (N_READS, 76) and c1.shape == (N_READS // 2, 76)
    for x, y in ((rcodes, codes), (rc1, c1), (rc2, c2)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(np.asarray(ridx.text), np.asarray(idx.text))
    assert np.array_equal(np.asarray(ridx.sa), np.asarray(idx.sa))
    assert idx.meta["chd"]["canonical"]


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_wire_equals_reference(worlds, mappers, kind):
    """The isoform config on that world: both packages size the same budget
    and turn the pair pool on; the port's wire buffer and WireResult of
    4,096 reads (pairs) equal rapmap_tpu's, int32 for int32. The SE batch
    overflows its record buffer in both, so the case pins the dropped tail."""
    ref, port = mappers
    _, rcodes, rc1, rc2, _ = worlds["ref"]
    _, codes, c1, c2, _ = worlds["port"]
    assert port.cfg.expand_pairs and ref.cfg.expand_pairs
    assert port.cfg.expand_budget == ref.cfg.expand_budget > 4
    B = N_READS if kind == "se" else N_READS // 2
    lens = np.full(B, 76, np.int32)
    if kind == "se":
        rh, ph = ref.map_se_async(rcodes, lens), port.map_se_async(codes, lens)
    else:
        rh = ref.map_pe_async(rc1, lens, rc2, lens)
        ph = port.map_pe_async(c1, lens, c2, lens)
    assert np.array_equal(ph.wire.numpy(), np.asarray(rh[2]))
    want, got = ref.fetch(rh), port.fetch(ph)
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    assert want.counters["reads_mapped"] > 0.95 * B
    if kind == "se":
        assert want.overflowed and got.overflowed and want.total > len(want.recs)


def test_pe_winner_lists_cut_pairs(iso, worlds, mappers):
    """A fault the port shares with rapmap_tpu (whose PE wire the case
    above holds equal), pinned: the PE merge compacts each mate's winner
    rows into rec_slots x chunk rows, drops the rest unflagged, and pairs
    past the cut come out as orphans. The mates mapped as SE batches show
    where each list was cut; there pairs differ from the oracle while the
    wire marks no overflow, and outside it every pair equals the oracle."""
    _, port = mappers
    idx, _, c1, c2, _ = worlds["port"]
    B = N_READS // 2
    lens = np.full(B, 76, np.int32)
    wr = port.fetch(port.map_pe_async(c1, lens, c2, lens))
    (cut, overflowed), = iso.sw.side_lists(port, c1, c2, B, 1)
    assert overflowed and not wr.overflowed and 0 < cut.sum() < B // 8
    off = iso.sw.offsets_of(wr)

    def differs(i):
        return iso.sw.recs_of(wr, i, off) != iso.sw.oracle_rows_pe(idx, c1[i], c2[i], port.cfg)

    assert sum(differs(i) for i in np.flatnonzero(cut)) > cut.sum() // 2
    assert not any(differs(i) for i in np.flatnonzero(~cut)[::8])


def test_accuracy_line_equals_reference(iso, tmp_path, capsys):
    """eval_accuracy_torch.py --device cpu prints scripts/eval_accuracy.py's
    JSON line on a 40-gene isoform FASTA, chimeras, indels and the score
    filter included; the line before it counts the overflowed batches."""
    import txome_sim

    fa = str(tmp_path / "iso40.fa")
    txome_sim.write_fasta(txome_sim.gen_isoform_txome(np.random.default_rng(3), n_genes=GENES),
                          fa)
    flags = ["-t", fa, "-n", "1024", "--batchSize", "512", "--chimeraFrac", "0.1",
             "--indelRate", "0.01", "--mappingScore", "--minScoreFraction", "0.65"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, os.path.join(SCRIPTS, "eval_accuracy.py"), *flags],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ev = _load("eval_accuracy_torch", os.path.join(SCRIPTS, "eval_accuracy_torch.py"))
    assert ev.main([*flags, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    assert json.loads(lines[-1]) == want and lines[-1] == ref.stdout.strip().splitlines()[-1]
    assert want["score_filtered_records"] > 0 and want["chimera_reads"] > 0
    run = json.loads(lines[-2])
    assert run["device"] == {"platform": "cpu"} and run["batches"] == 2
    assert 0 <= run["overflowed_batches"] <= 2 and run["records_dropped"] >= 0


def test_script_on_cpu(iso, tmp_path):
    """The whole run at a toy size with --cli: the pair pool on, every
    sampled read equal to the oracle or cut by an overflowed batch's full
    buffer, the CPU batches equal, the bitonic pass sorting its power-of-two
    pool and equal to its twin, the command line's replicated engine writing
    every read's and pair's SAM lines as the library gives them, and the
    kernels' plain versions equal. The command line's batches of 256 reads
    overflow their record buffers and warn of it, once a batch."""
    rc, rec = iso.run(iso.parser(), [
        "--device", "cpu", "--genes", str(GENES), "--reads", "1024", "--batch", "512",
        "--chunk", "256", "--oracle-sample", "64", "--cli", "--cli-batch", "256",
        "--workdir", str(tmp_path)])
    assert rc == 0 and rec["failed"] == []
    assert rec["config"]["expand_pairs"] and rec["config"]["expand_budget"] == 9
    orc = rec["oracle"]
    for kind, n in (("se", 64), ("pe", 32)):
        o = orc[f"oracle_{kind}"]
        assert o["checked"] == n and o["unequal"] == 0 and o["cut_outside_overflow"] == 0
    assert rec["se"]["overflowed_batches"] == 2 and rec["se"]["records_dropped"] > 0
    assert orc["oracle_se"]["cut_by_overflow"] > 0
    assert rec["cpu_plain"]["se_equal"] and rec["cpu_plain"]["se_overflowed"]
    assert rec["cpu_plain"]["pe_equal"]
    bit = rec["bitonic_pass"]
    assert bit["equal_twin"] and bit["expand_budget"] == 16 and bit["sort_nel"] == [4096]
    for kind, n in (("se", 1024), ("pe", 512)):
        c = rec["cli"][kind]
        assert c["rc"] == 0 and c["engine"] == "replicated"
        assert c["checked"] == n and c["unequal"] == 0 and c["extra"] == 0
        assert c["overflow_warnings"] == c["library_drops"]["overflowed_batches"]
    assert rec["cli"]["se"]["overflow_warnings"] > 0
    assert rec["cli"]["config"]["expand_pairs"] and rec["cli"]["config"]["chunk"] == 0
    assert rec["kernels"]["anchor_walk"]["equal_plain"]
    assert rec["kernels"]["bitonic_sort_pairs"]["equal_plain"]


def test_cut_rows(iso):
    """The rows a full record buffer may cut: from the row that reaches a
    program's rec_slots x C records to the program's end, in full programs
    only."""
    from collections import namedtuple

    W = namedtuple("W", "counts")
    got = iso.sw.cut_rows(W(np.array([3, 2, 3, 0, 1, 1, 0, 0])), 4, 2)
    assert got.tolist() == [False, False, True, True, False, False, False, False]
    assert iso.sw.cut_rows(W(np.array([2, 2, 0, 0])), 0, 1).tolist() == [False, True, True, True]


def test_no_card_fails(iso, tmp_path, monkeypatch):
    """--device cuda (the default) without a card returns 1 before any work,
    in both scripts; neither turns to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = str(tmp_path / "w")
    assert iso.main(["--genes", str(GENES), "--workdir", work]) == 1
    assert not os.path.exists(work)
    ev = _load("eval_accuracy_torch", os.path.join(SCRIPTS, "eval_accuracy_torch.py"))
    assert ev.main(["--isoform", "-n", "16"]) == 1
