"""The port's command line on the host-staged engine and the compact index
artifacts (in process, on the CPU under TQM_FORCE_CPU=1) against the
reference's command line: twins of the CLI cases of tests/test_core_index.py
and tests/test_mapping_index.py (`quasiindex --coreIndex`, `quasimap` on a
quasi_map artifact and its refusals), `--engine staged` single-end,
paired-end and with --mappingScore, the staged `pseudomap`, and `--engine
auto` picking the staged engine: every SAM equal to tqm's apart from @PG,
so the port's engine choice (its budget is 85% of the card's memory, tqm's
TQM_HBM_GB = 16) cannot change a SAM."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_cli import ENV, REPO, body
from tests.test_torch_staged import _one_thread  # noqa: F401
from tests.util import BASES, random_transcriptome, sample_reads, write_fasta, write_fastq
from tests.test_torch_pe import jax_cache_off  # noqa: F401

COMP = bytes.maketrans(b"ACGT", b"TGCA")
SE = ["--maxReadLen", "36", "--batchSize", "16"]


MAPS = {  # the reads of each comparison, and its flags
    "se": (["-r", "FQ"], "quasimap", []),
    "pe": (["-1", "FQ1", "-2", "FQ2"], "quasimap", []),
    "score": (["-r", "FQ"], "quasimap", ["--mappingScore"]),
    "pseudo": (["-r", "FQ"], "pseudomap", []),
}


@pytest.fixture
def port(monkeypatch, caplog):
    """The port's command line in process on the CPU -> (return code, the
    log's messages)."""
    from rapmap_tpu_torch import cli

    monkeypatch.setenv("TQM_FORCE_CPU", "1")

    def run(*argv, env=None):
        for k, v in (env or {}).items():
            monkeypatch.setenv(k, v)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            rc = cli.main(list(argv))
        return rc, [r.getMessage() for r in caplog.records]

    return run


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_core_index.py's CLI world (4 transcripts of 150-250 bp,
    k = 11, 12 reads of 36 bp) plus two junk reads, 10 pairs of 2 x 36 bp
    from 100 bp fragments, the port's quasi and pseudo indexes, and the
    port's SAM files of them on the replicated engine (`test_cli_sams_equal_tqm`
    holds them to tqm's)."""
    from rapmap_tpu_torch import cli
    from rapmap_tpu_torch.index.builder import build_pseudo_index, build_quasi_index

    rng = np.random.default_rng(93)
    tmp = tmp_path_factory.mktemp("tstcli")
    txps = random_transcriptome(rng, n_txps=4, min_len=150, max_len=250)
    fa = write_fasta(str(tmp / "t.fa"), txps)
    reads = sample_reads(rng, txps, 12, read_len=36)
    reads += [(f"junk{j}", BASES[rng.integers(0, 4, 36)].tobytes()) for j in range(2)]
    left, right = [], []
    for j in range(10):
        seq = txps[j % len(txps)][1]
        a = int(rng.integers(0, len(seq) - 100))
        left.append((f"p{j}", seq[a : a + 36]))
        right.append((f"p{j}", seq[a + 64 : a + 100].translate(COMP)[::-1]))
    files = dict(FQ=write_fastq(str(tmp / "r.fq"), reads),
                 FQ1=write_fastq(str(tmp / "r_1.fq"), left),
                 FQ2=write_fastq(str(tmp / "r_2.fq"), right))
    build_quasi_index(fa, str(tmp / "idx"), k=11)
    build_pseudo_index(fa, str(tmp / "pidx"), k=11)
    env, threads = os.environ.get("TQM_FORCE_CPU"), torch.get_num_threads()
    os.environ["TQM_FORCE_CPU"] = "1"
    torch.set_num_threads(1)  # as _one_thread does for each test
    try:
        for name, (argv, cmd, extra) in MAPS.items():
            idx = str(tmp / ("pidx" if cmd == "pseudomap" else "idx"))
            assert cli.main([cmd, "-i", idx, *(files.get(a, a) for a in argv), *SE, *extra,
                             "-o", str(tmp / f"rep_{name}.sam")]) == 0
    finally:
        torch.set_num_threads(threads)
        if env is None:
            del os.environ["TQM_FORCE_CPU"]
        else:
            os.environ["TQM_FORCE_CPU"] = env
    return tmp, fa, files


def _rep(tmp, name):
    """The port's replicated-engine SAM of a comparison, without @PG."""
    return body(str(tmp / f"rep_{name}.sam"))


def _reads(files, name):
    return [files.get(a, a) for a in MAPS[name][0]]


def test_cli_sams_equal_tqm(world, port, tmp_path):
    """tqm's own index and SAM files (its four commands started together)
    against the port's: the replicated engine's and `--engine staged`'s,
    single-end, paired-end, --mappingScore and pseudomap, each equal apart
    from @PG."""
    from rapmap_tpu.index.builder import build_pseudo_index as ref_pbuild
    from rapmap_tpu.index.builder import build_quasi_index as ref_build

    tmp, fa, files = world
    ref_build(fa, str(tmp_path / "idx"), k=11)
    ref_pbuild(fa, str(tmp_path / "pidx"), k=11)
    procs = {}
    for name, (argv, cmd, extra) in MAPS.items():
        idx = str(tmp_path / ("pidx" if cmd == "pseudomap" else "idx"))
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "rapmap_tpu.cli", cmd, "-i", idx, *_reads(files, name), *SE,
             *extra, "-o", str(tmp_path / f"{name}.sam")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV, cwd=REPO)
    staged = {}
    for name, (argv, cmd, extra) in MAPS.items():
        idx = str(tmp / ("pidx" if cmd == "pseudomap" else "idx"))
        out = str(tmp_path / f"staged_{name}.sam")
        rc, log = port(cmd, "-i", idx, *_reads(files, name), "-o", out, "--engine", "staged",
                       *SE, *extra)
        assert rc == 0 and any("shard 0:" in m for m in log)
        staged[name] = body(out)
    for name, p in procs.items():
        _, err = p.communicate(timeout=560)
        assert p.returncode == 0, err
        want = body(str(tmp_path / f"{name}.sam"))
        assert _rep(tmp, name) == want, name
        assert staged[name] == want, name


def test_cli_core_index_build_and_map(world, port):
    """`quasiindex --coreIndex`, then `quasimap` on the core artifact (it
    reloads into a full index, so the replicated engine maps it): the full
    index's SAM; pseudomap refuses the type, as tqm's does."""
    tmp, fa, files = world
    core = str(tmp / "core")
    rc, log = port("quasiindex", "-t", fa, "-i", core, "-k", "11", "--coreIndex")
    assert rc == 0 and any("core index written" in m for m in log)
    out = str(tmp / "core.sam")
    rc, log = port("quasimap", "-i", core, "-r", files["FQ"], "-o", out, *SE)
    assert rc == 0 and not any("shard 0:" in m for m in log)
    assert body(out) == _rep(tmp, "se")
    rc, log = port("pseudomap", "-i", core, "-r", files["FQ"], "-o", "-")
    assert rc == 1 and any("expected pseudo" in m for m in log)


def test_cli_quasimap_on_mapping_artifact(world, port):
    """A quasi_map artifact always maps on the staged engine (its sweep's log
    lines), with the full index's SAM; --mappingScore and --engine
    replicated are refused as tqm refuses them, and pseudomap refuses the
    type."""
    from rapmap_tpu_torch.index.format import load_index, save_mapping_index

    tmp, _, files = world
    mdir = str(tmp / "mapidx")
    save_mapping_index(load_index(str(tmp / "idx"), mmap=False), mdir)
    out = str(tmp / "map.sam")
    rc, log = port("quasimap", "-i", mdir, "-r", files["FQ"], "-o", out, *SE)
    assert rc == 0 and any("shard 0:" in m for m in log)
    assert body(out) == _rep(tmp, "se")
    for extra, msg in ((["--mappingScore"], "mapping-only"),
                       (["--engine", "replicated"], "replicated")):
        rc, log = port("quasimap", "-i", mdir, "-r", files["FQ"], "-o", "-", *extra)
        assert rc == 1 and any(msg in m for m in log)
    rc, log = port("pseudomap", "-i", mdir, "-r", files["FQ"], "-o", "-")
    assert rc == 1 and any("expected pseudo" in m for m in log)


@pytest.mark.parametrize("name", list(MAPS))
def test_cli_engine_staged_overlap_checkpoint(world, port, name):
    """`--engine staged` in batches of 8 (two sweeps, each over the batches in
    flight) with TQM_SWEEP_OVERLAP=1, TQM_SWEEP_CKPT and small shards
    (TQM_STAGED_SHARD_GB): the replicated engine's SAM, the uploads
    overlapped, a snapshot after each shard and none left at the end."""
    tmp, _, files = world
    argv, cmd, extra = MAPS[name]
    ckpt = str(tmp / f"sweep_{name}.npz")
    env = dict(TQM_SWEEP_OVERLAP="1", TQM_SWEEP_CKPT=ckpt, TQM_SWEEP_CKPT_EVERY="1",
               TQM_STAGED_SHARD_GB="0.00001")
    out = str(tmp / f"staged_{name}.sam")
    idx = str(tmp / ("pidx" if cmd == "pseudomap" else "idx"))
    rc, log = port(cmd, "-i", idx, *_reads(files, name), "-o", out, "--engine", "staged",
                   *SE[:2], "--batchSize", "8", *extra, env=env)
    assert rc == 0 and body(out) == _rep(tmp, name)
    assert any("shard 1:" in m and "exposed wait" in m for m in log)
    assert any("checkpoint @ shard 1" in m for m in log)
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("name", ["se", "pe", "pseudo"])
def test_cli_auto_staged_equals_replicated(world, port, name):
    """The deliberate divergence: where the port's budget sends `--engine
    auto` to the staged engine (here TQM_HBM_GB forces it) and tqm's keeps
    the replicated one, the SAM is the same."""
    tmp, _, files = world
    argv, cmd, extra = MAPS[name]
    out = str(tmp / f"auto_{name}.sam")
    idx = str(tmp / ("pidx" if cmd == "pseudomap" else "idx"))
    rc, log = port(cmd, "-i", idx, *_reads(files, name), "-o", out, *SE,
                   env=dict(TQM_HBM_GB="0.000001"))
    assert rc == 0 and any("host-staged engine" in m for m in log)
    assert any("shard 0:" in m for m in log)
    assert body(out) == _rep(tmp, name)
