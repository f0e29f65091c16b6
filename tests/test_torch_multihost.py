"""Multi-process rapmap_tpu_torch on the CPU: torch.distributed over gloo on
localhost. parallel/multihost.global_counter_sum across two spawned
processes (integer counters summed, floats maxed, a counter one process
lacks counted as 0 there), and twins of tests/test_multiprocess.py (two
command-line ranks, single-end) and tests/test_multiprocess_hard.py
(paired-end at --worldSize 4; one rank's shard reset to a crash state and
the world rerun with --resume): each record union equals the port's
single-process SAM and tqm's records on the same world, and every rank's
global --statsJson counters equal the single-process ones. tqm's run of a
world is ONE `python -m rapmap_tpu.cli` subprocess, made once per module
world; the port's single process runs in process, its ranks as
subprocesses."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.util import random_transcriptome, sample_reads, write_fasta, write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(
    os.environ,
    TQM_FORCE_CPU="1",
    JAX_PLATFORMS="cpu",
    OMP_NUM_THREADS="1",
    TQM_DIST_INIT_TIMEOUT_S="120",
    TQM_DIST_SHUTDOWN_TIMEOUT_S="120",
    XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=1 --xla_cpu_parallel_codegen_split_count=1",
)
KEYS = ("reads_total", "reads_mapped", "records", "too_ambiguous")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _records(path: str) -> list[str]:
    with open(path) as f:
        return sorted(ln for ln in f.read().splitlines() if ln and not ln.startswith("@"))


def _stats(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _run_world(argv, out, tmp, world, tag, timeout=300):
    """`world` port ranks as processes -> their --statsJson dicts."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rapmap_tpu_torch.cli", *argv, "-o", out,
         "--statsJson", str(tmp / f"{tag}{rank}.json"), "--worldSize", str(world),
         "--rank", str(rank), "--coordinator", f"localhost:{port}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV, cwd=REPO,
    ) for rank in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
        errs.append(err)
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-2000:]
    return [_stats(tmp / f"{tag}{rank}.json") for rank in range(world)]


def _world(tmp, reads_argv):
    """Index the FASTA with the port's command line (in process), map the
    reads once with tqm (one subprocess) and once with the port's single
    process (in process) -> (index dir, tqm SAM, tqm stats, port SAM, port
    stats)."""
    from rapmap_tpu_torch import cli

    idx = str(tmp / "idx")
    assert cli.main(["quasiindex", "-t", str(tmp / "txome.fa"), "-i", idx, "-k", "11"]) == 0
    base = ["quasimap", "-i", idx, *reads_argv, "--batchSize", "8"]
    r = subprocess.run(
        [sys.executable, "-m", "rapmap_tpu.cli", *base, "-o", str(tmp / "tqm.sam"),
         "--statsJson", str(tmp / "tqm.json")],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=560,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    old = os.environ.get("TQM_FORCE_CPU")
    os.environ["TQM_FORCE_CPU"] = "1"
    try:
        assert cli.main([*base, "-o", str(tmp / "single.sam"),
                         "--statsJson", str(tmp / "single.json")]) == 0
    finally:
        if old is None:
            os.environ.pop("TQM_FORCE_CPU")
        else:
            os.environ["TQM_FORCE_CPU"] = old
    assert _records(tmp / "single.sam") == _records(tmp / "tqm.sam")
    return dict(idx=idx, base=base, tqm=_records(tmp / "tqm.sam"), tqm_stats=_stats(
        tmp / "tqm.json"), single=_records(tmp / "single.sam"),
        single_stats=_stats(tmp / "single.json"))


@pytest.fixture(scope="module")
def se_world(tmp_path_factory):
    """tests/test_multiprocess.py's world: 5 transcripts of 150-260 bp,
    44 reads of 36 bp, batches of 8 (6 batches, the last ragged)."""
    tmp = tmp_path_factory.mktemp("mh_se")
    rng = np.random.default_rng(21)
    txps = random_transcriptome(rng, n_txps=5, min_len=150, max_len=260)
    write_fasta(str(tmp / "txome.fa"), txps)
    reads = sample_reads(rng, txps, 44, read_len=36, error_rate=0.02)
    fq = write_fastq(str(tmp / "reads.fq"), reads)
    return tmp, reads, _world(tmp, ["-r", fq])


@pytest.fixture(scope="module")
def pe_world(tmp_path_factory):
    """tests/test_multiprocess_hard.py's paired-end world: 5 transcripts of
    200-320 bp, 64 pairs of 36 bp mates from 120 bp fragments."""
    tmp = tmp_path_factory.mktemp("mh_pe")
    rng = np.random.default_rng(51)
    txps = random_transcriptome(rng, n_txps=5, min_len=200, max_len=320)
    write_fasta(str(tmp / "txome.fa"), txps)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    L, FRAG = 36, 120
    p1s, p2s = [], []
    for i in range(64):
        seq = txps[int(rng.integers(0, len(txps)))][1]
        a = int(rng.integers(0, len(seq) - FRAG))
        p1s.append((f"p{i}", seq[a : a + L]))
        p2s.append((f"p{i}", seq[a + FRAG - L : a + FRAG].translate(comp)[::-1]))
    f1 = write_fastq(str(tmp / "r1.fq"), p1s)
    f2 = write_fastq(str(tmp / "r2.fq"), p2s)
    return tmp, _world(tmp, ["-1", f1, "-2", f2])


SUM_SCRIPT = textwrap.dedent("""
    import json, sys
    from rapmap_tpu_torch.parallel import multihost

    rank, port = int(sys.argv[1]), sys.argv[2]
    multihost.init_distributed(f"localhost:{port}", 2, rank)
    totals = {"reads_total": 10 + rank, "records": 3 * rank, "wall_s": 1.5 + rank}
    if rank == 0:
        totals["host_fallback"] = 7
    try:
        print(json.dumps(multihost.global_counter_sum(totals)))
    finally:
        multihost.shutdown()
""")


def test_global_counter_sum_two_processes():
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", SUM_SCRIPT, str(rank), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=ENV, cwd=REPO) for rank in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    want = {"reads_total": 21, "records": 3, "host_fallback": 7, "wall_s": 2.5}
    for got in outs:
        assert got == want
        assert all(isinstance(got[k], int) for k in ("reads_total", "records", "host_fallback"))
        assert isinstance(got["wall_s"], float)


def test_two_process_cli_matches_single(se_world):
    tmp, _, w = se_world
    out = str(tmp / "multi.sam")
    stats = _run_world(w["base"], out, tmp, 2, "w2r")
    shard0, shard1 = _records(out + ".0000"), _records(out + ".0001")
    assert shard0 and shard1, "both processes should have produced records"
    assert sorted(shard0 + shard1) == w["single"] == w["tqm"]
    for suffix in (".0000", ".0001"):  # every shard is a standalone SAM
        with open(out + suffix) as f:
            assert f.readline().startswith("@HD")
    for s in stats:
        for key in KEYS:
            assert s[key] == w["single_stats"][key] == w["tqm_stats"][key], key


def test_pe_world4_matches_single(pe_world):
    tmp, w = pe_world
    world = 4
    out = str(tmp / "multi_pe.sam")
    stats = _run_world(w["base"], out, tmp, world, "w4r")
    shards = []
    for rank in range(world):
        recs = _records(out + f".{rank:04d}")
        assert recs, f"rank {rank} produced no records"
        shards += recs
    assert sorted(shards) == w["single"] == w["tqm"]
    for s in stats:
        for key in KEYS[:3]:
            assert s[key] == w["single_stats"][key] == w["tqm_stats"][key], key


def test_rank_failure_resume_union_exact(se_world):
    """Rank 1's output reset to a crash state (its progress after its first
    batch, with a torn record after it); the whole world rerun with --resume
    completes exactly: no rank re-emits or loses records."""
    tmp, reads, w = se_world
    out = str(tmp / "resume.sam")
    fq16 = write_fastq(str(tmp / "r16.fq"), reads[:16])
    base16 = ["quasimap", "-i", w["idx"], "-r", fq16, "--batchSize", "8"]
    _run_world(base16, out, tmp, 2, "pre")  # batch boundaries align with the full run
    crashed = out + ".0001"
    crashed_bytes = os.path.getsize(crashed)
    with open(crashed, "a") as f:
        f.write("TRUNCATED MID-RECORD GARBAG")  # partial batch tail
    stats = _run_world([*w["base"], "--resume"], out, tmp, 2, "res")
    assert sorted(_records(out + ".0000") + _records(out + ".0001")) == w["single"] == w["tqm"]
    with open(crashed) as f:
        text = f.read()
    assert "GARBAG" not in text[:crashed_bytes] and "TRUNCATED" not in text
    for s in stats:
        for key in KEYS:
            assert s[key] == w["single_stats"][key], key
