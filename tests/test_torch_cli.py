"""The port's command line (`python -m rapmap_tpu_torch.cli`, on the CPU under
TQM_FORCE_CPU=1) against the reference's (`python -m rapmap_tpu.cli`): the
pinned golden SAM, byte-for-byte equal SAM files apart from the @PG line and
equal --statsJson counters over flag and input variants, --resume, --noOutput,
the clean refusals of what is not ported yet, and a non-zero exit that names
CUDA when neither a card nor TQM_FORCE_CPU is there."""

import gzip
import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.test_golden_sam import GOLDEN, _fixture
from tests.util import BASES, random_transcriptome, sample_reads, write_fasta, write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(
    os.environ,
    TQM_FORCE_CPU="1",
    JAX_PLATFORMS="cpu",
    XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=1 --xla_cpu_parallel_codegen_split_count=1",
)
TIMING_KEYS = ("wall_s", "steady_reads_per_s")


def run_cli(package: str, *args, env=ENV):
    return subprocess.run(
        [sys.executable, "-m", f"{package}.cli", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=560,
    )


def port(*args, **kw):
    return run_cli("rapmap_tpu_torch", *args, **kw)


def ref(*args, **kw):
    return run_cli("rapmap_tpu", *args, **kw)


def body(path) -> list[str]:
    """SAM lines without @PG, which carries the command line."""
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("@PG")]


def counters(path) -> dict:
    with open(path) as f:
        return {k: v for k, v in json.load(f).items() if k not in TIMING_KEYS}


def test_port_cli_writes_golden_sam(tmp_path):
    fa, fq = _fixture(str(tmp_path))
    idx, out = str(tmp_path / "idx"), str(tmp_path / "se.sam")
    r = port("quasiindex", "-t", fa, "-i", idx, "-k", "15")
    assert r.returncode == 0, r.stderr
    r = port("quasimap", "-i", idx, "-r", fq, "-o", out)
    assert r.returncode == 0, r.stderr
    with open(GOLDEN) as f:
        assert body(out) == f.read().splitlines()
    with open(out) as f:
        assert sum(ln.startswith("@PG\tID:tqm\tPN:tqm\t") for ln in f) == 1


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The shape of tests/test_cli_sam.py's worlds in one: 5 transcripts of
    400-700 bp, k = 11, each tool's own index of them; 12 reads of 36 bp plus
    two junk reads, and a FASTQ mixing lengths 20..300 with one read shorter
    than k."""
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("tcli")
    txps = random_transcriptome(rng, n_txps=5, min_len=400, max_len=700)
    fa = write_fasta(str(tmp / "txome.fa"), txps)
    reads = sample_reads(rng, txps, 12, read_len=36)
    reads += [(f"junk{j}", BASES[rng.integers(0, 4, 36)].tobytes()) for j in range(2)]
    fq = write_fastq(str(tmp / "reads.fq"), reads)
    mixed = []
    for j, n in enumerate([20, 36, 60, 90, 130, 200, 300, 36, 200, 20]):
        (rd,) = sample_reads(rng, txps, 1, read_len=n, error_rate=0.02)
        mixed.append((f"m{j}_L{n}", rd[1]))
    mixed.append(("tiny", b"ACGTACG"))
    write_fastq(str(tmp / "mixed.fq"), mixed)
    for tool, name in ((ref, "idx_ref"), (port, "idx")):
        r = tool("quasiindex", "-t", fa, "-i", str(tmp / name), "-k", "11")
        assert r.returncode == 0, r.stderr
    return tmp, txps, reads, fq


def _split_inputs(tmp, fq):
    with open(fq) as f:
        lines = f.read().splitlines()
    recs = ["\n".join(lines[i : i + 4]) for i in range(0, len(lines), 4)]
    a, b = str(tmp / "part1.fq"), str(tmp / "part2.fq")
    with open(a, "w") as f:
        f.write("\n".join(recs[:6]) + "\n")
    with open(b, "w") as f:
        f.write("\n".join(recs[6:]) + "\n")
    return f"{a},{b}"


def _gz_input(tmp, fq):
    gz = str(tmp / "reads.fq.gz")
    with open(fq, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    return gz


CASES = {
    "default_flags": (None, []),
    "chunk_size": (None, ["--batchSize", "8", "--chunkSize", "4"]),
    "no_unmapped": (None, ["--noUnmapped", "--batchSize", "16"]),
    "two_threads": (None, ["-t", "2", "--batchSize", "4", "--pipelineDepth", "2"]),
    "comma_separated_files": (_split_inputs, ["--batchSize", "16"]),
    "gz_input": (_gz_input, ["--batchSize", "16"]),
    "mixed_read_lengths": (lambda tmp, fq: str(tmp / "mixed.fq"), ["--batchSize", "6"]),
    "python_parser": (None, ["--batchSize", "16"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sam_and_stats_equal_reference(world, case):
    tmp, txps, reads, fq = world
    make_input, flags = CASES[case]
    src = make_input(tmp, fq) if make_input else fq
    env = ENV
    if case == "python_parser":
        # the port without its native FASTQ parser; the reference as it is
        env = dict(ENV, TQM_NO_NATIVE_PARSE="1")
    outs = []
    for tool, idx, e in ((ref, "idx_ref", ENV), (port, "idx", env)):
        out = str(tmp / f"{case}.{idx}.sam")
        stats = str(tmp / f"{case}.{idx}.json")
        r = tool("quasimap", "-i", str(tmp / idx), "-r", src, "-o", out,
                 "--statsJson", stats, *flags, env=e)
        assert r.returncode == 0, r.stderr
        outs.append((body(out), counters(stats)))
    (want_sam, want_ctr), (got_sam, got_ctr) = outs
    assert got_sam == want_sam
    assert got_ctr == want_ctr
    assert want_ctr["reads_mapped"] > 0
    if case == "no_unmapped":
        assert want_ctr["reads_mapped"] < want_ctr["reads_total"]
        assert not any(ln.startswith("junk") for ln in want_sam)
    if case == "default_flags":
        assert any(ln.startswith("junk0\t4\t") for ln in want_sam)


def test_port_reads_the_reference_index(world):
    """One index format: the port maps on the index the reference built."""
    tmp, txps, reads, fq = world
    a, b = str(tmp / "own.sam"), str(tmp / "theirs.sam")
    for idx, out in (("idx", a), ("idx_ref", b)):
        r = port("quasimap", "-i", str(tmp / idx), "-r", fq, "-o", out, "--batchSize", "16")
        assert r.returncode == 0, r.stderr
    assert body(a) == body(b)


def test_no_output_flag(world):
    tmp, txps, reads, fq = world
    stats = str(tmp / "n.json")
    r = port("quasimap", "-i", str(tmp / "idx"), "-r", fq, "-n", "--statsJson", stats,
             "--batchSize", "16")
    assert r.returncode == 0, r.stderr
    assert r.stdout == ""
    assert counters(stats)["reads_mapped"] == 12
    assert not os.path.exists("-.tqm_progress.json")


def test_profile_logs_the_program_stages(world):
    """--profile's stage log holds the program's own stages beside the
    command line's."""
    tmp, txps, reads, fq = world
    r = port("quasimap", "-i", str(tmp / "idx"), "-r", fq, "-n", "--profile",
             "--batchSize", "16")
    assert r.returncode == 0, r.stderr
    assert "stage tqm.vote" in r.stderr and "stage dispatch" in r.stderr


def test_resume_produces_identical_sam(world):
    """Twin of tests/test_resume.py: interrupted run + --resume == clean run,
    and the clean run equals the reference's."""
    tmp, txps, _, _ = world
    rng = np.random.default_rng(61)
    reads = sample_reads(rng, txps, 40, read_len=36)
    fq = write_fastq(str(tmp / "r40.fq"), reads)
    flags = ["--batchSize", "8", "--pipelineDepth", "2"]
    clean, part, theirs = (str(tmp / n) for n in ("clean.sam", "part.sam", "ref40.sam"))
    r = port("quasimap", "-i", str(tmp / "idx"), "-r", fq, "-o", clean, *flags)
    assert r.returncode == 0, r.stderr
    with open(clean + ".tqm_progress.json") as f:
        assert json.load(f)["batches_done"] == 5
    r = ref("quasimap", "-i", str(tmp / "idx_ref"), "-r", fq, "-o", theirs, *flags)
    assert r.returncode == 0, r.stderr
    assert body(clean) == body(theirs)

    # a crash after 2 batches: a run over the first 16 reads leaves that
    # progress file; a partial batch's tail follows it in the SAM
    fq16 = write_fastq(str(tmp / "r16.fq"), reads[:16])
    r = port("quasimap", "-i", str(tmp / "idx"), "-r", fq16, "-o", part, *flags)
    assert r.returncode == 0, r.stderr
    with open(part, "a") as f:
        f.write("GARBAGE LINE FROM A CRASHED BATCH\n")
    r = port("quasimap", "-i", str(tmp / "idx"), "-r", fq, "-o", part, *flags, "--resume")
    assert r.returncode == 0, r.stderr
    assert "resuming after 2 completed batches" in r.stderr
    assert body(part) == body(clean)
    with open(part + ".tqm_progress.json") as f:
        st = json.load(f)
    assert st["batches_done"] == 5
    assert st["counters"]["reads_total"] == len(reads)


def _pseudo_index(tmp):
    """The world's pseudo index (the port's build)."""
    from rapmap_tpu_torch.index.builder import build_pseudo_index

    dst = str(tmp / "pidx")
    if not os.path.exists(dst):
        build_pseudo_index(str(tmp / "txome.fa"), dst, k=11)
    return dst


def _retyped_index(tmp, itype):
    """A copy of the world's index whose header claims another type."""
    dst = str(tmp / f"idx_{itype}")
    if not os.path.exists(dst):
        shutil.copytree(str(tmp / "idx"), dst)
        with open(os.path.join(dst, "header.json")) as f:
            header = json.load(f)
        if itype == "no_chd":
            for name in ("chd_dir", "chd_perm", "chd_cls"):
                header["hashes"].pop(name)
        else:
            header["index_type"] = itype
        with open(os.path.join(dst, "header.json"), "w") as f:
            json.dump(header, f)
    return dst


REFUSALS = {
    # paired-end mapping is ported: half a pair is what is refused now
    "paired_end": (["quasimap", "-i", "IDX", "-1", "FQ"], "-1/-2 for paired-end"),
    # pseudomap is ported: what the reference refuses is refused
    "pseudomap_mapping_score": (["pseudomap", "-i", "PIDX", "-r", "FQ", "--mappingScore"],
                                "--mappingScore needs the suffix-array text; quasimap only"),
    "pseudomap_quasi_index": (["pseudomap", "-i", "IDX", "-r", "FQ"],
                              "is type quasi, expected pseudo"),
    # the mapping score and the artifacts are ported: the mapping-only
    # artifact refuses the score and the replicated engine, as tqm's does,
    # and pseudomap refuses the core artifact
    "mapping_score": (["quasimap", "-i", "quasi_map", "-r", "FQ", "--mappingScore"],
                      "mapping-only"),
    # --worldSize > 1 is ported: a rank outside the world is refused before
    # any process group is joined, as tqm refuses it
    "world_size": (["quasimap", "-i", "IDX", "-r", "FQ", "--worldSize", "2", "--rank", "2",
                    "-o", "OUT"], "--rank must be in [0, worldSize)"),
    "index_quasi_map": (["quasimap", "-i", "quasi_map", "-r", "FQ", "--engine", "replicated"],
                        "has no replicated-engine arrays"),
    "index_quasi_core": (["pseudomap", "-i", "quasi_core", "-r", "FQ"],
                         "is type quasi_core, expected pseudo"),
    "index_pseudo": (["quasimap", "-i", "pseudo", "-r", "FQ"], "is type pseudo, expected quasi"),
    "no_reads": (["quasimap", "-i", "IDX"], "provide -r"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_exit_1_with_one_line(world, case, monkeypatch, capfd):
    """What is not ported yet, or what tqm refuses too, is refused in
    process: return code 1, one error line that names it, no exception,
    nothing written."""
    from rapmap_tpu_torch import cli

    tmp, _, _, fq = world
    argv, message = REFUSALS[case]
    out = str(tmp / f"refused_{case}")
    subst = {"IDX": str(tmp / "idx"), "FQ": fq, "FA": str(tmp / "txome.fa"), "OUT": out}
    if "PIDX" in argv:
        subst["PIDX"] = _pseudo_index(tmp)
    argv = [subst.get(a) or (_retyped_index(tmp, a) if a in
                             ("quasi_map", "quasi_core", "pseudo", "no_chd") else a)
            for a in argv]
    monkeypatch.setenv("TQM_FORCE_CPU", "1")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = Keep(level=logging.ERROR)
    cli.log.addHandler(handler)
    try:
        assert cli.main(argv) == 1
    finally:
        cli.log.removeHandler(handler)
    assert len(records) == 1
    assert message in records[0].getMessage()
    assert not os.path.exists(out)
    assert capfd.readouterr().out == ""


@pytest.mark.parametrize("ends", ["single", "paired"])
def test_index_without_canonical_chd_maps_as_reference(world, ends):
    """The world's index with its CHD section dropped (what a with_chd=False
    build or a failed CHD placement leaves): both tools map it (the port
    through the binary-search probe and the full upload) and write the same
    SAM apart from @PG, single-end and paired-end; and the same as the port
    writes on the index with its CHD."""
    tmp, txps, reads, fq = world
    nochd = _retyped_index(tmp, "no_chd")
    if ends == "single":
        argv = ["-r", fq]
    else:  # mates of 100-180 bp fragments, the right one reverse-complemented
        rng = np.random.default_rng(8)
        comp = bytes.maketrans(b"ACGT", b"TGCA")
        mates = ([], [])
        for i in range(14):
            seq = txps[i % len(txps)][1]
            frag = int(rng.integers(100, 181))
            a = int(rng.integers(0, len(seq) - frag + 1))
            mates[0].append((f"p{i}", seq[a : a + 36]))
            mates[1].append((f"p{i}", seq[a + frag - 36 : a + frag].translate(comp)[::-1]))
        argv = ["-1", write_fastq(str(tmp / "nochd_1.fq"), mates[0]),
                "-2", write_fastq(str(tmp / "nochd_2.fq"), mates[1])]
    out = {}
    for name, tool, index in (("port", port, nochd), ("ref", ref, nochd),
                              ("port_chd", port, str(tmp / "idx"))):
        out[name] = str(tmp / f"nochd_{ends}_{name}.sam")
        r = tool("quasimap", "-i", index, *argv, "-o", out[name], "--batchSize", "8")
        assert r.returncode == 0, r.stderr
    assert body(out["port"]) == body(out["ref"])
    assert body(out["port"]) == body(out["port_chd"])
    assert sum(1 for ln in body(out["port"]) if ln[0] != "@" and not int(ln.split("\t")[1]) & 4)


def test_cli_without_card_exits_nonzero_and_names_cuda(world):
    """No TQM_FORCE_CPU and no card (as where these tests run): the CLI
    fails and says why; it does not carry on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    tmp, _, _, fq = world
    env = {k: v for k, v in ENV.items() if k != "TQM_FORCE_CPU"}
    out = str(tmp / "nocard.sam")
    r = port("quasimap", "-i", str(tmp / "idx"), "-r", fq, "-o", out, env=env)
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "Traceback" not in r.stderr
    assert not os.path.exists(out)
