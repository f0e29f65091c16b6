"""The port's command line on paired-end reads (`quasimap -1 ... -2 ...`, on
the CPU under TQM_FORCE_CPU=1) against the reference's: the pinned golden
SAM, and byte-for-byte equal SAM files apart from the @PG line and equal
--statsJson counters at the default flags, chunked with a parser thread,
with the Python SAM writer, with a starved --expandBudget that takes the
host-oracle fallback `remap_pe`, and over --resume. The pair options and
--noUnmapped are in tests/test_torch_pe_cli_flags.py."""

import json

import numpy as np
import pytest

from tests.test_golden_sam import GOLDEN_PE, _fixture, _pe_fixture
from tests.test_torch_cli import body, counters, port, ref
from tests.util import BASES, random_transcriptome, write_fasta


def test_port_cli_writes_golden_pe_sam(tmp_path):
    fa, _ = _fixture(str(tmp_path))
    f1, f2 = _pe_fixture(str(tmp_path), fa)
    idx, out = str(tmp_path / "idx"), str(tmp_path / "pe.sam")
    r = port("quasiindex", "-t", fa, "-i", idx, "-k", "15")
    assert r.returncode == 0, r.stderr
    r = port("quasimap", "-i", idx, "-1", f1, "-2", f2, "-o", out)
    assert r.returncode == 0, r.stderr
    with open(GOLDEN_PE) as f:
        assert body(out) == f.read().splitlines()


def _write_mates(path1, path2, pairs, start=0):
    with open(path1, "w") as a, open(path2, "w") as b:
        for i, (m1, m2) in enumerate(pairs, start):
            a.write(f"@p{i}\n{m1.decode()}\n+\n{'I' * len(m1)}\n")
            b.write(f"@p{i}\n{m2.decode()}\n+\n{'I' * len(m2)}\n")
    return path1, path2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Six transcripts of 400-700 bp, three of which share one 150 bp
    segment, k = 11, each tool's own index of them; 40 pairs of 40 bp mates
    from 120-300 bp fragments (a fifth swapped, some of them long enough to
    fail --maxFragLen), six orphan pairs and two junk pairs."""
    rng = np.random.default_rng(41)
    tmp = tmp_path_factory.mktemp("tpecli")
    txps = random_transcriptome(rng, n_txps=6, min_len=400, max_len=700)
    shared = txps[0][1][100:250]
    for i in (1, 2):
        name, s = txps[i]
        txps[i] = (name, s[:60] + shared + s[60:])
    fa = write_fasta(str(tmp / "txome.fa"), txps)
    comp = bytes.maketrans(b"ACGT", b"TGCA")

    def rc(s):
        return s.translate(comp)[::-1]

    def junk():
        return BASES[rng.integers(0, 4, 40)].tobytes()

    pairs = []
    for _ in range(40):
        seq = txps[int(rng.integers(0, len(txps)))][1]
        frag = int(rng.integers(120, 300))
        a = int(rng.integers(0, len(seq) - frag + 1))
        left, right = seq[a : a + 40], rc(seq[a + frag - 40 : a + frag])
        if rng.random() < 0.2:
            left, right = rc(left), rc(right)
        pairs.append((left, right))
    pairs += [(txps[3][1][:40], junk()), (junk(), rc(txps[4][1][9:49]))] * 3
    pairs += [(junk(), junk())] * 2
    f1, f2 = _write_mates(str(tmp / "r_1.fq"), str(tmp / "r_2.fq"), pairs)
    for tool, name in ((ref, "idx_ref"), (port, "idx")):
        r = tool("quasiindex", "-t", fa, "-i", str(tmp / name), "-k", "11")
        assert r.returncode == 0, r.stderr
    return tmp, pairs, f1, f2


CASES = {
    "default_flags": [],
    # chunks of 4 pairs: counts and flags ride the wire unpacked (C % 8 != 0)
    "chunk_size_two_threads": ["--batchSize", "16", "--chunkSize", "4", "-t", "2",
                               "--pipelineDepth", "2", "--profile"],
    "starved_budget_fallback": ["--expandBudget", "1", "--batchSize", "16"],
}
_ref_runs: dict = {}


def run_both(world, case, flags):
    """One quasimap of the world's pairs by each tool -> ((SAM body,
    counters) of the reference, of the port). The reference's run of a case
    on a world is kept for the tests that follow."""
    tmp, _, f1, f2 = world
    key = (str(tmp), case)
    outs = []
    for tool, idx in ((ref, "idx_ref"), (port, "idx")):
        if tool is ref and key in _ref_runs:
            outs.append(_ref_runs[key])
            continue
        out, stats = str(tmp / f"{case}.{idx}.sam"), str(tmp / f"{case}.{idx}.json")
        r = tool("quasimap", "-i", str(tmp / idx), "-1", f1, "-2", f2, "-o", out,
                 "--statsJson", stats, *flags)
        assert r.returncode == 0, r.stderr
        outs.append((body(out), counters(stats)))
        if tool is ref:
            _ref_runs[key] = outs[-1]
    return outs


def assert_equal_reference(world, case, flags):
    """The port's SAM and counters equal the reference's -> (SAM, counters)."""
    (want_sam, want_ctr), (got_sam, got_ctr) = run_both(world, case, flags)
    assert got_sam == want_sam
    assert got_ctr == want_ctr
    n = len(world[1])
    assert want_ctr["reads_total"] == n and 0 < want_ctr["reads_mapped"] < n
    return want_sam, want_ctr


@pytest.mark.parametrize("case", list(CASES))
def test_pe_sam_and_stats_equal_reference(world, case):
    want_sam, want_ctr = assert_equal_reference(world, case, CASES[case])
    if case == "default_flags":
        assert any("\t77\t*\t" in ln for ln in want_sam)  # an unmapped pair
        assert any(ln[0] != "@" and int(ln.split("\t")[1]) & 0x8 for ln in want_sam)
    if case == "starved_budget_fallback":
        assert want_ctr["host_fallback"] > 0
        default = run_both(world, "default_flags", CASES["default_flags"])[0]
        assert want_sam == default[0]


def test_pe_python_sam_writer(world, monkeypatch):
    """The port's command line in process with the Python SAM writer (no
    native formatter) writes the reference's SAM."""
    from rapmap_tpu_torch import cli
    from rapmap_tpu_torch.io import sam

    tmp, _, f1, f2 = world
    want_sam, want_ctr = run_both(world, "default_flags", [])[0]
    monkeypatch.setattr(sam, "get_native_formatter", lambda names: None)
    monkeypatch.setenv("TQM_FORCE_CPU", "1")
    out, stats = str(tmp / "py_writer.sam"), str(tmp / "py_writer.json")
    assert cli.main(["quasimap", "-i", str(tmp / "idx"), "-1", f1, "-2", f2, "-o", out,
                     "--statsJson", stats]) == 0
    assert body(out) == want_sam and counters(stats) == want_ctr


def test_pe_resume_produces_identical_sam(world):
    """Twin of tests/test_resume.py on pairs: a run cut after 2 batches,
    resumed with --resume, writes the clean run's SAM, which equals the
    reference's."""
    tmp, pairs, f1, f2 = world
    flags = ["--batchSize", "8", "--pipelineDepth", "2"]
    (want_sam, _), (got_sam, _) = run_both(world, "batch_8", flags)
    assert got_sam == want_sam
    clean, part = str(tmp / "batch_8.idx.sam"), str(tmp / "part_pe.sam")
    batches = -(-len(pairs) // 8)
    with open(clean + ".tqm_progress.json") as f:
        assert json.load(f)["batches_done"] == batches

    # a crash after 2 batches: a run over the first 16 pairs leaves that
    # progress file; a partial batch's tail follows it in the SAM
    h1, h2 = _write_mates(str(tmp / "h_1.fq"), str(tmp / "h_2.fq"), pairs[:16])
    r = port("quasimap", "-i", str(tmp / "idx"), "-1", h1, "-2", h2, "-o", part, *flags)
    assert r.returncode == 0, r.stderr
    with open(part, "a") as f:
        f.write("GARBAGE LINE FROM A CRASHED BATCH\n")
    r = port("quasimap", "-i", str(tmp / "idx"), "-1", f1, "-2", f2, "-o", part, *flags,
             "--resume")
    assert r.returncode == 0, r.stderr
    assert "resuming after 2 completed batches" in r.stderr
    assert body(part) == body(clean)
    with open(part + ".tqm_progress.json") as f:
        st = json.load(f)
    assert st["batches_done"] == batches and st["counters"]["reads_total"] == len(pairs)
