"""The port's command line for pseudo-mapping (`pseudoindex`, `pseudomap`,
on the CPU under TQM_FORCE_CPU=1) against the reference's: the pinned golden
SAM (tests/golden/tiny_pseudo.sam, the fixture and commands of
tests/test_golden_sam.py), the same SAM apart from the @PG line and the same
--statsJson counters single-end and paired-end on a small world, and an index
written by either command line mapped by the other."""

import numpy as np
import pytest

from tests.test_golden_sam import GOLDEN_PS, _fixture
from tests.test_torch_cli import body, counters, port, ref
from tests.util import BASES, random_transcriptome, sample_reads, write_fasta, write_fastq


def test_port_cli_writes_golden_pseudo_sam(tmp_path):
    fa, fq = _fixture(str(tmp_path))
    idx, out = str(tmp_path / "pidx"), str(tmp_path / "ps.sam")
    r = port("pseudoindex", "-t", fa, "-i", idx, "-k", "15")
    assert r.returncode == 0, r.stderr
    r = port("pseudomap", "-i", idx, "-r", fq, "-o", out)
    assert r.returncode == 0, r.stderr
    with open(GOLDEN_PS) as f:
        assert body(out) == f.read().splitlines()
    with open(out) as f:
        assert sum(ln.startswith("@PG\tID:tqm\tPN:tqm\t") for ln in f) == 1


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """5 transcripts of 300-500 bp, k = 11, each tool's own pseudo index of
    them; 14 single-end reads of 36 bp (two of them junk) and 12 pairs of
    36 bp mates from 100-180 bp fragments, the right mate reverse-
    complemented (one pair's right mate junk: an orphan; one pair all
    junk)."""
    rng = np.random.default_rng(44)
    tmp = tmp_path_factory.mktemp("tpcli")
    txps = random_transcriptome(rng, n_txps=5, min_len=300, max_len=500)
    fa = write_fasta(str(tmp / "txome.fa"), txps)
    reads = sample_reads(rng, txps, 12, read_len=36, error_rate=0.02)
    reads += [(f"junk{j}", BASES[rng.integers(0, 4, 36)].tobytes()) for j in range(2)]
    fq = write_fastq(str(tmp / "reads.fq"), reads)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    mates = ([], [])
    for i in range(12):
        seq = txps[i % len(txps)][1]
        frag = int(rng.integers(100, 181))
        a = int(rng.integers(0, len(seq) - frag + 1))
        right = seq[a + frag - 36 : a + frag].translate(comp)[::-1]
        left = seq[a : a + 36]
        if i in (5, 11):
            right = BASES[rng.integers(0, 4, 36)].tobytes()
        if i == 11:
            left = BASES[rng.integers(0, 4, 36)].tobytes()
        mates[0].append((f"p{i}", left))
        mates[1].append((f"p{i}", right))
    pe = ["-1", write_fastq(str(tmp / "r_1.fq"), mates[0]),
          "-2", write_fastq(str(tmp / "r_2.fq"), mates[1])]
    for tool, name in ((ref, "pidx_ref"), (port, "pidx")):
        r = tool("pseudoindex", "-t", fa, "-i", str(tmp / name), "-k", "11")
        assert r.returncode == 0, r.stderr
    return tmp, fq, pe


@pytest.mark.parametrize("ends", ["single", "paired"])
def test_sam_and_stats_equal_reference(world, ends):
    tmp, fq, pe = world
    argv = ["-r", fq] if ends == "single" else pe
    outs = []
    for tool, idx in ((ref, "pidx_ref"), (port, "pidx")):
        out = str(tmp / f"{ends}.{idx}.sam")
        stats = str(tmp / f"{ends}.{idx}.json")
        r = tool("pseudomap", "-i", str(tmp / idx), *argv, "-o", out, "--statsJson", stats,
                 "--batchSize", "8")
        assert r.returncode == 0, r.stderr
        outs.append((body(out), counters(stats)))
    (want_sam, want_ctr), (got_sam, got_ctr) = outs
    assert got_sam == want_sam
    assert got_ctr == want_ctr
    assert 0 < want_ctr["reads_mapped"] < want_ctr["reads_total"]


@pytest.mark.parametrize("mapper", ["port", "ref"])
def test_index_of_one_cli_maps_in_the_other(world, mapper):
    """An index written by one command line loads and maps in the other, to
    the SAM that the other's own index gives."""
    tmp, fq, _ = world
    tool, own, other = (port, "pidx", "pidx_ref") if mapper == "port" else (ref, "pidx_ref",
                                                                             "pidx")
    sams = []
    for idx in (own, other):
        out = str(tmp / f"cross.{mapper}.{idx}.sam")
        r = tool("pseudomap", "-i", str(tmp / idx), "-r", fq, "-o", out, "--batchSize", "8")
        assert r.returncode == 0, r.stderr
        sams.append(body(out))
    assert sams[0] == sams[1]
    assert any(ln[0] != "@" and not int(ln.split("\t")[1]) & 4 for ln in sams[0])
