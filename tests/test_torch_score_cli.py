"""The port's command line with --mappingScore (`quasimap`, on the CPU under
TQM_FORCE_CPU=1): the pinned golden SAMs `tiny_quasi_se_as.sam` and
`tiny_quasi_pe_as.sam` byte for byte apart from @PG, and twins of
tests/test_mapping_score.py and tests/test_round3_fixes.py: every AS:i tag
equals the numpy oracle's score of its record (SE and PE, unchunked and
chunked), --minScoreFraction suppresses a junk read and re-derives the
counters, a suppressed first record promotes the next one to primary, and
--minScoreFraction without --mappingScore is rejected."""

import io
import json

import numpy as np
import pytest

from rapmap_tpu_torch import cli
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.io.sam import write_se_records_dense
from rapmap_tpu_torch.models.scorefilter import filter_se
from rapmap_tpu_torch.ops.wire import FLAG_MAPPED, WireResult
from tests.test_golden_sam import GOLDEN_PE_AS, GOLDEN_SE_AS, _fixture, _pe_fixture
from tests.test_mapping_score import _check_as, _parse_sam, world  # noqa: F401
from tests.test_torch_cli import body, port

SCORE = ["--mappingScore", "--minScoreFraction", "0.5"]


@pytest.fixture(scope="module")
def golden_world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("golden_as"))
    fa, fq = _fixture(tmp)
    f1, f2 = _pe_fixture(tmp, fa)
    idx = f"{tmp}/idx"
    r = port("quasiindex", "-t", fa, "-i", idx, "-k", "15")
    assert r.returncode == 0, r.stderr
    return tmp, idx, fq, f1, f2


@pytest.mark.parametrize("ends", ["single", "paired"])
def test_port_cli_writes_golden_as_sam(golden_world, ends):
    tmp, idx, fq, f1, f2 = golden_world
    out = f"{tmp}/{ends}_as.sam"
    reads = ["-r", fq] if ends == "single" else ["-1", f1, "-2", f2]
    r = port("quasimap", "-i", idx, *reads, "-o", out, *SCORE)
    assert r.returncode == 0, r.stderr
    with open(GOLDEN_SE_AS if ends == "single" else GOLDEN_PE_AS) as f:
        want = f.read().splitlines()
    assert body(out) == want
    assert any("\tAS:i:" in ln for ln in want)


def run(argv, monkeypatch) -> int:
    monkeypatch.setenv("TQM_FORCE_CPU", "1")
    return cli.main(argv)


@pytest.mark.parametrize("chunk", ["0", "16"])
def test_se_as_tags_match_oracle(world, tmp_path, chunk, monkeypatch):  # noqa: F811
    out = str(tmp_path / f"se_{chunk}.sam")
    assert run(["quasimap", "-i", world["idxdir"], "-r", world["fq"], "-o", out,
                "--mappingScore", "--batchSize", "32", "--chunkSize", chunk],
               monkeypatch) == 0
    seqs = {(n, False): s for n, s, *_ in world["reads"]}
    assert _check_as(world, out, seqs, MapConfig(k=17, mapping_score=True)) >= 40


@pytest.mark.parametrize("chunk", ["0", "16"])
def test_pe_as_tags_match_oracle(world, tmp_path, chunk, monkeypatch):  # noqa: F811
    out = str(tmp_path / f"pe_{chunk}.sam")
    assert run(["quasimap", "-i", world["idxdir"], "-1", world["fq1"], "-2", world["fq2"],
                "-o", out, "--mappingScore", "--batchSize", "16", "--chunkSize", chunk],
               monkeypatch) == 0
    seqs = {}
    for n, a, b in world["pairs"]:
        seqs[(n, False)] = a
        seqs[(n, True)] = b
    assert _check_as(world, out, seqs, MapConfig(k=17, mapping_score=True)) >= 30


def test_min_score_fraction_filters(world, tmp_path, monkeypatch):  # noqa: F811
    """A read that anchors (an exact 17-mer) but is mostly junk maps without
    the filter and is unmapped under 0.85; the clean read survives; the
    counters follow (reads_mapped, score_filtered)."""
    rng = np.random.default_rng(5)
    idx = world["idx"]
    text = np.asarray(idx.text)
    off = np.asarray(idx.txp_offsets)
    tl = np.asarray(idx.txp_lens)
    t0_seq = "".join(np.array(list("_ACGT"))[text[off[0] : off[0] + tl[0]]])
    clean = t0_seq[10:70]
    junk = t0_seq[20:37] + "".join("ACGT"[int(rng.integers(0, 4))] for _ in range(43))
    fq = str(tmp_path / "mix.fq")
    with open(fq, "w") as f:
        f.write(f"@clean\n{clean}\n+\n{'I' * 60}\n@junk\n{junk}\n+\n{'I' * 60}\n")

    def go(frac):
        out, stats = str(tmp_path / f"f{frac}.sam"), str(tmp_path / f"f{frac}.json")
        assert run(["quasimap", "-i", world["idxdir"], "-r", fq, "-o", out, "--mappingScore",
                    "--minScoreFraction", frac, "--batchSize", "8", "--statsJson", stats],
                   monkeypatch) == 0
        with open(stats) as f:
            return {r["name"]: r for r in _parse_sam(out)}, json.load(f)

    by0, st0 = go("0.0")
    assert not by0["clean"]["flag"] & 0x4 and not by0["junk"]["flag"] & 0x4
    by1, st1 = go("0.85")
    assert not by1["clean"]["flag"] & 0x4
    assert by1["junk"]["flag"] & 0x4, "junk read must be score-filtered"
    assert st1["reads_mapped"] == st0["reads_mapped"] - 1
    assert st1.get("score_filtered", 0) >= 1 and "score_filtered" not in st0


def test_primary_promotion_after_suppression():
    """Suppressing a read's first record promotes the next survivor to
    primary (no 0x100, MAPQ 1), with its AS:i tag."""
    cfg = MapConfig(k=31, mapping_score=True, min_score_fraction=0.9, align_ma=2)
    recs = np.array([[0, 5, 0, 84], [1, 9, 1, 120]], dtype=np.int32)  # threshold 108
    wr = WireResult(recs=recs, counts=np.array([2], np.int32),
                    flags=np.array([FLAG_MAPPED], np.int32), total=2, overflowed=False,
                    counters={"reads_mapped": 1, "records": 2})
    out = filter_se(wr, np.array([60], np.int32), cfg)
    assert out.total == 1 and int(out.counts[0]) == 1
    assert int(out.flags[0]) & FLAG_MAPPED
    assert out.counters["score_filtered"] == 1 and out.counters["records"] == 1
    buf = io.StringIO()
    n = write_se_records_dense(buf, ["r0"], [b"A" * 60], [b"I" * 60], np.asarray(out.recs),
                               np.asarray(out.counts), ["t0", "t1"], with_score=True)
    assert n == 1
    fields = buf.getvalue().strip().split("\t")
    assert not int(fields[1]) & 0x100 and int(fields[4]) == 1 and fields[2] == "t1"
    assert "AS:i:120" in buf.getvalue()


def test_min_score_fraction_needs_mapping_score():
    args = cli.build_parser().parse_args(
        ["quasimap", "-i", "x", "-r", "y", "-o", "z", "--minScoreFraction", "0.5"])
    with pytest.raises(SystemExit):
        cli._cfg_from_args(args, k=31)
