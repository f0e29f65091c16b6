"""rapmap_tpu_torch's host I/O against rapmap_tpu's on the same seeded
inputs: `batched_reads` (native parser and TQM_NO_NATIVE_PARSE=1), `prefetch`,
the SAM header and single-end writers (Python loops and the native formatter)
and the numpy oracle's `map_read`. Bytes and integers: exact equality."""

import gzip
import io

import numpy as np
import pytest

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.io import fastx as rfastx
from rapmap_tpu.io import sam as rsam
from rapmap_tpu.ops.collate import MapOut as RefMapOut
from rapmap_tpu.oracle import quasimap as roracle
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.io import fastx, sam
from rapmap_tpu_torch.native import bindings
from rapmap_tpu_torch.ops.collate import MapOut
from rapmap_tpu_torch.oracle import quasimap as oracle
from tests.test_device_parity import codes_of
from tests.util import BASES, sample_reads, toy_index


@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    """37 FASTQ records with Ns and lower case (the first 16 of 18..47 bases,
    the rest up to 96, one of 140: longer than the max_len the tests pass),
    split over a plain and a gzipped file; and a FASTA file."""
    rng = np.random.default_rng(5)
    tmp = tmp_path_factory.mktemp("io")
    alphabet = np.frombuffer(b"ACGTNacgt", dtype=np.uint8)
    recs = []
    for i in range(37):
        n = 140 if i == 20 else int(rng.integers(18, 48 if i < 16 else 97))
        seq = alphabet[rng.choice(9, n, p=[.23, .23, .23, .23, .02, .015, .015, .015, .015])]
        qual = rng.integers(33, 74, n).astype(np.uint8)
        recs.append((f"read{i}", seq.tobytes(), qual.tobytes()))

    def text(rs):
        return b"".join(b"@%s extra words\n%s\n+\n%s\n" % (n.encode(), s, q) for n, s, q in rs)

    a, b = str(tmp / "a.fq"), str(tmp / "b.fq.gz")
    with open(a, "wb") as f:
        f.write(text(recs[:15]))
    with gzip.open(b, "wb") as f:
        f.write(text(recs[15:]))
    fa = str(tmp / "r.fa")
    with open(fa, "wb") as f:
        for n, s, _ in recs[:9]:
            f.write(b">%s\n%s\n%s\n" % (n.encode(), s[:10], s[10:]))
    return a, b, fa


def same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.codes.dtype == w.codes.dtype and np.array_equal(g.codes, w.codes)
        assert g.lens.dtype == w.lens.dtype and np.array_equal(g.lens, w.lens)
        assert (g.names, g.seqs, g.quals, g.n) == (w.names, w.seqs, w.quals, w.n)


@pytest.mark.parametrize("parser", ["native", "python"])
@pytest.mark.parametrize("source", ["one_file", "two_files_one_gz", "fasta"])
def test_batched_reads(read_files, monkeypatch, parser, source):
    a, b, fa = read_files
    if parser == "python":
        monkeypatch.setenv("TQM_NO_NATIVE_PARSE", "1")
    else:
        assert bindings.available(), "the port's native library did not build"
    path = {"one_file": a, "two_files_one_gz": f"{a},{b}", "fasta": fa}[source]
    assert fastx._use_native(path) == (parser == "native" and source != "fasta")
    same_batches(fastx.batched_reads(path, 8, 96), rfastx.batched_reads(path, 8, 96))
    if source == "two_files_one_gz":
        batches = list(fastx.batched_reads(path, 8, 96))
        assert [x.n for x in batches] == [8, 8, 8, 8, 5]
        assert batches[-1].codes.shape[0] == 8 and (batches[-1].lens[5:] == 0).all()
        assert len({x.codes.shape[1] for x in batches}) > 1  # the length bucket moves
        assert max(len(s) for x in batches for s in x.seqs) == 96  # the 140 bp read is cut


def test_prefetch_and_buckets(read_files):
    a, b, _ = read_files
    path = f"{a},{b}"
    same_batches(fastx.prefetch(fastx.batched_reads(path, 8, 96), depth=2),
                 rfastx.batched_reads(path, 8, 96))
    for max_len in (40, 512, 2000):
        assert [fastx.bucket_len(n, max_len) for n in range(1, 1100)] == [
            rfastx.bucket_len(n, max_len) for n in range(1, 1100)]

    def broken():
        yield 1
        raise ValueError("parser failed")

    it = fastx.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(ValueError, match="parser failed"):
        next(it)


def _sam_inputs(rng, B=40, n_txps=7):
    names = [f"q{i}" for i in range(B)]
    seqs = [BASES[rng.integers(0, 4, int(n))].tobytes() for n in rng.integers(20, 60, B)]
    seqs[3] = b"ACGTNNacgtn" * 3
    quals = [rng.integers(33, 74, len(s)).astype(np.uint8).tobytes() for s in seqs]
    counts = rng.integers(0, 4, B).astype(np.int32)
    counts[rng.random(B) < 0.3] = 0
    total = int(counts.sum())
    recs = np.stack([
        rng.integers(0, n_txps, total), rng.integers(-30, 5000, total),
        rng.integers(0, 2, total), rng.integers(1, 9, total),
    ], axis=1).astype(np.int32)
    return names, seqs, quals, recs, counts, [f"txp{i}|x" for i in range(n_txps)]


@pytest.mark.parametrize("write_unmapped", [True, False])
@pytest.mark.parametrize("writer", ["python", "native"])
def test_write_se_records_dense(writer, write_unmapped):
    rng = np.random.default_rng(8)
    names, seqs, quals, recs, counts, txp_names = _sam_inputs(rng)
    fmt = rfmt = None
    if writer == "native":
        fmt, rfmt = sam.get_native_formatter(txp_names), rsam.get_native_formatter(txp_names)
        assert fmt is not None and type(fmt).__module__ == "rapmap_tpu_torch.native.bindings"
    got, want = io.StringIO(), io.StringIO()
    # recs carries a spare tail, as the wire's record buffer does
    padded = np.concatenate([recs, np.zeros((5, 4), np.int32)])
    n_got = sam.write_se_records_dense(got, names, seqs, quals, padded, counts, txp_names,
                                       write_unmapped, formatter=fmt)
    n_want = rsam.write_se_records_dense(want, names, seqs, quals, padded, counts, txp_names,
                                         write_unmapped, formatter=rfmt)
    assert got.getvalue() == want.getvalue() and n_got == n_want == int(counts.sum())
    lines = got.getvalue().splitlines()
    assert len(lines) == int(counts.sum()) + (int((counts == 0).sum()) if write_unmapped else 0)
    if writer == "native":  # and the native formatter writes what the Python loop writes
        plain = io.StringIO()
        sam.write_se_records_dense(plain, names, seqs, quals, padded, counts, txp_names,
                                   write_unmapped)
        assert plain.getvalue() == got.getvalue()


def test_header_slotted_writer_and_revcomp():
    rng = np.random.default_rng(9)
    names, seqs, quals, recs, counts, txp_names = _sam_inputs(rng)
    lens = rng.integers(100, 9000, len(txp_names)).astype(np.int32)
    assert sam.sam_header(txp_names, lens, "1.2", "tqm x -y") == rsam.sam_header(
        txp_names, lens, "1.2", "tqm x -y")
    assert sam.revcomp_seq(seqs[3]) == rsam.revcomp_seq(seqs[3]) == b"nacgtNNACGT" * 3
    MO = 3
    t = np.full((len(names), MO), -1, np.int32)
    pos, strand, score = (np.zeros_like(t) for _ in range(3))
    off = 0
    for i, c in enumerate(counts):
        t[i, :c], pos[i, :c], strand[i, :c], score[i, :c] = recs[off : off + c].T
        off += c
    flags = (counts, counts > 0, counts < 0, counts < 0, counts < 0)
    got, want = io.StringIO(), io.StringIO()
    n_got = sam.write_se_records(got, names, seqs, quals,
                                 MapOut(t, pos, strand, score, *flags), txp_names)
    n_want = rsam.write_se_records(want, names, seqs, quals,
                                   RefMapOut(t, pos, strand, score, *flags), txp_names)
    assert got.getvalue() == want.getvalue() and n_got == n_want == int(counts.sum())
    dense = io.StringIO()
    sam.write_se_records_dense(dense, names, seqs, quals, recs, counts, txp_names)
    assert dense.getvalue() == got.getvalue()


@pytest.fixture(scope="module")
def oracle_world(tmp_path_factory):
    rng = np.random.default_rng(19)
    idx, txps = toy_index(tmp_path_factory.mktemp("orc"), rng, n_txps=7, min_len=120,
                          max_len=300, k=11, shared_prefix=45)
    seqs = [r[1] for r in sample_reads(rng, txps, 30, read_len=50, error_rate=0.04,
                                       n_frac=0.02)]
    seqs += [txps[0][1][10:35] + txps[1][1][50:75], txps[0][1][:45], b"N" * 30, b"ACGTACG",
             BASES[rng.integers(0, 4, 50)].tobytes()]
    return idx, index_from_reference(vars(idx)), seqs


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(consistent_hits=True, fuzzy=True), dict(strict_check=True),
     dict(quasi_coverage=0.5), dict(max_num_hits=1), dict(max_interval=1)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default",
)
def test_oracle_map_read(oracle_world, kw):
    ref_idx, idx, seqs = oracle_world
    n_mapped = 0
    for s in seqs:
        codes, n = codes_of(s, len(s))
        want = roracle.map_read(ref_idx, codes[:n], RefConfig(k=ref_idx.k, **kw))
        got = oracle.map_read(idx, codes[:n], MapConfig(k=idx.k, **kw))
        assert [(m.txp, m.pos, m.fwd, m.score) for m in got] == [
            (m.txp, m.pos, m.fwd, m.score) for m in want]
        n_mapped += bool(want)
        hw = roracle.scan_strand(ref_idx, codes[:n], RefConfig(k=ref_idx.k, **kw))
        hg = oracle.scan_strand(idx, codes[:n], MapConfig(k=idx.k, **kw))
        assert [(h.q, h.length, h.b, h.e) for h in hg] == [(h.q, h.length, h.b, h.e) for h in hw]
    assert n_mapped > 10
