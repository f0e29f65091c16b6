"""rapmap_tpu_torch's paired-end host I/O against rapmap_tpu's on the same
seeded inputs: `batched_read_pairs` (native parser and
TQM_NO_NATIVE_PARSE=1, and what each does with mate files of unequal record
counts), and the paired-end SAM writers, dense (`write_pe_records_dense`,
Python loop and native formatter) and slotted (`write_pe_records`), with and
without unmapped records. The twin of
tests/test_native_sam.py::test_pe_byte_parity without the score fields.
Bytes and integers: exact equality."""

import gzip
import io

import numpy as np
import pytest

from rapmap_tpu.io import fastx as rfastx
from rapmap_tpu.io import sam as rsam
from rapmap_tpu.ops.pairs import PairOut as RefPairOut
from rapmap_tpu_torch.io import fastx, sam
from rapmap_tpu_torch.native import bindings
from rapmap_tpu_torch.ops.pairs import PairOut
from tests.test_torch_io import same_batches
from tests.util import BASES
from tests.test_torch_pe import jax_cache_off  # noqa: F401


def _records(rng, n, tag):
    alphabet = np.frombuffer(b"ACGTNacgt", dtype=np.uint8)
    recs = []
    for i in range(n):
        m = 130 if i == 11 else int(rng.integers(18, 97))
        seq = alphabet[rng.choice(9, m, p=[.23, .23, .23, .23, .02, .015, .015, .015, .015])]
        recs.append((f"p{i}/{tag}", seq.tobytes(), rng.integers(33, 74, m).astype(np.uint8).tobytes()))
    return recs


def _write(path, recs):
    text = b"".join(b"@%s x\n%s\n+\n%s\n" % (n.encode(), s, q) for n, s, q in recs)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def mate_files(tmp_path_factory):
    """29 pairs (mates of 18-96 bases with Ns and lower case, one of 130:
    longer than the max_len the tests pass), each mate's records split over
    a plain and a gzipped file; and a mate-2 file one record short and one a
    record long."""
    rng = np.random.default_rng(23)
    tmp = tmp_path_factory.mktemp("peio")
    m1, m2 = _records(rng, 29, 1), _records(rng, 30, 2)
    files = {}
    for mate, recs in ((1, m1), (2, m2[:29])):
        a = _write(str(tmp / f"a_{mate}.fq"), recs[:10])
        b = _write(str(tmp / f"b_{mate}.fq.gz"), recs[10:])
        files[mate] = f"{a},{b}"
    files["short"] = _write(str(tmp / "short_2.fq"), m2[:28])
    files["long"] = _write(str(tmp / "long_2.fq"), m2)
    files["one"] = _write(str(tmp / "one_1.fq"), m1)
    return files


def _pair_batches(mod, p1, p2):
    out = []
    for b1, b2 in mod.batched_read_pairs(p1, p2, 8, 96):
        out += [b1, b2]
    return out


@pytest.mark.parametrize("parser", ["native", "python"])
def test_batched_read_pairs(mate_files, monkeypatch, parser):
    if parser == "python":
        monkeypatch.setenv("TQM_NO_NATIVE_PARSE", "1")
    else:
        assert bindings.available(), "the port's native library did not build"
    p1, p2 = mate_files[1], mate_files[2]
    assert fastx._use_native(p1) == (parser == "native")
    got = _pair_batches(fastx, p1, p2)
    same_batches(got, _pair_batches(rfastx, p1, p2))
    assert [b.n for b in got] == [8, 8, 8, 8, 8, 8, 5, 5]
    for b1, b2 in zip(got[::2], got[1::2]):  # both mates share one length bucket
        assert b1.codes.shape == b2.codes.shape
        assert b1.names == [n.replace("/2", "/1") for n in b2.names]


@pytest.mark.parametrize("parser", ["native", "python"])
@pytest.mark.parametrize("mate2", ["short", "long"])
def test_batched_read_pairs_unequal_counts(mate_files, monkeypatch, parser, mate2):
    """Mate files of unequal record counts: the port raises where the
    reference raises, with its message, and otherwise yields its batches."""
    if parser == "python":
        monkeypatch.setenv("TQM_NO_NATIVE_PARSE", "1")

    def run(mod):
        try:
            return _pair_batches(mod, mate_files["one"], mate_files[mate2]), None
        except ValueError as exc:
            return None, str(exc)

    (got, got_err), (want, want_err) = run(fastx), run(rfastx)
    assert got_err == want_err
    if want_err is None:
        same_batches(got, want)
    if mate2 == "short" or parser == "native":
        assert want_err == "paired FASTQ files have unequal record counts"


def _pe_inputs(rng, B=48, n_txps=9):
    names = [f"q{i}" for i in range(B)]

    def reads():
        seqs = [BASES[rng.integers(0, 4, int(n))].tobytes() for n in rng.integers(20, 70, B)]
        seqs[3] = b"ACGTNNacgtn" * 3
        return seqs, [rng.integers(33, 74, len(s)).astype(np.uint8).tobytes() for s in seqs]

    seqs1, quals1 = reads()
    seqs2, quals2 = reads()
    counts = rng.integers(0, 4, B).astype(np.int32)
    counts[rng.random(B) < 0.3] = 0
    total = int(counts.sum())
    h1 = rng.integers(0, 2, total)
    h2 = np.where(h1 == 0, 1, rng.integers(0, 2, total))  # at least one mate
    recs = np.stack([
        rng.integers(0, n_txps, total), np.where(h1, rng.integers(-5, 3000, total), 0),
        rng.integers(0, 2, total), h1, np.where(h2, rng.integers(-5, 3000, total), 0),
        rng.integers(0, 2, total), h2,
    ], axis=1).astype(np.int32)
    txp_names = [f"t{i}.iso{i % 3}" for i in range(n_txps)]
    return names, seqs1, quals1, seqs2, quals2, recs, counts, txp_names


@pytest.mark.parametrize("write_unmapped", [True, False])
@pytest.mark.parametrize("writer", ["python", "native"])
def test_write_pe_records_dense(writer, write_unmapped):
    rng = np.random.default_rng(13)
    names, s1, q1, s2, q2, recs, counts, txp_names = _pe_inputs(rng)
    fmt = rfmt = None
    if writer == "native":
        fmt, rfmt = sam.get_native_formatter(txp_names), rsam.get_native_formatter(txp_names)
        assert fmt is not None and type(fmt).__module__ == "rapmap_tpu_torch.native.bindings"
    # recs carries a spare tail, as the wire's record buffer does
    padded = np.concatenate([recs, np.zeros((5, 7), np.int32)])
    got, want = io.StringIO(), io.StringIO()
    n_got = sam.write_pe_records_dense(got, names, s1, q1, s2, q2, padded, counts, txp_names,
                                       write_unmapped, formatter=fmt)
    n_want = rsam.write_pe_records_dense(want, names, s1, q1, s2, q2, padded, counts,
                                         txp_names, write_unmapped, formatter=rfmt)
    assert got.getvalue() == want.getvalue() and n_got == n_want > int(counts.sum())
    unmapped = got.getvalue().count("\t77\t*\t")
    assert unmapped == (int((counts == 0).sum()) if write_unmapped else 0)
    if writer == "native":  # and the native formatter writes what the Python loop writes
        plain = io.StringIO()
        sam.write_pe_records_dense(plain, names, s1, q1, s2, q2, padded, counts, txp_names,
                                   write_unmapped)
        assert plain.getvalue() == got.getvalue()


@pytest.mark.parametrize("write_unmapped", [True, False])
def test_write_pe_records_slotted(write_unmapped):
    """The slotted writer on the PairOut of the same records: the
    reference's text, and the dense writer's."""
    rng = np.random.default_rng(14)
    names, s1, q1, s2, q2, recs, counts, txp_names = _pe_inputs(rng)
    B, MO = len(names), 4
    cols = [np.zeros((B, MO), np.int32) for _ in range(7)]
    cols[0][:] = -1
    off = 0
    for i, c in enumerate(counts):
        for f in range(7):
            cols[f][i, :c] = recs[off : off + c, f]
        off += c
    t, p1, st1, h1, p2, st2, h2 = cols
    per_read = (counts > 0, counts, counts < 0, counts > 0, counts < 0)
    fields = (t, p1, st1, h1.astype(bool), p2, st2, h2.astype(bool))
    got, want, dense = io.StringIO(), io.StringIO(), io.StringIO()
    n_got = sam.write_pe_records(got, names, s1, q1, s2, q2, PairOut(*fields, *per_read),
                                 txp_names, write_unmapped)
    n_want = rsam.write_pe_records(want, names, s1, q1, s2, q2,
                                   RefPairOut(*fields, *per_read), txp_names, write_unmapped)
    assert got.getvalue() == want.getvalue() and n_got == n_want
    sam.write_pe_records_dense(dense, names, s1, q1, s2, q2, recs, counts, txp_names,
                               write_unmapped)
    assert dense.getvalue() == got.getvalue()
