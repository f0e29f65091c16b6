"""rapmap_tpu_torch end to end against rapmap_tpu on the CPU, integer for
integer (tolerance zero): QuasiMapper.map_se_async / fetch gives the
reference's chunked SE wire buffer and WireResult with the bitonic voting sort
on and off; the unchunked wire buffer equals `map_batch_se_wire`'s and
`map_se` the reference's MapOut and counters, on the read sets of
tests/test_device_parity.py and two of its fuzz seeds (its config sweep is in
tests/test_torch_quasi_sweep.py), every batch padded past n_valid."""

import numpy as np
import pytest

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models.quasi import QuasiMapper
from tests.test_device_parity import batch_of
from tests.util import BASES, random_transcriptome, sample_reads, toy_index, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

B, L, CHUNK = 64, 72, 32  # one padded shape for every set: one compile per config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Random transcripts (half sharing a 40 bp prefix) plus three that
    share one 80 bp segment, so some reads multimap."""
    rng = np.random.default_rng(21)
    txps = random_transcriptome(rng, n_txps=8, min_len=150, max_len=300, shared_prefix=40)
    base = random_transcriptome(rng, n_txps=3, min_len=150, max_len=200)
    shared = base[0][1][30:110]
    txps += [(f"m{i}", s[:40] + shared + s[40:]) for i, (_, s) in enumerate(base)]
    idx = ref_build(write_fasta(str(tmp_path_factory.mktemp("q") / "t.fa"), txps), k=11)

    sets = {}
    sets["exact"] = [r[1] for r in sample_reads(rng, txps, 40, read_len=48, rc_frac=0.5)]
    messy = [r[1] for r in sample_reads(rng, txps, 44, read_len=52, error_rate=0.05,
                                        n_frac=0.02)]
    messy += [BASES[rng.integers(0, 4, 52)].tobytes() for _ in range(8)]
    sets["messy"] = messy + [b"N" * 52, txps[0][1][:52]]
    mixed = []
    for rl in (30, 41, 52, 64, 72):
        mixed += [r[1] for r in sample_reads(rng, txps, 12, read_len=rl, rc_frac=0.6,
                                             error_rate=0.03)]
    sets["mixed_lengths"] = mixed
    sets["multimapping"] = [shared[5:55], shared[10:60], txps[-1][1][:50], shared[:72]]
    chim = txps[0][1][10:35] + txps[1][1][50:75]
    sets["sweep"] = sets["messy"][:40] + sets["multimapping"] + [chim]
    return idx, sets


@pytest.mark.parametrize("bitonic", [False, True])
@pytest.mark.parametrize("read_set", ["exact", "messy", "mixed_lengths", "multimapping"])
def test_wire_parity(world, read_set, bitonic):
    idx, sets = world
    seqs = sets[read_set]
    codes, lens = batch_of(seqs + [b""] * (B - len(seqs)), L)
    kw = dict(k=idx.k, chunk=CHUNK, bitonic_sort=bitonic)
    ref = RefMapper(idx, RefConfig(**kw))
    rh = ref.map_se_async(codes, lens, n_valid=len(seqs))
    want_wire = np.asarray(rh[2])
    port = QuasiMapper(index_from_reference(vars(idx)), MapConfig(**kw), device="cpu")
    res = port.map_se_async(codes, lens, n_valid=len(seqs))
    got_wire = res.wire.numpy()
    assert got_wire.dtype == np.int32
    assert np.array_equal(got_wire, want_wire)
    want, got = ref.fetch(rh), port.fetch(res)
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    assert want.counters["reads_total"] == len(seqs)
    assert want.counters["reads_mapped"] > 0


def assert_unchunked_parity(idx, seqs, kw, pad_to=B, pad_len=L):
    """`map_se` (MapOut and counters) and the unchunked wire buffer with its
    WireResult, port against reference, on one batch padded to `pad_to` rows
    with n_valid = len(seqs)."""
    codes, lens = batch_of(seqs + [b""] * (pad_to - len(seqs)), pad_len)
    n = len(seqs)
    ref = RefMapper(idx, RefConfig(k=idx.k, **kw))
    port = QuasiMapper(index_from_reference(vars(idx)), MapConfig(k=idx.k, **kw), device="cpu")
    assert port.cfg == MapConfig(**vars(ref.cfg))

    want_out, want_ctr = ref.map_se(codes, lens, n_valid=n)
    got_out, got_ctr = port.map_se(codes, lens, n_valid=n)
    for f in want_out._fields:
        w, g = getattr(want_out, f), getattr(got_out, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    for f in want_ctr._fields:
        assert int(getattr(got_ctr, f)) == int(getattr(want_ctr, f)), f
    assert int(want_ctr.reads_total) == n

    rh = ref.map_se_async(codes, lens, n_valid=n)
    res = port.map_se_async(codes, lens, n_valid=n)
    assert rh[3] == 0 and res.C == 0, "expected the unchunked program"
    got_wire = res.wire.numpy()
    assert got_wire.dtype == np.int32
    assert np.array_equal(got_wire, np.asarray(rh[2]))
    want, got = ref.fetch(rh), port.fetch(res)
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    return want_out, want


@pytest.mark.parametrize("read_set", ["exact", "messy", "mixed_lengths", "multimapping"])
def test_unchunked_parity(world, read_set):
    idx, sets = world
    # a chunk that does not divide the batch leaves it one program
    kw = dict(chunk=48) if read_set == "mixed_lengths" else {}
    out, res = assert_unchunked_parity(idx, sets[read_set], kw)
    assert out.mapped.any() and res.total > 0


@pytest.mark.parametrize("seed", [101, 202])
def test_unchunked_parity_fuzz(tmp_path, seed):
    """The draws of tests/test_device_parity.py::test_se_parity_fuzz."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(7, 16))
    idx, txps = toy_index(
        tmp_path, rng,
        n_txps=int(rng.integers(3, 9)),
        min_len=int(rng.integers(80, 150)),
        max_len=int(rng.integers(200, 500)),
        k=k,
        shared_prefix=int(rng.integers(0, 50)),
    )
    seqs = []
    for _ in range(int(rng.integers(12, 30))):
        rl = int(rng.integers(k + 1, 90))
        (rd,) = sample_reads(
            rng, txps, 1, read_len=rl,
            error_rate=float(rng.uniform(0, 0.08)),
            n_frac=float(rng.uniform(0, 0.04)),
        )
        seqs.append(rd[1])
    kw = {}
    if rng.random() < 0.4:
        kw["consistent_hits"] = True
        kw["fuzzy"] = rng.random() < 0.5
    if rng.random() < 0.3:
        kw["strict_check"] = True
    if rng.random() < 0.3:
        kw["quasi_coverage"] = float(rng.uniform(0.1, 0.6))
    if rng.random() < 0.3:
        kw["max_interval"] = int(rng.integers(4, 64))
    pad_len = max(len(s) for s in seqs)
    kw["max_hits_per_strand"] = max(1, pad_len - k + 1)
    assert_unchunked_parity(idx, seqs, kw, pad_to=32, pad_len=pad_len)


def test_unchunked_results_stay_valid_across_batches(world):
    """An unchunked WireResult's records are a view of its own wire buffer:
    dispatching and fetching later batches (of other shapes) changes no
    result fetched before."""
    idx, sets = world
    port = QuasiMapper(index_from_reference(vars(idx)), MapConfig(k=idx.k), device="cpu")
    batches = [batch_of(sets["exact"], 48), batch_of(sets["messy"] + [b""] * 10, L),
               batch_of(sets["exact"][::-1], 48)]
    pending = [port.map_se_async(c, ln, n_valid=min(len(ln), 54)) for c, ln in batches]
    results = [port.fetch(p) for p in pending]
    assert all(p.C == 0 for p in pending)
    assert np.shares_memory(results[0].recs, pending[0].wire.numpy())
    kept = [(r.recs.copy(), r.counts.copy(), r.flags.copy()) for r in results]
    for c, ln in batches:  # more traffic through the same mapper
        port.fetch(port.map_se_async(c, ln))
    for r, (recs, counts, flags) in zip(results, kept):
        assert np.array_equal(r.recs, recs) and np.array_equal(r.counts, counts)
        assert np.array_equal(r.flags, flags)
    assert not np.shares_memory(results[0].recs, results[2].recs)
    assert results[0].total == results[2].total > 0
