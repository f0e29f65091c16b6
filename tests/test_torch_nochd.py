"""rapmap_tpu_torch end to end on indexes without the canonical CHD, against
rapmap_tpu on the CPU, integer for integer (tolerance zero): the SE and PE
wire buffers, chunked and unchunked, with their WireResults, `map_se`'s
MapOut and `map_pe`'s PairOut, on an index built with with_chd=False (the
binary-search probe and the full upload; twins of
tests/test_device_parity.py::test_se_parity_exact_reads and ::test_pe_parity),
and a big-SA index against the int32 engine (tests/test_bigsa.py)."""

import numpy as np
import pytest

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models.quasi import QuasiMapper
from tests.test_device_parity import batch_of, parity_cfg
from tests.util import BASES, random_transcriptome, sample_reads, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

B, L, CHUNK = 32, 48, 16
COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Six transcripts of 250-400 bp, k = 11, indexed with with_chd=False;
    single-end reads of test_se_parity_exact_reads and the pairs of
    test_pe_parity (an orphan and an unmapped pair among them)."""
    rng = np.random.default_rng(5)
    txps = random_transcriptome(rng, n_txps=6, min_len=250, max_len=400)
    fa = write_fasta(str(tmp_path_factory.mktemp("nochd") / "t.fa"), txps)
    idx = ref_build(fa, k=11, with_chd=False)
    assert idx.chd_dir is None and "chd" not in idx.meta
    se = [r[1] for r in sample_reads(rng, txps, 28, read_len=L, rc_frac=0.5, error_rate=0.02)]
    se += [BASES[rng.integers(0, 4, L)].tobytes(), b"N" * L]
    pairs = []
    for _ in range(26):
        seq = txps[int(rng.integers(0, len(txps)))][1]
        p1 = int(rng.integers(0, len(seq) - 150))
        frag = int(rng.integers(90, 150))
        pairs.append((seq[p1 : p1 + L], seq[p1 + frag - L : p1 + frag].translate(COMP)[::-1]))
    pairs.append((txps[0][1][:L], BASES[rng.integers(0, 4, L)].tobytes()))
    pairs.append((BASES[rng.integers(0, 4, L)].tobytes(),) * 2)
    return idx, se, pairs


def _mappers(idx, **kw):
    ref = RefMapper(idx, RefConfig(k=idx.k, **kw))
    port = QuasiMapper(index_from_reference(vars(idx)), MapConfig(k=idx.k, **kw), device="cpu")
    assert port.didx.kmer_rows is not None and port.didx.chd_dir is None
    assert not port.st.use_chd and port.didx.text is not None
    return ref, port


def _assert_wire_equal(rh, res, ref, port, chunked):
    assert (rh[3] > 0) == chunked and (res.C > 0) == chunked
    assert np.array_equal(res.wire.numpy(), np.asarray(rh[2]))
    want, got = ref.fetch(rh), port.fetch(res)
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    return want


@pytest.mark.parametrize("chunked", [True, False])
def test_se_wire_parity_without_chd(world, chunked):
    idx, se, _ = world
    codes, lens = batch_of(se + [b""] * (B - len(se)), L)
    ref, port = _mappers(idx, chunk=CHUNK if chunked else 0, bitonic_sort=chunked)
    want = _assert_wire_equal(ref.map_se_async(codes, lens, n_valid=len(se)),
                              port.map_se_async(codes, lens, n_valid=len(se)), ref, port,
                              chunked)
    assert want.counters["reads_mapped"] >= len(se) - 4
    if not chunked:
        (wo, wc), (go, gc) = ref.map_se(codes, lens, len(se)), port.map_se(codes, lens, len(se))
        for f in wo._fields:
            assert np.array_equal(getattr(go, f), np.asarray(getattr(wo, f))), f
        for f in wc._fields:
            assert int(getattr(gc, f)) == int(getattr(wc, f)), f


@pytest.mark.parametrize("chunked", [True, False])
def test_pe_wire_parity_without_chd(world, chunked):
    idx, _, pairs = world
    pad = [(b"", b"")] * (B - len(pairs))
    c1, l1 = batch_of([p[0] for p in pairs + pad], L)
    c2, l2 = batch_of([p[1] for p in pairs + pad], L)
    n = len(pairs)
    ref, port = _mappers(idx, chunk=CHUNK if chunked else 0)
    want = _assert_wire_equal(ref.map_pe_async(c1, l1, c2, l2, n_valid=n),
                              port.map_pe_async(c1, l1, c2, l2, n_valid=n), ref, port, chunked)
    assert want.counters["reads_mapped"] >= n - 2
    if not chunked:
        w, g = ref.map_pe(c1, l1, c2, l2, n), port.map_pe(c1, l1, c2, l2, n)
        for a, b in zip(g[:3], w[:3]):
            for f in b._fields:
                assert np.array_equal(getattr(a, f), np.asarray(getattr(b, f))), f
        assert int(np.asarray(w[2].concordant).sum()) >= n - 3


def test_bigsa_matches_int32_engine(tmp_path):
    """Twin of tests/test_bigsa.py::test_bigsa_matches_int32_engine: the
    port on an int64 SA (lean upload, no flat sa/text) maps as it does on
    the int32 one, and as the reference's big-SA engine."""
    rng = np.random.default_rng(42)
    txps = random_transcriptome(rng, n_txps=5, min_len=150, max_len=250)
    fa = write_fasta(str(tmp_path / "t.fa"), txps)
    small = ref_build(fa, k=11)
    big = ref_build(fa, k=11, big_sa=True)
    assert np.asarray(big.sa).dtype == np.int64
    codes, lens = batch_of([r[1] for r in sample_reads(rng, txps, 40, read_len=50,
                                                       error_rate=0.02)], 50)
    cfg = parity_cfg(small, 50)
    port_cfg = MapConfig(**vars(cfg))
    o_small, c_small = QuasiMapper(index_from_reference(vars(small)), port_cfg,
                                   device="cpu").map_se(codes, lens)
    o_big, c_big = QuasiMapper(index_from_reference(vars(big)), port_cfg,
                               device="cpu").map_se(codes, lens)
    o_ref, c_ref = RefMapper(big, cfg).map_se(codes, lens)
    for f in o_small._fields:
        assert np.array_equal(getattr(o_small, f), getattr(o_big, f)), f
        assert np.array_equal(getattr(o_big, f), np.asarray(getattr(o_ref, f))), f
    assert c_small == c_big
    assert [int(x) for x in c_big] == [int(x) for x in c_ref]
    assert o_big.mapped.sum() >= 36
