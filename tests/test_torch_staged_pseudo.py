"""The port's host-staged pseudo engine and the staged geometry
(rapmap_tpu_torch.parallel.staged, on the CPU) against the reference's:
twins of tests/test_staged_pseudo.py and tests/test_staged_geometry.py on
their worlds — geometries equal field for field, empty shards' pad keys,
records equal to the reference's staged engine, to the port's replicated
PseudoMapper and to the numpy pseudo oracle — and the quasi engine's
anchor-budget rerun."""

import math

import numpy as np
import pytest

import rapmap_tpu.parallel.staged as rstg
import rapmap_tpu_torch.parallel.staged as stg
from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.builder import build_pseudo_index as ref_pbuild
from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import PseudoIndex, index_from_reference
from rapmap_tpu_torch.models.pseudo import PseudoMapper
from rapmap_tpu_torch.oracle import pseudomap as pm
from rapmap_tpu_torch.oracle import quasimap as qm
from rapmap_tpu_torch.parallel.staged import (
    StagedMapper, StagedPseudoEngine, StagedPseudoMapper,
)
from tests.test_device_parity import batch_of
from tests.test_torch_staged import _lists, _one_thread  # noqa: F401
from tests.util import BASES, random_transcriptome, sample_reads, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

L = 40


def _repetitive_pseudo(tmp_path, rng, n_txps=6):
    """tests/test_staged_pseudo.py's world: 6 transcripts of 150-260 bp
    sharing a 90 bp segment, k = 11 -> (reference index, port index, txps)."""
    base = random_transcriptome(rng, n_txps=n_txps, min_len=150, max_len=260)
    shared = base[0][1][30:120]
    txps = [(f"t{i}", s[:30] + shared + s[30:]) for i, (_, s) in enumerate(base)]
    ridx = ref_pbuild(write_fasta(str(tmp_path / "p.fa"), txps), k=11)
    return ridx, index_from_reference(vars(ridx), PseudoIndex), txps


def _oracle(idx, codes, lens, cfg):
    return [[(m.txp, m.pos, 0 if m.fwd else 1, m.score)
             for m in pm.map_read(idx, codes[i][: lens[i]], cfg)] for i in range(len(codes))]


def _replicated(idx, kw, codes, lens):
    m = PseudoMapper(idx, MapConfig(**{**kw, "expand_budget": 2048, "max_out": 256,
                                       "rec_slots": 64}), device="cpu")
    w = m.fetch(m.map_se_async(codes, lens))
    assert not w.overflowed
    return _lists(w)


def _both(ridx, idx, kw, codes, lens, n_shards, with_lens=False):
    """Both packages' staged pseudo engines on one batch -> port records."""
    ls = [lens] if with_lens else None
    want, wst = rstg.StagedPseudoEngine(ridx, RefConfig(**kw), n_shards=n_shards, read_len=L,
                                        batch=len(codes)).map_batches([codes], lens=ls)
    eng = StagedPseudoEngine(idx, MapConfig(**kw), n_shards=n_shards, read_len=L,
                             batch=len(codes), device="cpu")
    got, st = eng.map_batches([codes], lens=ls)
    assert got == want and st == wst
    assert eng.geo == rstg.staged_geometry_pseudo(ridx, n_shards)
    return got[0], st


def test_staged_pseudo_vs_oracle(tmp_path):
    rng = np.random.default_rng(51)
    ridx, idx, txps = _repetitive_pseudo(tmp_path, rng)
    reads = [r[1] for r in sample_reads(rng, txps, 40, read_len=L, error_rate=0.03,
                                        n_frac=0.02)]
    reads.append(BASES[rng.integers(0, 4, L)].tobytes())  # junk
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=8)
    got, stats = _both(ridx, idx, kw, codes, lens, 3)
    assert stats["anchor_overflow"] == 0
    assert got == _oracle(idx, codes, lens, MapConfig(**kw))
    assert got == _replicated(idx, kw, codes, lens)


@pytest.fixture(scope="module")
def sweep_world(tmp_path_factory):
    rng = np.random.default_rng(52)
    ridx, idx, txps = _repetitive_pseudo(tmp_path_factory.mktemp("psweep"), rng)
    reads = [r[1] for r in sample_reads(rng, txps, 28, read_len=L, error_rate=0.03)]
    reads.append(txps[0][1][10:30] + txps[1][1][60:80])  # a chimera
    return (ridx, idx, *batch_of(reads, L))


@pytest.mark.parametrize(
    "kw",
    [
        dict(consistent_hits=True),
        dict(consistent_hits=True, fuzzy=True),
        dict(quasi_coverage=0.5),
        dict(max_num_hits=2),
        dict(max_interval=4),
    ],
)
def test_staged_pseudo_config_sweep(sweep_world, kw):
    """-c/-f/-z/-m/maxInterval through the staged pseudo collate."""
    ridx, idx, codes, lens = sweep_world
    kw = dict(k=idx.k, max_hits_per_strand=L - idx.k + 1, **kw)
    got, _ = _both(ridx, idx, kw, codes, lens, 3)
    assert got == _oracle(idx, codes, lens, MapConfig(**kw))
    assert got == _replicated(idx, kw, codes, lens)


def test_staged_pseudo_variable_lens(tmp_path):
    rng = np.random.default_rng(53)
    ridx, idx, txps = _repetitive_pseudo(tmp_path, rng)
    Lv = 44
    seqs = []
    for r in sample_reads(rng, txps, 24, read_len=Lv, error_rate=0.02):
        seqs.append(r[1][: int(rng.integers(idx.k + 2, Lv + 1))])
    codes, lens = batch_of(seqs, Lv)
    kw = dict(k=idx.k, max_hits_per_strand=8)
    want = rstg.StagedPseudoEngine(ridx, RefConfig(**kw), n_shards=2, read_len=Lv,
                                   batch=len(seqs)).map_batches([codes], lens=[lens])[0][0]
    got = StagedPseudoEngine(idx, MapConfig(**kw), n_shards=2, read_len=Lv, batch=len(seqs),
                             device="cpu").map_batches([codes], lens=[lens])[0][0]
    assert got == want
    assert got == _oracle(idx, codes, lens, MapConfig(**kw))
    assert got == _replicated(idx, kw, codes, lens)


def test_staged_pseudo_pe_parity(tmp_path):
    rng = np.random.default_rng(54)
    ridx, idx, txps = _repetitive_pseudo(tmp_path, rng)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    p1s, p2s = [], []
    for _ in range(12):
        seq = txps[int(rng.integers(0, len(txps)))][1]
        if len(seq) < 150:
            continue
        a = int(rng.integers(0, len(seq) - 120))
        p1s.append(seq[a : a + L])
        p2s.append(seq[a + 100 - L : a + 100].translate(comp)[::-1])
    c1, l1 = batch_of(p1s, L)
    c2, l2 = batch_of(p2s, L)
    kw = dict(k=idx.k, max_hits_per_strand=8)
    item = [("pe", c1, l1, c2, l2)]
    want = rstg.StagedPseudoEngine(ridx, RefConfig(**kw), n_shards=3, read_len=L,
                                   batch=len(p1s)).map_group(item)[0]
    res = StagedPseudoEngine(idx, MapConfig(**kw), n_shards=3, read_len=L, batch=len(p1s),
                             device="cpu").map_group(item)[0]
    assert res["recs"] == want["recs"]
    for f in ("conc", "too_amb", "trunc"):
        assert np.array_equal(res[f], want[f]), f
    for i in range(len(p1s)):
        ms, conc = pm.map_pair(idx, c1[i][: l1[i]], c2[i][: l2[i]], MapConfig(**kw))
        assert bool(res["conc"][i]) == conc, i
        got = [(t, p1 if h1 else None, p2 if h2 else None)
               for t, p1, s1, h1, p2, s2, h2 in res["recs"][i]]
        assert got == [(m.txp, m.pos1, m.pos2) for m in ms], i
    rep = PseudoMapper(idx, MapConfig(**kw, expand_budget=2048, max_out=256, rec_slots=64),
                       device="cpu")
    assert res["recs"] == _lists(rep.fetch(rep.map_pe_async(c1, l1, c2, l2)))


def test_staged_pseudo_adapter_wire(tmp_path):
    """StagedPseudoMapper's async adapter: a padded partial batch, its
    WireResult equal to the reference adapter's and the replicated engine's."""
    rng = np.random.default_rng(55)
    ridx, idx, txps = _repetitive_pseudo(tmp_path, rng)
    reads = [r[1] for r in sample_reads(rng, txps, 10, read_len=L, error_rate=0.02)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=8)
    ad = StagedPseudoMapper(idx, MapConfig(**kw), batch=16, read_len=L, n_shards=2,
                            device="cpu")
    rad = rstg.StagedPseudoMapper(ridx, RefConfig(**kw), batch=16, read_len=L, n_shards=2)
    wr, rw = ad.fetch(ad.map_se_async(codes, lens)), rad.fetch(rad.map_se_async(codes, lens))
    for f in ("recs", "counts", "flags"):
        assert np.array_equal(getattr(wr, f), getattr(rw, f)), f
    assert wr.counters == rw.counters and wr.counters["reads_total"] == len(reads)
    rep = PseudoMapper(idx, MapConfig(**kw), device="cpu")
    w = rep.fetch(rep.map_se_async(codes, lens))
    assert np.array_equal(wr.recs, w.recs) and wr.counters == w.counters
    assert [r for lst in _oracle(idx, codes, lens, MapConfig(**kw)) for r in lst] == \
        [tuple(int(v) for v in row) for row in wr.recs]


def test_staged_quasi_budget_rerun_exact(tmp_path):
    """A too-small anchor budget escalates to the full-width stage-A rerun
    (counted in stats), with results equal to the reference's (which reruns
    too) and the oracle's: the budgeted pass never drops an anchor."""
    rng = np.random.default_rng(57)
    base = random_transcriptome(rng, n_txps=6, min_len=150, max_len=260)
    shared = base[0][1][30:120]
    txps = [(f"t{i}", s[:30] + shared + s[30:]) for i, (_, s) in enumerate(base)]
    ridx = ref_build(write_fasta(str(tmp_path / "g.fa"), txps), k=11)
    idx = index_from_reference(vars(ridx))
    reads = [r[1] for r in sample_reads(rng, txps, 24, read_len=L, error_rate=0.02)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=16)
    sm = StagedMapper(idx, MapConfig(**kw), n_shards=3, read_len=L, batch=len(reads),
                      anchor_budget=8, device="cpu")
    got, stats = sm.map_batches([codes])
    want, wst = rstg.StagedMapper(ridx, RefConfig(**kw), n_shards=3, read_len=L,
                                  batch=len(reads), anchor_budget=8).map_batches([codes])
    assert stats["anchor_overflow"] > 0 and stats == wst
    assert got == want
    assert got[0] == [[(m.txp, m.pos, 0 if m.fwd else 1, m.score)
                       for m in qm.map_read(idx, codes[i][: lens[i]], MapConfig(**kw))]
                      for i in range(len(reads))]


def test_staged_pseudo_strict_matches_replicated(tmp_path):
    """-s has no pseudo-oracle pin; the staged and replicated engines agree."""
    rng = np.random.default_rng(56)
    ridx, idx, txps = _repetitive_pseudo(tmp_path, rng)
    reads = [r[1] for r in sample_reads(rng, txps, 24, read_len=L, error_rate=0.03)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=8, strict_check=True, expand_budget=2048,
              max_out=256)
    out, _ = PseudoMapper(idx, MapConfig(**kw), device="cpu").map_se(codes, lens)
    got, _ = _both(ridx, idx, kw, codes, lens, 3)
    for i in range(len(reads)):
        rep = [(int(out.t[i, j]), int(out.pos[i, j]), int(out.strand[i, j]),
                int(out.score[i, j])) for j in range(out.t.shape[1]) if out.t[i, j] != -1]
        assert got[i] == rep, f"read {i}"


# ---- geometry (tests/test_staged_geometry.py) ----------------------------------

class _FakeCsr:
    """A key-sorted k-mer table and CSR offsets with controlled occurrence
    skew: each row in its own prefix bucket (p = 4 for K = 64)."""

    def __init__(self, k: int, prefixes: np.ndarray, occ_counts: np.ndarray):
        self.k = k
        self.kmer_hi = np.zeros(len(prefixes), np.uint32)
        self.kmer_lo = ((prefixes.astype(np.uint64) << np.uint64(24))
                        | np.arange(len(prefixes), dtype=np.uint64)).astype(np.uint32)
        self.kmer_off = np.concatenate([[0], np.cumsum(occ_counts.astype(np.int64))])


def test_pseudo_geometry_occ_skew_rebalance(monkeypatch):
    """Row-balanced cuts put 480 of 528 occurrences in shard 0; with the int32
    limit lowered to 200 the cuts are redone by occurrence count, as the
    reference redoes them."""
    K = 64
    idx = _FakeCsr(16, np.arange(K) * 4, np.where(np.arange(K) < 16, 30, 1))
    geo0 = stg.staged_geometry_pseudo(idx, 4)
    assert geo0.S_pad == 480 and geo0 == rstg.staged_geometry_pseudo(idx, 4)
    monkeypatch.setattr(stg, "_S_PAD_LIMIT", 200)
    monkeypatch.setattr(rstg, "_S_PAD_LIMIT", 200)
    geo = stg.staged_geometry_pseudo(idx, 4)
    assert geo.S_pad < 200 and geo == rstg.staged_geometry_pseudo(idx, 4)
    assert geo.slot_cuts[0] == 0 and geo.slot_cuts[-1] == 528
    assert all(a <= b for a, b in zip(geo.slot_cuts, geo.slot_cuts[1:]))
    assert geo.row_cuts[0] == 0 and geo.row_cuts[-1] == K


def test_pseudo_geometry_truly_unsplittable_still_asserts(monkeypatch):
    """One CSR row over the limit cannot be split: the assert stands."""
    occ = np.ones(16, np.int64)
    occ[7] = 500
    idx = _FakeCsr(16, np.arange(16) * 4, occ)
    monkeypatch.setattr(stg, "_S_PAD_LIMIT", 200)
    with pytest.raises(AssertionError, match="occ offsets overflow"):
        stg.staged_geometry_pseudo(idx, 4)


def test_pseudo_auto_shards_lut_term(tmp_path, monkeypatch):
    """StagedPseudoMapper's shard count counts the geometry's real prefix
    LUT (4^p x 8 bytes): a budget that only that term exceeds gives 2 shards,
    as the reference's does."""
    rng = np.random.default_rng(77)
    fa = write_fasta(str(tmp_path / "t.fa"),
                     random_transcriptome(rng, n_txps=5, min_len=150, max_len=260))
    ridx = ref_pbuild(fa, k=11)
    idx = index_from_reference(vars(ridx), PseudoIndex)
    K = len(idx.kmer_hi)
    p = max(4, min(idx.k, 12, math.ceil(math.log(max(K, 2), 4)) + 1))
    monkeypatch.setenv("TQM_STAGED_SHARD_GB", f"{(K * 16 + 4**p * 8 - 4**p * 4) / 2**30:.9f}")
    m = StagedPseudoMapper(idx, MapConfig(k=idx.k), batch=8, read_len=40, device="cpu")
    assert m.sm.n_shards == 2
    assert rstg.StagedPseudoMapper(ridx, RefConfig(k=idx.k), batch=8,
                                   read_len=40).sm.n_shards == 2


def _empty_shard(geo):
    for p in range(len(geo.row_cuts) - 1):
        if geo.row_cuts[p] == geo.row_cuts[p + 1]:
            return p
    return None


def _low_complexity_txps(rng):
    """AC-only transcripts: k-mers occupy 2^p of the 4^p prefix buckets, so
    a high shard count forces duplicate prefix-boundary cuts."""
    seqs = [BASES[rng.integers(0, 2, n)].tobytes() for n in (2000, 1200)]
    return [(f"ac{i}", s) for i, s in enumerate(seqs)]


def test_empty_shard_pad_keys(tmp_path):
    """Empty shards carry -1 pad keys (not all-zero rows, whose key is the
    poly-A k-mer), quasi and pseudo, with the reference's geometry."""
    rng = np.random.default_rng(78)
    fa = write_fasta(str(tmp_path / "t.fa"), _low_complexity_txps(rng))
    ridx = ref_pbuild(fa, k=11)
    pidx = index_from_reference(vars(ridx), PseudoIndex)
    geo = stg.staged_geometry_pseudo(pidx, 150)
    assert geo == rstg.staged_geometry_pseudo(ridx, 150)
    p = _empty_shard(geo)
    assert p is not None
    didx, _ = stg.pseudo_shard_device_arrays(pidx, geo, p)
    rdidx, _ = rstg.pseudo_shard_device_arrays(ridx, geo, p)
    assert (didx.kmer_rows[:, :2] == -1).all()
    for f in ("kmer_rows", "lut_rows"):
        assert np.array_equal(getattr(didx, f), np.asarray(getattr(rdidx, f))), f
    rq = ref_build(fa, k=11)
    qidx = index_from_reference(vars(rq))
    qgeo = stg.staged_geometry(qidx, 150)
    assert qgeo == rstg.staged_geometry(rq, 150)
    qp = _empty_shard(qgeo)
    assert qp is not None
    for shard in (qp, 0):
        qd, qst, qs0 = stg.shard_device_arrays(qidx, qgeo, shard)
        rd, rst_, rs0 = rstg.shard_device_arrays(rq, qgeo, shard)
        assert qs0 == rs0 and qst.lookup_steps == rst_.lookup_steps
        for f in ("kmer_rows", "lut_rows", "sa_cmp"):
            assert np.array_equal(getattr(qd, f), np.asarray(getattr(rd, f))), f
    assert (stg.shard_device_arrays(qidx, qgeo, qp)[0].kmer_rows[:, :2] == -1).all()


def test_staged_pseudo_parity_with_empty_shards(tmp_path):
    """A shard count high enough to leave shards empty still maps as the
    oracle does; every one of the 150 shards' arrays equals the reference's.
    The reference's own test (tests/test_staged_geometry.py, the same seed,
    world, reads and config) holds its engine to the same oracle on this
    input, so the two engines agree on it; its 150 sweeps are not run twice."""
    rng = np.random.default_rng(79)
    txps = _low_complexity_txps(rng)
    ridx = ref_pbuild(write_fasta(str(tmp_path / "p.fa"), txps), k=11)
    idx = index_from_reference(vars(ridx), PseudoIndex)
    reads = [r[1] for r in sample_reads(rng, txps, 24, read_len=L, error_rate=0.03,
                                        n_frac=0.02)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=8)
    eng = StagedPseudoEngine(idx, MapConfig(**kw), n_shards=150, read_len=L,
                             batch=len(reads), device="cpu")
    assert _empty_shard(eng.geo) is not None
    assert eng.geo == rstg.staged_geometry_pseudo(ridx, 150)
    for p in range(150):
        got, s0 = stg.pseudo_shard_device_arrays(idx, eng.geo, p)
        want, rs0 = rstg.pseudo_shard_device_arrays(ridx, eng.geo, p)
        assert s0 == rs0
        for f in ("kmer_rows", "lut_rows"):
            assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f))), (p, f)
    got = eng.map_batches([codes])[0][0]
    assert got == _oracle(idx, codes, lens, MapConfig(**kw))
    assert got == _replicated(idx, kw, codes, lens)
