"""The mapping score (cfg.mapping_score, SEMANTICS.md §9) through
rapmap_tpu_torch's mapping programs against rapmap_tpu's on the CPU, integer
for integer (tolerance zero): the SE wire buffer and WireResult chunked and
unchunked, the PE one chunked (direct merge, and the slotted branch with
`pe_direct_eligible` patched to False in both packages) and unchunked, the
score record layouts `rec_spec_se` / `rec_spec_pe`, the --minScoreFraction
filter (`filter_se`, `filter_pe`, `min_score_of`) on the same WireResults,
and the host-oracle fallback's scored rows (`remap_se`, `remap_pe`) on a
starved expansion budget; every scored row also equals the numpy oracle."""

from types import SimpleNamespace

import numpy as np
import pytest

import rapmap_tpu.ops.pairs as ref_pairs
import rapmap_tpu_torch.models.quasi as port_quasi
from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.index.encode import revcomp_codes
from rapmap_tpu.models import fallback as rfb
from rapmap_tpu.models import scorefilter as rsf
from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
from rapmap_tpu.oracle import quasimap as rqm
from rapmap_tpu.ops import wire as rwire
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models import fallback as fb
from rapmap_tpu_torch.models import scorefilter as sf
from rapmap_tpu_torch.models.quasi import QuasiMapper
from rapmap_tpu_torch.ops import wire
from rapmap_tpu_torch.ops.device_index import EngineStatic
from rapmap_tpu_torch.ops.wire import FLAG_DEGRADED
from rapmap_tpu_torch.oracle import quasimap as qm
from rapmap_tpu_torch.oracle.align import score_mapping_np
from tests.test_device_parity import batch_of
from tests.test_fallback import _repetitive_world
from tests.util import random_transcriptome, sample_reads, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

B, L, C = 64, 64, 16      # single-end: 4 chunks of 16
PB, PL, PC = 32, 56, 16   # paired-end: 2 chunks of 16 (8 for the slotted branch)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_mapping_score.py's world (10 transcripts of 150-400 bp,
    k = 17): 48 reads of 60 bp with 4% errors and 1% Ns, 24 pairs of 55 bp
    mates from 115 bp fragments with 4% errors, and two junk reads/pairs."""
    rng = np.random.default_rng(99)
    txps = random_transcriptome(rng, n_txps=10, min_len=150, max_len=400)
    idx = ref_build(write_fasta(str(tmp_path_factory.mktemp("score") / "t.fa"), txps), k=17)
    reads = [r[1] for r in sample_reads(rng, txps, n_reads=48, read_len=60,
                                        error_rate=0.04, n_frac=0.01)]
    reads += [b"ACGT" * 15, txps[0][1][:30]]
    pairs = []
    while len(pairs) < 24:
        seq = txps[int(rng.integers(0, len(txps)))][1]
        p = int(rng.integers(0, len(seq) - 120))
        left, right = bytearray(seq[p : p + 55]), bytearray(seq[p + 60 : p + 115])
        for b in (left, right):
            for j in range(len(b)):
                if rng.random() < 0.04:
                    b[j] = b"ACGT"[int(rng.integers(0, 4))]
        pairs.append((bytes(left), bytes(right).translate(COMP)[::-1]))
    pairs += [(b"ACGT" * 14, b"TTGCA" * 11), (txps[1][1][:55], b"GATC" * 14)]
    return idx, reads, pairs


def _mappers(idx, **kw):
    kw = dict(dict(k=idx.k, mapping_score=True), **kw)
    ref = RefMapper(idx, RefConfig(**kw))
    port = QuasiMapper(index_from_reference(vars(idx)), MapConfig(**kw), device="cpu")
    assert port.cfg == MapConfig(**vars(ref.cfg))
    return ref, port


def _same_wire(ref, rh, port, res):
    got = res.wire.numpy()
    assert got.dtype == np.int32 and np.array_equal(got, np.asarray(rh[2]))
    want, have = ref.fetch(rh), port.fetch(res)
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(have, f)), np.asarray(getattr(want, f))), f
    return have


def _oracle(idx, codes, t, pos, strand, cfg):
    return score_mapping_np(idx, codes, int(t), int(pos), int(strand), cfg.align_band,
                            cfg.align_ma, cfg.align_mp, cfg.align_go, cfg.align_ge)


def se_batch(world):
    idx, reads, _ = world
    codes, lens = batch_of(reads + [b""] * (B - len(reads)), L)
    return idx, codes, lens, len(reads)


def pe_batch(world):
    idx, _, pairs = world
    pad = [b""] * (PB - len(pairs))
    c1, l1 = batch_of([p[0] for p in pairs] + pad, PL)
    c2, l2 = batch_of([p[1] for p in pairs] + pad, PL)
    return idx, c1, l1, c2, l2, len(pairs)


@pytest.mark.parametrize("chunk", [C, 0])
def test_se_wire_with_mapping_score(world, chunk):
    """map_se_async / fetch with cfg.mapping_score, chunked (the direct
    compaction, packed 2-word rows with the 12-bit score field) and
    unchunked (compact_se, then the score column replaced): the
    reference's wire buffer; every record's score is the oracle's."""
    idx, codes, lens, n = se_batch(world)
    ref, port = _mappers(idx, chunk=chunk)
    res = port.map_se_async(codes, lens, n_valid=n)
    assert res.C == chunk and (res.spec is not None) == bool(chunk)
    got = _same_wire(ref, ref.map_se_async(codes, lens, n_valid=n), port, res)
    off = np.concatenate([[0], np.cumsum(got.counts)])
    for i in range(n):
        for t, pos, strand, sc in got.recs[off[i] : off[i + 1]]:
            assert sc == _oracle(port.host_index, codes[i, : lens[i]], t, pos, strand, port.cfg)
    assert got.recs.shape[1] == 4 and (got.recs[:, 3] > 100).sum() >= n // 2


def _assert_pe(world, chunk, expect_w=9):
    idx, c1, l1, c2, l2, n = pe_batch(world)
    ref, port = _mappers(idx, chunk=chunk)
    res = port.map_pe_async(c1, l1, c2, l2, n_valid=n)
    assert res.C == chunk
    got = _same_wire(ref, ref.map_pe_async(c1, l1, c2, l2, n_valid=n), port, res)
    assert got.recs.shape[1] == expect_w
    off = np.concatenate([[0], np.cumsum(got.counts)])
    for i in range(n):
        for t, p1, s1, h1, p2, s2, h2, sc1, sc2 in got.recs[off[i] : off[i + 1]]:
            assert sc1 == (_oracle(port.host_index, c1[i, : l1[i]], t, p1, s1, port.cfg)
                           if h1 else 0)
            assert sc2 == (_oracle(port.host_index, c2[i, : l2[i]], t, p2, s2, port.cfg)
                           if h2 else 0)
    assert (got.recs[:, 7] > 80).sum() >= n // 2 and (got.recs[:, 8] > 80).sum() >= n // 2
    return got


@pytest.mark.parametrize("chunk", [PC, 0])
def test_pe_wire_with_mapping_score(world, chunk):
    """map_pe_async / fetch with cfg.mapping_score, chunked (the direct
    merge: rows scatter unpacked, both mates scored in one pass, 9 fields
    packed into 2 words) and unchunked (compact_pe's score branch): the
    reference's wire buffer and 9-field WireResult."""
    got = _assert_pe(world, chunk)
    assert (got.recs[:, 3] == 0).any() or (got.recs[:, 6] == 0).any()  # an orphan


def test_pe_wire_with_mapping_score_slotted(world, monkeypatch):
    """The chunked path's slotted branch (both packages' pe_direct_eligible
    patched to False, their direct merge made to raise; test only), at a
    chunk of its own so the reference traces its own program: compact_pe
    with score_args."""
    def direct_merge(*a, **kw):
        raise AssertionError("the direct merge ran")

    for mod in (ref_pairs, port_quasi):
        monkeypatch.setattr(mod, "pe_direct_eligible", lambda st, cfg, C: False)
        monkeypatch.setattr(mod, "collate_records_pe", direct_merge)
    _assert_pe(world, PC // 2)


def test_rec_specs_match_reference(world):
    """The score layouts: SE's score field is 12 bits, PE gains two 12-bit
    fields; stats that overflow 64 bits give None in both packages."""
    idx = world[0]
    st = EngineStatic.for_index(index_from_reference(vars(idx)))
    big = SimpleNamespace(n_txps=1 << 20, max_tpos=1 << 26, pad_tail=64)
    for stats in (st, big, SimpleNamespace(n_txps=3, max_tpos=1 << 14, pad_tail=64), None):
        for score in (False, True):
            cfg, rcfg = MapConfig(k=17, mapping_score=score), RefConfig(k=17, mapping_score=score)
            for mine, ref in ((wire.rec_spec_se, rwire.rec_spec_se),
                              (wire.rec_spec_pe, rwire.rec_spec_pe)):
                got, want = mine(stats, cfg), ref(stats, rcfg)
                assert (got is None) == (want is None)
                if got is not None:
                    assert tuple(got) == tuple(want)
    assert wire.rec_spec_pe(st, MapConfig(k=17, mapping_score=True)).bits[-2:] == (12, 12)
    assert wire.rec_spec_se(st, MapConfig(k=17, mapping_score=True)).bits[-1] == 12
    assert wire.rec_spec_pe(big, MapConfig(k=17, mapping_score=True)) is None


def _same_result(got, want):
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "counters":
            assert g == w
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), f


@pytest.mark.parametrize("frac", [0.0, 0.9, 1.0])
def test_score_filters_match_reference(world, frac):
    """filter_se and filter_pe on the port's scored WireResults give what
    the reference's filters give on the same inputs: records, counts, flags,
    total and counters (score_filtered, reads_mapped); min_score_of too."""
    idx, codes, lens, n = se_batch(world)
    ref, port = _mappers(idx, chunk=C)
    se = port.fetch(port.map_se_async(codes, lens, n_valid=n))
    _, c1, l1, c2, l2, npairs = pe_batch(world)
    pe = port.fetch(port.map_pe_async(c1, l1, c2, l2, n_valid=npairs))
    cfg = MapConfig(k=17, mapping_score=True, min_score_fraction=frac)
    rcfg = RefConfig(k=17, mapping_score=True, min_score_fraction=frac)
    got_se, got_pe = sf.filter_se(se, lens, cfg), sf.filter_pe(pe, l1, l2, cfg)
    _same_result(got_se, rsf.filter_se(se, lens, rcfg))
    _same_result(got_pe, rsf.filter_pe(pe, l1, l2, rcfg))
    if frac == 0.9:
        assert 0 < got_se.counters["score_filtered"] < se.total
        assert 0 < got_pe.counters["score_filtered"] < pe.total
    for rl in (0, 60, 3000):
        assert sf.min_score_of(cfg, rl) == rsf.min_score_of(rcfg, rl)


def test_fallback_scores_match_reference(tmp_path):
    """--mappingScore on a starved expansion budget (tests/test_fallback.py's
    repetitive world): remap_se's 4-field and remap_pe's 9-field rows equal
    the reference's fallback on the same inputs, every score the oracle's."""
    ref_idx, txps, shared = _repetitive_world(tmp_path, np.random.default_rng(8))
    Lr = 40
    reads = [shared[j : j + Lr] for j in range(0, len(shared) - Lr + 1, 3)]
    reads += [txps[0][1][:Lr], txps[1][1][100 : 100 + Lr]]
    codes, lens = batch_of(reads, Lr)
    ref, port = _mappers(ref_idx, expand_budget=1, max_hits_per_strand=Lr - ref_idx.k + 1)
    n = len(reads)
    recsd = port.fetch(port.map_se_async(codes, lens))
    rrecsd = ref.fetch(ref.map_se_async(codes, lens))
    assert (np.asarray(recsd.flags) & FLAG_DEGRADED).any()
    fixed = fb.remap_se(recsd, codes, lens, n, port.host_index, port.cfg, qm)
    _same_result(fixed, rfb.remap_se(rrecsd, codes, lens, n, ref_idx, ref.cfg, rqm))
    assert fixed.counters["host_fallback"] > 0
    off = np.concatenate([[0], np.cumsum(fixed.counts)])
    for i in range(n):
        for t, pos, strand, sc in fixed.recs[off[i] : off[i + 1]]:
            assert sc == _oracle(port.host_index, codes[i, : lens[i]], t, pos, strand, port.cfg)

    c2 = np.stack([revcomp_codes(c) for c in codes])
    recsd2 = port.fetch(port.map_pe_async(codes, lens, c2, lens))
    rrecsd2 = ref.fetch(ref.map_pe_async(codes, lens, c2, lens))
    fixed2 = fb.remap_pe(recsd2, codes, lens, c2, lens, n, port.host_index, port.cfg, qm)
    _same_result(fixed2, rfb.remap_pe(rrecsd2, codes, lens, c2, lens, n, ref_idx, ref.cfg,
                                      rqm))
    assert fixed2.recs.shape[1] == 9 and fixed2.counters["host_fallback"] > 0
    assert (fixed2.recs[:, 7] > 0).any() and (fixed2.recs[:, 8] > 0).any()
