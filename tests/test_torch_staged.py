"""The port's host-staged engine (rapmap_tpu_torch.parallel.staged, on the
CPU: stage A's plain versions) against the reference's
(rapmap_tpu.parallel.staged): twins of tests/test_staged.py on its worlds,
each result equal to the reference's staged engine on the same input, to the
port's replicated engine (QuasiMapper) and to the numpy oracle; the plain
anchor-parallel extension (`extend_packed(..., lane=)`) against the
reference's, and a scalar per-anchor model of csrc/walk.cu's
tqm_extend_packed_lanes against the plain version (a CUDA kernel cannot run
here; chip_smoke.py holds the kernel itself to the plain version on the
card)."""

import os

import numpy as np
import pytest
import torch

import rapmap_tpu_torch.parallel.staged as stg
from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.parallel.staged import StagedMapper as RefStaged
from rapmap_tpu.parallel.staged import StagedQuasiMapper as RefAdapter
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models.quasi import QuasiMapper
from rapmap_tpu_torch.oracle import quasimap as qm
from rapmap_tpu_torch.ops.wire import FLAG_MAPPED
from rapmap_tpu_torch.parallel.staged import StagedMapper, StagedQuasiMapper
from tests.test_device_parity import batch_of
from tests.util import random_transcriptome, sample_reads, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

L = 40


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test runs, then the count it had: stage
    A's plain versions issue thousands of tiny ops, and with the suite's
    workers on every core a multi-threaded pool only contends (a 1,440-row
    gather: ~10 ms on 8 threads, ~0.03 ms on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _repetitive(tmp_path, rng, n_txps=6, cut=30, span=(30, 120), big_sa=False):
    """tests/test_staged.py's world: 6 transcripts of 150-260 bp sharing a
    90 bp segment, k = 11 -> (reference index, port index, transcripts)."""
    base = random_transcriptome(rng, n_txps=n_txps, min_len=150, max_len=260)
    shared = base[0][1][span[0] : span[1]]
    txps = [(f"t{i}", s[:cut] + shared + s[cut:]) for i, (_, s) in enumerate(base)]
    fa = write_fasta(str(tmp_path / "g.fa"), txps)
    ridx = ref_build(fa, k=11, big_sa=big_sa)
    return ridx, index_from_reference(vars(ridx)), txps


def _lists(w) -> list:
    """A WireResult's records as per-read lists of tuples."""
    off = np.concatenate([[0], np.cumsum(w.counts)])
    return [[tuple(int(x) for x in w.recs[j]) for j in range(off[i], off[i + 1])]
            for i in range(len(w.counts))]


def _replicated(idx, kw, codes, lens, pe=None):
    """The port's replicated engine on the same reads, as per-read lists;
    its voting pool, slots and record buffer sized so that no read degrades
    into the host fallback and no record is cut on these toy worlds (the
    staged engine has neither cap)."""
    m = QuasiMapper(idx, MapConfig(**{**kw, "expand_budget": 2048, "max_out": 256,
                                      "rec_slots": 64}), device="cpu")
    w = m.fetch(m.map_se_async(codes, lens) if pe is None
                else m.map_pe_async(codes, lens, *pe))
    assert not w.overflowed
    return _lists(w)


def _both(ridx, idx, kw, codes, lens, n_shards, with_lens=False, **extra):
    """The reference's and the port's staged engine on one batch ->
    (port records, port stats); asserts they are equal."""
    ref = RefStaged(ridx, RefConfig(**kw), n_shards=n_shards, read_len=L,
                    batch=len(codes), **extra)
    port = StagedMapper(idx, MapConfig(**kw), n_shards=n_shards, read_len=L,
                        batch=len(codes), device="cpu", **extra)
    ls = [lens] if with_lens else None
    want, wstats = ref.map_batches([codes], lens=ls)
    got, stats = port.map_batches([codes], lens=ls)
    assert got == want and stats == wstats
    return got[0], stats


def _oracle(idx, codes, lens, cfg):
    return [[(m.txp, m.pos, 0 if m.fwd else 1, m.score)
             for m in qm.map_read(idx, codes[i][: lens[i]], cfg)] for i in range(len(codes))]


@pytest.mark.parametrize("big_sa", [False, True])
def test_staged_vs_oracle(tmp_path, big_sa):
    rng = np.random.default_rng(31)
    ridx, idx, txps = _repetitive(tmp_path, rng, big_sa=big_sa)
    reads = [r[1] for r in sample_reads(rng, txps, 48, read_len=L, error_rate=0.02)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=16, expand_budget=256, max_out=64)
    got, stats = _both(ridx, idx, kw, codes, lens, 3)
    assert stats["anchor_overflow"] == 0
    assert got == _oracle(idx, codes, lens, MapConfig(**kw))
    assert got == _replicated(idx, kw, codes, lens)


@pytest.mark.parametrize("overlap", [False, True])
def test_staged_sweep_checkpoint_resume(tmp_path, overlap):
    """A sweep stopped by a fault after its first checkpoint resumes past
    shard 0 with the same geometry, in both pipeline modes, and equals the
    uninterrupted run (and the reference's) bit for bit; the snapshot is
    gone once the sweep completes."""
    rng = np.random.default_rng(34)
    ridx, idx, txps = _repetitive(tmp_path, rng, cut=25, span=(40, 130))
    reads = [r[1] for r in sample_reads(rng, txps, 48, read_len=L, error_rate=0.02)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=16, expand_budget=256, max_out=64)
    want, _ = _both(ridx, idx, kw, codes, lens, 4)
    ckpt = str(tmp_path / "ckpt.npz")

    def mapper():
        sm = StagedMapper(idx, MapConfig(**kw), n_shards=4, read_len=L, batch=len(reads),
                          device="cpu")
        sm.checkpoint_path, sm.checkpoint_every, sm.upload_overlap = ckpt, 2, overlap
        return sm

    crash = mapper()
    orig = crash._stage_a_union

    def faulting(didx, lanes, lens2, a, s0, _n=[0]):
        _n[0] += 1
        if _n[0] > 3:  # shards 0-2 complete; the checkpoint holds shard 2
            raise RuntimeError("induced fault")
        return orig(didx, lanes, lens2, a, s0)

    crash._stage_a_union = faulting
    with pytest.raises(RuntimeError, match="induced"):
        crash.map_batches([codes])
    assert os.path.exists(ckpt)

    resumed = mapper()
    shards_run = []
    orig2 = resumed._stage_a_union

    def counting(didx, lanes, lens2, a, s0):
        shards_run.append(s0)
        return orig2(didx, lanes, lens2, a, s0)

    resumed._stage_a_union = counting
    got, stats = resumed.map_batches([codes])
    assert stats["anchor_overflow"] == 0
    assert len(shards_run) == 2  # resumed at shard 2 of 4, not 0
    assert got[0] == want
    assert not os.path.exists(ckpt)


def test_staged_checkpoint_geometry_mismatch_is_a_fresh_sweep(tmp_path):
    """A snapshot of another geometry (here: 3 shards against 4) is ignored
    with a warning, and the sweep runs from shard 0."""
    rng = np.random.default_rng(34)
    ridx, idx, txps = _repetitive(tmp_path, rng, cut=25, span=(40, 130))
    reads = [r[1] for r in sample_reads(rng, txps, 16, read_len=L, error_rate=0.02)]
    codes, lens = batch_of(reads, L)
    cfg = MapConfig(k=idx.k, max_hits_per_strand=16)
    ckpt = str(tmp_path / "ckpt.npz")
    np.savez(ckpt, next_shard=2, overflow=0, n_shards=3, n_batches=1, R=2 * len(reads),
             S=L - idx.k + 1)
    sm = StagedMapper(idx, cfg, n_shards=4, read_len=L, batch=len(reads), device="cpu")
    sm.checkpoint_path = ckpt
    got, _ = sm.map_batches([codes])
    assert len(sm.shard_timings) == 4 and not os.path.exists(ckpt)
    assert got[0] == _oracle(idx, codes, lens, cfg)


def test_staged_upload_overlap_parity(tmp_path):
    """upload_overlap (the next shard uploads while this one runs) equals
    the serial sweep bit for bit; only its timing rows carry exposed_wait_s."""
    rng = np.random.default_rng(35)
    ridx, idx, txps = _repetitive(tmp_path, rng)
    reads = [r[1] for r in sample_reads(rng, txps, 48, read_len=L, error_rate=0.02)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=16, expand_budget=256, max_out=64)
    want, _ = _both(ridx, idx, kw, codes, lens, 4)
    serial = StagedMapper(idx, MapConfig(**kw), n_shards=4, read_len=L, batch=len(reads),
                          device="cpu")
    over = StagedMapper(idx, MapConfig(**kw), n_shards=4, read_len=L, batch=len(reads),
                        device="cpu")
    over.upload_overlap = True
    assert serial.map_batches([codes])[0][0] == want
    got, stats = over.map_batches([codes])
    assert stats["anchor_overflow"] == 0 and got[0] == want
    assert all(t["exposed_wait_s"] is not None for t in over.shard_timings)
    assert all(t["exposed_wait_s"] is None for t in serial.shard_timings)


def test_staged_read_len_cap(tmp_path):
    """Reads past k + 48 bases are refused (compares stay inside the fused
    sa_cmp words), by the engine and by the anchor-parallel extension."""
    from rapmap_tpu_torch.ops.extend_packed import extend_anchors

    rng = np.random.default_rng(32)
    fa = write_fasta(str(tmp_path / "s.fa"),
                     random_transcriptome(rng, n_txps=2, min_len=200, max_len=220))
    idx = index_from_reference(vars(ref_build(fa, k=11)))
    with pytest.raises(ValueError, match="sa_cmp"):
        StagedMapper(idx, MapConfig(k=11), n_shards=2, read_len=120, batch=4, device="cpu")
    with pytest.raises(ValueError, match="120"):
        StagedQuasiMapper(idx, MapConfig(k=11), batch=4, read_len=120, device="cpu")
    didx, _, _ = stg.shard_device_arrays(idx, stg.staged_geometry(idx, 1), 0)
    didx = didx._replace(**{f: torch.from_numpy(getattr(didx, f)) for f in
                            ("text2q", "sa_cmp")})
    z = torch.zeros(4, dtype=torch.int64)
    rows = torch.zeros((2, 11 + 49), dtype=torch.int64)  # L = k + 49: 4 words past k
    with pytest.raises(ValueError, match="fused sa_cmp words"):
        extend_anchors(didx, rows, rows, z[:2], z, z, z, z.bool(), z, k=11, ext_steps=4)


@pytest.fixture(scope="module")
def sweep_world(tmp_path_factory):
    """tests/test_staged.py's config-sweep world (the same for every case):
    32 reads with 3% errors and a chimera."""
    rng = np.random.default_rng(41)
    ridx, idx, txps = _repetitive(tmp_path_factory.mktemp("sweep"), rng)
    reads = [r[1] for r in sample_reads(rng, txps, 32, read_len=L, error_rate=0.03)]
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
        dict(strict_check=True),
        dict(strict_check=True, consistent_hits=True),
    ],
)
def test_staged_config_sweep(sweep_world, kw):
    """The staged collate over the flag surface (-c/-f/-s/-z/-m)."""
    ridx, idx, codes, lens = sweep_world
    kw = dict(k=idx.k, max_hits_per_strand=L - idx.k + 1, **kw)
    got, _ = _both(ridx, idx, kw, codes, lens, 3)
    assert got == _oracle(idx, codes, lens, MapConfig(**kw))
    assert got == _replicated(idx, kw, codes, lens)


def test_staged_variable_lens(tmp_path):
    """Mixed read lengths (length-aware rc lanes)."""
    rng = np.random.default_rng(42)
    ridx, idx, txps = _repetitive(tmp_path, rng)
    Lv = 44
    reads = []
    for ln in (20, 27, 33, 40, 44, 44, 31, 25):
        reads += [r[1] for r in sample_reads(rng, txps, 2, read_len=ln, error_rate=0.02)]
    codes, lens = batch_of(reads, Lv)
    kw = dict(k=idx.k, max_hits_per_strand=Lv - idx.k + 1)
    ref = RefStaged(ridx, RefConfig(**kw), n_shards=2, read_len=Lv, batch=len(reads))
    port = StagedMapper(idx, MapConfig(**kw), n_shards=2, read_len=Lv, batch=len(reads),
                        device="cpu")
    got = port.map_batches([codes], lens=[lens])[0][0]
    assert got == ref.map_batches([codes], lens=[lens])[0][0]
    assert got == _oracle(idx, codes, lens, MapConfig(**kw))
    assert got == _replicated(idx, kw, codes, lens)


def _pairs(rng, txps):
    comp = dict(zip(b"ACGT", b"TGCA"))
    pairs = []
    for _ in range(24):
        seq = txps[int(rng.integers(0, len(txps)))][1]
        F = min(len(seq), 120)
        p = int(rng.integers(0, len(seq) - F + 1))
        frag = seq[p : p + F]
        pairs.append((frag[:L], bytes(comp.get(c, ord("N")) for c in reversed(frag[-L:]))))
    pairs.append((txps[0][1][:L], txps[1][1][50 : 50 + L]))  # discordant
    return pairs


@pytest.mark.parametrize("kw", [dict(), dict(no_orphans=True), dict(max_frag_len=150)])
def test_staged_pe_parity(tmp_path, kw):
    """The staged pair merge against the reference's staged engine, the
    oracle's map_pair and the port's replicated engine."""
    rng = np.random.default_rng(43)
    ridx, idx, txps = _repetitive(tmp_path, rng)
    pairs = _pairs(rng, txps)
    c1, l1 = batch_of([p[0] for p in pairs], L)
    c2, l2 = batch_of([p[1] for p in pairs], L)
    kw = dict(k=idx.k, max_hits_per_strand=L - idx.k + 1, **kw)
    item = [("pe", c1, l1, c2, l2)]
    want = RefStaged(ridx, RefConfig(**kw), n_shards=3, read_len=L,
                     batch=len(pairs)).map_group(item)[0]
    res = StagedMapper(idx, MapConfig(**kw), n_shards=3, read_len=L, batch=len(pairs),
                       device="cpu").map_group(item)[0]
    assert res["recs"] == want["recs"]
    for f in ("conc", "too_amb", "trunc"):
        assert np.array_equal(res[f], want[f]), f
    for i in range(len(pairs)):
        ms, conc = qm.map_pair(idx, c1[i][: l1[i]], c2[i][: l2[i]], MapConfig(**kw))
        exp = [(m.txp, m.pos1 if m.pos1 is not None else 0, 0 if m.fwd1 else 1,
                int(m.pos1 is not None), m.pos2 if m.pos2 is not None else 0,
                0 if m.fwd2 else 1, int(m.pos2 is not None)) for m in ms]
        assert res["recs"][i] == exp and bool(res["conc"][i]) == conc, i
    assert res["recs"] == _replicated(idx, kw, c1, l1, pe=(c2, l2))


def test_staged_mapping_score(tmp_path):
    """--mappingScore through the host banded scorer: the reference's staged
    scores, the oracle's, and the replicated engine's (csrc/align.cu's plain
    version) on SE and PE records."""
    from rapmap_tpu_torch.oracle.align import score_mapping_np

    rng = np.random.default_rng(44)
    ridx, idx, txps = _repetitive(tmp_path, rng)
    reads = [r[1] for r in sample_reads(rng, txps, 24, read_len=L, error_rate=0.04)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=L - idx.k + 1, mapping_score=True)
    got, _ = _both(ridx, idx, kw, codes, lens, 2)
    cfg = MapConfig(**kw)
    n_recs = 0
    for i, m_list in enumerate(_oracle(idx, codes, lens, cfg)):
        assert len(got[i]) == len(m_list)
        for g, (t, p, s, _) in zip(got[i], m_list):
            sc = score_mapping_np(idx, codes[i][: lens[i]], t, p, s, cfg.align_band,
                                  cfg.align_ma, cfg.align_mp, cfg.align_go, cfg.align_ge)
            assert g == (t, p, s, sc)
            n_recs += 1
    assert n_recs > 10
    assert got == _replicated(idx, kw, codes, lens)
    pairs = _pairs(rng, txps)[:12]
    c1, l1 = batch_of([p[0] for p in pairs], L)
    c2, l2 = batch_of([p[1] for p in pairs], L)
    item = [("pe", c1, l1, c2, l2)]
    pe = StagedMapper(idx, cfg, n_shards=2, read_len=L, batch=12,
                      device="cpu").map_group(item)[0]["recs"]
    assert pe == RefStaged(ridx, RefConfig(**kw), n_shards=2, read_len=L,
                           batch=12).map_group(item)[0]["recs"]
    assert pe == _replicated(idx, kw, c1, l1, pe=(c2, l2))


def test_staged_adapter_wire(tmp_path):
    """StagedQuasiMapper (the command line's adapter): two queued batches
    mapped in one sweep, the short one padded; each WireResult (counters,
    counts, flags, recs) equals the reference adapter's and the replicated
    engine's, and its records the oracle's."""
    rng = np.random.default_rng(45)
    ridx, idx, txps = _repetitive(tmp_path, rng)
    reads = [r[1] for r in sample_reads(rng, txps, 20, read_len=L, error_rate=0.02)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=L - idx.k + 1)
    ad = StagedQuasiMapper(idx, MapConfig(**kw), batch=16, read_len=L, n_shards=2,
                           device="cpu")
    rad = RefAdapter(ridx, RefConfig(**kw), batch=16, read_len=L, n_shards=2)
    rep = QuasiMapper(idx, MapConfig(**kw), device="cpu")
    parts = [(slice(0, 16), 16), (slice(16, 20), 4)]
    hs = [ad.map_se_async(codes[s], lens[s], n_valid=n) for s, n in parts]
    rhs = [rad.map_se_async(codes[s], lens[s], n_valid=n) for s, n in parts]
    for (s, n), h, rh in zip(parts, hs, rhs):
        got, want = ad.fetch(h), rad.fetch(rh)
        for f in ("recs", "counts", "flags"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert (got.counters, got.total, got.overflowed) == (want.counters, want.total,
                                                             want.overflowed)
        assert got.counters["reads_total"] == n
        w = rep.fetch(rep.map_se_async(codes[s], lens[s], n_valid=n))
        assert np.array_equal(got.recs, w.recs) and got.counters == w.counters
        assert np.array_equal(got.counts, w.counts) and np.array_equal(got.flags, w.flags)
        assert _lists(got) == _oracle(idx, codes[s], lens[s], MapConfig(**kw))
        assert all(bool(f & FLAG_MAPPED) == bool(c) for f, c in zip(got.flags, got.counts))


def test_staged_chunked_upload_parity(tmp_path, monkeypatch):
    """Row-sliced shard uploads (a tiny TQM_STAGED_XFER_MB, every shard
    array in many slices into one preallocated tensor) equal whole-array
    uploads and the reference."""
    rng = np.random.default_rng(33)
    txps = random_transcriptome(rng, n_txps=5, min_len=150, max_len=240)
    ridx = ref_build(write_fasta(str(tmp_path / "c.fa"), txps), k=11)
    idx = index_from_reference(vars(ridx))
    reads = [r[1] for r in sample_reads(rng, txps, 24, read_len=L, error_rate=0.02)]
    codes, lens = batch_of(reads, L)
    kw = dict(k=idx.k, max_hits_per_strand=16, expand_budget=256, max_out=64)
    whole, _ = _both(ridx, idx, kw, codes, lens, 2)
    arr = np.arange(4000 * 6, dtype=np.int32).reshape(4000, 6)
    monkeypatch.setattr(stg, "_MAX_XFER", 4096)
    assert torch.equal(stg._chunked_upload(arr, "cpu"), torch.from_numpy(arr))
    parts = StagedMapper(idx, MapConfig(**kw), n_shards=2, read_len=L, batch=len(reads),
                         device="cpu").map_batches([codes])[0][0]
    assert parts == whole


# ---- the extension in anchor-parallel mode ----------------------------------

@pytest.fixture(scope="module")
def anchors(tmp_path_factory):
    """A shard's compacted anchors of a batch whose anchors outnumber its read
    rows (lanes repeat), on tests/test_staged.py's world, plus random whole-
    shard searches and dead anchors."""
    tmp = tmp_path_factory.mktemp("anch")
    rng = np.random.default_rng(46)
    ridx, idx, txps = _repetitive(tmp, rng)
    reads = [r[1] for r in sample_reads(rng, txps, 12, read_len=L, error_rate=0.03,
                                        n_frac=0.02)]
    codes, lens = batch_of(reads, L)
    lanes = np.concatenate([codes, stg._rc_lanes(codes, lens)])
    lens2 = np.concatenate([lens, lens]).astype(np.int64)
    geo = stg.staged_geometry(idx, 2)
    didx_np, st, _ = stg.shard_device_arrays(idx, geo, 0)
    didx = didx_np._replace(**{f: torch.from_numpy(getattr(didx_np, f)) for f in
                               didx_np._fields if getattr(didx_np, f) is not None})
    cfg = MapConfig(k=idx.k)
    lt, l2 = torch.from_numpy(lanes), torch.from_numpy(lens2)
    preads, next_bad, live, src, db, de, n = stg._dense_anchors(didx, st, cfg, lt, l2, 4096)
    n = int(n)
    assert n > lanes.shape[0]  # anchors outnumber the rows
    A = n + lanes.shape[0] + 5
    S = L - idx.k + 1
    lane = np.concatenate([(src[:n] // S).numpy(), rng.integers(0, len(lanes), A - n)])
    pos = np.concatenate([(src[:n] % S).numpy(), rng.integers(0, S, A - n)])
    n_sa = didx.sa_cmp.shape[0]
    b0 = np.concatenate([db[src[:n]].numpy(), np.zeros(A - n, np.int64)])
    e0 = np.concatenate([de[src[:n]].numpy(), np.full(A - n, n_sa, np.int64)])
    act = np.concatenate([np.ones(n, bool), rng.random(A - n) < 0.8])
    return (ridx, idx, didx, preads, next_bad, l2, lanes, lens2,
            *(torch.from_numpy(x) for x in (b0, e0, pos, act, lane)))


def test_extend_packed_lanes_matches_reference(anchors):
    """extend_packed(..., lane=) with anchors that outnumber rows (lanes
    repeat, some dead, some over the whole shard) equals the reference's
    extend_packed(..., lane=) on the same inputs."""
    import jax.numpy as jnp

    from rapmap_tpu.ops import encode as rdenc
    from rapmap_tpu.ops.device_index import DeviceQuasiIndex as RefDidx
    from rapmap_tpu.ops.extend_packed import extend_packed as ref_extend
    from rapmap_tpu.ops.extend_packed import pack_reads as ref_pack
    from rapmap_tpu_torch.ops.extend_packed import extend_anchors, extend_packed

    _, idx, didx, preads, next_bad, l2, lanes, lens2, b0, e0, pos, act, lane = anchors
    steps = int(np.ceil(np.log2(didx.sa_cmp.shape[0] + 1))) + 1
    got = extend_packed(didx, preads, next_bad, l2, b0, e0, pos, act, idx.k, steps, L,
                        lane=lane)
    assert all(torch.equal(g, w) for g, w in zip(
        got, extend_anchors(didx, preads, next_bad, l2, b0, e0, pos, act, lane, k=idx.k,
                            ext_steps=steps)))
    import jax

    rj = jnp.asarray(lanes)
    rdidx = RefDidx(text2q=jnp.asarray(didx.text2q.numpy()),
                    sa_meta=jnp.zeros((1, 2), jnp.int32),
                    sa_cmp=jnp.asarray(didx.sa_cmp.numpy()))
    want = jax.jit(ref_extend, static_argnums=(8, 9, 10))(
        rdidx, ref_pack(rj), rdenc.next_bad_batch(rj, L), jnp.asarray(lens2.astype(np.int32)),
        *(jnp.asarray(x.numpy().astype(np.int32)) for x in (b0, e0, pos)),
        jnp.asarray(act.numpy()), idx.k, steps, L,
        lane=jnp.asarray(lane.numpy().astype(np.int32)))
    for name, g, w in zip(("b", "e", "mlen"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert int((got[2] > idx.k).sum()) > 0  # extensions reached past k


def test_anchor_kernel_model_matches_plain(anchors):
    """A scalar per-anchor model of tqm_extend_packed_lanes' control flow
    (anchor i reads row lane[i], clamped; an inactive anchor keeps (b0, e0)
    with length k without reading its row; extend_lane otherwise, the walk's
    LaneModel) against the plain version."""
    from rapmap_tpu_torch.ops.extend_packed import extend_packed
    from tests.test_torch_walk import LaneModel

    _, idx, didx, preads, next_bad, l2, _, _, b0, e0, pos, act, lane = anchors
    steps = 3  # searches stopped short of convergence, as a static bound does
    want = extend_packed(didx, preads, next_bad, l2, b0, e0, pos, act, idx.k, steps, L,
                         lane=lane)
    model = LaneModel(didx, idx.k, L, steps)
    pre, nbad, R = preads.numpy(), next_bad.numpy(), preads.shape[0]
    got = []
    for i in range(lane.shape[0]):
        if not bool(act[i]):
            got.append((int(b0[i]), int(e0[i]), idx.k))
            continue
        r = min(max(int(lane[i]), 0), R - 1)
        got.append(model.extend(pre[r], nbad[r], int(l2[r]), 0, int(b0[i]), int(e0[i]),
                                int(pos[i]), True))
    got = np.array(got)
    for c, name in enumerate(("b", "e", "mlen")):
        assert np.array_equal(got[:, c], want[c].numpy()), name
