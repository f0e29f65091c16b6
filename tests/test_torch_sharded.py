"""The SA-sharded engine of rapmap_tpu_torch against rapmap_tpu's on the CPU,
integer for integer (tolerance zero): twins of tests/test_sharded.py and
tests/test_sharded_score.py on their worlds and seeds. The port's
shard_quasi_index arrays equal the reference's field for field (dtype
included); map_batch_se_sharded / map_batch_pe_sharded over a (n_data,
n_idx) mesh of CPU entries equal the reference's map_batch_*_sharded on its
virtual device mesh, MapOut, PairOut and Counters, and the port's
single-device result, with each row's shards stacked on one device and
split over their own uploads (split_idx=True: the trip loop of the split
path, its trips on the CPU's plain version); sharded_walk_plain's hits and
the split walk's equal the reference's
sharded walk (_sharded_scan_paired, _sharded_scan) on one shard layout per
lane kind, with a shard whose slots no shard owns. A scalar per-lane model
of csrc/walk.cu's sharded build (the owner-first trip) equals
sharded_walk_plain, and the wrapper refuses shard tables the kernel cannot
search before any launch. One trip's per-shard terms (sharded_trip_plain)
sum to the walk's extension and to the replicated index's, and a scalar
per-lane model of the sharded trip kernel (K10) equals each term; its
wrapper refuses what the kernel does not take.

tests/test_sharded.py::test_slot64_requires_x64 has no twin: it tests that
the reference refuses slot64 while 64-bit JAX is off, a JAX switch the port
does not have (torch carries int64 on every device)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.ops import encode as ref_enc
from rapmap_tpu.parallel import sharded as rsh
from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models.quasi import QuasiMapper, _host
from rapmap_tpu_torch.ops.device_index import upload_index
from rapmap_tpu_torch.ops.extend_packed import extend_packed
from rapmap_tpu_torch.parallel import sharded as psh
from tests.test_device_parity import batch_of
from tests.test_torch_pe import jax_cache_off  # noqa: F401
from tests.test_torch_walk import LaneModel, clamp
from tests.util import BASES, sample_reads, toy_index

needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture
def x64():
    """64-bit JAX for the reference's slot64 regime, restored after."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _same(want, got, *why):
    """Reference NamedTuple (numpy) against the port's (tensors or numpy):
    equal values, field for field, and equal dtypes unless 64-bit JAX is on
    (the reference's slot64 tests run with it, and its int fields widen)."""
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f)
        g = _host(g) if isinstance(g, torch.Tensor) else np.asarray(g)
        assert np.array_equal(g, w), (*why, f)
        assert g.dtype == w.dtype or jax.config.jax_enable_x64, (*why, f, g.dtype, w.dtype)


def _arrays_equal(ref_arr, port_arr):
    for f in ref_arr._fields:
        a, b = getattr(ref_arr, f), getattr(port_arr, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == a.dtype and np.array_equal(a, b), f


def _split(n, n_data, per):
    nv = np.zeros(n_data, np.int32)
    rem = n
    for i in range(n_data):
        nv[i] = min(per, max(rem, 0))
        rem -= nv[i]
    return nv


def _tensors(*arrays):
    return [torch.from_numpy(np.asarray(a, np.int64 if a.ndim == 1 else np.int8))
            for a in arrays]


def shard_both(idx, n_idx, **kw):
    """Both packages' cuts of one index -> (reference arrays, its st, port
    arrays, port st, port index), the arrays held equal."""
    ref_arr, ref_st = rsh.shard_quasi_index(idx, n_idx, **kw)
    pidx = index_from_reference(vars(idx))
    port_arr, port_st = psh.shard_quasi_index(pidx, n_idx, **kw)
    _arrays_equal(ref_arr, port_arr)
    assert (port_st.use_chd, port_st.chd_canonical) == (ref_st.use_chd, ref_st.chd_canonical)
    return ref_arr, ref_st, port_arr, port_st, pidx


def port_uploads(port_arr, mesh, split: bool):
    """The port's host arrays for a call (stacked by map_batch_*_sharded) or,
    split, upload_sharded's ShardSets, every shard uploaded on its own."""
    if not split:
        return port_arr
    uploads = psh.upload_sharded(port_arr, mesh, split_idx=True)
    assert all(isinstance(u, psh.ShardSet) for u in uploads)
    return uploads


def port_se(port_arr, port_st, n_data, n_idx, codes, lens, nv, kw, split=False):
    """The port's map_batch_se_sharded on one batch -> (MapOut, Counters),
    its rows stacked or, split, over ShardSets."""
    mesh = psh.make_mesh_2d(n_data, n_idx, ["cpu", "cpu"])
    return psh.map_batch_se_sharded(port_uploads(port_arr, mesh, split), port_st,
                                    *_tensors(codes, lens), nv, MapConfig(**kw), mesh)


def run_se(ref_arr, ref_st, port_arr, port_st, n_data, n_idx, codes, lens, nv, kw):
    """map_batch_se_sharded of both packages on one batch -> (reference
    MapOut, Counters as numpy; the port's as tensors)."""
    want = jax.tree.map(np.asarray, rsh.map_batch_se_sharded(
        jax.tree.map(jnp.asarray, ref_arr), ref_st, jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(nv), RefConfig(**kw), rsh.make_mesh_2d(n_data, n_idx)))
    return want, port_se(port_arr, port_st, n_data, n_idx, codes, lens, nv, kw)


@needs8
@pytest.mark.parametrize(
    "n_data,n_idx,mode",
    [(4, 2, "canonical"), (2, 4, "canonical"), (4, 2, "strand"), (4, 2, "bsearch")],
)
def test_sharded_matches_reference(tmp_path, n_data, n_idx, mode):
    rng = np.random.default_rng(91)
    idx, txps = toy_index(
        tmp_path / f"m{n_idx}{mode}", rng, n_txps=6, min_len=150, max_len=300, k=11,
        shared_prefix=30,
    )
    reads = sample_reads(rng, txps, 40, read_len=44, error_rate=0.03, n_frac=0.01)
    seqs = [r[1] for r in reads] + [BASES[rng.integers(0, 4, 44)].tobytes() for _ in range(4)]
    per = -(-len(seqs) // n_data) + 1  # a little pad on every data shard
    codes, lens = batch_of(seqs + [b""] * (n_data * per - len(seqs)), 44)
    kw = dict(k=idx.k, max_hits_per_strand=34, expand_budget=128, max_out=32)
    ref_arr, ref_st, port_arr, port_st, pidx = shard_both(
        idx, n_idx, use_chd=mode != "bsearch", canonical=mode == "canonical")
    if mode == "canonical":
        assert port_st.use_chd and port_st.chd_canonical and port_arr.chd_rows.shape[-1] == 6
    elif mode == "strand":
        assert port_st.use_chd and not port_st.chd_canonical and port_arr.chd_rows.shape[-1] == 4
    else:
        assert not port_st.use_chd and port_arr.chd_dir is None
    nv = _split(len(seqs), n_data, per)
    (want_out, want_ctr), (out, ctr) = run_se(ref_arr, ref_st, port_arr, port_st, n_data,
                                              n_idx, codes, lens, nv, kw)
    _same(want_out, out, mode)
    _same(want_ctr, ctr, mode)
    split = port_se(port_arr, port_st, n_data, n_idx, codes, lens, nv, kw, split=True)
    _same(want_out, split[0], mode, "split")
    _same(want_ctr, split[1], mode, "split")
    single = QuasiMapper(pidx, MapConfig(**kw), device="cpu").map_se(codes, lens,
                                                                     n_valid=len(seqs))
    _same(single[0], out, "single")
    _same(single[1], ctr, "single")
    assert int(ctr.reads_mapped) > 0


def test_shard_cut_points(tmp_path):
    rng = np.random.default_rng(92)
    idx, _ = toy_index(tmp_path, rng, n_txps=5, min_len=120, max_len=250, k=9)
    _, _, arr, _, _ = shard_both(idx, 3)
    # every k-mer interval lies wholly inside one shard
    kb, ke = np.asarray(idx.kmer_b), np.asarray(idx.kmer_e)
    cuts = list(arr.slot_base[:, 0]) + [len(idx.sa)]
    for b, e in zip(kb, ke):
        owner = np.searchsorted(cuts, b, side="right") - 1
        assert cuts[owner] <= b and e <= cuts[owner + 1], (b, e, cuts)


@pytest.mark.skipif(len(jax.devices()) < 6, reason="needs 6 virtual devices")
def test_sharded_slot_ownership_past_cuts(tmp_path):
    """A shard shorter than S_pad must not claim the next shard's first slots
    through its zero-padded rows: reads start at the text positions of the
    slots just past every cut."""
    rng = np.random.default_rng(94)
    idx, _ = toy_index(tmp_path, rng, n_txps=7, min_len=120, max_len=400, k=11)
    n_idx, n_data = 3, 2
    ref_arr, ref_st, arr, st, pidx = shard_both(idx, n_idx)
    S_pad = arr.sa_meta.shape[1]
    ns = arr.slot_base[:, 1]
    assert (ns < S_pad).any(), "test needs at least one short shard"
    sa = np.asarray(idx.sa, dtype=np.int64)
    text = np.asarray(idx.text)
    rl = 24
    seqs = []
    for p in range(1, n_idx):
        cut = int(arr.slot_base[p, 0])
        hi = min(int(arr.slot_base[p - 1, 0]) + S_pad, cut + int(ns[p]))
        for s in range(cut, hi):
            w = text[sa[s] : sa[s] + rl]
            if len(w) == rl and (w >= 1).all():  # sentinel-free window
                seqs.append(bytes(BASES[w - 1]))
    assert seqs, "no sentinel-free reads in the double-claim windows"
    seqs = seqs[:40]
    per = -(-len(seqs) // n_data)
    codes, lens = batch_of(seqs + [b""] * (n_data * per - len(seqs)), rl)
    kw = dict(k=idx.k, max_hits_per_strand=16, expand_budget=128, max_out=32)
    nv = _split(len(seqs), n_data, per)
    (want_out, _), (out, _) = run_se(ref_arr, ref_st, arr, st, n_data, n_idx, codes, lens,
                                     nv, kw)
    _same(want_out, out)
    single, _ = QuasiMapper(pidx, MapConfig(**kw), device="cpu").map_se(codes, lens,
                                                                        n_valid=len(seqs))
    _same(single, out, "single")


@needs8
def test_sharded_pe_matches_reference(tmp_path):
    rng = np.random.default_rng(93)
    idx, txps = toy_index(tmp_path, rng, n_txps=5, min_len=250, max_len=400, k=11)
    L = 36
    lefts, rights = [], []
    for _ in range(22):
        seq = txps[int(rng.integers(0, len(txps)))][1]
        a = int(rng.integers(0, len(seq) - 130))
        lefts.append(seq[a : a + L])
        rights.append(seq[a + 100 - L : a + 100].translate(COMP)[::-1])
    n_data, n_idx = 4, 2
    per = -(-len(lefts) // n_data) + 1
    B = n_data * per
    c1, l1 = batch_of(lefts + [b""] * (B - len(lefts)), L)
    c2, l2 = batch_of(rights + [b""] * (B - len(rights)), L)
    kw = dict(k=idx.k, max_hits_per_strand=26, expand_budget=64, max_out=32)
    ref_arr, ref_st, arr, st, pidx = shard_both(idx, n_idx)
    nv = _split(len(lefts), n_data, per)
    want = jax.tree.map(np.asarray, rsh.map_batch_pe_sharded(
        jax.tree.map(jnp.asarray, ref_arr), ref_st, jnp.asarray(c1), jnp.asarray(l1),
        jnp.asarray(c2), jnp.asarray(l2), jnp.asarray(nv), RefConfig(**kw),
        rsh.make_mesh_2d(n_data, n_idx)))
    mesh = psh.make_mesh_2d(n_data, n_idx, ["cpu"])
    got, split = (psh.map_batch_pe_sharded(port_uploads(arr, mesh, sp), st,
                                           *_tensors(c1, l1, c2, l2), nv, MapConfig(**kw), mesh)
                  for sp in (False, True))
    for w, g, s in zip(want, got, split):
        _same(w, g)
        _same(w, s, "split")
    single = QuasiMapper(pidx, MapConfig(**kw), device="cpu").map_pe(c1, l1, c2, l2,
                                                                     n_valid=len(lefts))
    for s, g in zip(single, got):
        _same(s, g, "single")
    assert got[2].concordant.any()


def _slot64_world(tmp_path, seed):
    rng = np.random.default_rng(seed)
    idx, txps = toy_index(
        tmp_path, rng, n_txps=6, min_len=150, max_len=300, k=11, shared_prefix=30
    )
    reads = sample_reads(rng, txps, 40, read_len=44, error_rate=0.03, n_frac=0.01)
    seqs = [r[1] for r in reads]
    n_data = 4
    per = -(-len(seqs) // n_data) + 1
    codes, lens = batch_of(seqs + [b""] * (n_data * per - len(seqs)), 44)
    return idx, codes, lens, _split(len(seqs), n_data, per), len(seqs)


@needs8
def test_sharded_slot64_matches_reference(tmp_path, x64):
    """The genome-scale slot layout (int64 global slots) forced small: the
    port's slot64 cut equals the reference's, and both packages' outputs
    equal the int32 cut's and the single-device result."""
    idx, codes, lens, nv, n = _slot64_world(tmp_path, 95)
    kw = dict(k=idx.k, max_hits_per_strand=34, expand_budget=128, max_out=32)
    outs = {}
    for slot64 in (False, True):
        ref_arr, ref_st, arr, st, pidx = shard_both(idx, 2, slot64=slot64)
        assert arr.slot_base.dtype == (np.int64 if slot64 else np.int32)
        (want_out, want_ctr), (out, ctr) = run_se(ref_arr, ref_st, arr, st, 4, 2, codes, lens,
                                                  nv, kw)
        _same(want_out, out, slot64)
        _same(want_ctr, ctr, slot64)
        split = port_se(arr, st, 4, 2, codes, lens, nv, kw, split=True)
        _same(want_out, split[0], slot64, "split")
        _same(want_ctr, split[1], slot64, "split")
        outs[slot64] = out
    single, _ = QuasiMapper(pidx, MapConfig(**kw), device="cpu").map_se(codes, lens, n_valid=n)
    _same(single, outs[True], "single")
    _same(single, outs[False], "single")


@needs8
def test_sharded_slot64_genome_geometry_shift(tmp_path, x64):
    """Global slots above 2^31 through the whole slot64 path: every global
    carrier (slot_base column 0, the class rows' intervals) moved up by B0
    gives the same output in both packages; an int32 cut of a global would
    wrap and break it."""
    idx, codes, lens, nv, _ = _slot64_world(tmp_path, 97)
    kw = dict(k=idx.k, max_hits_per_strand=34, expand_budget=128, max_out=32)
    ref_arr, ref_st, arr, st, _ = shard_both(idx, 2, slot64=True)
    B0 = np.int64(2**31 + 12345)

    def shifted(a):
        sb = a.slot_base.copy()
        sb[:, 0] += B0  # column 1 is the shard's slot count
        rows = a.chd_rows.copy()
        real = rows[..., 0] != -1
        for c in range(2, 6):
            rows[..., c] = np.where(real, rows[..., c] + B0, rows[..., c])
        assert int(rows[..., 2:6].max()) > 2**31
        return a._replace(slot_base=sb, chd_rows=rows)

    base_want, base_got = run_se(ref_arr, ref_st, arr, st, 4, 2, codes, lens, nv, kw)
    want, got = run_se(shifted(ref_arr), ref_st, shifted(arr), st, 4, 2, codes, lens, nv, kw)
    _same(want[0], got[0])
    _same(base_want[0], got[0], "unshifted")
    _same(base_want[0], base_got[0], "unshifted")
    assert int(got[1].reads_mapped) == int(want[1].reads_mapped) > 0


@needs8
@pytest.mark.parametrize("seed", [811, 822, 833])
def test_sharded_parity_fuzz(tmp_path, seed):
    """The reference's fuzz: transcriptome shape, k, read mix, config knobs,
    mesh shape and probe mode all drawn from the seed."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(9, 16))
    idx, txps = toy_index(
        tmp_path, rng, n_txps=int(rng.integers(3, 9)), min_len=int(rng.integers(80, 150)),
        max_len=int(rng.integers(200, 500)), k=k, shared_prefix=int(rng.integers(0, 50)),
    )
    rl = int(rng.integers(k + 10, 70))
    reads = sample_reads(
        rng, txps, int(rng.integers(12, 30)), read_len=rl,
        error_rate=float(rng.uniform(0, 0.08)), n_frac=float(rng.uniform(0, 0.04)),
    )
    seqs = [r[1] for r in reads] + [BASES[rng.integers(0, 4, rl)].tobytes() for _ in range(3)]
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
    kw = dict(k=idx.k, max_hits_per_strand=34, expand_budget=128, max_out=32, **kw)
    n_data, n_idx = [(2, 2), (4, 2), (2, 4), (2, 3)][int(rng.integers(0, 4))]
    mode = ["canonical", "strand", "bsearch"][int(rng.integers(0, 3))]
    per = -(-len(seqs) // n_data) + 1
    codes, lens = batch_of(seqs + [b""] * (n_data * per - len(seqs)), rl)
    ref_arr, ref_st, arr, st, pidx = shard_both(
        idx, n_idx, use_chd=mode != "bsearch", canonical=mode == "canonical")
    nv = _split(len(seqs), n_data, per)
    (want_out, want_ctr), (out, ctr) = run_se(ref_arr, ref_st, arr, st, n_data, n_idx, codes,
                                              lens, nv, kw)
    _same(want_out, out, mode, n_data, n_idx)
    _same(want_ctr, ctr, mode, n_data, n_idx)
    split = port_se(arr, st, n_data, n_idx, codes, lens, nv, kw, split=True)
    _same(want_out, split[0], mode, n_data, n_idx, "split")
    _same(want_ctr, split[1], mode, n_data, n_idx, "split")
    single = QuasiMapper(pidx, MapConfig(**kw), device="cpu").map_se(codes, lens,
                                                                     n_valid=len(seqs))
    _same(single[0], out, "single")


@needs8
def test_sharded_mapping_score_matches_reference(tmp_path):
    """Twin of tests/test_sharded_score.py: sharded records carry the banded
    alignment scores, equal to the reference's sharded MapOut and to the
    port's replicated wire records (ts-ordered per read)."""
    rng = np.random.default_rng(77)
    idx, txps = toy_index(
        tmp_path, rng, n_txps=6, min_len=150, max_len=300, k=11, shared_prefix=40
    )
    L = 44
    seqs = [r[1] for r in sample_reads(rng, txps, 36, read_len=L, error_rate=0.04)]
    n_data, n_idx = 4, 2
    per = -(-len(seqs) // n_data)
    codes, lens = batch_of(seqs + [b""] * (n_data * per - len(seqs)), L)
    kw = dict(k=idx.k, max_hits_per_strand=34, expand_budget=128, max_out=16, rec_slots=24,
              mapping_score=True)
    ref_arr, ref_st, arr, st, pidx = shard_both(idx, n_idx)
    nv = np.full(n_data, per, np.int32)
    nv[-1] = len(seqs) - per * (n_data - 1)
    (want_out, _), (out, _) = run_se(ref_arr, ref_st, arr, st, n_data, n_idx, codes, lens,
                                     nv, kw)
    _same(want_out, out)
    _same(want_out, port_se(arr, st, n_data, n_idx, codes, lens, nv, kw, split=True)[0], "split")
    mapper = QuasiMapper(pidx, MapConfig(**kw), device="cpu")
    wr = mapper.fetch(mapper.map_se_async(codes, lens, n_valid=len(seqs)))
    mo = [_host(x) for x in (out.t, out.pos, out.strand, out.score)]
    base = n_checked = 0
    for i in range(len(seqs)):
        cnt = int(wr.counts[i])
        for j in range(cnt):
            assert [int(m[i, j]) for m in mo] == [int(x) for x in wr.recs[base + j]], (i, j)
            n_checked += 1
        base += cnt
    assert n_checked > 10


def _ref_walk(ref_arr, ref_st, codes, lens, cfg, paired: bool):
    """The reference's sharded walk alone (a (1, n_idx) mesh, its module
    holders set inside the shard_map body as _se_shard2d sets them)."""
    n_idx = ref_arr.sa_cmp.shape[0]

    def body(sh, r, ln):
        didx = rsh._local_didx(sh)
        rsh.didx_base_holder[0] = sh.slot_base[0, 0]
        rsh.didx_nlocal_holder[0] = sh.slot_base[0, 1]
        if paired:
            return rsh._sharded_scan_paired(didx, ref_st, r, ln, cfg)
        lanes = jnp.concatenate([r, ref_enc.revcomp_batch(r, ln)], axis=0)
        return rsh._sharded_scan(didx, ref_st, lanes, jnp.concatenate([ln, ln]), cfg)

    fn = jax.jit(jax.shard_map(body, mesh=rsh.make_mesh_2d(1, n_idx),
                               in_specs=(P("idx"), P("data"), P("data")), out_specs=P("data"),
                               check_vma=False))
    return jax.tree.map(np.asarray, fn(jax.tree.map(jnp.asarray, ref_arr), jnp.asarray(codes),
                                       jnp.asarray(lens)))


@needs8
@pytest.mark.parametrize("paired", [True, False], ids=["paired_lanes", "explicit_lanes"])
def test_sharded_walk_plain_equals_reference_walk(tmp_path, paired):
    """sharded_walk_plain's hits (through the port's sharded dense phase)
    equal the reference's walk on the same shard layout: canonical-class
    shards for strand-paired lanes, per-strand CHD shards for explicit
    lanes; then with shard 1's true count set to 0 in both packages, so that
    anchors in its range have no owner and record (0, 0, 0). The split
    path's dense phase (each shard its own upload) equals the stack's, and
    its trip loop over sharded_trip_plain terms gives the reference's hits
    with no kernel launch."""
    rng = np.random.default_rng(98)
    idx, txps = toy_index(tmp_path, rng, n_txps=6, min_len=150, max_len=300, k=11,
                          shared_prefix=30)
    seqs = [r[1] for r in sample_reads(rng, txps, 24, read_len=40, error_rate=0.03,
                                       n_frac=0.01)]
    codes, lens = batch_of(seqs, 40)
    kw = dict(k=idx.k, max_hits_per_strand=31, expand_budget=128, max_out=32)
    ref_arr, ref_st, arr, st, _ = shard_both(idx, 3, canonical=paired)
    assert st.chd_canonical == paired
    for gap in (False, True):
        if gap:
            ref_arr = ref_arr._replace(slot_base=ref_arr.slot_base.copy())
            ref_arr.slot_base[1, 1] = 0
            arr = arr._replace(slot_base=ref_arr.slot_base.copy())
        want = _ref_walk(ref_arr, ref_st, codes, lens, RefConfig(**kw), paired)
        (stack,) = psh.upload_sharded(arr, [["cpu"] * 3])
        w, wkw = psh.scan_inputs(stack, st, *_tensors(codes, lens), MapConfig(**kw))
        assert wkw["paired"] == paired
        got = psh.sharded_walk_plain(stack, *w, **wkw)
        (sset,) = psh.upload_sharded(arr, [["cpu"] * 3], split_idx=True)
        ws, _ = psh.scan_inputs(sset, st, *_tensors(codes, lens), MapConfig(**kw))
        assert all(torch.equal(a, b) for a, b in zip(ws, w))
        kernels.reset_launches()
        split = psh.sharded_walk(sset, ws, **wkw)
        assert kernels.LAUNCHES["sharded_trip"] == 0
        for f in want._fields:
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), (gap, f)
            assert np.array_equal(getattr(split, f).numpy(), np.asarray(getattr(want, f))), \
                (gap, f, "split")
        live = np.arange(want.q.shape[1])[None, :] < want.n[:, None]
        unowned = int((live & (want.l == 0)).sum())
        assert (unowned > 0) == gap and int(want.n.sum()) > 0


def test_mesh_2d_order_and_cpu_only_when_asked(monkeypatch):
    """make_mesh_2d lays the reference's mesh over n_data x n_idx devices or
    more (data row d on devices[d * n_idx : (d + 1) * n_idx]), and with fewer
    keeps each data row's shards on one device, handing the devices to the
    rows in turn; without a card it raises unless the caller names the CPU.
    upload_sharded stacks a row on one device (rows on that device share
    the stack) and splits a row over several into a ShardSet: one upload a
    shard, on its device, text2q and txp_align once a device, rows sharing
    the uploads of their common (device, shard); split_idx=True splits a
    one-device row, split_idx=False refuses a row over several devices."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert psh.make_mesh_2d(2, 3, ["cpu"]) == [[cpu] * 3] * 2
    mesh = psh.make_mesh_2d(3, 2, ["cpu", "meta"])
    assert mesh == [[cpu] * 2, [meta] * 2, [cpu] * 2]
    assert psh.make_mesh_2d(2, 2, ["cpu", "meta", "meta", "cpu", "meta"]) == [[cpu, meta],
                                                                            [meta, cpu]]
    P_, S = 2, 4
    two = psh.ShardedIndexArrays(
        text2q=np.zeros((P_, 1, 4), np.int32), sa_cmp=np.zeros((P_, S, 4), np.int32),
        sa_meta=np.zeros((P_, S, 2), np.int32), kmer_rows=np.zeros((P_, 1, 4), np.int32),
        lut_rows=np.zeros((P_, 4, 2), np.int32),
        slot_base=np.array([[0, S], [S, S]], np.int32), txp_align=np.zeros((P_, 1, 3), np.int32))
    stacks = psh.upload_sharded(two, mesh)
    assert [s.sa_cmp.device for s in stacks] == [cpu, meta, cpu]
    assert stacks[0] is stacks[2]
    assert all(isinstance(s, psh.ShardStack) for s in stacks)
    rows = psh.upload_sharded(two, [["cpu", "meta"], ["meta", "cpu"], ["cpu", "meta"]])
    assert all(isinstance(r, psh.ShardSet) and r.bases == ((0, S), (S, S)) for r in rows)
    assert [[d.sa_cmp.device for d in r.shards] for r in rows] == [[cpu, meta], [meta, cpu],
                                                                  [cpu, meta]]
    assert [r.home for r in rows] == [cpu, meta, cpu]
    assert rows[0].shards[0] is rows[2].shards[0] and rows[0].shards[1] is rows[2].shards[1]
    by_dev = {}
    for r in rows:
        for d in r.shards:
            by_dev.setdefault(d.sa_cmp.device, set()).update({id(d.text2q), id(d.txp_align)})
    assert {dev: len(ids) for dev, ids in by_dev.items()} == {cpu: 2, meta: 2}
    for p, d in enumerate(rows[0].shards):
        assert tuple(d.sa_cmp.shape) == (S, 4) and tuple(d.sa_meta.shape) == (S, 2)
        assert d.chd_dir is None and tuple(d.text2q.shape) == (1, 4)
    (one,) = psh.upload_sharded(two, [["cpu", "cpu"]], split_idx=True)
    assert isinstance(one, psh.ShardSet) and one.shards[0].text2q is one.shards[1].text2q
    assert torch.equal(one.shards[1].sa_cmp, torch.from_numpy(two.sa_cmp[1]))
    with pytest.raises(ValueError, match="several devices"):
        psh.upload_sharded(two, [["cpu", "meta"]], split_idx=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psh.make_mesh_2d(1, 2)


# ---- a scalar per-lane model of csrc/walk.cu's sharded build (K8) ---------------


class ShardedLaneModel(LaneModel):
    """The sharded build's trip, lane by lane (tests/test_torch_walk.py's
    LaneModel for the walk and the extension): the owner is the last shard
    whose offset is <= b0, found by binary lifting over the ascending
    offsets in the same steps as the kernel; the lane extends ONCE, on that
    shard's rows at local slots, when the shard owns b0 (b0 - offset below
    its true count), and records the result rebased to global slots, else
    (0, 0, 0)."""

    def __init__(self, stack, k, L, steps):
        super().__init__(stack.local(0), k, L, steps)
        self.bases = stack.bases
        self.shards = [LaneModel(stack.local(p), k, L, steps) for p in range(len(stack.bases))]

    def owner(self, b0):
        P_ = len(self.bases)
        top = 1
        while 2 * top <= P_ - 1:
            top *= 2
        p, step = 0, (top if P_ > 1 else 0)
        while step > 0:
            q = p + step
            p = q if q < P_ and self.bases[q][0] <= b0 else p
            step >>= 1
        return p

    def extend_lane(self, r, pre, nbad, ln, col_off, b0, e0, pos):
        p = self.owner(b0)
        base, n_local = self.bases[p]
        if not 0 <= b0 - base < n_local:
            return 0, 0, 0
        b, e, mlen = self.shards[p].extend(pre[r], nbad[r], ln, col_off, b0 - base,
                                           clamp(e0 - base, 0, n_local), pos, True)
        return b + base, e + base, mlen


@pytest.fixture(scope="module")
def k8_world(tmp_path_factory):
    """A small transcriptome with shared prefixes (k = 11) and 40 bp reads
    with errors and Ns, as the port's index."""
    rng = np.random.default_rng(99)
    idx, txps = toy_index(tmp_path_factory.mktemp("k8"), rng, n_txps=6, min_len=150,
                          max_len=300, k=11, shared_prefix=30)
    seqs = [r[1] for r in sample_reads(rng, txps, 24, read_len=40, error_rate=0.03,
                                       n_frac=0.01)]
    codes, lens = batch_of(seqs, 40)
    return index_from_reference(vars(idx)), codes, lens


@pytest.mark.parametrize("n_idx,gap,paired", [
    (3, False, True), (3, True, True), (1, False, True), (3, False, False), (4, True, False),
], ids=["P3_paired", "P3_shard1_gap_paired", "P1_paired", "P3_lanes", "P4_shard1_gap_lanes"])
def test_sharded_lane_model_matches_walk_plain(k8_world, n_idx, gap, paired):
    """The owner-first trip of the kernel gives sharded_walk_plain's hits
    (tolerance zero), on the dense phase's anchors plus forward lanes whose
    first anchor is moved to b0 = every shard's first and last owned slot,
    one slot before and after them (a short shard's padding, the next
    shard's first slot), with intervals 1 and 3 wide; with shard 1's true
    count set to 0 its slots have no owner and record (0, 0, 0)."""
    pidx, codes, lens = k8_world
    kw = dict(k=pidx.k, max_hits_per_strand=24, expand_budget=128, max_out=32)
    arr, st = psh.shard_quasi_index(pidx, n_idx, canonical=paired)
    if gap:
        arr = arr._replace(slot_base=arr.slot_base.copy())
        arr.slot_base[1, 1] = 0
    (stack,) = psh.upload_sharded(arr, [["cpu"] * n_idx])
    w, wkw = psh.scan_inputs(stack, st, *_tensors(codes, lens), MapConfig(**kw))
    assert wkw["paired"] == paired
    s_pad = stack.sa_cmp.shape[1]
    targets = sorted({t for base, n in stack.bases
                      for t in (base - 1, base, base + n - 1, base + n, base + s_pad - 1)
                      if 0 <= t < stack.bases[-1][0] + stack.bases[-1][1]})
    bf, ef, anch = w.bf.clone(), w.ef.clone(), w.anch_f.clone()
    assert len(targets) <= bf.shape[0]
    for r, t in enumerate(targets):
        bf[r, 0], ef[r, 0], anch[r, 0] = t, t + 1 + 2 * (r % 2), True
    w = w._replace(bf=bf, ef=ef, anch_f=anch)
    if not paired:  # explicit lanes read br/er/anch_rF as bf/ef/anch_f
        w = w._replace(br=bf, er=ef, anch_rF=anch)
    kernels.reset_launches()
    want = psh.sharded_walk(stack, w, **wkw)
    assert kernels.LAUNCHES["sharded_walk"] + kernels.LAUNCHES["sharded_walk_lanes"] == 0
    model = ShardedLaneModel(stack, wkw["k"], w.preads.shape[1], wkw["ext_steps"])
    got = model.walk(w, wkw["H"], paired=paired)
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(got, f)).astype(np.int64),
                              getattr(want, f).numpy().astype(np.int64)), f
    first = want.b[: len(targets), 0].numpy()
    live = np.arange(want.q.shape[1])[None, :] < want.n.numpy()[:, None]
    unowned = int((live & (want.l.numpy() == 0)).sum())
    assert (unowned > 0) == gap
    assert (first[want.l[: len(targets), 0].numpy() > 0] >= 0).all()
    assert int((want.l > pidx.k).sum()) > 0  # some trips extended past k


def _meta_stack(bases):
    """A ShardStack of len(bases) shards on the meta device (no data), with
    the given host table of [offset, true count] pairs."""
    P_ = len(bases)

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    return psh.ShardStack(text2q=meta(8, 4), sa_cmp=meta(P_, 16, 4), sa_meta=meta(P_, 16, 2),
                          kmer_rows=meta(P_, 1, 4), lut_rows=meta(P_, 4, 2),
                          slot_base=meta(P_, 2), chd_dir=None, chd_rows=None,
                          txp_align=meta(1, 3), bases=tuple(bases))


@pytest.mark.parametrize("case, match", [
    ("descending", "ascend"), ("overlapping", "ascend"), ("negative_count", "ascend"),
    ("over_cap", "shards"), ("valid", "no kernel for device"),
])
def test_sharded_walk_wrapper_refuses_shard_tables(case, match):
    """Off the CPU the wrapper launches or raises: descending or overlapping
    shard ranges (the kernel's owner search takes the last shard whose
    offset is <= b0, exact only for ascending disjoint ranges) and more
    shards than the kernel's shared-memory table holds raise before any
    launch; a valid table reaches the device check (meta tensors stand in
    for a device that is not the CPU)."""
    cap = psh.SHARDED_WALK_MAX_SHARDS
    bases = {"descending": [(0, 10), (30, 10), (20, 5)],
             "overlapping": [(0, 10), (8, 10), (20, 5)],
             "negative_count": [(0, 10), (10, -1), (20, 5)],
             "over_cap": [(4 * p, 4) for p in range(cap + 1)],
             "valid": [(0, 10), (10, 0), (10, 7), (20, 5)]}[case]
    R, L, k = 4, 20, 11
    S = L - k + 1

    def meta(*shape, dt=torch.int64):
        return torch.empty(shape, dtype=dt, device="meta")

    w = psh.WalkInputs(preads=meta(R, L), next_bad=meta(R, L), lens2=meta(R), col_off2=meta(R),
                       bf=meta(R // 2, S), ef=meta(R // 2, S), br=meta(R // 2, S),
                       er=meta(R // 2, S), anch_f=meta(R // 2, S, dt=torch.bool),
                       anch_rF=meta(R // 2, S, dt=torch.bool))
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        psh.sharded_walk(_meta_stack(bases), w, k=k, H=4, ext_steps=8, paired=True)
    assert kernels.LAUNCHES["sharded_walk"] == 0


# ---- one shard's trip (K10, the split path) ----------------------------------


class TripLaneModel(LaneModel):
    """csrc/walk.cu's sharded trip kernel, lane by lane, for one shard: a
    lane is the shard's when it is active and b0 - base lies in [0, n_local)
    (else (0, 0, 0), and no row is read); it then extends once over the
    shard's rows at local slots and records the result rebased to global
    slots."""

    def __init__(self, didx, base, n_local, k, L, steps):
        super().__init__(didx, k, L, steps)
        self.base, self.n_local = base, n_local

    def term(self, pre, nbad, ln, col_off, b0, e0, pos, act):
        lb = b0 - self.base if act else -1
        if not 0 <= lb < self.n_local:
            return 0, 0, 0
        b, e, mlen = self.extend(pre, nbad, ln, col_off, lb, clamp(e0 - self.base, 0, self.n_local),
                                 pos, True)
        return b + self.base, e + self.base, mlen


def edge_trip(stack, w):
    """One trip's lane values: lane r at the first forward anchor of its row
    r % B (column 0 without one, inactive), the first lanes active at b0 =
    every shard's first and last owned slot, one slot before and after them,
    and the last slot of its padding (the next shard's), intervals 1 and 3
    wide, and every fifth lane after them inactive -> (b0, e0, pos, act,
    the targets)."""
    R, B = w.lens2.shape[0], w.bf.shape[0]
    row = torch.arange(R) % B
    anch = w.anch_f[row]
    pos = torch.where(anch.any(1), anch.to(torch.int64).argmax(1), 0)
    b0, e0, act = w.bf[row, pos].clone(), w.ef[row, pos].clone(), anch.any(1).clone()
    s_pad, end = stack.sa_cmp.shape[1], stack.bases[-1][0] + stack.bases[-1][1]
    targets = sorted({t for base, n in stack.bases
                      for t in (base - 1, base, base + n - 1, base + n, base + s_pad - 1)
                      if 0 <= t < end})
    nt = len(targets)
    assert nt <= R
    b0[:nt] = torch.tensor(targets)
    e0[:nt] = b0[:nt] + 1 + 2 * (torch.arange(nt) % 2)
    act[:nt] = True
    act[nt::5] = False
    return b0, e0, pos, act, targets


@pytest.mark.parametrize("n_idx,gap,paired", [
    (1, False, True), (3, False, True), (3, True, False), (4, True, True), (4, False, False),
], ids=["P1_paired", "P3_paired", "P3_shard1_gap_lanes", "P4_shard1_gap_paired", "P4_lanes"])
def test_sharded_trip_terms_sum_to_walk_extension(k8_world, n_idx, gap, paired):
    """One trip of the split path: the shards' sharded_trip_plain terms,
    each over its own upload (a ShardSet), sum to sharded_walk_plain's
    extension over the stack (trip_extension), and to the replicated
    index's extend_packed at global slots on every lane a shard owns (e0
    cut at the owner's last slot, as the trip cuts it), with (0, 0, 0) on
    the others; each term equals TripLaneModel's, lane by lane,
    and is nonzero only on the shard's own lanes. P = 1, 3, 4; shard 1
    without slots; b0 on every shard's edges and in the padding (edge_trip);
    the wrapper takes the plain version on CPU tensors, with no launch."""
    pidx, codes, lens = k8_world
    kw = dict(k=pidx.k, max_hits_per_strand=24, expand_budget=128, max_out=32)
    arr, st = psh.shard_quasi_index(pidx, n_idx, canonical=paired)
    if gap:
        arr = arr._replace(slot_base=arr.slot_base.copy())
        arr.slot_base[1, 1] = 0
    (stack,) = psh.upload_sharded(arr, [["cpu"] * n_idx])
    (sset,) = psh.upload_sharded(arr, [["cpu"] * n_idx], split_idx=True)
    w, wkw = psh.scan_inputs(stack, st, *_tensors(codes, lens), MapConfig(**kw))
    assert wkw["paired"] == paired
    k, steps, L = wkw["k"], wkw["ext_steps"], w.preads.shape[1]
    b0, e0, pos, act, _ = edge_trip(stack, w)
    lanes = (w.preads, w.next_bad, w.lens2, w.col_off2)
    kernels.reset_launches()
    terms = [psh.sharded_trip(sset.local(p), base, n, *lanes, b0, e0, pos, act, k=k,
                              ext_steps=steps) for p, (base, n) in enumerate(sset.bases)]
    assert kernels.LAUNCHES["sharded_trip"] == 0
    total = [sum(t[i] for t in terms) for i in range(3)]
    ext = psh.trip_extension(stack, w, psh.sharded_trip_plain, k=k, ext_steps=steps)(
        b0, e0, pos, act)
    assert all(torch.equal(a, b) for a, b in zip(total, ext))
    owned, end = torch.zeros_like(act), e0.clone()  # end: the owner's last slot + 1
    for base, n in sset.bases:
        mine = act & (b0 - base >= 0) & (b0 - base < n)
        owned |= mine
        end = torch.where(mine, base + n, end)
    full, _ = upload_index(pidx, "cpu")
    rep = extend_packed(full, *lanes[:3], b0, torch.minimum(e0, end), pos, owned, k, steps, L,
                        col_off=w.col_off2)
    for got, want in zip(total, rep):
        assert torch.equal(got, torch.where(owned, want, 0))
    unowned = int((act & ~owned).sum())
    assert (unowned > 0) == gap and int((total[2][owned] > k).sum()) > 0
    pre, nbad = w.preads.numpy(), w.next_bad.numpy()
    for p, (base, n) in enumerate(sset.bases):
        model = TripLaneModel(sset.local(p), base, n, k, L, steps)
        mine = act & (b0 - base >= 0) & (b0 - base < n)
        for r in range(len(act)):
            want = model.term(pre[r], nbad[r], int(w.lens2[r]), int(w.col_off2[r]), int(b0[r]),
                              int(e0[r]), int(pos[r]), bool(act[r]))
            assert tuple(int(t[r]) for t in terms[p]) == want, (p, r)
            assert bool(mine[r]) == (want[2] > 0), (p, r)


@pytest.mark.parametrize("case, exc, match", [
    ("valid", ValueError, "no kernel for device"), ("act_int64", TypeError, "act must be"),
    ("b0_int32", TypeError, "b0 must be"), ("pos_on_cpu", ValueError, "pos lies on"),
    ("short_e0", ValueError, "lane inputs"), ("count_past_rows", ValueError, "true slot count"),
    ("odd_rows", ValueError, "sa_cmp must be"),
])
def test_sharded_trip_wrapper_refuses(case, exc, match):
    """Off the CPU the trip's wrapper launches K10 or raises, before any
    launch and with no fallback, on what the kernel does not take; valid
    inputs reach the device check (meta tensors stand in for a device that
    is not the CPU)."""
    R, L, n = 6, 20, 16

    def meta(*shape, dt=torch.int64, dev="meta"):
        return torch.empty(shape, dtype=dt, device=dev)

    lanes = dict(preads=meta(R, L), next_bad=meta(R, L), lens2=meta(R), col_off2=meta(R),
                 b0=meta(R), e0=meta(R), pos=meta(R), act=meta(R, dt=torch.bool))
    didx = psh.DeviceQuasiIndex(text2q=meta(8, 4, dt=torch.int32),
                                sa_meta=meta(n, 2, dt=torch.int32),
                                sa_cmp=meta(n, 3 if case == "odd_rows" else 6, dt=torch.int32))
    n_local = n + 1 if case == "count_past_rows" else n
    if case == "act_int64":
        lanes["act"] = meta(R)
    elif case == "b0_int32":
        lanes["b0"] = meta(R, dt=torch.int32)
    elif case == "pos_on_cpu":
        lanes["pos"] = meta(R, dev="cpu")
    elif case == "short_e0":
        lanes["e0"] = meta(R - 1)
    kernels.reset_launches()
    with pytest.raises(exc, match=match):
        psh.sharded_trip(didx, 100, n_local, *lanes.values(), k=11, ext_steps=5)
    assert kernels.LAUNCHES["sharded_trip"] == 0
