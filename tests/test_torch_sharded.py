"""The SA-sharded engine of rapmap_tpu_torch against rapmap_tpu's on the CPU,
integer for integer (tolerance zero): twins of tests/test_sharded.py and
tests/test_sharded_score.py on their worlds and seeds. The port's
shard_quasi_index arrays equal the reference's field for field (dtype
included); map_batch_se_sharded / map_batch_pe_sharded over a (n_data,
n_idx) mesh of CPU entries equal the reference's map_batch_*_sharded on its
virtual device mesh, MapOut, PairOut and Counters, and the port's
single-device result; sharded_walk_plain's hits equal the reference's
sharded walk (_sharded_scan_paired, _sharded_scan) on one shard layout per
lane kind, with a shard whose slots no shard owns. A scalar per-lane model
of csrc/walk.cu's sharded build (the owner-first trip) equals
sharded_walk_plain, and the wrapper refuses shard tables the kernel cannot
search before any launch.

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


def run_se(ref_arr, ref_st, port_arr, port_st, n_data, n_idx, codes, lens, nv, kw):
    """map_batch_se_sharded of both packages on one batch -> (reference
    MapOut, Counters as numpy; the port's as tensors)."""
    want = jax.tree.map(np.asarray, rsh.map_batch_se_sharded(
        jax.tree.map(jnp.asarray, ref_arr), ref_st, jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(nv), RefConfig(**kw), rsh.make_mesh_2d(n_data, n_idx)))
    got = psh.map_batch_se_sharded(port_arr, port_st, *_tensors(codes, lens), nv, MapConfig(**kw),
                                   psh.make_mesh_2d(n_data, n_idx, ["cpu", "cpu"]))
    return want, got


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
    got = psh.map_batch_pe_sharded(arr, st, *_tensors(c1, l1, c2, l2), nv, MapConfig(**kw),
                                   psh.make_mesh_2d(n_data, n_idx, ["cpu"]))
    for w, g in zip(want, got):
        _same(w, g)
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
    anchors in its range have no owner and record (0, 0, 0)."""
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
        for f in want._fields:
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), (gap, f)
        live = np.arange(want.q.shape[1])[None, :] < want.n[:, None]
        unowned = int((live & (want.l == 0)).sum())
        assert (unowned > 0) == gap and int(want.n.sum()) > 0


def test_mesh_2d_order_and_cpu_only_when_asked(monkeypatch):
    """make_mesh_2d keeps each data row's idx shards on one device and hands
    the devices to the rows in turn, so upload_sharded takes its default
    mesh over several devices; without a card it raises unless the caller
    names the CPU; a data row whose shards span devices is refused."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert psh.make_mesh_2d(2, 3, ["cpu"]) == [[cpu] * 3] * 2
    mesh = psh.make_mesh_2d(3, 2, ["cpu", "meta"])
    assert mesh == [[cpu] * 2, [meta] * 2, [cpu] * 2]
    P_, S = 2, 4
    two = psh.ShardedIndexArrays(
        text2q=np.zeros((P_, 1, 4), np.int32), sa_cmp=np.zeros((P_, S, 4), np.int32),
        sa_meta=np.zeros((P_, S, 2), np.int32), kmer_rows=np.zeros((P_, 1, 4), np.int32),
        lut_rows=np.zeros((P_, 4, 2), np.int32),
        slot_base=np.array([[0, S], [S, S]], np.int32), txp_align=np.zeros((P_, 1, 3), np.int32))
    stacks = psh.upload_sharded(two, mesh)
    assert [s.sa_cmp.device for s in stacks] == [cpu, meta, cpu]
    assert stacks[0] is stacks[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psh.make_mesh_2d(1, 2)
    arr = psh.ShardedIndexArrays(*(np.zeros((2, 1, 1), np.int32),) * 6)
    with pytest.raises(ValueError, match="share one device"):
        psh.upload_sharded(arr, [["cpu", "meta"]])


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
