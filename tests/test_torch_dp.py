"""Data-parallel rapmap_tpu_torch against rapmap_tpu on the CPU, integer for
integer (tolerance zero): twins of tests/test_parallel.py. The port's
map_batch_se_dp / map_batch_pe_dp over 8 CPU mesh entries (one device named
8 times, one upload of the index) equal the reference's dp.map_batch_*_dp on
its 8-device virtual mesh, every field of MapOut, PairOut and Counters with
its dtype, and the port's single-device result; split_valid equals the
reference's on edge cases."""

import jax
import numpy as np
import pytest
import torch

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
from rapmap_tpu.parallel import dp as ref_dp
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models.quasi import QuasiMapper, _host
from rapmap_tpu_torch.parallel import dp
from tests.test_device_parity import batch_of
from tests.test_torch_pe import jax_cache_off  # noqa: F401
from tests.util import sample_reads, toy_index

N_DEV = 8


def _same(want, got):
    """A reference NamedTuple of arrays (after jax.tree.map(np.asarray)) and
    the port's of tensors: equal values and dtypes, field for field."""
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), _host(getattr(got, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f


def _mesh():
    return dp.make_mesh(N_DEV, devices=["cpu"] * N_DEV)


@pytest.mark.skipif(len(jax.devices()) < N_DEV, reason="needs 8 virtual devices")
def test_dp_matches_reference_and_single_device(tmp_path):
    rng = np.random.default_rng(17)
    idx, txps = toy_index(tmp_path, rng, n_txps=6, min_len=150, max_len=300, k=11)
    reads = sample_reads(rng, txps, 61, read_len=40, error_rate=0.02)  # 61: ragged tail
    seqs = [r[1] for r in reads]
    per = 8
    B = N_DEV * per
    codes, lens = batch_of(seqs + [b""] * (B - len(seqs)), 40)
    kw = dict(k=idx.k, max_hits_per_strand=30, expand_budget=512, max_out=32)
    ref = RefMapper(idx, RefConfig(**kw))
    nv = ref_dp.split_valid(len(seqs), N_DEV, per)
    want_out, want_ctr = jax.tree.map(np.asarray, ref_dp.map_batch_se_dp(
        ref.didx, ref.st, codes, lens, nv, ref.cfg, ref_dp.make_mesh(N_DEV)))

    port = QuasiMapper(index_from_reference(vars(idx)), MapConfig(**kw), device="cpu")
    out, ctr = dp.map_batch_se_dp(port.didx, port.st, torch.from_numpy(codes),
                                  torch.from_numpy(lens.astype(np.int64)),
                                  dp.split_valid(len(seqs), N_DEV, per), port.cfg, _mesh())
    _same(want_out, out)
    _same(want_ctr, ctr)
    single_out, single_ctr = port.map_se(codes, lens, n_valid=len(seqs))
    _same(single_out, out)
    _same(single_ctr, ctr)
    assert int(ctr.reads_total) == len(seqs) and int(ctr.reads_mapped) > 0


@pytest.mark.skipif(len(jax.devices()) < N_DEV, reason="needs 8 virtual devices")
def test_dp_pe_matches_reference_and_single_device(tmp_path):
    rng = np.random.default_rng(19)
    idx, txps = toy_index(tmp_path, rng, n_txps=5, min_len=250, max_len=400, k=11)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    L = 36
    lefts, rights = [], []
    for _ in range(30):
        t = int(rng.integers(0, len(txps)))
        seq = txps[t][1]
        a = int(rng.integers(0, len(seq) - 130))
        lefts.append(seq[a : a + L])
        rights.append(seq[a + 100 - L : a + 100].translate(comp)[::-1])
    per = 4
    B = N_DEV * per
    c1, l1 = batch_of(lefts + [b""] * (B - len(lefts)), L)
    c2, l2 = batch_of(rights + [b""] * (B - len(rights)), L)
    kw = dict(k=idx.k, max_hits_per_strand=26, expand_budget=512, max_out=32)
    ref = RefMapper(idx, RefConfig(**kw))
    nv = ref_dp.split_valid(len(lefts), N_DEV, per)
    want = jax.tree.map(np.asarray, ref_dp.map_batch_pe_dp(
        ref.didx, ref.st, c1, l1, c2, l2, nv, ref.cfg, ref_dp.make_mesh(N_DEV)))

    port = QuasiMapper(index_from_reference(vars(idx)), MapConfig(**kw), device="cpu")
    t = [torch.from_numpy(x) for x in (c1, l1.astype(np.int64), c2, l2.astype(np.int64))]
    got = dp.map_batch_pe_dp(port.didx, port.st, *t, nv, port.cfg, _mesh())
    for w, g in zip(want, got):
        _same(w, g)
    single = port.map_pe(c1, l1, c2, l2, n_valid=len(lefts))
    for s, g in zip(single, got):
        _same(s, g)
    assert got[2].concordant.any() and int(got[3].reads_mapped) > 0


@pytest.mark.parametrize("n_valid,n_dev,per", [
    (0, 4, 8), (1, 4, 8), (8, 4, 8), (9, 4, 8), (31, 4, 8), (32, 4, 8), (40, 4, 8),
    (61, 8, 8), (5, 1, 16), (3, 3, 1),
])
def test_split_valid_matches_reference(n_valid, n_dev, per):
    want = ref_dp.split_valid(n_valid, n_dev, per)
    got = dp.split_valid(n_valid, n_dev, per)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """The default mesh is every CUDA device and never the CPU; a list may
    repeat a device, and its replicas share one upload."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.make_mesh()
    mesh = dp.make_mesh(3, devices=["cpu"] * 4)
    assert mesh == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="replicas"):
        dp.make_mesh(5, devices=["cpu"] * 4)
