"""rapmap_tpu_torch collation against rapmap_tpu: the same ScanHits through
both `_collate_core` and `collate_records_se` give equal CollateCore fields,
records and flags over a config sweep, and through `collate_batch` the same
slotted MapOut (exact equality: all integers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.ops import collate as rcol
from rapmap_tpu.ops.device_index import upload_index as ref_upload
from rapmap_tpu.ops.mmp import ScanHits as RefHits
from rapmap_tpu.ops.wire import rec_spec_se as ref_rec_spec
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.ops import collate as col
from rapmap_tpu_torch.ops.device_index import upload_index
from rapmap_tpu_torch.ops.mmp import scan_dispatch
from rapmap_tpu_torch.ops.wire import rec_spec_se
from tests.test_device_parity import batch_of
from tests.util import BASES, sample_reads, toy_index

B = 64  # reads; with expand_budget 8 the voting pool is 512, a power of two


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(13)
    idx, txps = toy_index(tmp_path_factory.mktemp("col"), rng, n_txps=6, min_len=120,
                          max_len=260, k=11, shared_prefix=50)
    seqs = [r[1] for r in sample_reads(rng, txps, B - 6, read_len=50, error_rate=0.04,
                                       n_frac=0.01)]
    chim = txps[0][1][10:35] + txps[1][1][50:75]
    seqs += [chim, txps[2][1][:50], b"N" * 50]
    seqs += [BASES[rng.integers(0, 4, 50)].tobytes() for _ in range(3)]
    codes, lens = batch_of(seqs, 50)
    return idx, codes, lens


SWEEP = {
    "default": dict(),
    "c": dict(consistent_hits=True),
    "c_f": dict(consistent_hits=True, fuzzy=True),
    "s": dict(strict_check=True),
    "s_c": dict(strict_check=True, consistent_hits=True),
    "z0.5": dict(quasi_coverage=0.5),
    "m2": dict(max_num_hits=2),
    "bitonic": dict(bitonic_sort=True),
    "pairs": dict(expand_pairs=True),
    "pairs_bitonic": dict(expand_pairs=True, bitonic_sort=True),
    "exhausted_pool": dict(expand_budget=1),
}
# EngineStatic overrides that take the reference's other key layouts:
# n_txps = 0 -> unpacked 3-key vote sort; a huge max_tpos -> packed keys but
# the 4-key group sort (sb + pb > 31)
ST = {"unpacked_keys": dict(n_txps=0), "group_sort": dict(max_tpos=1 << 26)}


@pytest.mark.parametrize(
    "name",
    list(SWEEP) + list(ST) + ["records_unpacked", "records_over_cap"],
)
def test_collate_parity(world, name):
    idx, codes, lens = world
    kw = dict(k=idx.k, max_hits_per_strand=8, expand_budget=8)
    kw.update(SWEEP.get(name, {}))
    cfg = MapConfig(**kw)
    rcfg = RefConfig(**kw)
    rdidx, rst = ref_upload(idx, lean=True, meta_pairs=cfg.expand_pairs)
    didx, st = upload_index(index_from_reference(vars(idx)), "cpu",
                            meta_pairs=cfg.expand_pairs)
    if name in ST:
        st = dataclasses.replace(st, **ST[name])
        rst = dataclasses.replace(rst, **ST[name])
    cap = 8 if name == "records_over_cap" else cfg.rec_slots * B
    spec = None if name == "records_unpacked" else rec_spec_se(st, cfg)
    rspec = None if spec is None else ref_rec_spec(rst, rcfg)

    hits = scan_dispatch(didx, st, torch.from_numpy(codes),
                         torch.from_numpy(lens.astype(np.int64)), cfg)
    rhits = RefHits(*(jnp.asarray(h.numpy().astype(
        bool if h.dtype == torch.bool else np.int32)) for h in hits))

    def ref_fn(d, h, ln):
        core = rcol._collate_core(d, rst, h, ln, rcfg)
        return core, rcol.collate_records_se(d, rst, h, ln, rcfg, cap, rec_spec=rspec)

    rcore, (rse, rflags) = jax.jit(ref_fn)(rdidx, rhits, jnp.asarray(lens))
    lt = torch.from_numpy(lens.astype(np.int64))
    core = col._collate_core(didx, st, hits, lt, cfg)
    se, flags = col.collate_records_se(didx, st, hits, lt, cfg, cap, rec_spec=spec)

    for part, got, want in (("core", core, rcore), ("se", se, rse), ("flags", flags, rflags)):
        for f in want._fields:
            g = getattr(got, f).numpy().astype(np.int64)
            w = np.asarray(getattr(want, f)).astype(np.int64)
            assert g.shape == w.shape and np.array_equal(g, w), f"{part}.{f}"
    if name == "exhausted_pool":
        assert np.asarray(rflags.over_budget).any()
    if name == "bitonic":
        assert core.keep.shape[0] == 8 * B
    if name == "records_over_cap":
        assert bool(se.overflowed)


@pytest.mark.parametrize("name", ["default", "m2", "s_c", "pairs", "exhausted_pool",
                                  "one_out_slot"])
def test_collate_batch_parity(world, name):
    """`collate_batch`: winners in the (B, MAX_OUT) MapOut layout, with
    max_out = 1 cutting multimappers (out_truncated)."""
    idx, codes, lens = world
    kw = dict(k=idx.k, max_hits_per_strand=8, expand_budget=8, max_out=8)
    kw.update(SWEEP.get(name, {}))
    if name == "one_out_slot":
        kw["max_out"] = 1
    cfg, rcfg = MapConfig(**kw), RefConfig(**kw)
    rdidx, rst = ref_upload(idx, lean=True, meta_pairs=cfg.expand_pairs)
    didx, st = upload_index(index_from_reference(vars(idx)), "cpu",
                            meta_pairs=cfg.expand_pairs)
    lt = torch.from_numpy(lens.astype(np.int64))
    hits = scan_dispatch(didx, st, torch.from_numpy(codes), lt, cfg)
    rhits = RefHits(*(jnp.asarray(h.numpy().astype(
        bool if h.dtype == torch.bool else np.int32)) for h in hits))
    want = jax.jit(lambda d, h, ln: rcol.collate_batch(d, rst, h, ln, rcfg))(
        rdidx, rhits, jnp.asarray(lens))
    got = col.collate_batch(didx, st, hits, lt, cfg)
    assert got.t.dtype == torch.int32 and got.t.shape == (B, cfg.out_slots)
    for f in want._fields:
        g = getattr(got, f).numpy().astype(np.int64)
        w = np.asarray(getattr(want, f)).astype(np.int64)
        assert g.shape == w.shape and np.array_equal(g, w), f
    assert np.asarray(want.mapped).any()
    if name == "one_out_slot":
        assert np.asarray(want.out_truncated).any()
    if name == "m2":
        assert np.asarray(want.too_ambiguous).any()
    if name == "exhausted_pool":
        assert np.asarray(want.over_budget).any()
