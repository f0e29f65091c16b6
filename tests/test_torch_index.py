"""rapmap_tpu_torch index build, on-disk format and device upload against
rapmap_tpu: same FASTA -> equal arrays; one index directory readable by
both; the lean upload's tensors equal the reference upload's arrays."""

import dataclasses

import numpy as np
import pytest
import torch

from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.index.format import load_index as ref_load
from rapmap_tpu.ops.device_index import upload_index as ref_upload
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.builder import build_quasi_index
from rapmap_tpu_torch.index.format import QuasiIndex, index_from_reference, load_index
from rapmap_tpu_torch.models.quasi import QuasiMapper
from rapmap_tpu_torch.ops.device_index import (
    EngineStatic, device_bytes_estimate, upload_index,
)
from tests.util import random_transcriptome, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401


def assert_index_equal(a, b):
    for f in dataclasses.fields(QuasiIndex):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or isinstance(x, np.ndarray) or hasattr(x, "__array__"):
            assert (x is None) == (y is None), f.name
            if x is not None:
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _fasta(tmp_path, seed, **kw):
    rng = np.random.default_rng(seed)
    txps = random_transcriptome(rng, **kw)
    # non-ACGT letters exercise the builder's seeded random-base replacement,
    # and a repeated sequence its dedup
    name, seq = txps[0]
    txps[0] = (name, seq[:20] + b"NNRY" + seq[24:])
    txps.append(("dup", txps[1][1]))
    return write_fasta(str(tmp_path / "txome.fa"), txps)


@pytest.mark.parametrize(
    "k, kw",
    [
        (11, dict(n_txps=6, min_len=80, max_len=300)),
        (31, dict(n_txps=5, min_len=120, max_len=400, shared_prefix=60)),
    ],
)
def test_builder_equals_reference(tmp_path, k, kw):
    fa = _fasta(tmp_path, k, **kw)
    ref = ref_build(fa, k=k)
    got = build_quasi_index(fa, k=k)
    assert got.meta["chd"]["canonical"]
    assert_index_equal(ref, got)


def test_reference_directory_loads_and_round_trips(tmp_path):
    fa = _fasta(tmp_path, 3, n_txps=5, min_len=100, max_len=250)
    ref = ref_build(fa, str(tmp_path / "ref_idx"), k=15)
    got = load_index(str(tmp_path / "ref_idx"), verify=True)
    assert_index_equal(ref, got)
    # and a directory written by the port loads in the reference
    build_quasi_index(fa, str(tmp_path / "port_idx"), k=15)
    assert_index_equal(ref_load(str(tmp_path / "port_idx"), verify=True), got)


def test_index_from_reference(tmp_path):
    fa = _fasta(tmp_path, 4, n_txps=4, min_len=100, max_len=200)
    ref = ref_build(fa, k=11)
    got = index_from_reference(vars(ref))
    assert isinstance(got, QuasiIndex)
    assert_index_equal(ref, got)


@pytest.mark.parametrize("meta_pairs", [False, True])
def test_upload_equals_reference(tmp_path, meta_pairs):
    """The lean upload; tests/test_torch_lookup.py holds the full, legacy-CHD
    and big-SA uploads."""
    fa = _fasta(tmp_path, 5, n_txps=6, min_len=100, max_len=300)
    ref = ref_build(fa, k=11)
    rdidx, rst = ref_upload(ref, lean=True, meta_pairs=meta_pairs)
    didx, st = upload_index(index_from_reference(vars(ref)), "cpu", lean=True,
                            meta_pairs=meta_pairs)
    assert dataclasses.asdict(st) == dataclasses.asdict(rst)
    assert st == EngineStatic.for_index(ref)
    for name in didx._fields:
        got = getattr(didx, name)
        assert (got is None) == (getattr(rdidx, name) is None), name
        if got is None:
            continue
        want = np.asarray(getattr(rdidx, name))
        assert got.dtype == torch.int32 and got.device.type == "cpu", name
        assert np.array_equal(got.numpy(), want.view(np.int32)), name
    used = sum(t.numel() * t.element_size() for t in didx if t is not None)
    assert used <= device_bytes_estimate(ref)


def test_mapper_maps_index_without_canonical_chd(tmp_path):
    """An index built with with_chd=False maps (the binary-search probe and
    the full upload) and gives the reference's wire buffer."""
    from rapmap_tpu.config import MapConfig as RefConfig
    from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
    from tests.test_device_parity import batch_of
    from tests.util import sample_reads

    rng = np.random.default_rng(6)
    txps = random_transcriptome(rng, n_txps=3, min_len=100, max_len=200)
    fa = write_fasta(str(tmp_path / "txome.fa"), txps)
    idx = build_quasi_index(fa, k=11, with_chd=False)
    assert idx.chd_dir is None
    mapper = QuasiMapper(idx, MapConfig(k=11, chunk=8), device="cpu")
    assert mapper.didx.kmer_rows is not None and mapper.didx.chd_dir is None
    seqs = [r[1] for r in sample_reads(rng, txps, 16, read_len=40, error_rate=0.02)]
    codes, lens = batch_of(seqs, 40)
    got = mapper.map_se_async(codes, lens)
    ref = RefMapper(ref_build(fa, k=11, with_chd=False), RefConfig(k=11, chunk=8))
    want = ref.map_se_async(codes, lens)
    assert np.array_equal(got.wire.numpy(), np.asarray(want[2]))
    assert mapper.fetch(got).counters["reads_mapped"] > 0
