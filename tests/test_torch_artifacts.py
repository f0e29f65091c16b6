"""The port's compact index artifacts (rapmap_tpu_torch.index.format: the
core artifact, index_type quasi_core, and the mapping-only one, quasi_map)
against the reference's: twins of tests/test_core_index.py and
tests/test_mapping_index.py on their worlds, the same content hashes for the
same index, each package loading what the other writes, and the port's
staged engine (on the CPU) mapping from either artifact as the reference's
staged engine maps from the full index."""

import json
import os

import numpy as np
import pytest

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index import format as rfmt
from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.parallel.staged import StagedMapper as RefStaged
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index import format as fmt
from rapmap_tpu_torch.index.builder import build_quasi_index
from rapmap_tpu_torch.index.format import (
    MappingQuasiIndex, QuasiIndex, index_from_reference, load_index, save_core_index,
    save_mapping_index,
)
from rapmap_tpu_torch.parallel.staged import StagedMapper
from tests.test_device_parity import batch_of
from tests.test_torch_staged import _one_thread  # noqa: F401
from tests.util import random_transcriptome, sample_reads, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

_DERIVED = ["text2b", "sa_txp", "sa_tpos", "kmer_hi", "kmer_lo",
            "kmer_b", "kmer_e", "prefix_lut"]


def _world(tmp, seed):
    """tests/test_core_index.py's and test_mapping_index.py's world: 6
    transcripts of 150-300 bp, k = 11, 32 reads of 40 bp with 3% errors and
    2% Ns; the port's build of it and the reference's."""
    rng = np.random.default_rng(seed)
    txps = random_transcriptome(rng, n_txps=6, min_len=150, max_len=300)
    fa = write_fasta(str(tmp / "t.fa"), txps)
    reads = [r[1] for r in sample_reads(rng, txps, 32, read_len=40, error_rate=0.03,
                                        n_frac=0.02)]
    codes, _ = batch_of(reads, 40)
    return build_quasi_index(fa, k=11), ref_build(fa, k=11), codes


def _staged(idx, codes, ref=False):
    """The staged engine's records of one batch, 3 shards, on the CPU."""
    if ref:
        sm = RefStaged(idx, RefConfig(k=idx.k, max_hits_per_strand=8), n_shards=3,
                       read_len=40, batch=len(codes))
    else:
        sm = StagedMapper(idx, MapConfig(k=idx.k, max_hits_per_strand=8), n_shards=3,
                          read_len=40, batch=len(codes), device="cpu")
    return sm.map_batches([codes])[0]


@pytest.fixture(scope="module")
def core_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tcore")
    idx, ridx, codes = _world(tmp, 91)
    info = save_core_index(idx, str(tmp / "core"))
    rinfo = rfmt.save_core_index(ridx, str(tmp / "ref_core"))
    return idx, ridx, str(tmp / "core"), str(tmp / "ref_core"), info, rinfo, codes


@pytest.fixture(scope="module")
def map_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tmap")
    idx, ridx, codes = _world(tmp, 81)
    info = save_mapping_index(idx, str(tmp / "map"))
    rinfo = rfmt.save_mapping_index(ridx, str(tmp / "ref_map"))
    want = _staged(ridx, codes, ref=True)
    return idx, ridx, str(tmp / "map"), str(tmp / "ref_map"), info, rinfo, codes, want


def _header(d):
    with open(os.path.join(d, "header.json")) as f:
        h = json.load(f)
    h.pop("tool_version")
    return h


def test_core_roundtrip_bitexact(core_world):
    idx, ridx, cdir, rdir, info, rinfo, _ = core_world
    assert info == rinfo
    assert _header(cdir) == _header(rdir)  # the reference's hashes for the same index
    for src in (cdir, rdir):  # the port's own artifact and the reference's
        got = load_index(src)
        assert isinstance(got, QuasiIndex)
        for name in ["text", "sa", "txp_offsets", "txp_lens"] + _DERIVED:
            a, b = np.asarray(getattr(got, name)), np.asarray(getattr(idx, name))
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.dtype == b.dtype, name
        assert got.txp_names == idx.txp_names
        for n in ("chd_dir", "chd_perm", "chd_cls"):
            np.testing.assert_array_equal(np.asarray(getattr(got, n)),
                                          np.asarray(getattr(idx, n)))
    # the reference loads the port's artifact
    back = rfmt.load_index(cdir)
    for name in ["sa", "kmer_b", "kmer_e", "prefix_lut"]:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(ridx, name)))
    derived_bytes = sum(np.asarray(getattr(idx, n)).nbytes for n in _DERIVED)
    assert info["bytes"] < derived_bytes + idx.text.nbytes
    assert np.load(os.path.join(cdir, "sa.npy"), mmap_mode="r").dtype == np.uint32


def test_core_big_sa_roundtrip(tmp_path):
    rng = np.random.default_rng(92)
    txps = random_transcriptome(rng, n_txps=3, min_len=120, max_len=200)
    fa = write_fasta(str(tmp_path / "t.fa"), txps)
    idx = build_quasi_index(fa, k=11, big_sa=True)
    assert np.asarray(idx.sa).dtype == np.int64
    save_core_index(idx, str(tmp_path / "core"))
    rfmt.save_core_index(ref_build(fa, k=11, big_sa=True), str(tmp_path / "ref"))
    assert _header(str(tmp_path / "core")) == _header(str(tmp_path / "ref"))
    for d in ("core", "ref"):
        ridx = load_index(str(tmp_path / d))
        assert np.asarray(ridx.sa).dtype == np.int64
        np.testing.assert_array_equal(np.asarray(ridx.sa), np.asarray(idx.sa))


def test_core_staged_mapping_parity(core_world):
    """The staged engine on the core artifact's reload equals it on the full
    index, and the reference's staged engine on its own build."""
    idx, ridx, cdir, _, _, _, codes = core_world
    want = _staged(ridx, codes, ref=True)
    assert _staged(idx, codes) == want
    assert _staged(load_index(cdir), codes) == want


def test_core_corrupt_stored_fails(core_world):
    cdir = core_world[2]
    path = os.path.join(cdir, "sa.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-5] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    try:
        with pytest.raises(ValueError, match="content-hash"):
            load_index(cdir)
        with pytest.raises(ValueError, match="content-hash"):
            rfmt.load_index(cdir)
    finally:
        raw[-5] ^= 0xFF
        open(path, "wb").write(bytes(raw))


def test_core_reconstruction_mismatch_fails(core_world):
    """A derived-array hash that no longer matches (a header edit stands in
    for a derivation fault) refuses to map, naming the array."""
    cdir = core_world[2]
    hpath = os.path.join(cdir, "header.json")
    orig = open(hpath).read()
    h = json.loads(orig)
    h["hashes"]["kmer_hi"] = "0" * 16
    open(hpath, "w").write(json.dumps(h))
    try:
        with pytest.raises(ValueError, match="reconstruction of kmer_hi"):
            load_index(cdir)
    finally:
        open(hpath, "w").write(orig)


def test_artifact_smaller_and_verifies(map_world):
    idx, ridx, mdir, rdir, info, rinfo, _, _ = map_world
    assert info == rinfo
    assert _header(mdir) == _header(rdir)
    for d in (mdir, rdir):
        midx = load_index(d, verify=True)
        assert isinstance(midx, MappingQuasiIndex)
        assert np.asarray(midx.sa).dtype == np.uint32
        assert np.asarray(midx.kmer_w).dtype == np.uint32
        np.testing.assert_array_equal(midx.kmer_e[0 : len(idx.kmer_b)],
                                      np.asarray(idx.kmer_e, dtype=np.int64))
        assert len(midx.text) == len(idx.text)
    assert isinstance(rfmt.load_index(mdir, verify=True), rfmt.MappingQuasiIndex)
    full_bytes = idx.text.nbytes + idx.sa.nbytes + idx.kmer_b.nbytes + idx.kmer_e.nbytes
    pruned = sum(info["per_array"][n] for n in ("sa", "kmer_b", "kmer_w"))
    assert pruned < full_bytes


def test_staged_parity_full_vs_mapping_artifact(map_world):
    """The port's staged engine on either package's artifact equals the
    reference's staged engine on the full index."""
    idx, _, mdir, rdir, _, _, codes, want = map_world
    assert _staged(idx, codes) == want
    assert _staged(load_index(mdir), codes) == want
    assert _staged(load_index(rdir), codes) == want


def test_mapping_score_refused_on_artifact(map_world):
    mdir, codes = map_world[2], map_world[6]
    midx = load_index(mdir)
    with pytest.raises(ValueError, match="mapping-only"):
        StagedMapper(midx, MapConfig(k=midx.k, mapping_score=True), n_shards=2,
                     read_len=40, batch=len(codes), device="cpu")


def test_corrupt_artifact_fails_hash(map_world):
    mdir = map_world[2]
    path = os.path.join(mdir, "kmer_w.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-5] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    try:
        for load in (load_index, rfmt.load_index):
            with pytest.raises(ValueError, match="content-hash"):
                load(mdir, verify=True)
    finally:
        raw[-5] ^= 0xFF
        open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("kind", ["quasi_map", "quasi_core"])
def test_artifacts_of_a_reference_index(tmp_path, kind):
    """An index the reference built, carried over with index_from_reference,
    writes the artifact the reference writes for it, byte for byte."""
    rng = np.random.default_rng(93)
    fa = write_fasta(str(tmp_path / "t.fa"),
                     random_transcriptome(rng, n_txps=4, min_len=150, max_len=250))
    ridx = ref_build(fa, k=11)
    save = dict(quasi_map=(save_mapping_index, rfmt.save_mapping_index),
                quasi_core=(save_core_index, rfmt.save_core_index))[kind]
    save[0](index_from_reference(vars(ridx)), str(tmp_path / "port"))
    save[1](ridx, str(tmp_path / "ref"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        if n != "header.json":
            with open(tmp_path / "port" / n, "rb") as a, open(tmp_path / "ref" / n, "rb") as b:
                assert a.read() == b.read(), n
    assert _header(str(tmp_path / "port")) == _header(str(tmp_path / "ref"))
    assert _header(str(tmp_path / "port"))["index_type"] == kind


def test_format_copies_reference_layout():
    """The artifact array lists are the reference's."""
    assert fmt._QUASI_MAP_ARRAYS == rfmt._QUASI_MAP_ARRAYS
    assert fmt._QUASI_OPTIONAL == rfmt._QUASI_OPTIONAL
