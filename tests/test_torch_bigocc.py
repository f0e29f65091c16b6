"""The big-occ pseudo layout of rapmap_tpu_torch (occurrence pair rows,
occurrence ids as uint32 values): twins of tests/test_bigocc.py's three cases
on the port (the layout bit-exact against the narrow one, and both against
rapmap_tpu), and the probes' wrap-safe interval widths: a class row whose
interval straddles 2^31 (the ids a big-occ table carries as int32 bit
patterns) is found by the port's canonical, legacy-CHD and binary-search
probes, as by the reference's, with the same bounds modulo 2^32."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.models import pseudo as ref_pseudo
from rapmap_tpu.models.pseudo import PseudoMapper as RefMapper
from rapmap_tpu.ops import lookup as ref_lookup
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.builder import build_pseudo_index
from rapmap_tpu_torch.models import pseudo
from rapmap_tpu_torch.models.pseudo import PseudoMapper
from rapmap_tpu_torch.ops import lookup
from tests.test_device_parity import batch_of
from tests.util import random_transcriptome, sample_reads, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(21)
    base = random_transcriptome(rng, n_txps=5, min_len=150, max_len=250)
    shared = base[0][1][20:100]
    txps = [(f"t{i}", s[:25] + shared + s[25:]) for i, (_, s) in enumerate(base)]
    fa = write_fasta(str(tmp_path_factory.mktemp("tbigocc") / "t.fa"), txps)
    idx = build_pseudo_index(fa, k=11)
    reads = [r[1] for r in sample_reads(rng, txps, 32, read_len=40, error_rate=0.02)]
    return idx, reads


def test_bigocc_layout_bitexact(world):
    """Twin of test_bigocc.py::test_bigocc_layout_bitexact; both layouts'
    MapOut also equals the reference's."""
    idx, reads = world
    codes, lens = batch_of(reads, 40)
    kw = dict(k=idx.k, max_hits_per_strand=8, expand_budget=64, max_out=32)
    m1 = PseudoMapper(idx, MapConfig(**kw), device="cpu")
    m2 = PseudoMapper(idx, MapConfig(**kw), force_big_occ=True, device="cpu")
    assert not m1.st.occ_pairs and m2.st.occ_pairs
    o1, c1 = m1.map_se(codes, lens)
    o2, c2 = m2.map_se(codes, lens)
    for f, a, b in zip(o1._fields, o1, o2):
        assert np.array_equal(a, b), f"MapOut.{f} differs under big-occ layout"
    for f, a, b in zip(c1._fields, c1, c2):
        assert np.array_equal(a, b), f"Counters.{f} differs under big-occ layout"
    ro, _ = RefMapper(idx, RefConfig(**kw), force_big_occ=True).map_se(codes, lens)
    for f, a, b in zip(o2._fields, o2, ro):
        assert np.array_equal(a, np.asarray(b)), f
    assert int(c1.reads_mapped) > 20


def test_bigocc_wire_bitexact(world):
    """Twin of test_bigocc.py::test_bigocc_wire_bitexact; the big-occ wire
    buffer also equals the reference's."""
    idx, reads = world
    codes, lens = batch_of(reads, 40)
    kw = dict(k=idx.k, max_hits_per_strand=8, expand_budget=64, max_out=16, rec_slots=8,
              chunk=16)
    m1 = PseudoMapper(idx, MapConfig(**kw), device="cpu")
    m2 = PseudoMapper(idx, MapConfig(**kw), force_big_occ=True, device="cpu")
    h2 = m2.map_se_async(codes, lens)
    a, b = m1.fetch(m1.map_se_async(codes, lens)), m2.fetch(h2)
    assert np.array_equal(a.recs, b.recs)
    assert np.array_equal(a.counts, b.counts)
    assert a.counters == b.counters
    rm = RefMapper(idx, RefConfig(**kw), force_big_occ=True)
    assert np.array_equal(h2.wire.numpy(), np.asarray(rm.map_se_async(codes, lens)[2]))


def test_no_2pow31_gate_left():
    """Twin of test_bigocc.py::test_no_2pow31_gate_left on the port's
    models/pseudo.py: no NotImplementedError gate at 2^31, only the 2^32
    single-device ceiling."""
    src = inspect.getsource(pseudo)
    assert "NotImplementedError" not in src
    assert "2**32" in src


# ---- wrap-safe interval widths: a row that straddles 2^31 -------------------

K = 11
B_STRADDLE, E_STRADDLE = 2**31 - 2, 2**31 + 3  # width 5


def _i32(v: int) -> int:
    return v - 2**32 if v >= 2**31 else v


def _tables(kind: str):
    """One index table (rows as the reference's int32 bit patterns) holding
    key 1 (AAAAAAAAAAC, its own canonical form) with the straddling interval:
    a 1-slot canonical CHD (m_bits = t_bits = 0), a 1-slot legacy CHD, or a
    1-row k-mer table under a prefix LUT."""
    b, e = _i32(B_STRADDLE), _i32(E_STRADDLE)
    kmer_rows = np.array([[0, 1, b, e]], np.int32)
    lut = np.ones((4**4, 2), np.int32)
    lut[0] = (0, 1)
    chd = dict(use_chd=kind != "binary_search", chd_seed=7, chd_m_bits=0, chd_t_bits=0,
               chd_canonical=kind == "canonical")
    rows = np.array([[0, 1, b, e, 0, 0]], np.int32) if kind == "canonical" else kmer_rows
    tabs = dict(kmer_rows=kmer_rows, lut_rows=lut, occ_rows=np.zeros((1, 2), np.int32))
    if kind != "binary_search":
        tabs.update(chd_dir=np.zeros(1, np.int32), chd_rows=rows)
    st = dict(k=K, prefix_bases=4, lookup_steps=2, **chd)
    return tabs, st


@pytest.mark.parametrize("kind", ["canonical", "legacy_chd", "binary_search"])
def test_probe_finds_interval_straddling_2pow31(kind):
    tabs, st = _tables(kind)
    rdidx = ref_pseudo.DevicePseudoIndex(**{n: jnp.asarray(v) for n, v in tabs.items()})
    rst = ref_pseudo.PseudoStatic(**st)
    didx = pseudo.DevicePseudoIndex(**{n: torch.from_numpy(v) for n, v in tabs.items()})
    pst = pseudo.PseudoStatic(**st)
    keys = np.array([1, 5], np.uint32)  # key 5 is absent
    hi, lo = np.zeros(2, np.uint32), keys
    rhi, rlo = jnp.asarray(hi), jnp.asarray(lo)
    thi, tlo = torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64))
    if kind == "canonical":
        want = ref_lookup.kmer_lookup_2str(rdidx, rst, rhi, rlo)[:3]
        got = lookup.kmer_lookup_2str(didx, pst, thi, tlo)[:3]
    elif kind == "legacy_chd":
        want = ref_lookup._chd_lookup(rdidx, rst, rhi, rlo)
        got = lookup._chd_lookup(didx, pst, thi, tlo)
    else:
        want = ref_lookup.kmer_lookup(rdidx, rst, rhi, rlo)
        got = lookup.kmer_lookup(didx, pst, thi, tlo)
    (rf, rb, re_), (f, b, e) = [tuple(np.asarray(x) for x in t) for t in (want, got)]
    assert rf.tolist() == f.tolist() == [True, False]
    assert (rb[0], re_[0]) == (_i32(B_STRADDLE), _i32(E_STRADDLE))
    assert (b[0], e[0]) == (B_STRADDLE, E_STRADDLE)
    assert np.array_equal(b, rb.astype(np.int64) & M32)
    assert np.array_equal(e, re_.astype(np.int64) & M32)
    assert e[0] - b[0] == 5  # exact width: the anchor test (e - b) <= max_interval holds
