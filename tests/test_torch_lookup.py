"""The k-mer probes and device uploads of rapmap_tpu_torch against rapmap_tpu
on the CPU, integer for integer (tolerance zero): `kmer_lookup` in each of
its three modes (canonical-class CHD, legacy per-strand CHD, prefix-LUT
binary search) on every table key plus 256 alien keys; the CHD probe against
the binary search (tests/test_chd.py); the poly-T k = 32 sentinel
(tests/test_round3_fixes.py); `chd_query_np` and `attach_chd`; the read
encoders of the charwise path; and every tensor of the full, lean,
legacy-CHD and big-SA uploads, each within `device_bytes_estimate`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.index.chd import attach_chd as ref_attach_chd
from rapmap_tpu.index.chd import build_chd as ref_build_chd
from rapmap_tpu.index.chd import chd_query_np as ref_chd_query_np
from rapmap_tpu.index.chd import key64_of, rc_key64_np
from rapmap_tpu.ops import encode as rdenc
from rapmap_tpu.ops import lookup as rlookup
from rapmap_tpu.ops.device_index import DeviceQuasiIndex as RefDeviceIndex
from rapmap_tpu.ops.device_index import EngineStatic as RefStatic
from rapmap_tpu.ops.device_index import upload_index as ref_upload
from rapmap_tpu_torch.index.chd import attach_chd, chd_query_np
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.ops import encode as denc
from rapmap_tpu_torch.ops.device_index import (
    DeviceQuasiIndex, EngineStatic, device_bytes_estimate, upload_index,
)
from rapmap_tpu_torch.ops.lookup import _chd_lookup, _prefix_of, kmer_lookup
from tests.test_chd import _key_space
from tests.test_device_parity import batch_of
from tests.util import random_transcriptome, sample_reads, toy_index, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

M32 = 0xFFFFFFFF


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def legacy_chd(idx):
    """A copy of the index with a per-strand (not canonical) CHD over its
    k-mer rows, as indexes built before the canonical CHD carry."""
    chd = ref_build_chd(np.asarray(idx.kmer_hi, np.uint32), np.asarray(idx.kmer_lo, np.uint32),
                        seed0=idx.seed + 1)
    assert chd is not None
    meta = dict(idx.meta, chd={k: chd[k] for k in ("seed", "m_bits", "t_bits", "p_bits")})
    return dataclasses.replace(idx, chd_dir=chd["dir"], chd_perm=chd["perm"], chd_cls=None,
                               meta=meta)


def without_chd(idx):
    meta = {k: v for k, v in idx.meta.items() if k != "chd"}
    return dataclasses.replace(idx, chd_dir=None, chd_perm=None, chd_cls=None, meta=meta)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(66)
    idx, txps = toy_index(tmp_path_factory.mktemp("lk"), rng, n_txps=12, min_len=100,
                          max_len=400)
    assert idx.meta["chd"]["canonical"]
    ahi, alo = _key_space(idx, rng, 256)
    qhi = np.concatenate([np.asarray(idx.kmer_hi, np.uint32), ahi])
    qlo = np.concatenate([np.asarray(idx.kmer_lo, np.uint32), alo])
    return idx, txps, qhi, qlo


def _lookup_pair(idx, mode, qhi, qlo):
    """(reference (found, b, e), port (found, b, e)) of one probe mode."""
    if mode == "legacy_chd":
        idx = legacy_chd(idx)
    rdidx, rst = ref_upload(idx)
    didx, st = upload_index(index_from_reference(vars(idx)), "cpu")
    if mode == "binary_search":
        rst = RefStatic.for_index(idx, use_chd=False)
        st = EngineStatic.for_index(index_from_reference(vars(idx)), use_chd=False)
    assert st.use_chd == (mode != "binary_search")
    assert st.chd_canonical == (mode != "legacy_chd")
    want = rlookup.kmer_lookup(rdidx, rst, jnp.asarray(qhi), jnp.asarray(qlo))
    got = kmer_lookup(didx, st, t_(qhi.astype(np.int64)), t_(qlo.astype(np.int64)))
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("mode", ["canonical_chd", "legacy_chd", "binary_search"])
def test_kmer_lookup_equals_reference(world, mode):
    idx, _, qhi, qlo = world
    want, got = _lookup_pair(idx, mode, qhi, qlo)
    for name, w, g in zip(("found", "b", "e"), want, got):
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), name
    n = len(idx.kmer_b)
    assert got[0][:n].all() and not got[0][n:].any()


def test_chd_lookup_matches_binary_search(world):
    """Twin of tests/test_chd.py::test_chd_device_lookup_matches_binary_search."""
    idx, _, qhi, qlo = world
    pidx = index_from_reference(vars(idx))
    didx, st = upload_index(pidx, "cpu")
    st_bs = EngineStatic.for_index(pidx, use_chd=False)
    assert st.use_chd and not st_bs.use_chd
    keys = t_(qhi.astype(np.int64)), t_(qlo.astype(np.int64))
    f_chd, b_chd, e_chd = (x.numpy() for x in kmer_lookup(didx, st, *keys))
    f_bs, b_bs, e_bs = (x.numpy() for x in kmer_lookup(didx, st_bs, *keys))
    assert np.array_equal(f_chd, f_bs)
    assert np.array_equal(b_chd, b_bs) and np.array_equal(e_chd, e_bs)
    n = len(idx.kmer_b)
    assert f_chd[:n].all() and not f_chd[n:].any()
    assert np.array_equal(b_chd[:n], np.asarray(idx.kmer_b))
    assert np.array_equal(e_chd[:n], np.asarray(idx.kmer_e))


def test_binary_search_needs_full_upload(world):
    idx, _, qhi, qlo = world
    didx, _ = upload_index(index_from_reference(vars(idx)), "cpu", lean=True)
    st = EngineStatic.for_index(idx, use_chd=False)
    with pytest.raises(ValueError, match="full upload"):
        kmer_lookup(didx, st, t_(qhi.astype(np.int64)), t_(qlo.astype(np.int64)))


def test_chd_sentinel_poly_t_k32():
    """Twin of tests/test_round3_fixes.py::test_chd_sentinel_poly_t_k32: a
    probe for the absent all-T k-mer (key == the empty-slot sentinel at
    k = 32) does not hit a sentinel row; a real row still does."""
    m_bits, t_bits = 4, 4
    sentinel = np.tile(np.array([-1, -1, 0, 0], np.int32), (1 << t_bits, 1))
    real = np.tile(np.array([-1, -1, 3, 9], np.int32), (1 << t_bits, 1))
    st = EngineStatic(k=32, prefix_bases=4, lookup_steps=1, pad_tail=64, use_chd=True,
                      chd_seed=7, chd_m_bits=m_bits, chd_t_bits=t_bits, chd_canonical=False)
    rst = RefStatic(**dataclasses.asdict(st))
    ones = np.full(8, M32, np.uint32)
    for rows, hit in ((sentinel, False), (real, True)):
        didx = DeviceQuasiIndex(text2q=torch.zeros((4, 4), dtype=torch.int32),
                                sa_meta=torch.zeros((4, 2), dtype=torch.int32),
                                sa_cmp=torch.zeros((4, 6), dtype=torch.int32),
                                chd_dir=torch.zeros(1 << m_bits, dtype=torch.int32),
                                chd_rows=t_(rows))
        rdidx = RefDeviceIndex(text2q=jnp.zeros((4, 4), jnp.uint32),
                               sa_meta=jnp.zeros((4, 2), jnp.int32),
                               chd_dir=jnp.zeros(1 << m_bits, jnp.int32),
                               chd_rows=jnp.asarray(rows))
        found, b, e = _chd_lookup(didx, st, t_(ones.astype(np.int64)), t_(ones.astype(np.int64)))
        rf, rb, re = _chd_lookup_ref(rdidx, rst, ones)
        assert bool(found.all()) == hit and bool(found.any()) == hit
        assert np.array_equal(found.numpy(), rf)
        assert np.array_equal(b.numpy(), rb) and np.array_equal(e.numpy(), re)
    assert b.tolist() == [3] * 8 and e.tolist() == [9] * 8


def _chd_lookup_ref(rdidx, rst, keys):
    return [np.asarray(x) for x in rlookup._chd_lookup(rdidx, rst, jnp.asarray(keys),
                                                       jnp.asarray(keys))]


def test_chd_width_test_wraps_in_int32():
    """A row whose b and e are uint32 bit patterns straddling 2^31 (as
    big-occ tables carry): the reference takes the width e - b in int32, the
    port reads b and e as their uint32 values, so both find the row with
    width 5; the bounds equal the reference's modulo 2^32."""
    st = EngineStatic(k=11, prefix_bases=4, lookup_steps=1, pad_tail=64, use_chd=True,
                      chd_seed=3, chd_m_bits=2, chd_t_bits=2, chd_canonical=False)
    rows = np.tile(np.array([0, 5, 2**31 - 2, -(2**31) + 3], np.int32), (4, 1))
    didx = DeviceQuasiIndex(text2q=torch.zeros((4, 4), dtype=torch.int32),
                            sa_meta=torch.zeros((4, 2), dtype=torch.int32),
                            sa_cmp=torch.zeros((4, 6), dtype=torch.int32),
                            chd_dir=torch.zeros(4, dtype=torch.int32), chd_rows=t_(rows))
    rdidx = RefDeviceIndex(text2q=jnp.zeros((4, 4), jnp.uint32),
                           sa_meta=jnp.zeros((4, 2), jnp.int32),
                           chd_dir=jnp.zeros(4, jnp.int32), chd_rows=jnp.asarray(rows))
    lo = np.full(3, 5, np.uint32)
    hi = np.zeros(3, np.uint32)
    found, b, e = _chd_lookup(didx, st, t_(hi.astype(np.int64)), t_(lo.astype(np.int64)))
    rf, rb, re = [np.asarray(x) for x in rlookup._chd_lookup(
        rdidx, RefStatic(**dataclasses.asdict(st)), jnp.asarray(hi), jnp.asarray(lo))]
    assert rf.all() and np.array_equal(found.numpy(), rf)
    assert (b == 2**31 - 2).all() and (e == 2**31 + 3).all()
    assert np.array_equal(b.numpy(), rb.astype(np.int64) & 0xFFFFFFFF)
    assert np.array_equal(e.numpy(), re.astype(np.int64) & 0xFFFFFFFF)


def test_chd_query_np_and_attach_chd(world, tmp_path):
    """The numpy probe model returns the reference's rows, and attach_chd
    upgrades an index without a CHD (and a legacy one) to the canonical CHD
    the reference attaches, saved and reloaded alike."""
    idx, _, qhi, qlo = world
    chd = idx.meta["chd"]
    key64 = key64_of(idx.kmer_hi, idx.kmer_lo)
    can64 = np.minimum(key64, rc_key64_np(key64, idx.k))
    chi = (can64 >> np.uint64(32)).astype(np.uint32)
    clo = (can64 & np.uint64(M32)).astype(np.uint32)
    for hi, lo in ((chi, clo), (qhi, qlo)):
        args = (hi, lo, np.asarray(idx.chd_dir), np.asarray(idx.chd_perm), chd["seed"],
                chd["m_bits"], chd["t_bits"], chd.get("p_bits", 0))
        assert np.array_equal(chd_query_np(*args), ref_chd_query_np(*args))
    for make in (without_chd, legacy_chd):
        ref = make(idx)
        port = index_from_reference(vars(make(idx)))
        assert ref_attach_chd(ref) and attach_chd(port, str(tmp_path / make.__name__))
        for name in ("chd_dir", "chd_perm", "chd_cls"):
            assert np.array_equal(np.asarray(getattr(port, name)), np.asarray(getattr(ref, name)))
        assert port.meta["chd"] == ref.meta["chd"] and port.meta["chd"]["canonical"]
    from rapmap_tpu_torch.index.format import load_index

    back = load_index(str(tmp_path / "legacy_chd"))
    assert np.array_equal(np.asarray(back.chd_cls), np.asarray(idx.chd_cls))
    assert attach_chd(back)  # already canonical: nothing to do


def test_read_encoders_equal_reference(world):
    """revcomp_batch (left-aligned, NCODE pad), kmer_keys_batch (charwise
    keys) and _prefix_of on reads with Ns, mixed lengths and pad columns."""
    idx, txps, _, _ = world
    rng = np.random.default_rng(3)
    seqs = [r[1] for r in sample_reads(rng, txps, 20, read_len=int(rng.integers(11, 60)),
                                       error_rate=0.03, n_frac=0.05)]
    seqs += [b"ACGTN" * 6, b"ACG", b""]
    codes, lens = batch_of(seqs + [r[1] for r in sample_reads(rng, txps, 6, read_len=40)], 60)
    rc = denc.revcomp_batch(t_(codes), t_(lens.astype(np.int64)))
    assert rc.dtype == torch.int8
    assert np.array_equal(rc.numpy(), np.asarray(rdenc.revcomp_batch(jnp.asarray(codes),
                                                                      jnp.asarray(lens))))
    for k in (11, 16, 31):
        want = rdenc.kmer_keys_batch(jnp.asarray(codes), k)
        got = denc.kmer_keys_batch(t_(codes), k)
        for name, w, g in zip(("hi", "lo", "valid"), want, got):
            assert np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64)), \
                (k, name)
        hi, lo = np.asarray(want[0]), np.asarray(want[1])
        for p in (4, 8, 11):
            if p <= k:
                w = np.asarray(rlookup._prefix_of(jnp.asarray(hi), jnp.asarray(lo), k, p))
                g = _prefix_of(t_(hi.astype(np.int64)), t_(lo.astype(np.int64)), k, p)
                assert np.array_equal(g.numpy(), w.astype(np.int64)), (k, p)


def _bigsa_index(tmp_path):
    rng = np.random.default_rng(9)
    txps = random_transcriptome(rng, n_txps=4, min_len=100, max_len=200)
    idx = ref_build(write_fasta(str(tmp_path / "big.fa"), txps), k=11, big_sa=True)
    assert np.asarray(idx.sa).dtype == np.int64
    return idx


UPLOADS = {
    # kind: (index maker, lean, meta_pairs)
    "full": (lambda w, tp: w, False, False),
    "full_meta_pairs": (lambda w, tp: w, False, True),
    "lean": (lambda w, tp: w, True, False),
    "no_chd": (lambda w, tp: without_chd(w), False, False),
    "legacy_chd": (lambda w, tp: legacy_chd(w), False, False),
    "legacy_chd_lean": (lambda w, tp: legacy_chd(w), True, False),
    "big_sa": (lambda w, tp: _bigsa_index(tp), False, False),
}


@pytest.mark.parametrize("kind", list(UPLOADS))
def test_upload_kinds_equal_reference(world, tmp_path, kind):
    """Every tensor of the upload equals the reference's array, int32 for
    int32 (text int8), None where the reference's is None; the bytes
    uploaded never exceed device_bytes_estimate for that upload."""
    make, lean, meta_pairs = UPLOADS[kind]
    idx = make(world[0], tmp_path)
    rdidx, rst = ref_upload(idx, lean=lean, meta_pairs=meta_pairs)
    didx, st = upload_index(index_from_reference(vars(idx)), "cpu", lean=lean,
                            meta_pairs=meta_pairs)
    assert dataclasses.asdict(st) == dataclasses.asdict(rst)
    for name in didx._fields:
        got, want = getattr(didx, name), getattr(rdidx, name)
        assert (got is None) == (want is None), name
        if got is None:
            continue
        want = np.asarray(want)
        dtype = np.int8 if name == "text" else np.int32
        assert got.numpy().dtype == dtype and got.device.type == "cpu", name
        assert np.array_equal(got.numpy(), want.view(dtype)), name
    if kind == "big_sa":  # twin of tests/test_bigsa.py::test_bigsa_upload_drops_flat_arrays
        assert didx.sa is None and didx.text is None
        assert didx.sa_ext.shape == (len(idx.sa), 3)
    if kind.startswith("legacy"):
        assert didx.chd_rows.shape[1] == 4
    used = sum(t.numel() * t.element_size() for t in didx if t is not None)
    assert used <= device_bytes_estimate(idx, lean=lean)
    if not lean and kind != "big_sa":
        assert didx.text is not None and didx.sa is not None


def test_lean_upload_needs_a_chd(world):
    with pytest.raises(ValueError, match="lean upload requires"):
        upload_index(index_from_reference(vars(without_chd(world[0]))), "cpu", lean=True)


def test_estimate_counts_full_upload_without_chd(world):
    """Without a CHD the estimate is the full upload's (what QuasiMapper
    uploads), which the lean estimate of the same arrays undercounts."""
    idx = without_chd(world[0])
    full = device_bytes_estimate(idx)
    assert full == device_bytes_estimate(idx, lean=False) > device_bytes_estimate(idx, lean=True)
    n = len(idx.sa)
    extra = (len(idx.kmer_b) * 16 + (len(idx.prefix_lut) - 1) * 8 + n * 12 + len(idx.text)
             + n * 4)
    assert full - device_bytes_estimate(idx, lean=True) == extra
