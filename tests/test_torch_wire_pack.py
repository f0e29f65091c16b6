"""The port's wire_in pack (ops/wire.py pack_in_se / pack_in_pe): the native
one-pass pack (native/wire.cpp), the numpy fallback (`_pack_codes_np`, what
runs when the native library cannot load) and the reference's
rapmap_tpu.ops.wire pack give the same bytes, fresh and into a dirty
preallocated buffer, on row-strided code views, codes over the whole int8
range and lens of several dtypes; `PACKS` counts the mate blocks each path
packed; and a mapper's WireResult is the same on either path."""

import numpy as np
import pytest

from rapmap_tpu.ops import wire as rwire
from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.builder import build_quasi_index
from rapmap_tpu_torch.models.quasi import QuasiMapper
from rapmap_tpu_torch.native import bindings
from rapmap_tpu_torch.ops import wire
from tests.test_device_parity import batch_of
from tests.util import random_transcriptome, sample_reads, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

LENS = (1, 3, 4, 5, 7, 8, 9, 31, 76, 101, 150)
LENS_DTYPES = (np.int32, np.int64, np.uint16)
# (L, B, row-strided view, lens dtype): every L at one row and at the
# benchmark's batch, the layouts and lens dtypes taking turns
CASES = [(L, B, (i + j) % 2 == 1, LENS_DTYPES[(i + j) % 3])
         for i, L in enumerate(LENS) for j, B in enumerate((1, 65536))]


def force_numpy(monkeypatch):
    """The library's loader finds nothing: every pack takes the numpy path."""
    monkeypatch.setattr(bindings, "_load", lambda: None)


def mate(rng, B: int, L: int, strided: bool) -> np.ndarray:
    """(B, L) int8 codes, half of them 0..5 (pad, A..T, N) and half over
    the whole int8 range; a column window of a wider pool when strided."""
    W = L + 13 if strided else L
    small = rng.integers(0, 6, (B, W), dtype=np.int8)
    wide = rng.integers(-128, 128, (B, W), dtype=np.int8)
    pool = np.where(rng.random((B, W)) < 0.5, small, wide)
    return pool[:, 5 : 5 + L] if strided else pool


def packs_of(fn, *args):
    """Fresh, and into a dirty preallocated buffer of the right size."""
    fresh = fn(*args)
    dirty = np.random.default_rng(len(fresh)).integers(0, 256, len(fresh), dtype=np.uint8)
    into = fn(*args, out=dirty)
    assert into is dirty
    return fresh, into


@pytest.mark.parametrize("L,B,strided,lens_dt", CASES,
                         ids=[f"L{c[0]}-B{c[1]}-{'strided' if c[2] else 'dense'}-"
                              f"{np.dtype(c[3]).name}" for c in CASES])
def test_pack_equals_reference(L, B, strided, lens_dt, monkeypatch):
    rng = np.random.default_rng(1000 * L + B)
    c1, c2 = mate(rng, B, L, strided), mate(rng, B, L, strided)
    if strided and B > 1 and L > 1:
        assert not c1.flags.c_contiguous
    l1 = rng.integers(0, L + 1, B).astype(lens_dt)
    l2 = rng.integers(0, L + 1, B).astype(lens_dt)
    nv = B - 1  # n_valid < B
    want_se = rwire.pack_in_se(c1, l1, nv)
    want_pe = rwire.pack_in_pe(c1, l1, c2, l2, nv)
    assert len(want_se) == wire.in_bytes(B, L) and len(want_pe) == wire.in_bytes(B, L, 2)

    kernels.reset_launches()
    for got in packs_of(wire.pack_in_se, c1, l1, nv):
        assert np.array_equal(got, want_se)
    for got in packs_of(wire.pack_in_pe, c1, l1, c2, l2, nv):
        assert np.array_equal(got, want_pe)
    assert wire.PACKS == {"native": 2 + 4, "numpy": 0}

    force_numpy(monkeypatch)
    for got in packs_of(wire.pack_in_se, c1, l1, nv):
        assert np.array_equal(got, want_se)
    for got in packs_of(wire.pack_in_pe, c1, l1, c2, l2, nv):
        assert np.array_equal(got, want_pe)
    assert wire.PACKS == {"native": 6, "numpy": 6}
    kernels.reset_launches()
    assert wire.PACKS == {"native": 0, "numpy": 0}


def test_pack_native_entry_and_refusals():
    """The native entry alone: codes that are not int8, or whose row codes
    are not adjacent, and outputs of the wrong size, are refused; the
    wire's own pack converts other code dtypes as the numpy path does."""
    rng = np.random.default_rng(5)
    codes = rng.integers(-128, 128, (9, 13), dtype=np.int8)
    b2, bm = np.empty(9 * 4, np.uint8), np.empty(9 * 2, np.uint8)
    assert bindings.pack_codes(codes, b2, bm)
    p2, pm = wire._pack_codes_np(codes)
    assert np.array_equal(b2, p2.reshape(-1)) and np.array_equal(bm, pm.reshape(-1))
    for bad in (codes.astype(np.int16), codes[:, ::2], codes.T):
        with pytest.raises(ValueError):
            bindings.pack_codes(bad, b2, bm)
    with pytest.raises(ValueError):
        bindings.pack_codes(codes, b2[:-1], bm)
    lens = np.full(9, 13)
    want = rwire.pack_in_se(codes.astype(np.int32), lens, 9)
    assert np.array_equal(wire.pack_in_se(codes.astype(np.int32), lens, 9), want)
    assert np.array_equal(wire.pack_in_se(codes.view(np.uint8), lens, 9), want)
    assert np.array_equal(wire.pack_in_se(codes.T.copy().T, lens, 9), want)
    for out in (np.empty(wire.in_bytes(9, 13) + 1, np.uint8),
                np.empty(wire.in_bytes(9, 13), np.int8)):
        with pytest.raises(ValueError):
            wire.pack_in_se(codes, lens, 9, out=out)
    with pytest.raises(ValueError):
        wire.pack_in_se(codes, lens[:8], 9)
    with pytest.raises(ValueError):
        wire.pack_in_pe(codes, lens, codes[:, :12], lens, 9)


@pytest.fixture(scope="module")
def small_mapper(tmp_path_factory):
    rng = np.random.default_rng(22)
    txps = random_transcriptome(rng, n_txps=12, min_len=200, max_len=600)
    fa = write_fasta(str(tmp_path_factory.mktemp("pack") / "txome.fa"), txps)
    idx = build_quasi_index(fa, outdir=None, k=15)
    return QuasiMapper(idx, MapConfig(k=15), device="cpu"), txps


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_mapper_same_result_either_path(kind, small_mapper, monkeypatch):
    mapper, txps = small_mapper
    rng = np.random.default_rng(7 if kind == "se" else 8)
    L, B = 50, 48
    seqs = [r[1] for r in sample_reads(rng, txps, 2 * B, L, error_rate=0.02, n_frac=0.01)]
    c1, l1 = batch_of(seqs[:B], L)
    c2, l2 = batch_of(seqs[B:], L)
    l1[-3:] = 31  # ragged rows, their tails past the length
    nv = B - 5

    def run():
        if kind == "se":
            return mapper.fetch(mapper.map_se_async(c1, l1, nv))
        return mapper.fetch(mapper.map_pe_async(c1, l1, c2, l2, nv))

    kernels.reset_launches()
    a = run()
    mates = 1 if kind == "se" else 2
    assert wire.PACKS == {"native": mates, "numpy": 0}
    force_numpy(monkeypatch)
    b = run()
    assert wire.PACKS == {"native": mates, "numpy": mates}
    assert a.total > 0 and a.counters["reads_mapped"] > 0
    for name in ("recs", "counts", "flags"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert (a.total, a.overflowed, a.counters) == (b.total, b.overflowed, b.counters)
