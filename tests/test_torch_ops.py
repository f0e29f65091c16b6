"""rapmap_tpu_torch device ops against rapmap_tpu on the same numpy inputs:
encode/keys, the canonical CHD probe (p_bits 0 and > 0), the packed
extension, the strand-paired scan, the wire's device halves, the record
compaction (past its cap too), `pack_out` through `unpack_out`, and the
bitonic sort. Every value is an integer, so every comparison is exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.index.chd import mix32_np
from rapmap_tpu.ops import encode as rdenc
from rapmap_tpu.ops import compact as rcompact
from rapmap_tpu.ops import wire as rwire
from rapmap_tpu.ops.collate import MapOut as RefMapOut
from rapmap_tpu.ops.device_index import upload_index as ref_upload
from rapmap_tpu.ops.extend_packed import extend_packed as ref_extend
from rapmap_tpu.ops.extend_packed import pack_reads as ref_pack_reads
from rapmap_tpu.ops.lookup import kmer_lookup_2str as ref_lookup
from rapmap_tpu.ops.mmp import scan_dispatch as ref_scan
from rapmap_tpu.ops.pallas.sort2 import bitonic_sort_pairs_pallas
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.ops import encode as denc
from rapmap_tpu_torch.ops import compact, wire
from rapmap_tpu_torch.ops.collate import MapOut
from rapmap_tpu_torch.ops.device_index import upload_index
from rapmap_tpu_torch.ops.extend_packed import extend_packed, pack_reads
from rapmap_tpu_torch.ops.lookup import _mix32, kmer_lookup_2str
from rapmap_tpu_torch.ops.mmp import scan_dispatch
from rapmap_tpu_torch.ops.sort2 import bitonic_sort_pairs, bitonic_sort_pairs_plain
from tests.test_device_parity import batch_of
from tests.util import BASES, random_transcriptome, sample_reads, toy_index, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    g = got.numpy()
    if want.dtype == np.uint32:
        g = g.astype(np.int64) & 0xFFFFFFFF
    return np.array_equal(g.astype(np.int64), want.astype(np.int64))


def random_codes(rng, R, L, n_frac=0.05):
    codes = rng.integers(1, 5, (R, L)).astype(np.int8)
    codes[rng.random((R, L)) < n_frac] = 5
    codes[-1, :] = 5  # an all-N row
    return codes


# ---- encode ---------------------------------------------------------------

@pytest.mark.parametrize("k, L", [(11, 40), (31, 76), (31, 33)])
def test_encode_and_keys(k, L):
    rng = np.random.default_rng(k + L)
    codes = random_codes(rng, 12, L)
    S = L - k + 1
    rj = jnp.asarray(codes)
    rt = t_(codes)
    assert eq(denc.comp_flip_batch(rt), rdenc.comp_flip_batch(rj))
    rnb = rdenc.next_bad_batch(rj, L)
    nb = denc.next_bad_batch(rt, L)
    assert eq(nb, rnb)
    rpre = ref_pack_reads(rj)
    pre = pack_reads(rt)
    assert eq(pre, rpre)
    rhi, rlo, rv = rdenc.kmer_keys_from_packed(rpre, rnb, k, S)
    hi, lo, v = denc.kmer_keys_from_packed(pre, nb, k, S)
    assert eq(hi, rhi) and eq(lo, rlo) and eq(v, rv)
    rchi, rclo = rdenc.rc_keys_batch(rhi, rlo, k)
    chi, clo = denc.rc_keys_batch(hi, lo, k)
    assert eq(chi, rchi) and eq(clo, rclo)


def test_mix32_matches_host_hash():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32),
    ])
    got = _mix32(t_(x.astype(np.int64)))
    assert eq(got, mix32_np(x))


# ---- canonical CHD probe ----------------------------------------------------

def _probe_world(tmp_path, n_txps, min_len, max_len, k, seed):
    rng = np.random.default_rng(seed)
    txps = random_transcriptome(rng, n_txps=n_txps, min_len=min_len, max_len=max_len)
    idx = ref_build(write_fasta(str(tmp_path / "txome.fa"), txps), k=k)
    return idx, txps, rng


@pytest.fixture(scope="module")
def big_world(tmp_path_factory):
    """>= 2^20 distinct 31-mer classes (~1.2 Mbp), so the CHD is striped
    (chd_p_bits > 0)."""
    idx, txps, rng = _probe_world(
        tmp_path_factory.mktemp("big"), 400, 2900, 3100, 31, 11
    )
    assert idx.meta["chd"]["p_bits"] > 0
    return idx, txps, rng


def _lookup_parity(idx, txps, rng, L):
    k = idx.k
    reads = sample_reads(rng, txps, 48, read_len=L, error_rate=0.02, n_frac=0.01)
    seqs = [r[1] for r in reads] + [BASES[rng.integers(0, 4, L)].tobytes() for _ in range(8)]
    codes, _ = batch_of(seqs, L)
    S = L - k + 1
    rdidx, rst = ref_upload(idx, lean=True)
    didx, st = upload_index(index_from_reference(vars(idx)), "cpu")
    rj = jnp.asarray(codes)
    rhi, rlo, _ = rdenc.kmer_keys_from_packed(
        ref_pack_reads(rj), rdenc.next_bad_batch(rj, L), k, S
    )
    want = jax.jit(ref_lookup, static_argnums=1)(rdidx, rst, rhi, rlo)
    got = kmer_lookup_2str(didx, st, t_(np.asarray(rhi).astype(np.int64)),
                           t_(np.asarray(rlo).astype(np.int64)))
    for name, g, w in zip(("ff", "bf", "ef", "fr", "br", "er"), got, want):
        assert eq(g, w), name
    assert np.asarray(want[0]).any() and np.asarray(want[3]).any()


def test_lookup_2str_unstriped(tmp_path):
    idx, txps, rng = _probe_world(tmp_path, 8, 150, 400, 11, 2)
    assert idx.meta["chd"]["p_bits"] == 0
    _lookup_parity(idx, txps, rng, 40)


def test_lookup_2str_striped(big_world):
    _lookup_parity(*big_world, 76)


# ---- packed extension -------------------------------------------------------

@pytest.mark.parametrize("L, seed", [(52, 77), (90, 79)])
def test_extend_packed(tmp_path, L, seed):
    """The reference's cases: random anchors over the whole SA, reads long
    enough (L = 90) to spill past the fused sa_cmp words into text2q."""
    rng = np.random.default_rng(seed)
    idx, txps = toy_index(tmp_path, rng, n_txps=6, min_len=200, max_len=420, k=11,
                          shared_prefix=30)
    reads = sample_reads(rng, txps, 32, read_len=L, error_rate=0.02, n_frac=0.01)
    codes, lens = batch_of([r[1] for r in reads], L)
    lens[::4] -= 7
    rdidx, _ = ref_upload(idx, lean=True)
    didx, _ = upload_index(index_from_reference(vars(idx)), "cpu")
    n_sa = len(idx.sa)
    R = len(reads)
    pos = rng.integers(0, L - idx.k, R).astype(np.int32)
    b0 = np.zeros(R, np.int32)
    e0 = np.full(R, n_sa, np.int32)
    act = rng.random(R) < 0.9
    col_off = rng.integers(0, 3, R).astype(np.int32)
    rj = jnp.asarray(codes)
    f = jax.jit(ref_extend, static_argnums=(8, 9, 10))
    want = f(rdidx, ref_pack_reads(rj), rdenc.next_bad_batch(rj, L), jnp.asarray(lens),
             jnp.asarray(b0), jnp.asarray(e0), jnp.asarray(pos), jnp.asarray(act),
             idx.k, 24, L, col_off=jnp.asarray(col_off))
    rt = t_(codes)
    got = extend_packed(
        didx, pack_reads(rt), denc.next_bad_batch(rt, L), t_(lens.astype(np.int64)),
        t_(b0.astype(np.int64)), t_(e0.astype(np.int64)), t_(pos.astype(np.int64)),
        t_(act), idx.k, 24, L, col_off=t_(col_off.astype(np.int64)),
    )
    for name, g, w in zip(("b", "e", "mlen"), got, want):
        assert eq(g, w), name


# ---- strand-paired scan -----------------------------------------------------

@pytest.fixture(scope="module")
def scan_world(tmp_path_factory):
    rng = np.random.default_rng(7)
    idx, txps = toy_index(tmp_path_factory.mktemp("scan"), rng, n_txps=8, min_len=100,
                          max_len=250, k=11, shared_prefix=40)
    seqs = []
    for rl in (30, 41, 52, 60):
        seqs += [r[1] for r in sample_reads(rng, txps, 8, read_len=rl, rc_frac=0.6,
                                            error_rate=0.05, n_frac=0.02)]
    seqs += [BASES[rng.integers(0, 4, 60)].tobytes() for _ in range(4)]
    seqs += [b"N" * 60, txps[0][1][:60], b"ACGT" * 2]
    codes, lens = batch_of(seqs, 60)
    return idx, codes, lens


@pytest.mark.parametrize("H", [16, 2])
def test_scan_hits(scan_world, H):
    """ScanHits field for field; H = 2 overflows the hit buffer."""
    idx, codes, lens = scan_world
    kw = dict(k=idx.k, max_hits_per_strand=H)
    rdidx, rst = ref_upload(idx, lean=True)
    didx, st = upload_index(index_from_reference(vars(idx)), "cpu")
    f = jax.jit(ref_scan, static_argnums=(1, 4))
    want = f(rdidx, rst, jnp.asarray(codes), jnp.asarray(lens), RefConfig(**kw))
    got = scan_dispatch(didx, st, t_(codes), t_(lens.astype(np.int64)), MapConfig(**kw))
    for name in want._fields:
        assert eq(getattr(got, name), getattr(want, name)), name
    if H == 2:
        assert np.asarray(want.truncated).any()


# ---- wire device halves -------------------------------------------------------

def test_wire_device_halves():
    rng = np.random.default_rng(3)
    B, L = 16, 37
    codes = random_codes(rng, B, L)
    lens = rng.integers(20, L + 1, B).astype(np.int32)
    win = rwire.pack_in_se(codes, lens, 13)
    rc, rl, rn = rwire.unpack_in_se(jnp.asarray(win), B, L)
    c, ln, n = wire.unpack_in_se(t_(win), B, L)
    assert eq(c, rc) and eq(ln, rl) and int(n) == int(rn) == 13
    counts = rng.integers(0, 2**16, B).astype(np.int32)
    fb = rng.integers(0, 16, B).astype(np.int32)
    rcw, rfw = rwire.pack_counts_flags(jnp.asarray(counts), jnp.asarray(fb))
    cw, fw = wire.pack_counts_flags(t_(counts), t_(fb))
    assert eq(cw, rcw) and eq(fw, rfw)
    spec = wire.RecSpec("se", (7, 14, 1, 6), 1024)
    fields = [rng.integers(0, 100, B), rng.integers(-60, 3000, B),
              rng.integers(0, 2, B), rng.integers(0, 33, B)]
    rhi, rlo = rwire.pack_rec_fields(
        rwire.RecSpec(*spec), [jnp.asarray(f.astype(np.int32)) for f in fields]
    )
    hi, lo = wire.pack_rec_fields(spec, [t_(f.astype(np.int64)) for f in fields])
    assert eq(hi, rhi) and eq(lo, rlo)
    back = wire.unpack_rec_rows(spec, np.stack([hi.numpy(), lo.numpy()], axis=1))
    assert np.array_equal(back, np.stack(fields, axis=1))


# ---- record compaction and the unchunked wire out -----------------------------

def _random_mapout(rng, B, MO):
    """A slotted MapOut as collate_batch leaves it: each read's records fill
    its first slots, the rest hold t = -1 and zeros."""
    n = rng.integers(0, MO + 1, B)
    n[rng.random(B) < 0.4] = 0
    live = np.arange(MO)[None, :] < n[:, None]
    t = np.where(live, rng.integers(0, 50, (B, MO)), -1).astype(np.int32)
    pos = np.where(live, rng.integers(-40, 3000, (B, MO)), 0).astype(np.int32)
    strand = np.where(live, rng.integers(0, 2, (B, MO)), 0).astype(np.int32)
    score = np.where(live, rng.integers(1, 9, (B, MO)), 0).astype(np.int32)
    flags = [rng.random(B) < 0.3 for _ in range(4)]
    return (t, pos, strand, score, n.astype(np.int32), *flags)


@pytest.mark.parametrize("cap", [256, 9, 1], ids=["ample", "past_cap", "cap_1"])
def test_compact_se(cap):
    """`_compact` / `compact_se`: dense records, per-read counts clamped to
    what was written, total and the overflow flag, under and past the cap."""
    rng = np.random.default_rng(cap)
    B, MO = 48, 6
    mo = _random_mapout(rng, B, MO)
    want = rcompact.compact_se(RefMapOut(*(jnp.asarray(a) for a in mo)), cap)
    got = compact.compact_se(MapOut(*(t_(a) for a in mo)), cap)
    assert got.recs.dtype == torch.int32 and got.recs.shape == (cap, 4)
    for f in want._fields:
        assert eq(getattr(got, f), getattr(want, f)), f
    assert bool(got.overflowed) == (int((mo[0] != -1).sum()) > cap)
    if cap != 256:
        assert bool(got.overflowed) and int(got.counts.sum()) == cap
    rrecs, rcounts, rtotal, rovf = rcompact._compact(
        [jnp.asarray(mo[0]), jnp.asarray(mo[3])], jnp.asarray(mo[0] != -1), cap)
    recs, counts, total, ovf = compact._compact(
        [t_(mo[0]), t_(mo[3])], t_(mo[0] != -1), cap)
    assert eq(recs, rrecs) and eq(counts, rcounts)
    assert int(total) == int(rtotal) and bool(ovf) == bool(rovf)


@pytest.mark.parametrize("cap", [256, 9], ids=["ample", "past_cap"])
def test_pack_out_then_unpack_out(cap):
    """The unchunked wire out: the port's `pack_out` equals the reference's
    int32 for int32, and the port's `unpack_out` reads it back as the
    reference's does."""
    from rapmap_tpu.models.quasi import Counters as RefCounters
    from rapmap_tpu_torch.models.quasi import Counters

    rng = np.random.default_rng(100 + cap)
    B, MO = 48, 6
    mo = _random_mapout(rng, B, MO)
    ctr = rng.integers(0, 1000, 6).astype(np.int32)
    fbits = rng.integers(0, 16, B).astype(np.int32)
    rse = rcompact.compact_se(RefMapOut(*(jnp.asarray(a) for a in mo)), cap)
    se = compact.compact_se(MapOut(*(t_(a) for a in mo)), cap)
    want = np.asarray(rwire.pack_out(
        rse, RefCounters(*(jnp.int32(c) for c in ctr)), jnp.asarray(fbits)))
    got = wire.pack_out(se, Counters(*(torch.tensor(int(c)) for c in ctr)), t_(fbits))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    a, b = wire.unpack_out(got.numpy(), B, 4), rwire.unpack_out(want, B, 4)
    for f in b._fields:
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f
    assert len(a.recs) == min(a.total, cap) == int(a.counts.sum())
    assert a.overflowed == (a.total > cap)
    assert a.counters == dict(zip(
        ("reads_total", "reads_mapped", "too_ambiguous", "over_budget", "records",
         "out_truncated"), (int(c) for c in ctr)))


# ---- bitonic sort -------------------------------------------------------------

def _sort_inputs(n, kind, rng):
    if kind == "random":
        hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    else:
        hi = rng.integers(0, 4, n).astype(np.uint32)
        lo = rng.integers(0, 4, n).astype(np.uint32)
        hi[::7] = 0xFFFFFFFF
        lo[::7] = 0xFFFFFFFF
    return hi, lo


@pytest.mark.parametrize("n", [2, 1024, 4096, 65536])
@pytest.mark.parametrize("kind", ["random", "duplicates_sentinels"])
def test_bitonic_sort(n, kind):
    """plain == wrapper (CPU tensors) == Pallas kernel (interpret mode) ==
    np.lexsort. N = 2 is below the Pallas kernel's lane width and is held to
    np.lexsort alone; N = 65,536 is the main path's voting pool."""
    hi, lo = _sort_inputs(n, kind, np.random.default_rng(n))
    order = np.lexsort((lo, hi))
    ph, pl = bitonic_sort_pairs_plain(t_(hi.view(np.int32)), t_(lo.view(np.int32)))
    wh, wl = bitonic_sort_pairs(t_(hi.view(np.int32)), t_(lo.view(np.int32)))
    if n >= 128:
        kh, kl = bitonic_sort_pairs_pallas(jnp.asarray(hi), jnp.asarray(lo), interpret=True)
    else:
        kh, kl = hi[order], lo[order]
    for h, l in ((ph, pl), (wh, wl)):
        assert h.dtype == torch.int32 and l.dtype == torch.int32
        assert eq(h, hi[order]) and eq(l, lo[order])
        assert eq(h, kh) and eq(l, kl)


def test_bitonic_sort_rejects_bad_lengths():
    with pytest.raises(ValueError):
        bitonic_sort_pairs(torch.zeros(6, dtype=torch.int32), torch.zeros(6, dtype=torch.int32))

