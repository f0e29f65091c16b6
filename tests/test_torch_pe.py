"""Paired-end rapmap_tpu_torch against rapmap_tpu on the CPU, integer for
integer (tolerance zero): QuasiMapper.map_pe_async / fetch gives the
reference's unchunked wire buffer (`map_batch_pe_wire`) and chunked one
(`map_batch_pe_wire_chunked`) with their WireResults, and `map_pe` the
reference's MapOuts, PairOut and counters, on the PE read sets of
tests/test_device_parity.py and tests/test_wire.py made on one module world
and padded to one shape (one reference compile per program and config).
This file holds the default configuration: the chunked direct merge, the
chunked slotted merge (`pe_direct_eligible` patched to False in both
packages) and the unchunked path, with the bitonic voting sort on and off,
and `pe_direct_eligible`'s verdict; tests/test_torch_pe_constraints.py and
tests/test_torch_pe_corner.py hold the other configurations.

`map_pe` compares the whole PairOut, empty slots included: their payloads
come from the stable sorts of `merge_pairs_batch`, ordered alike in both."""

from types import SimpleNamespace

import numpy as np
import pytest

import rapmap_tpu.ops.pairs as ref_pairs
import rapmap_tpu_torch.models.quasi as port_quasi
from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models.quasi import QuasiMapper
from rapmap_tpu_torch.ops.pairs import pe_direct_eligible
from tests.test_device_parity import batch_of
from tests.util import BASES, random_transcriptome, write_fasta

B, L, CHUNK = 32, 40, 8  # one padded shape for every set: one compile per config
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def rc(seq: bytes) -> bytes:
    return seq.translate(COMP)[::-1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Four transcripts sharing one 120 bp segment (ambiguous pairs, as in
    tests/test_wire.py's corner cases) and five random ones of 300-500 bp,
    k = 11, and the PE read sets of the reference's tests made on them."""
    rng = np.random.default_rng(77)
    base = random_transcriptome(rng, n_txps=4, min_len=260, max_len=400)
    shared = base[0][1][40:160]
    txps = [(f"s{i}", s[:30] + shared + s[30:]) for i, (_, s) in enumerate(base)]
    txps += random_transcriptome(rng, n_txps=5, min_len=300, max_len=500)
    idx = ref_build(write_fasta(str(tmp_path_factory.mktemp("pe") / "t.fa"), txps), k=11)

    def junk(n=L):
        return BASES[rng.integers(0, 4, n)].tobytes()

    def fragments(n, lo, hi, read_len=L, swap=0.0):
        out = []
        for _ in range(n):
            seq = txps[int(rng.integers(0, len(txps)))][1]
            frag = int(rng.integers(lo, hi))
            a = int(rng.integers(0, len(seq) - frag + 1))
            left, right = seq[a : a + read_len], rc(seq[a + frag - read_len : a + frag])
            if rng.random() < swap:  # rc mate before fwd mate
                left, right = rc(left), rc(right)
            out.append((left, right))
        return out

    sets = {}
    # test_pe_parity: fragments of 90-150 bp, an orphan and an unmapped pair
    sets["pe_parity"] = fragments(24, 90, 150) + [(txps[0][1][:L], junk()), (junk(),) * 2]
    # test_pe_no_orphans: the left mate maps, the right is junk
    sets["orphan"] = [(txps[5][1][:L], junk()), (junk(), rc(txps[6][1][20 : 20 + L]))]
    # test_pe_parity_fidelity_constraints: 60-260 bp, some swapped
    sets["fidelity"] = fragments(24, 60, 260, swap=0.3)
    # test_wire.py's PE sets: 36 bp mates of 100 bp fragments, then the
    # corner cases: orphans, a discordant pair, an ambiguous one, an empty one
    corner = fragments(6, 100, 101, read_len=36)
    corner += [(txps[0][1][5:41], junk(36)), (junk(36), rc(txps[1][1][50:86])),
               (txps[2][1][10:46], txps[3][1][10:46]),
               (shared[10:46], rc(shared[60:96])), (b"", b"")]
    sets["wire_fragments"] = fragments(13, 100, 101, read_len=36)
    sets["corner"] = corner
    return idx, sets


def _pair_batch(pairs, pad_to, pad_len):
    pad = [b""] * (pad_to - len(pairs))
    c1, l1 = batch_of([p[0] for p in pairs] + pad, pad_len)
    c2, l2 = batch_of([p[1] for p in pairs] + pad, pad_len)
    return c1, l1, c2, l2


def _same_wire(ref, rh, port, res):
    got = res.wire.numpy()
    assert got.dtype == np.int32 and np.array_equal(got, np.asarray(rh[2]))
    want, have = ref.fetch(rh), port.fetch(res)
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(have, f)), np.asarray(getattr(want, f))), f
    return want


def assert_pe_parity(idx, pairs, kw, paths=("unchunked", "chunked", "map_pe"),
                     pad_to=B, pad_len=L):
    """The port against the reference on one batch of `pad_to` pairs with
    n_valid = len(pairs): the wire buffer and WireResult of each path in
    `paths` ("unchunked": one program; "chunked": chunks of CHUNK pairs, or
    of kw["chunk"]), and `map_pe`. -> {path: the reference's WireResult or
    map_pe tuple}."""
    c1, l1, c2, l2 = _pair_batch(pairs, pad_to, pad_len)
    n = len(pairs)
    kw = dict(dict(max_hits_per_strand=pad_len - idx.k + 1, expand_budget=256), **kw)
    C = kw.pop("chunk", CHUNK)
    out = {}
    for path in paths:
        chunk = C if path == "chunked" else 0
        ref = RefMapper(idx, RefConfig(k=idx.k, chunk=chunk, **kw))
        port = QuasiMapper(index_from_reference(vars(idx)),
                           MapConfig(k=idx.k, chunk=chunk, **kw), device="cpu")
        assert port.cfg == MapConfig(**vars(ref.cfg))
        if path == "map_pe":
            want = ref.map_pe(c1, l1, c2, l2, n_valid=n)
            got = port.map_pe(c1, l1, c2, l2, n_valid=n)
            for w_nt, g_nt in zip(want, got):
                for f in w_nt._fields:
                    w, g = np.asarray(getattr(w_nt, f)), getattr(g_nt, f)
                    assert g.dtype == w.dtype and np.array_equal(g, w), f
            assert int(want[3].reads_total) == n
            out[path] = want
            continue
        rh = ref.map_pe_async(c1, l1, c2, l2, n_valid=n)
        res = port.map_pe_async(c1, l1, c2, l2, n_valid=n)
        assert res.kind == "pe" and rh[3] == res.C == chunk
        out[path] = _same_wire(ref, rh, port, res)
        assert out[path].recs.shape[1] == 7 and out[path].counters["reads_total"] == n
    return out


@pytest.mark.parametrize("read_set", ["pe_parity", "wire_fragments", "corner"])
def test_pe_parity_default(world, read_set):
    idx, sets = world
    out = assert_pe_parity(idx, sets[read_set], {})
    _, _, po, ctr = out["map_pe"]
    assert po.concordant.any() and int(ctr.reads_mapped) > 0
    # the direct chunked merge writes what the slotted unchunked one writes
    un, ch = out["unchunked"], out["chunked"]
    assert un.counters == ch.counters and np.array_equal(un.recs, ch.recs)
    assert np.array_equal(un.counts, ch.counts) and np.array_equal(un.flags, ch.flags)


@pytest.mark.parametrize("bitonic", [False, True])
def test_pe_chunked_slotted_branch(world, monkeypatch, bitonic):
    """The chunked path's slotted branch, which no real index takes: both
    packages' pe_direct_eligible patched to False, and their direct merge to
    raise, so neither can take it (test only). It runs at its own chunk size,
    so the reference traces a program of its own under the patch rather than
    finding the direct one in its jit cache."""
    idx, sets = world

    def direct_merge(*a, **kw):
        raise AssertionError("the direct merge ran")

    for mod in (ref_pairs, port_quasi):
        monkeypatch.setattr(mod, "pe_direct_eligible", lambda st, cfg, C: False)
        monkeypatch.setattr(mod, "collate_records_pe", direct_merge)
    out = assert_pe_parity(idx, sets["corner"], dict(chunk=16, bitonic_sort=bitonic),
                           paths=("chunked",))
    assert out["chunked"].total > 0


def test_pe_bitonic_sort(world):
    """cfg.bitonic_sort on the unchunked and the chunked direct path: both
    mates' voting pools (256 x 32 and 256 x 8 slots) take the sort kernel's
    plain version."""
    idx, sets = world
    out = assert_pe_parity(idx, sets["pe_parity"], dict(bitonic_sort=True),
                           paths=("unchunked", "chunked"))
    assert out["chunked"].counters == out["unchunked"].counters


@pytest.mark.parametrize("C", [1, 8, 8192, 1 << 20])
def test_pe_direct_eligible_matches_reference(C):
    """The chunked path's choice of merge: the same verdict as the
    reference's on either side of C * 2 * n_txps = 2^32, and without stats."""
    cfg = MapConfig(k=11)
    for n_txps in (0, 1, 10_000, (1 << 31) // C - 1, (1 << 31) // C, 1 << 31):
        st = SimpleNamespace(n_txps=n_txps)
        want = ref_pairs.pe_direct_eligible(st, RefConfig(k=11), C)
        assert pe_direct_eligible(st, cfg, C) == want
        assert want == (0 < n_txps and C * 2 * n_txps < (1 << 32))
    assert not pe_direct_eligible(None, cfg, C) and not ref_pairs.pe_direct_eligible(
        None, RefConfig(k=11), C)
