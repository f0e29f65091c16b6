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
come from the stable sorts of `merge_pairs_batch`, ordered alike in both.

`jax_cache_off` (autouse, module scope) keeps JAX's compilation cache off
while a module's tests run, whatever an earlier test of the same worker
process turned on (tests/test_mapping_score.py runs rapmap_tpu.cli.main in
process, and its jaxenv.setup() sets a persistent cache directory), and
drops the worker's compiled programs before and after the module, so that
their memory mappings do not pile up past the kernel's limit. Every
tests/test_torch_*.py file that calls into rapmap_tpu in process imports it.
"""

import gc
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax._src import compilation_cache

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


@pytest.fixture(scope="module", autouse=True)
def jax_cache_off():
    """JAX's compilation cache off for the module, the old state back after,
    and the worker's compiled programs dropped before and after the module.

    A compile takes the cache's path (compiler._compile_and_write_cache)
    whenever `jax_enable_compilation_cache` is on when compilation_cache
    first checks it, with or without a cache directory; that verdict and an
    initialised file cache are module state of jax._src.compilation_cache,
    which reset_cache() drops. So: both config values off, the module state
    reset, and at teardown the values restored and the state reset again
    (it re-initialises from them at the next compile).

    Every XLA:CPU executable keeps its code in memory mappings, ~1,300-1,500
    for one of the reference's mapping programs, and the jit caches keep
    every executable a worker process compiled: past vm.max_map_count
    (65,530) the next compile's mapping fails and the worker dies with a
    segmentation fault in backend_compile_and_load. So before and after the
    module, once the process holds more than MAPS_HIGH mappings,
    jax.clear_caches() and a collection release them (below that the
    programs stay, for the next module that runs the same ones)."""
    old = (jax.config.jax_compilation_cache_dir, jax.config.jax_enable_compilation_cache)
    jax.config.update("jax_compilation_cache_dir", None)
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    _release_programs()
    yield
    _MAPPERS.clear()
    _release_programs()
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_enable_compilation_cache", old[1])
    compilation_cache.reset_cache()


MAPS_HIGH = 16_000  # of vm.max_map_count's 65,530: room for the largest module's programs


def _release_programs():
    try:
        with open("/proc/self/maps") as f:
            n_maps = sum(1 for _ in f)
    except OSError:  # no /proc: release every time
        n_maps = MAPS_HIGH + 1
    if n_maps > MAPS_HIGH:
        jax.clear_caches()
        gc.collect()


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


_MAPPERS: dict = {}


def mappers(idx, kw: dict, chunk: int):
    """The reference's and the port's mapper of (index, config, chunk), made
    once for the whole session: a reference mapper uploads its index and
    traces its programs on first use, so one per config and chunk, not one
    per path and case, keeps a worker's compile count down."""
    key = (id(idx), chunk, tuple(sorted(kw.items())))
    if key not in _MAPPERS:
        _MAPPERS[key] = (
            idx,  # keeps id(idx) from being reused while the entry lives
            RefMapper(idx, RefConfig(k=idx.k, chunk=chunk, **kw)),
            QuasiMapper(index_from_reference(vars(idx)), MapConfig(k=idx.k, chunk=chunk, **kw),
                        device="cpu"),
        )
    return _MAPPERS[key][1:]


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
        ref, port = mappers(idx, kw, chunk)
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
