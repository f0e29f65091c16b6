"""rapmap_tpu_torch end to end against rapmap_tpu: QuasiMapper.map_se_async /
fetch on the CPU gives the reference's chunked SE wire buffer int32 for
int32, and the same WireResult, with the bitonic voting sort on and off, on
the read sets of tests/test_device_parity.py."""

import numpy as np
import pytest

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.builder import build_quasi_index as ref_build
from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models.quasi import QuasiMapper
from tests.test_device_parity import batch_of
from tests.util import BASES, random_transcriptome, sample_reads, write_fasta

B, L, CHUNK = 64, 72, 32  # one padded shape for every set: one compile per config


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Random transcripts (half sharing a 40 bp prefix) plus three that
    share one 80 bp segment, so some reads multimap."""
    rng = np.random.default_rng(21)
    txps = random_transcriptome(rng, n_txps=8, min_len=150, max_len=300, shared_prefix=40)
    base = random_transcriptome(rng, n_txps=3, min_len=150, max_len=200)
    shared = base[0][1][30:110]
    txps += [(f"m{i}", s[:40] + shared + s[40:]) for i, (_, s) in enumerate(base)]
    idx = ref_build(write_fasta(str(tmp_path_factory.mktemp("q") / "t.fa"), txps), k=11)

    sets = {}
    sets["exact"] = [r[1] for r in sample_reads(rng, txps, 40, read_len=48, rc_frac=0.5)]
    messy = [r[1] for r in sample_reads(rng, txps, 44, read_len=52, error_rate=0.05,
                                        n_frac=0.02)]
    messy += [BASES[rng.integers(0, 4, 52)].tobytes() for _ in range(8)]
    sets["messy"] = messy + [b"N" * 52, txps[0][1][:52]]
    mixed = []
    for rl in (30, 41, 52, 64, 72):
        mixed += [r[1] for r in sample_reads(rng, txps, 12, read_len=rl, rc_frac=0.6,
                                             error_rate=0.03)]
    sets["mixed_lengths"] = mixed
    sets["multimapping"] = [shared[5:55], shared[10:60], txps[-1][1][:50], shared[:72]]
    return idx, sets


@pytest.mark.parametrize("bitonic", [False, True])
@pytest.mark.parametrize("read_set", ["exact", "messy", "mixed_lengths", "multimapping"])
def test_wire_parity(world, read_set, bitonic):
    idx, sets = world
    seqs = sets[read_set]
    codes, lens = batch_of(seqs + [b""] * (B - len(seqs)), L)
    kw = dict(k=idx.k, chunk=CHUNK, bitonic_sort=bitonic)
    ref = RefMapper(idx, RefConfig(**kw))
    rh = ref.map_se_async(codes, lens, n_valid=len(seqs))
    want_wire = np.asarray(rh[2])
    port = QuasiMapper(index_from_reference(vars(idx)), MapConfig(**kw), device="cpu")
    res = port.map_se_async(codes, lens, n_valid=len(seqs))
    got_wire = res.wire.numpy()
    assert got_wire.dtype == np.int32
    assert np.array_equal(got_wire, want_wire)
    want, got = ref.fetch(rh), port.fetch(res)
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    assert want.counters["reads_total"] == len(seqs)
    assert want.counters["reads_mapped"] > 0


def test_unchunked_batch_is_refused(world):
    idx, sets = world
    codes, lens = batch_of(sets["exact"][:16], 48)
    port = QuasiMapper(index_from_reference(vars(idx)), MapConfig(k=idx.k), device="cpu")
    with pytest.raises(NotImplementedError, match="unchunked"):
        port.map_se_async(codes, lens)
