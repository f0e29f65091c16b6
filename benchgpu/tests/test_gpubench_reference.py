"""The reference (benchgpu/reference.py) against the program's own numpy
oracle (rapmap_tpu_torch/oracle/quasimap.py, which the port's engines are
held to) on toy worlds: the same mappings, read for read, under every
option of SEMANTICS.md §§3-5."""

import numpy as np
import pytest

from benchgpu import traffic, worlds
from benchgpu.reference import Reference, Semantics, revcomp, window_keys
from benchgpu.tests import gpubench_toy as toy


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from rapmap_tpu_torch.index.builder import build_quasi_index

    cfg = toy.config(n_genes=40)
    transcripts = worlds.make(cfg, 20241018)
    fa = str(tmp_path_factory.mktemp("w") / "t.fa")
    worlds.write_fasta(transcripts, fa)
    idx = build_quasi_index(fa, outdir=None, k=31)
    text = worlds.text_codes(transcripts)
    se = traffic.make_pool(toy.mix("se76_b64k", batch=300, pool_batches=1), text, 5).batches[0][0]
    pe = traffic.make_pool(toy.mix("pe76_b64k", batch=150, pool_batches=1), text, 6).batches[0]
    pe = pe[0], pe[2]
    se = se.copy()
    se[::7, 40] = 5  # an N in every seventh read
    se[::11, 3:5] = 5
    return transcripts, idx, se, pe


OPTIONS = [
    {},
    {"consistent_hits": True},
    {"consistent_hits": True, "fuzzy": True},
    {"strict_check": True},
    {"quasi_coverage": 0.6},
    {"max_num_hits": 3},
    {"max_interval": 2},
    {"no_orphans": True, "max_frag_len": 300},
    {"pair_order": True},
]


def _oracle_se(idx, read, cfg):
    from rapmap_tpu_torch.oracle import quasimap as qm

    return [(m.txp, m.pos, 0 if m.fwd else 1, m.score) for m in qm.map_read(idx, read, cfg)]


def _oracle_pe(idx, r1, r2, cfg):
    from rapmap_tpu_torch.oracle import quasimap as qm

    ms, _ = qm.map_pair(idx, r1, r2, cfg)
    return [(m.txp, m.pos1 if m.pos1 is not None else 0, 0 if m.fwd1 else 1,
             int(m.pos1 is not None), m.pos2 if m.pos2 is not None else 0,
             0 if m.fwd2 else 1, int(m.pos2 is not None)) for m in ms]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: ",".join(o) or "defaults")
def test_reference_equals_the_oracle(world, opts):
    from rapmap_tpu_torch.config import MapConfig

    transcripts, idx, se, pe = world
    sem = Semantics(**opts)
    cfg = MapConfig(k=31, **opts)
    ref = Reference(transcripts, k=31)
    ref.prepare(list(se) + list(pe[0]) + list(pe[1]))
    mapped = 0
    for r in se:
        got = [tuple(x) for x in ref.map_read(r, sem).tolist()]
        assert got == _oracle_se(idx, r, cfg)
        mapped += bool(got)
    for r1, r2 in zip(*pe):
        got = [tuple(x) for x in ref.map_pair(r1, r2, sem).tolist()]
        assert got == _oracle_pe(idx, r1, r2, cfg)
    assert mapped > len(se) // 2 or opts.get("max_interval") or opts.get("max_num_hits")


def test_window_keys_and_revcomp():
    codes = np.array([1, 2, 3, 4, 5, 1, 2], np.uint8)
    keys, ok = window_keys(codes, 3)
    assert keys[0] == (0 << 4) | (1 << 2) | 2 and ok.tolist() == [True, True, False, False, False]
    assert revcomp(codes).tolist() == [3, 4, 5, 1, 2, 3, 4]


def test_duplicates_indexed_once_and_text_only_acgt():
    ref = Reference([("a", b"ACGTACGT"), ("b", b"ACGTACGT"), ("c", b"TTTT")], k=3)
    assert ref.offsets.tolist() == [0, 9]
    with pytest.raises(ValueError):
        Reference([("a", b"ACGN")], k=3)
    with pytest.raises(ValueError):
        Semantics.of({"mapping_score": True})
