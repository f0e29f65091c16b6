"""Budget exhaustion never silently degrades the port's output: twins of
tests/test_fallback.py. The port's wire flags mark the same reads as the
reference's, `remap_se` restores the oracle's records and equals the
reference's remap field for field, and the port's CLI writes the same SAM
with a starved expansion budget as with an ample one."""

import json

import numpy as np

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.models import fallback as rfb
from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
from rapmap_tpu.oracle import quasimap as rqm
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models import fallback as fb
from rapmap_tpu_torch.models.quasi import QuasiMapper
from rapmap_tpu_torch.ops.wire import FLAG_DEGRADED
from rapmap_tpu_torch.oracle import quasimap as qm
from tests.test_device_parity import batch_of
from tests.test_fallback import _repetitive_world
from tests.test_torch_cli import body, port
from tests.util import write_fastq
from tests.test_torch_pe import jax_cache_off  # noqa: F401


def test_fallback_restores_oracle_results(tmp_path, rng):
    ref_idx, txps, shared = _repetitive_world(tmp_path, rng)
    idx = index_from_reference(vars(ref_idx))
    L = 40
    reads = [shared[j : j + L] for j in range(0, len(shared) - L + 1, 3)]
    reads += [txps[0][1][:L], txps[1][1][100 : 100 + L]]
    codes, lens = batch_of(reads, L)
    # starve the pool so multimapping reads overflow
    kw = dict(k=idx.k, expand_budget=1, max_hits_per_strand=L - idx.k + 1)
    cfg = MapConfig(**kw)
    mapper = QuasiMapper(idx, cfg, device="cpu")
    recsd = mapper.fetch(mapper.map_se_async(codes, lens))
    assert (np.asarray(recsd.flags) & FLAG_DEGRADED).any(), (
        "test should actually exhaust the pool"
    )
    ref = RefMapper(ref_idx, RefConfig(**kw))
    rrecsd = ref.fetch(ref.map_se_async(codes, lens))
    assert np.array_equal(recsd.flags, np.asarray(rrecsd.flags))

    fixed = fb.remap_se(recsd, codes, lens, len(reads), mapper.host_index, cfg, qm)
    off = np.concatenate([[0], np.cumsum(fixed.counts)])
    n_records = 0
    for i in range(len(reads)):
        got = [tuple(r) for r in fixed.recs[off[i] : off[i + 1]]]
        want = [
            (m.txp, m.pos, 0 if m.fwd else 1, m.score)
            for m in qm.map_read(idx, codes[i][: lens[i]], cfg)
        ]
        assert got == want, f"read {i}"
        n_records += len(want)
    assert fixed.counters["records"] == n_records
    assert fixed.counters["host_fallback"] > 0

    rfixed = rfb.remap_se(rrecsd, codes, lens, len(reads), ref_idx, ref.cfg, rqm)
    for f in ("recs", "counts", "flags"):
        assert np.array_equal(getattr(fixed, f), np.asarray(getattr(rfixed, f))), f
    assert (fixed.total, fixed.overflowed) == (rfixed.total, rfixed.overflowed)
    assert fixed.counters == rfixed.counters


def test_cli_starved_budget_equals_ample_budget(tmp_path, rng):
    """End-to-end: --expandBudget 1 (heavy fallback) == --expandBudget 64,
    and --noFallback leaves the starved run short of records."""
    _, txps, shared = _repetitive_world(tmp_path, rng)
    fa = str(tmp_path / "rep.fa")
    reads = [(f"r{j}", shared[j : j + 36]) for j in range(0, 24, 2)]
    fq = write_fastq(str(tmp_path / "r.fq"), reads)
    idx_dir = str(tmp_path / "idx")
    r = port("quasiindex", "-t", fa, "-i", idx_dir, "-k", "11")
    assert r.returncode == 0, r.stderr
    outs, stats = {}, {}
    for name, flags in (("starved", ["--expandBudget", "1"]),
                        ("ample", ["--expandBudget", "64"]),
                        ("starved_no_fallback", ["--expandBudget", "1", "--noFallback"])):
        out, js = str(tmp_path / f"{name}.sam"), str(tmp_path / f"{name}.json")
        r = port("quasimap", "-i", idx_dir, "-r", fq, "-o", out, "--statsJson", js,
                 "--batchSize", "32", *flags)
        assert r.returncode == 0, r.stderr
        outs[name] = [ln for ln in body(out) if not ln.startswith("@")]
        with open(js) as f:
            stats[name] = json.load(f)
        if name == "starved":
            assert "host-oracle fallback handled" in r.stderr  # the rate warning
    assert outs["starved"] == outs["ample"]
    assert outs["starved"], "expected records"
    assert stats["starved"]["host_fallback"] > 0
    assert stats["starved"]["host_fallback_frac"] > 0.01
    assert "host_fallback" not in stats["ample"]
    assert stats["starved"]["records"] == stats["ample"]["records"]
    assert stats["starved_no_fallback"]["over_budget"] > 0
    assert len(outs["starved_no_fallback"]) < len(outs["ample"])
