"""The port's spans (utils/timers.py) on the CPU: with no recorder
installed `span` is one shared null context and nothing is recorded; the
wire buffer is byte for byte the same with a recorder on; a recorder sees
each batch's stages, nested as they run, with their batch numbers (SE and
PE, one program a batch and chunked), the host fallback's and the index
build's set-up stages."""

import threading

import numpy as np
import pytest

from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.builder import build_quasi_index
from rapmap_tpu_torch.index.encode import encode_reads
from rapmap_tpu_torch.models import fallback as fb
from rapmap_tpu_torch.models.quasi import QuasiMapper
from rapmap_tpu_torch.ops.pairs import pe_direct_eligible
from rapmap_tpu_torch.oracle import quasimap as oracle
from rapmap_tpu_torch.utils import timers
from rapmap_tpu_torch.utils.timers import StageTimers, recording, span
from tests.util import random_transcriptome, write_fasta

B, L, CHUNK = 16, 40, 8
BUILD = ("tqm.build.concat", "tqm.build.native", "tqm.build.sa", "tqm.build.kmers",
         "tqm.build.derive", "tqm.build.chd", "tqm.build.chd_join")
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _codes(seqs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    codes = np.full((len(seqs), L), 5, np.int8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        c = encode_reads(np.frombuffer(s, np.uint8))
        codes[i, : len(c)], lens[i] = c, len(c)
    return codes, lens


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Six transcripts of 200-300 bp, each embedding one 60 bp block (reads
    there multimap), the index built under a recorder; two batches of SE
    reads and of pairs (120 bp fragments), the second half-full."""
    rng = np.random.default_rng(7)
    base = random_transcriptome(rng, n_txps=6, min_len=200, max_len=300)
    shared = base[0][1][50:110]
    txps = [(f"t{i}", s[:30] + shared + s[30:]) for i, (_, s) in enumerate(base)]
    fa = write_fasta(str(tmp_path_factory.mktemp("trace") / "t.fa"), txps)
    rec = StageTimers(keep=True)
    with recording(rec):
        idx = build_quasi_index(fa, k=11)
    frags = []
    for j in range(2 * B):
        s = txps[j % len(txps)][1]
        p = int(rng.integers(0, len(s) - 120))
        frags.append(s[p : p + 120])
    se = [_codes([f[:L] for f in frags[b * B : (b + 1) * B]]) for b in range(2)]
    pe = [(*_codes([f[:L] for f in frags[b * B : (b + 1) * B]]),
           *_codes([f[-L:].translate(COMP)[::-1] for f in frags[b * B : (b + 1) * B]]))
          for b in range(2)]
    return idx, rec, se, pe


def _run(mapper, kind: str, batches):
    """Both batches in flight, then both fetched -> (handles, results)."""
    hs = []
    for n, x in zip((B, B // 2), batches):
        hs.append(mapper.map_se_async(*x, n_valid=n) if kind == "se"
                  else mapper.map_pe_async(*x, n_valid=n))
    return hs, [mapper.fetch(h) for h in hs]


def test_no_recorder_records_nothing(world):
    idx, _, se, _ = world
    assert timers._recorder is None
    assert span("tqm.vote") is span("tqm.walk", 3) is timers._NULL
    idle = StageTimers(keep=True)
    _run(QuasiMapper(idx, MapConfig(k=idx.k), device="cpu"), "se", se)
    with recording(idle), recording(None):
        assert span("tqm.vote") is timers._NULL
        _run(QuasiMapper(idx, MapConfig(k=idx.k), device="cpu"), "se", se)
    assert timers._recorder is None
    assert not idle.spans and not idle.totals


PATHS = [(kind, chunk) for kind in ("se", "pe") for chunk in (0, CHUNK)]


@pytest.fixture(scope="module")
def runs(world):
    """Each path run with no recorder and under one that keeps and annotates."""
    idx, _, se, pe = world
    out = {}
    for kind, chunk in PATHS:
        got = []
        for rec in (None, StageTimers(keep=True)):
            mapper = QuasiMapper(idx, MapConfig(k=idx.k, chunk=chunk), device="cpu")
            if rec is not None:
                rec.annotate = True
            with recording(rec):
                got.append((mapper, rec, *_run(mapper, kind, se if kind == "se" else pe)))
        out[(kind, chunk)] = got
    return out


@pytest.mark.parametrize("path", PATHS, ids=[f"{k}-chunk{c}" for k, c in PATHS])
def test_wire_out_identical_with_recorder(runs, path):
    (_, _, h_off, r_off), (_, _, h_on, r_on) = runs[path]
    for a, b, ra, rb in zip(h_off, h_on, r_off, r_on):
        assert a.wire.numpy().tobytes() == b.wire.numpy().tobytes()
        for f in ("recs", "counts", "flags"):
            assert np.array_equal(getattr(ra, f), getattr(rb, f)), f
        assert ra.counters == rb.counters


@pytest.mark.parametrize("path", PATHS, ids=[f"{k}-chunk{c}" for k, c in PATHS])
def test_spans_of_each_batch(runs, path):
    kind, chunk = path
    mapper, rec, hs, _ = runs[path][1]
    assert [h.seq for h in hs] == [0, 1]
    programs = 2 if kind == "pe" else 1  # scans a batch, per chunk
    chunks = B // chunk if chunk else 1
    votes = 1 if kind == "pe" and chunk and pe_direct_eligible(mapper.st, mapper.cfg, chunk) \
        else programs
    want = {
        "tqm.pack_in": (1, None), "tqm.upload": (1, None), "tqm.program": (1, None),
        "tqm.dense": (programs * chunks, "tqm.program"),
        "tqm.walk": (programs * chunks, "tqm.program"),
        "tqm.vote": (votes * chunks, "tqm.program"),
        "tqm.compact": (chunks, "tqm.program"), "tqm.pack_out": (1, "tqm.program"),
        "tqm.fetch_wait": (1, None), "tqm.unpack_out": (1, None),
    }
    if kind == "pe" and not (chunk and votes == 1):
        want["tqm.merge"] = (chunks, "tqm.program")
    for seq in (0, 1):
        mine = [s for s in rec.spans if s.batch == seq]
        (prog,) = [s for s in mine if s.name == "tqm.program"]
        got: dict = {}
        for s in mine:  # a stage of the program runs inside its span, the others outside
            parent = ("tqm.program" if s is not prog and prog.start <= s.start
                      and s.end <= prog.end else None)
            n, p = got.get(s.name, (0, parent))
            assert p == parent, s.name
            got[s.name] = (n + 1, parent)
        assert got == want, seq
        assert all(s.start <= s.end for s in mine)


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_fallback_spans(world, kind):
    """A starved expansion pool degrades the block's multimapping reads;
    the oracle's remap of each batch is a span under the batch fetched."""
    idx, _, se, pe = world
    cfg = MapConfig(k=idx.k, expand_budget=1, max_hits_per_strand=L - idx.k + 1)
    mapper = QuasiMapper(idx, cfg, device="cpu")
    rec = StageTimers(keep=True)
    with recording(rec):
        hs = []
        for x in (se if kind == "se" else pe):
            hs.append(mapper.map_se_async(*x) if kind == "se" else mapper.map_pe_async(*x))
        fixed = []
        for h, x in zip(hs, se if kind == "se" else pe):
            r = mapper.fetch(h)
            remap = fb.remap_se if kind == "se" else fb.remap_pe
            fixed.append(remap(r, *x, B, idx, cfg, oracle))
    took = [f.counters.get("host_fallback", 0) for f in fixed]
    assert sum(took) > 0, "the pool should be starved"
    fallbacks = [s for s in rec.spans if s.name == "tqm.fallback"]
    assert [s.batch for s in fallbacks] == [0, 1]
    fetches = [s for s in rec.spans if s.name == "tqm.unpack_out"]
    assert all(f.start >= u.end for f, u in zip(fallbacks, fetches))


def test_build_spans(world):
    """The build's stages, the native library's load kept out of the suffix
    array's span, and the CHD on its worker thread inside the wait for it."""
    _, rec, _, _ = world
    assert sorted(s.name for s in rec.spans) == sorted(BUILD)
    assert all(s.end >= s.start for s in rec.spans)
    at = {s.name: s for s in rec.spans}
    assert at["tqm.build.native"].end <= at["tqm.build.sa"].start
    assert at["tqm.build.chd"].end <= at["tqm.build.chd_join"].end


def test_no_span_lost_across_threads():
    """Spans ended on several threads at once: every one is kept, with its
    total and count."""
    rec = StageTimers(keep=True)
    threads, spans = 8, 100
    with recording(rec):

        def job(j):
            for _ in range(spans):
                with span(f"job{j}"), span(f"inner{j}"):
                    pass

        ts = [threading.Thread(target=job, args=(j,)) for j in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    assert len(rec.spans) == 2 * threads * spans
    assert all(rec.counts[f"{n}{j}"] == spans for n in ("job", "inner") for j in range(threads))
