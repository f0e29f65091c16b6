"""scripts/genome_scale_torch.py, the port's genome-scale staged run, on the
CPU at a toy size: its FASTA generator byte for byte against
scripts/genome_scale.py's, its pipeline (int64 SA forced by --big-sa, k = 31,
3 shards) against the reference's staged engine and the numpy oracle, its
preflight's refusal, its refusal to run without a card; and the host-side
pieces it leans on at genome scale, chunked so that no temporary spans the
index (the prefix LUT, sa_txp/sa_tpos, the widest interval, a shard's
sa_cmp rows cut into pieces over threads, the 2^31 shard-span guard), each
equal to the whole-array form."""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_pe import jax_cache_off  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--allow-small", "--big-sa", "--gbase", "0.0003",
         "--reads", "256", "--batch", "128", "--shards", "3", "--oracle-sample", "256"]


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gs():
    return _load("genome_scale_torch", os.path.join(REPO, "scripts", "genome_scale_torch.py"))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test runs (as tests/test_torch_staged.py:
    stage A's plain versions issue thousands of tiny ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [5, 11])
def test_gen_fasta_equals_reference(gs, tmp_path, seed):
    """The reference's gen_fasta, taken out of scripts/genome_scale.py with
    ast (its module configures JAX when imported), writes the same bytes."""
    with open(os.path.join(REPO, "scripts", "genome_scale.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "gen_fasta")
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "genome_scale.py", "exec"), ns)
    a, b = str(tmp_path / "ref.fa"), str(tmp_path / "port.fa")
    assert ns["gen_fasta"](a, 60_000, seed) == gs.gen_fasta(b, 60_000, seed)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_pipeline_equals_reference_staged(gs, tmp_path):
    """The script's whole pipeline, saving its index: its staged records
    equal rapmap_tpu.parallel.staged's StagedMapper on the same (saved)
    index and reads, every read agrees with the oracle, the SA is int64,
    every shard was swept, the command line's records of every read (a
    child process) equal the library's, and --drop-fasta removed the FASTA
    once built."""
    from rapmap_tpu.config import MapConfig as RefConfig
    from rapmap_tpu.index.format import load_index as ref_load
    from rapmap_tpu.parallel.staged import StagedMapper as RefStaged

    work = str(tmp_path)
    rc, out, results, codes = gs.run(gs.parser(), [*SMALL, "--workdir", work, "--save-index",
                                                   "--cli", "--drop-fasta"])
    assert rc == 0 and not os.path.exists(os.path.join(work, "genome.fa"))
    assert out["int64_sa"] and out["sa_dtype"] == "int64"
    assert out["oracle_parity"] == "256/256" and out["every_shard_swept"]
    assert out["n_shards"] == 3 and out["map_rate_pct"] > 90
    assert out["cli"]["reads_checked"] == 256 and out["cli"]["reads_unequal"] == 0
    ridx = ref_load(os.path.join(work, "idx"))
    assert np.asarray(ridx.sa).dtype == np.int64
    ref = RefStaged(ridx, RefConfig(k=31, max_hits_per_strand=8), n_shards=3, read_len=76,
                    batch=128)
    want, stats = ref.map_batches([codes[:128], codes[128:]])
    assert results == want
    assert out["anchor_overflow"] == stats["anchor_overflow"]


def test_preflight_refuses_short_memory(gs, tmp_path, monkeypatch, capsys):
    """With MemAvailable made short, the script prints one "skipped" JSON
    line with both figures and the plan, exits 2 and writes no FASTA."""
    monkeypatch.setattr(gs, "mem_available_bytes", lambda: 1 << 20)
    work = str(tmp_path / "w")
    assert gs.main([*SMALL, "--workdir", work]) == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["skipped"] == "not enough host memory"
    assert line["mem_available_bytes"] == 1 << 20 and line["disk_free_bytes"] > 0
    assert line["plan"]["host_total"] > 1 << 20 and line["short"] == ["host memory"]
    assert not os.path.exists(os.path.join(work, "genome.fa"))


def test_preflight_plan_at_genome_scale(gs):
    """The plan at 2.2 Gbase in the int64 layout: ~41 B a base of mapping
    arrays, where the build peaks too (its scans hold a chunk besides their
    results), each process's measured share above them, and with
    --save-index as much disk; --cli adds the command line's child, which
    peaks below the library sweep."""
    p = gs.plan_bytes(int(2.2e9), big_sa=True, shard_gb=2, fasta=True, save_index=True,
                      save_core=True, ckpt_bytes=0)
    index = int(41.25 * 2.2e9)
    assert p["host_bytes_per_base"] == 41.25
    assert p["host_build"] == index + gs.BUILD_OVER
    assert p["host_total"] == index + 6 * 2**30 + gs.SWEEP_OVER
    assert p["disk"]["index"] == index and p["disk"]["core"] == int(5 * 2.2e9)
    c = gs.plan_bytes(int(2.2e9), big_sa=True, shard_gb=2, fasta=True, save_index=False,
                      save_core=True, ckpt_bytes=0, cli=True)
    assert sum(c["host_cli"].values()) == index + 6 * 2**30 + gs.CLI_OVER
    assert c["host_total"] == p["host_total"] and not p["host_cli"]


def test_no_card_fails(gs, tmp_path, monkeypatch):
    """--device cuda (the default) without a card returns 1 before any
    work; it never turns to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = str(tmp_path / "w")
    assert gs.main(["--allow-small", "--gbase", "0.0003", "--workdir", work]) == 1
    assert not os.path.exists(work)


# ---- the chunked host pieces ------------------------------------------------------


@pytest.fixture(scope="module")
def big_idx(gs, tmp_path_factory):
    """An int64-SA index of the script's FASTA at 60 kbase, k = 31."""
    from rapmap_tpu_torch.index.builder import build_quasi_index

    fa = str(tmp_path_factory.mktemp("g") / "g.fa")
    gs.gen_fasta(fa, 60_000)
    return build_quasi_index(fa, k=31, with_chd=False, big_sa=True)


@pytest.mark.parametrize("k,p", [(31, 4), (31, 8), (14, 4), (14, 9)])
def test_prefix_lut_chunks(big_idx, k, p):
    """The prefix LUT counted a chunk of rows at a time equals one count
    over the table and its definition (rows whose prefix is below v), with
    the prefix in the hi word (k = 31) and across both words (k = 14)."""
    from rapmap_tpu_torch.index.kmer_table import build_prefix_lut

    if k == 31:
        hi, lo = big_idx.kmer_hi, big_idx.kmer_lo
        keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    else:
        keys = np.unique(np.random.default_rng(k + p).integers(0, 4**k, 5000, dtype=np.uint64))
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lut = build_prefix_lut(hi, lo, k, p, chunk=777)
    assert np.array_equal(lut, build_prefix_lut(hi, lo, k, p, chunk=1 << 40))
    pref = keys >> np.uint64(2 * (k - p))
    assert np.array_equal(lut, np.searchsorted(pref, np.arange(4**p + 1, dtype=np.uint64)))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sa_txp_tpos_chunks(big_idx, dtype):
    from rapmap_tpu_torch.index.builder import sa_txp_tpos

    sa = np.asarray(big_idx.sa).astype(dtype)
    off, lens = np.asarray(big_idx.txp_offsets), np.asarray(big_idx.txp_lens)
    txp, tpos = sa_txp_tpos(sa, off, lens, chunk=999)
    want_t = np.searchsorted(off, sa.astype(np.int64), side="right") - 1
    assert np.array_equal(txp, want_t) and txp.dtype == np.int32
    assert np.array_equal(tpos, sa.astype(np.int64) - off[want_t]) and tpos.dtype == np.int32
    assert np.array_equal(txp, big_idx.sa_txp) and np.array_equal(tpos, big_idx.sa_tpos)


def test_shard_slice_in_pieces(big_idx, monkeypatch):
    """A shard's arrays cut into sa_cmp pieces of 1,000 slots over 4 threads
    equal the one-piece slice; the widest interval, taken a chunk of rows
    at a time, equals the whole table's."""
    import rapmap_tpu_torch.ops.device_index as di
    import rapmap_tpu_torch.parallel.staged as stg
    from rapmap_tpu_torch.ops.device_index import sa_cmp_rows

    geo = stg.staged_geometry(big_idx, 3)
    whole = [stg.shard_device_arrays(big_idx, geo, p) for p in range(3)]
    monkeypatch.setattr(di, "_PIECE_ROWS", 1000)
    monkeypatch.setattr(di, "_PIECE_THREADS", 4)
    monkeypatch.setattr(stg, "_ROWS", 777)
    assert stg.staged_geometry(big_idx, 3) == geo
    assert geo.max_interval_idx == int((big_idx.kmer_e - big_idx.kmer_b).max())
    for p in range(3):
        d, st, s0 = stg.shard_device_arrays(big_idx, geo, p)
        assert s0 == whole[p][2] and st == whole[p][1]
        for a, b in zip(d, whole[p][0]):
            assert np.array_equal(a, b)
    # the rows themselves: sa_cmp_rows over the shard's slots in one call,
    # its text words padded as before
    s0, s1 = geo.slot_cuts[1], geo.slot_cuts[2]
    sa = np.asarray(big_idx.sa[s0:s1])
    t = np.asarray(big_idx.sa_txp[s0:s1])
    tend = big_idx.txp_offsets[t] + big_idx.txp_lens[t]
    t2b = np.asarray(big_idx.text2b)
    rows = sa_cmp_rows(sa, tend, 31, t2b)
    assert np.array_equal(whole[1][0].sa_cmp[: s1 - s0], rows)
    assert not whole[1][0].sa_cmp[s1 - s0 :].any()
    # a text whose zero tail is cut short still reads zeros past its end
    short = t2b[: (int(sa.max()) + 31) // 16 + 1]
    padded = np.concatenate([short, np.zeros(64, np.uint32)])
    assert np.array_equal(sa_cmp_rows(sa, tend, 31, short), sa_cmp_rows(sa, tend, 31, padded))


def test_shard_span_guard(big_idx, monkeypatch):
    """A shard wider than the int32 local slots refuses to cut."""
    import rapmap_tpu_torch.parallel.staged as stg

    monkeypatch.setattr(stg, "_S_PAD_LIMIT", 1000)
    with pytest.raises(ValueError, match="raise n_shards"):
        stg.staged_geometry(big_idx, 3)


def test_staged_device_bytes(big_idx):
    from rapmap_tpu_torch.parallel.staged import staged_device_bytes, staged_shards

    n = staged_device_bytes(big_idx)
    assert n == len(big_idx.sa) * 24 + len(big_idx.kmer_b) * 16
    assert staged_shards(big_idx) == 1


def test_core_sa_written_in_chunks(big_idx, tmp_path):
    """save_core_index writes its narrowed SA through chunked file writes
    (no memory map): the file is byte for byte np.save's of the uint32 SA,
    its header hash that array's, and the core artifact reloads into the
    same index."""
    import io

    from rapmap_tpu_torch.index.format import _sha, load_header, load_index, save_core_index

    out = str(tmp_path / "core")
    save_core_index(big_idx, out, chunk_rows=1000)
    want = np.asarray(big_idx.sa).astype(np.uint32)
    buf = io.BytesIO()
    np.save(buf, want)
    with open(os.path.join(out, "sa.npy"), "rb") as f:
        assert f.read() == buf.getvalue()
    assert load_header(out)["hashes"]["sa_stored"] == _sha(want)
    core = load_index(out)
    for name in ("sa", "sa_txp", "sa_tpos", "kmer_b", "kmer_e", "prefix_lut"):
        assert np.array_equal(getattr(core, name), getattr(big_idx, name))
    assert np.asarray(core.sa).dtype == np.int64

