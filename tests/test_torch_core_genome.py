"""The core artifact's reload bounded in host memory, on the CPU at toy
sizes: the k-mer scan a chunk of slots at a time (native and numpy) and the
2-bit pack a chunk of words at a time, each equal to the reference's
unchunked result bit for bit, dtype included; the port's load of a core
written by rapmap_tpu equal to rapmap_tpu's load, array for array and dtype
for dtype, in the int32 and the int64-SA layouts; the SA's incremental hash
equal to the whole array's; the load's peak above its finished arrays, under
tracemalloc, the same at two index sizes; scripts/core_artifact_genome_torch.py
printing the reference script's record keys; and the genome script's
command-line run as a child process, every read's records equal."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest

from tests.test_torch_pe import jax_cache_off  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gs():
    return _load("genome_scale_torch", os.path.join(REPO, "scripts", "genome_scale_torch.py"))


def _fasta(gs, path: str, chars: int, seed: int = 5) -> str:
    gs.gen_fasta(path, chars, seed)
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's index, k = 11, of 12 transcripts of ~200 bases drawn
    from five shared 50-base segments (k-mer runs many slots long, and a '$'
    slot every ~200), and its core artifact, in each SA layout."""
    from rapmap_tpu.index.builder import build_quasi_index
    from rapmap_tpu.index.format import save_core_index

    tmp = tmp_path_factory.mktemp("core")
    fa = str(tmp / "t.fa")
    rng = np.random.default_rng(3)
    segs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 50)) for _ in range(5)]
    with open(fa, "w") as f:
        for i in range(12):
            tail = "".join("ACGT"[c] for c in rng.integers(0, 4, 3))
            f.write(f">t{i}\n{''.join(segs[j] for j in rng.integers(0, 5, 4))}{tail}\n")
    out = {}
    for big in (False, True):
        idx = build_quasi_index(fa, k=11, big_sa=big, with_chd=False)
        d = str(tmp / f"core{int(big)}")
        save_core_index(idx, d)
        out[big] = (idx, d)
    return out


# ---- the chunked k-mer scan and 2-bit pack --------------------------------------------


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("big", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_kmer_scan_chunks(world, monkeypatch, native, big, chunk):
    """The scan at forced-small chunks equals the reference's unchunked
    table bit for bit, dtype included (int64 kmer_b/e under an int64 SA),
    with chunk ends inside runs and on invalid slots."""
    from rapmap_tpu.index.kmer_table import build_kmer_table as ref_table
    from rapmap_tpu_torch.index.kmer_table import build_kmer_table
    from rapmap_tpu_torch.native import bindings as nat

    if native:
        assert nat.available()
    else:
        monkeypatch.setattr(nat, "kmer_table", lambda *a, **kw: None)
    idx = world[big][0]
    sa, text, n = np.asarray(idx.sa), np.asarray(idx.text), idx.n_text
    assert sa.dtype == (np.int64 if big else np.int32)
    want = ref_table(text[:n], sa, idx.k)
    got = build_kmer_table(text[:n], sa, idx.k, chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # chunks that start inside a run, and (but for 64) on an invalid slot
    kb, ke = want[2].astype(np.int64), want[3].astype(np.int64)
    covered = np.zeros(len(sa) + 1, bool)
    for b, e in zip(kb, ke):
        covered[b:e] = True
    starts = np.arange(chunk, len(sa), chunk)
    inside = np.isin(starts, np.concatenate([np.arange(b + 1, e) for b, e in zip(kb, ke)]))
    assert inside.any() and (chunk == 64 or (~covered[starts]).any())


@pytest.mark.parametrize("chunk_words", [1, 5, 1 << 22])
def test_pack_text_chunks(world, chunk_words):
    from rapmap_tpu.index.kmer_table import pack_text_2bit as ref_pack
    from rapmap_tpu_torch.index.kmer_table import pack_text_2bit

    text = np.asarray(world[True][0].text)
    for t in (text, text[:-3], text[:17]):
        for g, w in zip(pack_text_2bit(t, chunk_words=chunk_words), ref_pack(t)):
            assert g.dtype == w.dtype and np.array_equal(g, w)


# ---- the load ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [7, 1 << 24])
@pytest.mark.parametrize("big", [False, True], ids=["int32", "int64"])
def test_core_load_equals_reference(world, big, chunk):
    """The port's load of a core rapmap_tpu wrote equals rapmap_tpu's load
    of it: every array in value and dtype, and every other field."""
    from rapmap_tpu.index.format import load_index as ref_load
    from rapmap_tpu_torch.index.format import QuasiIndex, _load_core_index, load_header

    d = world[big][1]
    want = ref_load(d)
    got = _load_core_index(d, load_header(d), chunk=chunk)
    assert isinstance(got, QuasiIndex)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert type(g) is type(w), f.name  # text stays memory-mapped
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name
    assert got.sa.dtype == (np.int64 if big else np.int32)


@pytest.mark.parametrize("chunk", [1, 7, 64, 1 << 24])
def test_sa_hash_incremental(world, chunk):
    """The SA widened a chunk at a time hashes, chunk by chunk, to _sha of
    the whole stored and widened arrays; a changed stored byte raises."""
    import shutil

    from rapmap_tpu_torch.index.format import _sha, _widen_stored_sa, load_header

    idx, d = world[True]
    h = load_header(d)["hashes"]
    stored = np.load(os.path.join(d, "sa.npy"))
    assert h["sa_stored"] == _sha(stored) and h["sa"] == _sha(np.asarray(idx.sa))
    sa = _widen_stored_sa(os.path.join(d, "sa.npy"), np.int64, h, chunk)
    assert sa.dtype == np.int64 and np.array_equal(sa, idx.sa)
    bad = os.path.join(os.path.dirname(d), f"bad{chunk}.npy")
    shutil.copy(os.path.join(d, "sa.npy"), bad)
    with open(bad, "r+b") as f:
        f.seek(-3, 2)
        f.write(b"\x01")
    with pytest.raises(ValueError, match="sa_stored failed content-hash"):
        _widen_stored_sa(bad, np.int64, h, chunk)


def test_core_load_rejects_a_changed_derivation(world, tmp_path):
    """Verification stays on: a header hash of a derived array that differs
    from the rebuild raises."""
    import shutil

    from rapmap_tpu_torch.index.format import load_index

    d = str(tmp_path / "core")
    shutil.copytree(world[False][1], d)
    with open(os.path.join(d, "header.json")) as f:
        head = json.load(f)
    head["hashes"]["kmer_e"] = "0" * 16
    with open(os.path.join(d, "header.json"), "w") as f:
        json.dump(head, f)
    with pytest.raises(ValueError, match="reconstruction of kmer_e"):
        load_index(d)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_load_peak_above_arrays_is_flat(gs, tmp_path, monkeypatch, native):
    """The load's traced peak above the arrays it returns is the same at
    two index sizes (a chunk's temporaries, not a multiple of the index):
    no temporary spans the SA or the k-mer table. One prefix length for
    both: the LUT's 4^p counts are the header's, not the index size's."""
    from rapmap_tpu_torch.index.builder import build_quasi_index
    from rapmap_tpu_torch.index.format import _load_core_index, load_header, save_core_index
    from rapmap_tpu_torch.native import bindings as nat

    if not native:
        monkeypatch.setattr(nat, "kmer_table", lambda *a, **kw: None)
    excess = []
    for chars in (20_000, 80_000):
        d = str(tmp_path / f"c{chars}")
        save_core_index(build_quasi_index(_fasta(gs, str(tmp_path / f"{chars}.fa"), chars),
                                          k=31, prefix_bases=8, with_chd=False,
                                          big_sa=True), d)
        header = load_header(d)
        tracemalloc.start()
        try:
            idx = _load_core_index(d, header, chunk=256)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        held = sum(a.nbytes for a in vars(idx).values()
                   if isinstance(a, np.ndarray) and not isinstance(a, np.memmap))
        assert held > 30 * idx.n_text  # the SA, k-mer table and sa_txp/sa_tpos at least
        excess.append(peak - held)
    assert excess[1] <= excess[0] + 8192, excess


# ---- the scripts ---------------------------------------------------------------------------


def test_twin_script_record(world, tmp_path):
    """scripts/core_artifact_genome_torch.py, as a process: from a saved
    index (--idx) it writes and reloads the core; from a core (--core) it
    reloads it. Each prints the reference script's record keys."""
    from rapmap_tpu.index.format import save_index

    idx_dir = str(tmp_path / "idx")
    save_index(world[True][0], idx_dir)
    script = os.path.join(REPO, "scripts", "core_artifact_genome_torch.py")
    keys = {"core_disk_bytes", "core_per_array_bytes", "t_save_s", "t_reload_verify_s",
            "peak_rss_gb", "n_text", "n_kmers", "verified"}
    core = str(tmp_path / "core")
    for argv in (["--idx", idx_dir, "--out", core, "--keep"], ["--core", core]):
        out = subprocess.run([sys.executable, script, *argv], capture_output=True, text=True,
                             timeout=120, cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr[-2000:]
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        assert keys <= set(rec) and rec["mem_available_low_bytes"] > 0
        assert rec["n_text"] == world[True][0].n_text
        assert rec["n_kmers"] == len(world[True][0].kmer_b)
        assert rec["core_disk_bytes"] == sum(rec["core_per_array_bytes"].values())
        assert rec["verified"].startswith("all")
    assert os.path.exists(os.path.join(core, "header.json"))  # --core keeps its input


def test_genome_script_cli_child(gs, tmp_path, monkeypatch):
    """genome_scale_torch.py --save-core --cli on the CPU: `quasimap
    --engine auto` from the core runs as a child process, picks the staged
    engine (the device budget made tiny, as an index past the card's
    memory makes it), and every read's records equal the library sweep's."""
    monkeypatch.setenv("TQM_HBM_GB", "0.000001")
    work = str(tmp_path)
    rc, out, results, codes = gs.run(gs.parser(), [
        "--device", "cpu", "--allow-small", "--big-sa", "--gbase", "0.0002",
        "--reads", "192", "--batch", "128", "--shards", "2", "--oracle-sample", "16",
        "--workdir", work, "--save-core", "--cli"])
    assert rc == 0
    cli = out["cli"]
    assert cli["rc"] == 0 and cli["reads_checked"] == 192 and cli["reads_unequal"] == 0
    assert cli["engine"] == "staged" and cli["child_peak_rss_gb"] > 0
    assert cli["parent_rss_gb_at_start"] > 0 and cli["load_s"] > 0 and cli["sweep_s"] > 0
    assert cli["stats"]["reads_total"] == 192
