"""rapmap_tpu_torch stands alone: with jax and rapmap_tpu refused at import,
every module imports, a toy index builds and maps single-end reads and pairs
on the CPU (and one without a CHD, packed and charwise), a toy pseudo index
builds and pseudo-maps reads and pairs, the host-staged engine maps from
the mapping-only artifact and from the pseudo index, a core artifact
reloads and maps, a toy batch maps data-parallel over two CPU entries
(parallel/dp.py) and on the SA-sharded index (parallel/sharded.py; the
walk's plain version), parallel/multihost.py imports, and the command line
(`rapmap_tpu_torch.cli`) indexes and maps FASTQ to SAM, single-end and
paired-end, quasi and pseudo; a mapper asked for the default device without
a CUDA card raises instead of running on the CPU, and the command line
returns non-zero; chip_smoke.py without the package beside it exits
non-zero."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, json, pkgutil, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "rapmap_tpu"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rapmap_tpu")]:
        del sys.modules[m]

    import numpy as np
    import torch
    import rapmap_tpu_torch

    mods = [m.name for m in pkgutil.walk_packages(rapmap_tpu_torch.__path__, "rapmap_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)

    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.index.builder import build_quasi_index
    from rapmap_tpu_torch.models.quasi import QuasiMapper

    rng = np.random.default_rng(0)
    fa = sys.argv[1]
    seqs = [rng.integers(0, 4, int(n)) for n in rng.integers(150, 300, 5)]
    with open(fa, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">t{i}\\n" + "".join("ACGT"[c] for c in s) + "\\n")
    idx = build_quasi_index(fa, k=11)
    codes = np.full((16, 40), 5, np.int8)
    for i in range(16):
        s = seqs[i % 5]
        p = int(rng.integers(0, len(s) - 40))
        codes[i] = s[p : p + 40] + 1
    lens = np.full(16, 40, np.int32)
    cfg = MapConfig(k=11, chunk=8)
    res = QuasiMapper(idx, cfg, device="cpu")
    out = res.fetch(res.map_se_async(codes, lens))
    # pairs: each read with its own reverse complement as the right mate
    pe = res.fetch(res.map_pe_async(codes, lens, (5 - codes[:, ::-1]).copy(), lens))
    # an index without a CHD (binary-search probe, full upload), and the
    # charwise extension on it
    nochd = build_quasi_index(fa, k=11, with_chd=False)
    nochd_mapped = [
        QuasiMapper(nochd, MapConfig(k=11, chunk=8, packed_extension=p), device="cpu")
        .map_se(codes, lens)[1].reads_mapped.item() for p in (True, False)]
    # a pseudo index: reads and pairs
    from rapmap_tpu_torch.index.builder import build_pseudo_index
    from rapmap_tpu_torch.models.pseudo import PseudoMapper

    pidx = build_pseudo_index(fa, k=11)
    pmap = PseudoMapper(pidx, cfg, device="cpu")
    ps = pmap.fetch(pmap.map_se_async(codes, lens))
    ps_pe = pmap.fetch(pmap.map_pe_async(codes, lens, (5 - codes[:, ::-1]).copy(), lens))

    # the command line, in process: quasiindex, then quasimap FASTQ -> SAM
    import os
    from rapmap_tpu_torch import cli

    fq, sam, idir = fa + ".fq", fa + ".sam", fa + ".idx"
    with open(fq, "w") as f:
        for i in range(16):
            f.write(f"@r{i}\\n" + "".join("ACGT"[c - 1] for c in codes[i]) + "\\n+\\n"
                    + "I" * 40 + "\\n")
    os.environ["TQM_FORCE_CPU"] = "1"
    rc_index = cli.main(["quasiindex", "-t", fa, "-i", idir, "-k", "11"])
    rc_map = cli.main(["quasimap", "-i", idir, "-r", fq, "-o", sam, "--batchSize", "8"])
    with open(sam) as f:
        sam_mapped = sum(1 for ln in f if ln[0] != "@" and not int(ln.split("\\t")[1]) & 0x104)
    rc_pe = cli.main(["quasimap", "-i", idir, "-1", fq, "-2", fq, "-o", sam + ".pe",
                      "--batchSize", "8", "--chunkSize", "4"])
    with open(sam + ".pe") as f:
        pe_records = sum(1 for ln in f if ln[0] != "@" and not int(ln.split("\\t")[1]) & 0x4)
    # the host-staged engine on the mapping-only and core artifacts
    from rapmap_tpu_torch.index.format import load_index, save_core_index, save_mapping_index
    from rapmap_tpu_torch.parallel.staged import StagedPseudoMapper, StagedQuasiMapper

    save_mapping_index(idx, fa + ".map")
    save_core_index(idx, fa + ".core")
    staged = StagedQuasiMapper(load_index(fa + ".map"), cfg, batch=16, read_len=40,
                               n_shards=2, device="cpu")
    staged_mapped = staged.fetch(staged.map_se_async(codes, lens)).counters["reads_mapped"]
    core_mapped = QuasiMapper(load_index(fa + ".core"), cfg, device="cpu").map_se(
        codes, lens)[1].reads_mapped.item()
    pstaged = StagedPseudoMapper(pidx, cfg, batch=16, read_len=40, n_shards=2, device="cpu")
    pstaged_mapped = pstaged.fetch(pstaged.map_se_async(codes, lens)).counters["reads_mapped"]
    # data parallel over two CPU entries, and the SA-sharded engine
    from rapmap_tpu_torch.parallel import dp, multihost, sharded

    tc, tl = torch.from_numpy(codes), torch.from_numpy(lens.astype(np.int64))
    _, dp_ctr = dp.map_batch_se_dp(res.didx, res.st, tc, tl, dp.split_valid(16, 2, 8), res.cfg,
                                   dp.make_mesh(2, devices=["cpu", "cpu"]))
    sh_arr, sh_st = sharded.shard_quasi_index(idx, 2)
    _, sh_ctr = sharded.map_batch_se_sharded(sh_arr, sh_st, tc, tl, np.array([8, 8]), res.cfg,
                                             sharded.make_mesh_2d(2, 2, ["cpu"]))
    par_mapped = [int(dp_ctr.reads_mapped), int(sh_ctr.reads_mapped),
                  callable(multihost.global_counter_sum)]
    pdir = fa + ".pidx"
    rc_pindex = cli.main(["pseudoindex", "-t", fa, "-i", pdir, "-k", "11"])
    rc_pmap = cli.main(["pseudomap", "-i", pdir, "-r", fq, "-o", sam + ".ps",
                        "--batchSize", "8"])
    rc_ppe = cli.main(["pseudomap", "-i", pdir, "-1", fq, "-2", fq, "-o", sam + ".pspe",
                       "--batchSize", "8"])
    with open(sam + ".ps") as f:
        ps_sam_mapped = sum(1 for ln in f if ln[0] != "@" and not int(ln.split("\\t")[1]) & 0x104)
    with open(sam + ".pspe") as f:
        ps_pe_records = sum(1 for ln in f if ln[0] != "@" and not int(ln.split("\\t")[1]) & 0x4)

    torch.cuda.is_available = lambda: False
    try:
        QuasiMapper(idx, cfg)
        raised = False
    except RuntimeError:
        raised = True
    try:
        PseudoMapper(pidx, cfg)
        ps_raised = False
    except RuntimeError:
        ps_raised = True
    del os.environ["TQM_FORCE_CPU"]
    rc_no_card = cli.main(["quasimap", "-i", idir, "-r", fq, "-o", sam + ".2"])
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rapmap_tpu"))
    print(json.dumps(dict(modules=mods, mapped=out.counters["reads_mapped"],
                          pe_mapped=pe.counters["reads_mapped"], pe_kind=pe.recs.shape[1],
                          nochd_mapped=nochd_mapped,
                          rc_pe=rc_pe, pe_records=pe_records,
                          raised=raised, loaded=loaded, rc_index=rc_index, rc_map=rc_map,
                          sam_mapped=sam_mapped, rc_no_card=rc_no_card,
                          ps_mapped=ps.counters["reads_mapped"],
                          ps_pe_mapped=ps_pe.counters["reads_mapped"], ps_raised=ps_raised,
                          rc_pseudo=[rc_pindex, rc_pmap, rc_ppe], ps_sam_mapped=ps_sam_mapped,
                          ps_pe_records=ps_pe_records, staged_mapped=staged_mapped,
                          core_mapped=core_mapped, pstaged_mapped=pstaged_mapped,
                          par_mapped=par_mapped,
                          second_sam=os.path.exists(sam + ".2"))))
""")


def test_port_imports_and_maps_without_jax(tmp_path):
    script = tmp_path / "iso.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "t.fa")], cwd=str(tmp_path),
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert "rapmap_tpu_torch.models.quasi" in res["modules"]
    assert "rapmap_tpu_torch.ops.sort2" in res["modules"]
    assert res["mapped"] == 16
    assert res["raised"], "QuasiMapper(device=None) ran without a CUDA card"
    for m in ("cli", "io.fastx", "io.sam", "oracle.quasimap", "models.fallback",
              "utils.timers", "ops.compact", "ops.pairs"):
        assert f"rapmap_tpu_torch.{m}" in res["modules"]
    assert (res["rc_index"], res["rc_map"], res["sam_mapped"]) == (0, 0, 16)
    assert (res["pe_mapped"], res["pe_kind"]) == (16, 7)
    assert res["nochd_mapped"] == [16, 16]
    for m in ("ops.lookup", "ops.encode", "index.chd"):
        assert f"rapmap_tpu_torch.{m}" in res["modules"]
    assert res["rc_pe"] == 0 and res["pe_records"] > 0
    assert res["rc_no_card"] != 0 and not res["second_sam"]
    for m in ("models.pseudo", "oracle.pseudomap"):
        assert f"rapmap_tpu_torch.{m}" in res["modules"]
    assert (res["ps_mapped"], res["ps_pe_mapped"], res["ps_sam_mapped"]) == (16, 16, 16)
    assert res["rc_pseudo"] == [0, 0, 0] and res["ps_pe_records"] > 0
    assert res["ps_raised"], "PseudoMapper(device=None) ran without a CUDA card"
    assert "rapmap_tpu_torch.parallel.staged" in res["modules"]
    assert (res["staged_mapped"], res["core_mapped"], res["pstaged_mapped"]) == (16, 16, 16)
    for m in ("dp", "multihost", "sharded"):
        assert f"rapmap_tpu_torch.parallel.{m}" in res["modules"]
    assert res["par_mapped"] == [16, 16, True]


def _imports(path: str) -> set[str]:
    """The top-level names of every module a Python file imports, at any depth."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("where", ["parallel", "chip_smoke.py"])
def test_no_jax_imports(where):
    """The parallel subpackage (staged, dp, multihost, sharded) and
    chip_smoke.py name neither jax nor rapmap_tpu in any import statement (the run above refuses them at
    import; this reads the source, so an import on a path the run does not
    take counts too)."""
    root = os.path.join(REPO, "rapmap_tpu_torch", where) if where == "parallel" else REPO
    files = ([os.path.join(root, f) for f in os.listdir(root) if f.endswith(".py")]
             if where == "parallel" else [os.path.join(REPO, where)])
    assert files
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "rapmap_tpu"}
        assert not bad, (path, bad)


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for args in ([], ["--cpu-rehearsal"]):
        out = subprocess.run(
            [sys.executable, "chip_smoke.py", *args], cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
