"""rapmap_tpu_torch stands alone: with jax and rapmap_tpu refused at import,
every module imports, a toy index builds and maps on the CPU, and the command
line (`rapmap_tpu_torch.cli`) indexes and maps FASTQ to SAM; a mapper asked
for the default device without a CUDA card raises instead of running on the
CPU, and the command line returns non-zero; chip_smoke.py without the package
beside it exits non-zero."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

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

    torch.cuda.is_available = lambda: False
    try:
        QuasiMapper(idx, cfg)
        raised = False
    except RuntimeError:
        raised = True
    del os.environ["TQM_FORCE_CPU"]
    rc_no_card = cli.main(["quasimap", "-i", idir, "-r", fq, "-o", sam + ".2"])
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rapmap_tpu"))
    print(json.dumps(dict(modules=mods, mapped=out.counters["reads_mapped"],
                          raised=raised, loaded=loaded, rc_index=rc_index, rc_map=rc_map,
                          sam_mapped=sam_mapped, rc_no_card=rc_no_card,
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
              "utils.timers", "ops.compact"):
        assert f"rapmap_tpu_torch.{m}" in res["modules"]
    assert (res["rc_index"], res["rc_map"], res["sam_mapped"]) == (0, 0, 16)
    assert res["rc_no_card"] != 0 and not res["second_sam"]


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
