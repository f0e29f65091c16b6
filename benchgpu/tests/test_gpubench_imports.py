"""What a run loads: nothing of JAX or of the JAX package (rapmap_tpu), and
the reference nothing of the program either. Each check runs in a fresh
process and compares top-level module names whole (rapmap_tpu_torch's name
begins with rapmap_tpu's)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from benchgpu import run
from benchgpu.tests import gpubench_toy as toy
code, out = run.run_workload("isoform_6k.pe", 11, 0.2, False, device="cpu",
                             config=toy.config(), mix=toy.mix("pe76_b64k"))
assert code == 0 and out["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from benchgpu.reference import Reference, Semantics
ref = Reference([("a", b"ACGTTGCAACGGT" * 5)], k=7)
ref.prepare([[1, 2, 3, 4, 4, 3, 2, 1, 1, 2, 3]])
ref.map_read([1, 2, 3, 4, 4, 3, 2, 1, 1, 2, 3], Semantics(k=7))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True,
                       text=True, timeout=600, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level_names(RUN)
    assert "rapmap_tpu_torch" in names and "benchgpu" in names
    assert not names & {"jax", "jaxlib", "flax", "rapmap_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_names(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "rapmap_tpu", "rapmap_tpu_torch", "torch"}
