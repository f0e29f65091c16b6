#!/usr/bin/env python3
"""Run one cell of the benchmark of rapmap_tpu_torch once, on the CUDA card.

    python3 benchgpu/run.py --workload isoform_6k.se --seed 7 --seconds 10 --trace 0

The cell, its configuration (benchgpu/configs/<config>.json), its traffic
(benchgpu/mixes/<traffic>.json) and its metrics (benchgpu/metrics/<metric>.py,
or the reader of the name's part before its first dot) are found by name
from BENCHMARK.json at the checkout's root; the configuration names its
entry, world and read model the same way (see benchgpu/harness.py). With
--trace 0 the line reports the cell's end-to-end metrics, with --trace 1
its per-layer metrics, read from a torch.profiler trace of a stretch of the
window and from the harness's host spans.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, (--trace 1) breakdown, and last, checks: each
number compared with its limit, which also end standard error. Without a
CUDA card, or with fewer cards than the cell asks for, it prints no result
and exits 2; it exits 3 if a JAX module is loaded when the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rapmap_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def plan(bench: dict, workload: str) -> tuple[dict, list, list]:
    """-> (the cell, its end-to-end metrics, its per-layer metrics)."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return cell, e2e, layer


def reader_file(name: str) -> str:
    """benchgpu/metrics/<name>.py, or else the reader of the name's base (the
    part before its first dot), which serves every cell the metric lists."""
    own = os.path.join(HERE, "metrics", f"{name}.py")
    return own if os.path.exists(own) else os.path.join(HERE, "metrics",
                                                        f"{name.split('.')[0]}.py")


def reader(name: str):
    """The read(run) function of the metric's reader file."""
    spec = importlib.util.spec_from_file_location(
        "benchgpu_metric_" + name.replace(".", "_"), reader_file(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def run_workload(workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", config: dict | None = None,
                 mix: dict | None = None) -> tuple[int, dict | None]:
    """One run of a cell -> (exit code, the result line or None). device
    "cpu" (tests only) maps with the program's plain versions and skips the
    look for a card; config and mix, where given, replace the cell's files."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell, e2e, layer = plan(bench, workload)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        log(f"{workload} needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2, None
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if importlib.util.find_spec("rapmap_tpu_torch") is None:
        log("rapmap_tpu_torch is not in this checkout")
        return 2, None
    from benchgpu import harness

    config = config or load_json(HERE, "configs", f"{cell['config']}.json")
    mix = mix or load_json(HERE, "mixes", f"{cell['traffic']}.json")
    rec, win, verdict, dev = harness.run_cell(config, mix, seed, seconds, trace, device,
                                              T_START)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package were loaded: {', '.join(bad)}")
        return 3, None

    metrics = {}
    for m in (layer if trace else e2e):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = verdict["unequal"] == 0 and verdict["checked"] > 0 and win.batches > 0
    out = dict(correct=correct, attempted=win.attempted, failed=win.failed,
               metrics=metrics, device=dev)
    if trace and rec.trace:
        out["breakdown"] = {k: rec.trace[k] for k in ("device_ops", "idle_gaps")}
    out["run"] = dict(workload=workload, seed=seed, batches=win.batches,
                      window_s=win.seconds, setup_spans=rec.setup,
                      **{k: verdict[k] for k in ("checked", "distinct_answers", "equal",
                                                 "cut", "unequal", "reference_s", "examples")})
    out["checks"] = {"unequal_answers": {"value": verdict["unequal"], "limit": 0}}
    log(f"{workload} seed {seed}: {win.batches} batches in {win.seconds:.3f}s, "
        f"{verdict['checked']} sampled answers checked ({verdict['cut']} cut by the record "
        f"buffer), correct {correct}")
    log(f"check unequal_answers: {verdict['unequal']} (limit 0)")
    return 0, out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    code, out = run_workload(args.workload, args.seed, args.seconds, bool(args.trace))
    if out is not None:
        print(json.dumps(out), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
