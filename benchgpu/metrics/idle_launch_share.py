"""Percent of the traced stretch in which the device idled while the host
was in `tqm.program` or a stage inside it (benchgpu/progtrace.py: PROGRAM).
None where the trace has no program stages."""

from benchgpu.progtrace import PROGRAM


def read(run):
    st = (run.trace or {}).get("stages")
    if not st:
        return None
    return 100.0 * sum(st["ranges"].get(n, {}).get("idle_ms", 0.0) for n in PROGRAM) \
        / st["window_ms"]
