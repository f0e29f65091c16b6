"""Percent of the traced stretch in which the device idled while the host
was in the wire pack (`tqm.pack_in`; benchgpu/progtrace.py). None where the
trace has no program stages."""


def read(run):
    st = (run.trace or {}).get("stages")
    return 100.0 * st["ranges"].get("tqm.pack_in", {}).get("idle_ms", 0.0) / st["window_ms"] \
        if st else None
