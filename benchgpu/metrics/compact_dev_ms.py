"""Device ms a batch of the operations launched under `tqm.compact`, the
innermost program range at their launch (benchgpu/progtrace.py). None
where the trace has no program stages or no such range."""


def read(run):
    st = (run.trace or {}).get("stages")
    v = st["ranges"].get("tqm.compact") if st else None
    return v["device_ms"] if v else None
