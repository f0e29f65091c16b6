"""Seconds of build_quasi_index's `tqm.build.chd` span: the canonical CHD,
on its worker thread (index/builder.py). None where the run kept no
program spans."""


def read(run):
    p = getattr(run, "program", None)
    return p["setup"].get("tqm.build.chd") if p else None
