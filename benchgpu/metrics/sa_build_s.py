"""Seconds of build_quasi_index's `tqm.build.sa` span: the suffix array and
the text pack (index/builder.py). None where the run kept no program
spans."""


def read(run):
    p = getattr(run, "program", None)
    return p["setup"].get("tqm.build.sa") if p else None
