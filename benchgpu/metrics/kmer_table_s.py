"""Seconds of build_quasi_index's `tqm.build.kmers` span: the k-mer table
(index/builder.py). None where the run kept no program spans."""


def read(run):
    p = getattr(run, "program", None)
    return p["setup"].get("tqm.build.kmers") if p else None
