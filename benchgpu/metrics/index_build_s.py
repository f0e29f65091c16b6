"""Seconds of build_quasi_index from the FASTA (index/builder.py, native/)."""


def read(run):
    return run.setup.get("index_build")
