"""Single-end reads of the batches drained in the window (fetched, through
the fallback) over the window's seconds, host clock."""


def read(run):
    return run.rows_per_s
