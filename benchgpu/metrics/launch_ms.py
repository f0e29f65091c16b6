"""Host ms a batch in the program's launches (`tqm.program`: every launch
of the batch's wire program, models/quasi.py); mean over the window's
untraced batches. None where the run kept no program spans."""


def read(run):
    p = getattr(run, "program", None)
    return p["batch_ms"].get("tqm.program") if p else None
