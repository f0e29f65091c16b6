"""Host ms a batch in the program's wire pack (`tqm.pack_in`: ops/wire.py
pack_in_se / pack_in_pe, host numpy); mean over the window's untraced
batches. None where the run kept no program spans."""


def read(run):
    p = getattr(run, "program", None)
    return p["batch_ms"].get("tqm.pack_in") if p else None
