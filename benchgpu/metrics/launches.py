"""Device kernels started a batch in the traced stretch (torch.profiler)."""


def read(run):
    t = run.trace
    return t["kernels"] / t["batches"] if t else None
