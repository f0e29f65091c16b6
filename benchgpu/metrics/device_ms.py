"""Device busy ms a batch: kernel, copy and memset intervals merged over the
traced stretch, over its batches (torch.profiler)."""


def read(run):
    t = run.trace
    return 1e3 * t["busy_s"] / t["batches"] if t else None
