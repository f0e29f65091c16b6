"""Host ms a batch waits in QuasiMapper.fetch for its result copy and
unpacks it; mean over the window's untraced batches."""


def read(run):
    return run.span_mean_ms("fetch")
