"""Host ms a batch spends in models/fallback.remap_se or remap_pe; mean over
the window's untraced batches."""


def read(run):
    return run.span_mean_ms("fallback")
