"""Host ms a batch spends in the entry's submit (for quasimap:
QuasiMapper.map_se_async or map_pe_async: the wire's pack, the pinned
upload and every launch of its program, with any wait for a full launch
queue); mean over the window's untraced batches."""


def read(run):
    return run.span_mean_ms("dispatch")
