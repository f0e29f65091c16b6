"""Seconds from process start to the window's first dispatch: the world and
its reads, the kernel build (a first run), the index, the mapper and its
upload, and the warm batches."""


def read(run):
    return run.setup_s
