"""Seconds of QuasiMapper.__init__: the auto budget and upload_index
(ops/device_index.py), to a synchronize."""


def read(run):
    return run.setup.get("mapper_init")
