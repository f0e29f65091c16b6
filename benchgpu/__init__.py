"""The benchmark of rapmap_tpu_torch (see README.md)."""
