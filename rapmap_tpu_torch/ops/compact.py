"""Dense record buffers (port of rapmap_tpu.ops.compact's SERecords; the
slotted MapOut compaction and the paired-end records belong to later
slices)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SERecords(NamedTuple):
    recs: torch.Tensor       # (cap, W) int32: t, pos, strand, score (row-major
    #                          by read), or 2 packed words per wire.RecSpec
    counts: torch.Tensor     # (B,) records per read
    total: torch.Tensor      # scalar
    overflowed: torch.Tensor  # scalar bool — cap exceeded, tail dropped
