"""A transcriptome of independent random transcripts: a frozen, vectorised
copy of scripts/bench_scale.py::build_scale_world (the 100 Mbase FASTA
maker). Lognormal lengths (mu 6.8, sigma 0.75, clipped to 200-20,000, median
~900 bp) until the bases reach `mbase` million, the last transcript
included; names t<i>.
"""

from __future__ import annotations

import numpy as np

from benchgpu.worlds import ACGT


def make(shape: np.random.Generator, bases: np.random.Generator,
         mbase: float) -> list[tuple[str, bytes]]:
    target = mbase * 1_000_000
    lens = np.zeros(0, np.int64)
    while not len(lens) or lens.sum() < target:
        more = np.clip(shape.lognormal(6.8, 0.75, 1 + int(target / 1000)), 200, 20_000)
        lens = np.concatenate([lens, more.astype(np.int64)])
    n = int(np.searchsorted(np.cumsum(lens), target)) + 1
    lens = lens[:n]
    seq = ACGT[bases.integers(0, 4, int(lens.sum()), dtype=np.uint8)].tobytes()
    ends = np.cumsum(lens)
    return [(f"t{i}", seq[e - m : e]) for i, (e, m) in enumerate(zip(ends.tolist(), lens.tolist()))]
