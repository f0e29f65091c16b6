"""The read traffic of a mix, made from the seed: one general generator that
reads a mix's parameters (benchgpu/mixes/<name>.json) and draws its batches
with the read model the mix names (`reads`: benchgpu/reads/<model>.py).

A read model is a module with `PAIRED` and `draw(mix, text, gen)`, which
returns one batch of `mix["batch"]` rows drawn from the text codes
(worlds.text_codes): (codes, lens) for single-end reads, (codes1, lens1,
codes2, lens2) for pairs; codes are (rows, width) int8, A..T = 1..4, and a
row's codes past its length are ignored. A new read model is a new module
there. The helpers below are the pieces the models share.

Reads come in batches of `batch` rows; the pool holds `pool_batches` of
them and the window cycles through it. `sample_per_batch` rows of each pool
batch are the answers held to the reference.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

from benchgpu.worlds import rng


@dataclass
class Pool:
    paired: bool
    batch: int
    batches: list      # per pool batch, the read model's tuple of arrays
    sample: list       # per pool batch, the sorted rows held to the reference

    def reads_of(self, b: int, row: int):
        """The codes of pool batch b's row: a read, or a pair's two mates."""
        x = self.batches[b]
        if self.paired:
            return x[0][row, : x[1][row]], x[2][row, : x[3][row]]
        return x[0][row, : x[1][row]]


def windows(text: np.ndarray, n: int, width: int, gen) -> np.ndarray:
    """n windows of `width` text codes at uniform starts; a transcript end
    inside one becomes a random base."""
    starts = gen.integers(0, len(text) - width, size=n)
    w = text[starts[:, None] + np.arange(width)]
    bad = w < 1
    w[bad] = gen.integers(1, 5, int(bad.sum()), dtype=np.uint8)
    return w


def substitute(w: np.ndarray, rate: float, gen) -> np.ndarray:
    """Each code replaced by a random base at `rate`, in place."""
    hit = gen.random(w.shape) < rate
    w[hit] = gen.integers(1, 5, int(hit.sum()), dtype=np.uint8)
    return w


def revcomp_rows(w: np.ndarray) -> np.ndarray:
    return (5 - w)[:, ::-1]


def make_pool(mix: dict, text: np.ndarray, seed: int) -> Pool:
    """The mix's pool of batches, drawn from `text` (worlds.text_codes)."""
    model = importlib.import_module(f"benchgpu.reads.{mix['reads']}")
    gen, pick = rng(seed, 2), rng(seed, 3)
    B = int(mix["batch"])
    batches = [model.draw(mix, text, gen) for _ in range(int(mix["pool_batches"]))]
    k = min(B, int(mix["sample_per_batch"]))
    sample = [np.sort(pick.choice(B, k, replace=False)) for _ in batches]
    return Pool(bool(model.PAIRED), B, batches, sample)
