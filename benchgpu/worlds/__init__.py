"""The transcriptomes the benchmark maps against, made from the seed.

A configuration's `world` names its maker by `kind`: the module
benchgpu/worlds/<kind>.py, whose `make(shape, bases, **params)` returns
[(name, sequence bytes)]. A new kind of world is a new module here.

A world's shape (gene structures, exon and transcript lengths, paralog
sources, mutation sites) comes from the configuration's fixed `shape_seed`,
its bases from the run's seed. So every seed maps the same amount of
sequence with the same repeat structure, and only the letters differ.
"""

from __future__ import annotations

import importlib

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use (`stream`) of a run's seed."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def make(config: dict, seed: int) -> list[tuple[str, bytes]]:
    """A configuration's transcriptome for this seed."""
    world = dict(config["world"])
    maker = importlib.import_module(f"benchgpu.worlds.{world.pop('kind')}")
    shape = np.random.default_rng(world.pop("shape_seed"))
    return maker.make(shape, rng(seed, 1), **world)


def write_fasta(transcripts, path: str) -> None:
    with open(path, "wb") as f:
        for name, seq in transcripts:
            f.write(b">%s\n%s\n" % (name.encode(), seq))


def text_codes(transcripts) -> np.ndarray:
    """The transcripts as one code array, A..T = 1..4, a 0 after each: the
    sequence reads are drawn from."""
    lut = np.zeros(256, np.uint8)
    lut[ACGT] = (1, 2, 3, 4)
    parts = []
    for _, seq in transcripts:
        parts += [lut[np.frombuffer(seq, np.uint8)], np.zeros(1, np.uint8)]
    return np.concatenate(parts)
