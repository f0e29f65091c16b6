"""Toy sizes of the benchmark's configurations and mixes, for CPU tests."""

import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def config(name: str = "isoform_6k", **world) -> dict:
    """A configuration of the benchmark with a toy world: 30 genes, or
    0.05 Mbase for the lognormal world."""
    cfg = load("configs", name)
    small = {"isoform": {"n_genes": 30}, "lognormal": {"mbase": 0.05}}[cfg["world"]["kind"]]
    cfg["world"].update(small, **world)
    return cfg


def mix(name: str, batch: int = 256, pool_batches: int = 2) -> dict:
    """A mix of the benchmark in toy batches, every row sampled."""
    m = load("mixes", name)
    m.update(batch=batch, pool_batches=pool_batches, sample_per_batch=batch)
    return m
