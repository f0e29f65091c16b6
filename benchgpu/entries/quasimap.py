"""The command line's `quasimap` drain without parsing and SAM, on the
library calls it makes: per batch `QuasiMapper.map_se_async` (pairs:
`map_pe_async`), then `fetch`, then `models/fallback.remap_se`
(`remap_pe`). The index is built in memory from the FASTA
(`build_quasi_index(outdir=None)`) and uploaded lean with the canonical CHD.

Reads (pairs) whose records the shared record buffer cut are counted apart
(the window's `cut_share`), not failed: the buffer holds what the
configuration's `rec_slots` gives it, and such a read still gets its answer.
In each device program whose rec_slots x rows records all went out, they
are the row that reached the buffer's end and every mapped row after it
(`cut_rows`, a copy of scripts/scale_world_torch.py::cut_rows). Their
answers are judged as strict prefixes of the reference's.

The reference is benchgpu/reference.py; the control, the same with its vote
replaced by each transcript's first hit (`VoteSkipped`).
"""

from __future__ import annotations

import tempfile
from dataclasses import dataclass

import numpy as np

from benchgpu import worlds
from benchgpu.reference import Reference, Semantics

FLAG_MAPPED = 8  # ops/wire.py's outcome bit: the read had mappings before compaction


@dataclass
class Program:
    mapper: object
    idx: object
    rows: int  # rows of one device program


def program_rows(B: int, chunk: int) -> int:
    """Rows of one device program of a batch of B (models/quasi.py::_chunk_of)."""
    return chunk if chunk and chunk < B and B % chunk == 0 else B


def cut_rows(counts: np.ndarray, C: int, slots: int) -> np.ndarray:
    """Rows whose records a full record buffer may have cut: in each program
    of C rows whose slots x C records all went out, the row that reached the
    buffer's end and every row after it."""
    counts = np.asarray(counts, np.int64)
    ends = np.cumsum(counts.reshape(-1, C), axis=1)
    full = ends[:, -1] >= slots * C
    out = np.zeros(ends.shape, bool)
    first = np.argmax(ends >= slots * C, axis=1)
    out[full] = np.arange(C)[None, :] >= first[full, None]
    return out.reshape(-1)


def setup(transcripts, config: dict, device: str, spans, batch: int) -> Program:
    """The kernels (a checkout's first run builds them), the index from the
    FASTA and the mapper, each under a set-up span."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.index.builder import build_quasi_index
    from rapmap_tpu_torch.models.quasi import QuasiMapper

    cuda = device == "cuda"
    if cuda:
        with spans("kernel_build"):
            kernels.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        fa = f"{tmp}/txome.fa"
        with spans("fasta"):
            worlds.write_fasta(transcripts, fa)
        with spans("index_build"):
            idx = build_quasi_index(fa, outdir=None, k=int(config["k"]))
    if not idx.meta.get("chd", {}).get("canonical"):
        raise RuntimeError("the index has no canonical CHD: the lean engine needs it")
    with spans("mapper_init"):
        mapper = QuasiMapper(idx, MapConfig(k=idx.k, **config["map_config"]), device=device)
        if cuda:
            torch.cuda.synchronize()
    return Program(mapper, idx, program_rows(batch, mapper.cfg.chunk))


def submit(prog: Program, x):
    if len(x) == 4:
        return prog.mapper.map_pe_async(*x)
    return prog.mapper.map_se_async(*x)


def drain(prog: Program, x, handle, spans):
    """-> (per-row record counts, records, rows in a cut region, mapped rows
    there: those whose records the buffer cut)."""
    from rapmap_tpu_torch.models import fallback as fb
    from rapmap_tpu_torch.oracle import quasimap as oracle

    m = prog.mapper
    B = len(x[0])
    with spans("fetch"):
        raw = m.fetch(handle)
    with spans("fallback"):
        if len(x) == 4:
            wr = fb.remap_pe(raw, *x, B, prog.idx, m.cfg, oracle)
        else:
            wr = fb.remap_se(raw, *x, B, prog.idx, m.cfg, oracle)
    with spans("harness"):
        cut = cut_rows(raw.counts, prog.rows, m.cfg.rec_slots)
        capped = cut & ((np.asarray(raw.flags) & FLAG_MAPPED) != 0)
    return np.asarray(wr.counts), wr.recs, cut, capped


class Answers:
    """A reference's answers to reads (pairs), as the program gives them."""

    def __init__(self, ref: Reference, config: dict, paired: bool):
        self.ref, self.paired = ref, paired
        self.sem = Semantics.of(dict(config["map_config"], k=config["k"]))

    def prepare(self, xs) -> None:
        self.ref.prepare([r for x in xs for r in (x if self.paired else (x,))])

    def answer(self, x) -> np.ndarray:
        return self.ref.map_pair(*x, self.sem) if self.paired else self.ref.map_read(x, self.sem)


def reference(transcripts, config: dict, paired: bool) -> Answers:
    return Answers(Reference(transcripts, k=int(config["k"])), config, paired)


class VoteSkipped(Reference):
    """The reference with its vote (SEMANTICS.md §4) replaced: each
    transcript's first placement and a support of 1, the shortcut a change
    that drops the voting sort would take."""

    def vote(self, hits):
        best: dict[int, tuple[int, int]] = {}
        for t, tp in self.placements(hits):
            best.setdefault(t, (1, tp))
        return best


def control(transcripts, config: dict, paired: bool) -> Answers:
    return Answers(VoteSkipped(transcripts, k=int(config["k"])), config, paired)
