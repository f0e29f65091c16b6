"""An isoform transcriptome: a frozen, vectorised copy of
scripts/txome_sim.py::gen_isoform_txome (bench.py's build_isoform_world).
Genes of shared exon blocks, isoforms as ordered exon subsets, and
near-duplicate paralog genes; names gene<g>.iso<i> (paralogs gene<g>p.iso<i>).
"""

from __future__ import annotations

import numpy as np

from benchgpu.worlds import ACGT


def make(shape: np.random.Generator, bases: np.random.Generator, n_genes: int,
         exons_per_gene=(4, 12), exon_len=(80, 600), isoforms_per_gene=(2, 8),
         paralog_frac=0.08, paralog_div=0.015, min_txp_len=150) -> list[tuple[str, bytes]]:
    genes = []  # (source gene or -1, exon lengths, mutation sites, isoform exon subsets)
    for g in range(n_genes):
        if g and shape.random() < paralog_frac:
            src = int(shape.integers(0, g))
            lens = genes[src][1]
            sites = [shape.integers(0, n, shape.binomial(n, paralog_div)) for n in lens]
        else:
            src, sites = -1, None
            lens = shape.integers(*exon_len, size=int(shape.integers(*exons_per_gene)))
        n_iso = min(int(shape.integers(*isoforms_per_gene)), 2 ** len(lens) - 1)
        seen: set = set()
        subsets = []
        attempts = 0
        while len(subsets) < n_iso and attempts < 8 * n_iso:
            attempts += 1
            keep = shape.random(len(lens)) < 0.75
            key = tuple(np.flatnonzero(keep).tolist())
            if not key or key in seen:
                continue
            seen.add(key)
            if int(lens[list(key)].sum()) >= min_txp_len:
                subsets.append(key)
        genes.append((src, lens, sites, subsets))

    fresh = sum(int(lens.sum()) for src, lens, _, _ in genes if src < 0)
    pool = ACGT[bases.integers(0, 4, fresh, dtype=np.uint8)]
    n_mut = sum(sum(len(s) for s in sites) for src, _, sites, _ in genes if src >= 0)
    mut = ACGT[bases.integers(0, 4, n_mut, dtype=np.uint8)]
    exons: list[list[np.ndarray]] = []
    at = mt = 0
    out = []
    for g, (src, lens, sites, subsets) in enumerate(genes):
        if src < 0:
            ends = at + np.cumsum(lens)
            gene = [pool[e - n : e] for e, n in zip(ends, lens)]
            at = int(ends[-1])
            tag = f"gene{g}"
        else:
            gene = []
            for ex, s in zip(exons[src], sites):
                ex = ex.copy()
                ex[s] = mut[mt : mt + len(s)]
                mt += len(s)
                gene.append(ex)
            tag = f"gene{g}p"
        exons.append(gene)
        out += [(f"{tag}.iso{i}", b"".join(gene[j].tobytes() for j in key))
                for i, key in enumerate(subsets)]
    return out
