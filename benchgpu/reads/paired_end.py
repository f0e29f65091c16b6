"""Paired-end reads: a frozen, vectorised copy of bench.py::build_pe_reads
(as the world scripts copy it). A fragment of `fragment_len` bases from a
uniform text position; mate 1 its first `read_len` bases, mate 2 the
reverse complement of its last, each with its own substitutions at
`sub_rate`."""

from __future__ import annotations

import numpy as np

from benchgpu.traffic import revcomp_rows, substitute, windows

PAIRED = True


def draw(mix: dict, text: np.ndarray, gen):
    B, L, F = int(mix["batch"]), int(mix["read_len"]), int(mix["fragment_len"])
    frag = windows(text, B, F, gen)
    m1 = substitute(frag[:, :L].copy(), mix["sub_rate"], gen)
    m2 = substitute(revcomp_rows(frag[:, F - L :]).copy(), mix["sub_rate"], gen)
    lens = np.full(B, L, np.int32)
    return m1.astype(np.int8), lens, m2.astype(np.int8), lens
