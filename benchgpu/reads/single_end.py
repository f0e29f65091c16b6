"""Single-end reads: a frozen, vectorised copy of bench.py:267-283's
simulator (as scripts/isoform_world_torch.py and scripts/scale_world_torch.py
copy it). A read of `read_len` bases from a uniform text position, a base
where the text has a transcript's end drawn at random, each base
substituted by a random one at `sub_rate`, and a `rc_share` of reads
reverse-complemented."""

from __future__ import annotations

import numpy as np

from benchgpu.traffic import revcomp_rows, substitute, windows

PAIRED = False


def draw(mix: dict, text: np.ndarray, gen):
    B, L = int(mix["batch"]), int(mix["read_len"])
    w = substitute(windows(text, B, L, gen), mix["sub_rate"], gen)
    rc = gen.random(B) < mix["rc_share"]
    w[rc] = revcomp_rows(w[rc])
    return w.astype(np.int8), np.full(B, L, np.int32)
