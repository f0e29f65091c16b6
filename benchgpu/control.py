#!/usr/bin/env python3
"""The control of the comparison that decides `correct`: the entry's
control (its reference with one stated guarantee broken) put in the
program's place and judged as the program's answers are; it must come out
not correct.

For the quasimap entry the guarantee broken is the vote (SEMANTICS.md §4):
a mapping reports the position that the most hits of its transcript and
strand agree on (ties to the smallest) and their number; the control
reports the first hit's position and a support of 1, the shortcut a change
that drops the voting sort would take. It answers every sampled read (pair)
of the cell's pool at the cell's own size, once, with nothing cut.

    python3 benchgpu/control.py --workload isoform_6k.se --seed 7 [--seed 8 ...]

Runs on the host alone (no card). One JSON line a seed: the number the
benchmark compares (unequal answers) and its parts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchgpu import harness  # noqa: E402


def control_window(config: dict, pool, transcripts) -> harness.Window:
    """A Window holding the entry's control's answers to every sampled row
    of the pool."""
    ctl = harness.entry_of(config).control(transcripts, config, pool.paired)
    ctl.prepare([pool.reads_of(b, r) for b, sample in enumerate(pool.sample) for r in sample])
    win = harness.Window()
    for b, sample in enumerate(pool.sample):
        got = [ctl.answer(pool.reads_of(b, r)) for r in sample]
        counts = np.zeros(pool.batch, np.int64)
        counts[sample] = [len(g) for g in got]
        width = max((g.shape[1] for g in got), default=1)
        recs = np.zeros((int(counts.sum()), width), np.int32)
        at = np.concatenate([[0], np.cumsum(counts)])
        for r, g in zip(sample, got):
            recs[at[r] : at[r + 1]] = g
        win.observe(b, sample, counts, recs, np.zeros(pool.batch, bool))
    return win


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    from benchgpu.run import load_json, plan

    cell, _, _ = plan(load_json(ROOT, "BENCHMARK.json"), args.workload)
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    mix = load_json(HERE, "mixes", f"{cell['traffic']}.json")
    entry = harness.entry_of(config)
    for seed in args.seed:
        t0 = time.time()
        transcripts, pool = harness.setup_traffic(config, mix, seed)
        verdict = harness.judge(control_window(config, pool, transcripts), pool,
                                entry.reference(transcripts, config, pool.paired))
        print(json.dumps(dict(workload=args.workload, seed=seed, control="control",
                              unequal_answers=verdict["unequal"], checked=verdict["checked"],
                              equal=verdict["equal"], seconds=time.time() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
