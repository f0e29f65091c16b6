#!/usr/bin/env python3
"""Time the banded-DP kernel (rapmap_tpu_torch/csrc/align.cu) against forms
of itself with another group width, and against another checkout's
align.cu, on one CUDA card.

    python3 scripts/align_ablation.py [--parent DIR] [--rounds 2] [--seed 0]

Builds align.cu as it stands (`as_is`: group_lanes picks the lanes a record
by the band) and with group_lanes returning 4, 8, 16 or 32 lanes a record
whatever the band (`lanes_4` ... `lanes_32`; at b = 7 that is 4, 2, 1 and 1
cells a lane), each a text edit of the source that must apply exactly once.
With --parent DIR it also builds DIR/rapmap_tpu_torch/csrc/align.cu, whose
tqm_banded_scores has the same C interface.

Every build is checked against score_records_plain on the smoke chunk of
chip_smoke.py's world at band 7 (the record rows of the first 8,192 reads'
chunk as the mapping path holds them: 32,768 rows, the live ones first), on
an output that starts as 0xFF bytes. Then each launch is timed on the device
under torch.profiler, warm (100 launches back to back) and cold (50
launches, each after a 1 GiB fill that evicts the L2), the builds in turn
and in reverse turn for each round. Prints one JSON line; the card's name
and power limit are in it.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUP_LANES = ("int group_lanes(int wb) {", "template <int G, int C>\ncudaError_t launch_group(")


def edit(src: str, lanes: int) -> str:
    start, end = GROUP_LANES
    if src.count(start) != 1 or src.count(end) != 1:
        raise RuntimeError(f"align.cu no longer has one {start!r} and one {end!r}")
    a, b = src.index(start), src.index(end)
    return src[:a] + f"int group_lanes(int) {{ return {lanes}; }}\n\n" + src[b:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout whose csrc/align.cu to time beside this one")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("align_ablation: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.models.quasi import QuasiMapper
    from rapmap_tpu_torch.ops.align import banded_scores_cuda, score_records_plain

    out = os.path.join(ROOT, "build", "ablation")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(ROOT, "rapmap_tpu_torch", "csrc", "align.cu")) as f:
        src = f.read()
    sources = {}
    for name, text in [("as_is", src)] + [(f"lanes_{g}", edit(src, g)) for g in (4, 8, 16, 32)]:
        sources[name] = os.path.join(out, f"align_{name}.cu")
        with open(sources[name], "w") as f:
            f.write(text)
    if args.parent:
        sources["parent"] = os.path.join(args.parent, "rapmap_tpu_torch", "csrc", "align.cu")
    procs = {n: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", os.path.join(out, f"align_{n}.so"), p],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n, p in sources.items()}

    # the smoke chunk of chip_smoke.py: its world, its first batch's first chunk
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    idx, codes, lens, _, _ = cs.build_world(args.seed, 10_000, 262_144, work)
    for n, p in procs.items():
        log, _ = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"nvcc {n} failed:\n{log}")
    libs = {n: ctypes.CDLL(os.path.join(out, f"align_{n}.so")) for n in sources}

    dev = torch.device("cuda")
    B, C = 32768, 8192
    cfg = MapConfig(k=cs.K, chunk=C, bitonic_sort=True)
    mapper = QuasiMapper(idx, cfg, device=dev)
    res, _ = cs.library_path(mapper, codes, lens, B, 1, True)
    cap = cfg.rec_slots * C
    rows, valid = cs.score_rows(res[0], C, cap)
    cols = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    sargs = (torch.from_numpy(codes[:C]).to(dev),
             torch.from_numpy(lens[:C].astype(np.int64)).to(dev),
             cols[:, 3], cols[:, 0], cols[:, 1], cols[:, 2], torch.from_numpy(valid).to(dev))
    scfg = dataclasses.replace(cfg, mapping_score=True)
    didx = mapper.didx
    want = score_records_plain(didx, scfg, *sargs)
    scores = torch.empty_like(want)

    def launcher(name):
        def go():
            kernels._libs["align"] = libs[name]  # banded_scores_cuda loads this build
            banded_scores_cuda(didx, scfg, *sargs, out=scores)
        return go

    gos = {n: launcher(n) for n in sources}
    res_ = {}
    for name, go in gos.items():
        scores.fill_(-1)
        go()
        torch.cuda.synchronize()
        res_[name] = dict(equal_plain=bool(torch.equal(scores, want)), warm_ms=[], cold_ms=[])

    flush = torch.empty(1 << 28, dtype=torch.int32, device=dev)

    def kernel_ms(work, key="banded_"):
        """Mean device ms of the kernels whose name holds `key` in work(),
        under torch.profiler, three tries (the profiler now and then drops
        every device event of a window)."""
        for _ in range(3):
            v = [v for n, v in cs.device_kernels(work).items() if key in n]
            if v:
                return sum(x[0] for x in v) / sum(x[1] for x in v)
        raise RuntimeError(f"torch.profiler recorded no {key} kernel in three tries")

    for rnd in range(args.rounds):
        for name in (list(gos) if rnd % 2 == 0 else list(gos)[::-1]):
            go = gos[name]
            res_[name]["warm_ms"].append(kernel_ms(lambda: [go() for _ in range(100)]))

            def cold():
                for _ in range(50):
                    flush.fill_(1)
                    go()
            res_[name]["cold_ms"].append(kernel_ms(cold))
    kernels._libs.pop("align", None)
    print(json.dumps({"device": cs.nvidia_smi_line(), "rows": cap, "live_rows": int(valid.sum()),
                      "read_len": codes.shape[1], "band": scfg.align_band, "variants": res_}),
          flush=True)
    return 0 if all(v["equal_plain"] for v in res_.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
