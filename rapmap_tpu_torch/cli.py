"""tqm command-line interface of the PyTorch/CUDA port: quasiindex | quasimap.

Port of rapmap_tpu.cli: the same subcommands, flag names and defaults, so a
parity harness can drive either tool with the same argv. Single-end
`quasimap` on an index with the canonical CHD runs end to end (FASTQ in, SAM
out); what is not ported yet (paired-end, pseudo-mapping, --mappingScore, the
host-staged engine, --worldSize > 1, the quasi_map / quasi_core artifacts,
indexes without the canonical CHD) is refused with one log line and exit
code 1.

The mapping runs on the CUDA card. TQM_FORCE_CPU=1 runs every kernel's plain
PyTorch version on the CPU instead; without it and without a card the command
fails rather than carry on on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.version import __version__

log = logging.getLogger("tqm")


def _add_map_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-i", "--index", required=True, help="index directory")
    p.add_argument("-r", "--reads", help="single-end reads (FASTA/FASTQ, may be .gz)")
    p.add_argument("-1", "--mates1", dest="mates1", help="left mates")
    p.add_argument("-2", "--mates2", dest="mates2", help="right mates")
    p.add_argument("-o", "--output", default="-", help="output SAM path ('-' = stdout)")
    p.add_argument(
        "-t", "--numThreads", type=int, default=1,
        help="host worker threads; >= 2 runs parsing on a producer thread "
        "that prefetches batches ahead of the device (device work itself is "
        "one-card async-pipelined regardless)",
    )
    p.add_argument("-m", "--maxNumHits", type=int, default=200)
    p.add_argument("-s", "--strictCheck", action="store_true")
    p.add_argument("-f", "--fuzzy", action="store_true")
    p.add_argument("-c", "--consistentHits", action="store_true")
    p.add_argument("-z", "--quasiCoverage", type=float, default=0.0)
    p.add_argument("--noOrphans", action="store_true")
    p.add_argument(
        "--maxFragLen", type=int, default=0,
        help="[REF-VERIFY] concordant pairs must have |pos1-pos2| <= this (0 = off)",
    )
    p.add_argument(
        "--pairOrder", action="store_true",
        help="[REF-VERIFY] concordant pairs need the fwd mate at/before the rc mate",
    )
    p.add_argument("-n", "--noOutput", action="store_true", help="map but emit no SAM")
    p.add_argument("--maxInterval", type=int, default=1000)
    # selective-alignment scoring (SEMANTICS.md §9; salmon-era flag names)
    p.add_argument(
        "--mappingScore", action="store_true",
        help="score every mapping with a banded affine-gap alignment and "
        "emit it as an AS:i tag (quasimap only)",
    )
    p.add_argument(
        "--minScoreFraction", type=float, default=0.0,
        help="with --mappingScore: suppress records scoring below "
        "ceil(F * ma * readLen); 0 = tag only, no filtering",
    )
    p.add_argument("--ma", type=int, default=2, help="match bonus")
    p.add_argument("--mp", type=int, default=-4, help="mismatch penalty (negative)")
    p.add_argument("--go", type=int, default=5, help="gap open penalty (>= --ge)")
    p.add_argument("--ge", type=int, default=3, help="gap extend penalty")
    p.add_argument("--bandwidth", type=int, default=7, help="alignment DP band half-width")
    p.add_argument(
        "--expandBudget", type=int, default=0,
        help="average device SA-expansion slots per read; 0 = auto-size from "
        "index repetitiveness stats",
    )
    p.add_argument(
        "--noFallback", action="store_true",
        help="disable the host oracle remap of budget-degraded reads",
    )
    p.add_argument("--batchSize", type=int, default=4096)
    p.add_argument(
        "--engine", choices=["auto", "replicated", "staged"], default="auto",
        help="quasimap device engine: auto picks by index size vs the card's "
        "memory (TQM_HBM_GB overrides it) — replicated keeps the whole index "
        "card-resident; staged streams genome-scale indexes over the card "
        "shard by shard (the reference's invisible bigSA dispatch)",
    )
    p.add_argument(
        "--chunkSize", type=int, default=0,
        help="device inner chunk (reads); 0 = one program over the whole batch",
    )
    p.add_argument("--pipelineDepth", type=int, default=4, help="async batches in flight")
    p.add_argument("--maxReadLen", type=int, default=512)
    p.add_argument("--noUnmapped", action="store_true", help="suppress unmapped records")
    p.add_argument("--statsJson", help="write run counters to this JSON file")
    p.add_argument(
        "--resume", action="store_true",
        help="resume an interrupted run from <output>.tqm_progress.json "
        "(batch-granular; no duplicate SAM records)",
    )
    p.add_argument("--profile", action="store_true", help="log per-stage wall times")
    p.add_argument("--traceDir", help="write a torch.profiler trace to this directory")
    # multi-process distribution (SURVEY.md §5.8): one process per host, each
    # mapping batch i where i %% worldSize == rank into its own SAM shard
    p.add_argument("--worldSize", type=int, default=1, help="number of cooperating processes")
    p.add_argument("--rank", type=int, default=0, help="this process's id in [0, worldSize)")
    p.add_argument(
        "--coordinator", default="localhost:29471",
        help="host:port of process 0 for torch.distributed",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tqm-torch",
        description="quasi-mapping on a CUDA card (RapMap capability rebuild, PyTorch port)",
    )
    ap.add_argument("--version", action="version", version=f"tqm {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    qi = sub.add_parser("quasiindex", help="build suffix-array quasi-mapping index")
    qi.add_argument("-t", "--transcripts", required=True)
    qi.add_argument("-i", "--index", required=True)
    qi.add_argument("-k", "--kmerLen", type=int, default=31)
    qi.add_argument("--seed", type=int, default=0)
    qi.add_argument("--keepDuplicates", action="store_true")
    qi.add_argument(
        "-x", "--perfectHash", action="store_true",
        help="require the CHD perfect hash (BooPHF role): the index always "
        "tries to build one (maps use it when present); with -x a build whose "
        "CHD construction fails errors out instead of falling back to the "
        "binary-search probe",
    )
    qi.add_argument(
        "--coreIndex", action="store_true",
        help="write the compact core artifact instead of the full index: "
        "only {text, suffix array, txp geometry, CHD} on disk (~8x smaller "
        "at genome scale); the k-mer table and derived arrays are "
        "reconstructed at load and verified against the save-time hashes",
    )

    pi = sub.add_parser("pseudoindex", help="build k-mer-only pseudo-mapping index")
    pi.add_argument("-t", "--transcripts", required=True)
    pi.add_argument("-i", "--index", required=True)
    pi.add_argument("-k", "--kmerLen", type=int, default=31)
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("--keepDuplicates", action="store_true")

    qm = sub.add_parser("quasimap", help="map reads with the quasi index")
    _add_map_flags(qm)
    pm = sub.add_parser("pseudomap", help="map reads with the pseudo index")
    _add_map_flags(pm)
    return ap


def _cfg_from_args(args, k: int) -> MapConfig:
    if args.mappingScore:
        if args.go < args.ge:
            raise SystemExit("--go must be >= --ge")
        if args.mp >= 0:
            raise SystemExit("--mp must be negative")
        if args.bandwidth < 1:
            raise SystemExit("--bandwidth must be >= 1")
        if not (0.0 <= args.minScoreFraction <= 1.0):
            raise SystemExit("--minScoreFraction must be in [0, 1]")
    elif args.minScoreFraction > 0.0:
        raise SystemExit("--minScoreFraction requires --mappingScore")
    return MapConfig(
        k=k,
        max_num_hits=args.maxNumHits,
        max_interval=args.maxInterval,
        consistent_hits=args.consistentHits,
        fuzzy=args.fuzzy,
        strict_check=args.strictCheck,
        quasi_coverage=args.quasiCoverage,
        no_orphans=args.noOrphans,
        max_frag_len=args.maxFragLen,
        pair_order=args.pairOrder,
        expand_budget=args.expandBudget,
        chunk=args.chunkSize,
        mapping_score=args.mappingScore,
        min_score_fraction=args.minScoreFraction if args.mappingScore else 0.0,
        align_ma=args.ma, align_mp=args.mp, align_go=args.go,
        align_ge=args.ge, align_band=args.bandwidth,
    )


def _device_budget_bytes(device) -> float:
    """Bytes of device memory the index may take: 85% of TQM_HBM_GB when
    set (tests force it tiny), else of the card's memory; no limit on the
    CPU, where the index stays in host memory."""
    gb = os.environ.get("TQM_HBM_GB")
    if gb is not None:
        return float(gb) * 2**30 * 0.85
    if device.type != "cuda":
        return float("inf")
    import torch

    return torch.cuda.get_device_properties(device).total_memory * 0.85


def _choose_quasi_engine(args, idx, device) -> str:
    """Header/size-driven engine dispatch (upstream:src/RapMapSAMapper.cpp
    bigSA load-time branch, SURVEY.md §1 L6->L5): the user types the same
    `quasimap` whether the index fits the card's memory (replicated) or is
    genome-scale (host-staged shard streaming)."""
    if args.engine != "auto":
        return args.engine
    from rapmap_tpu_torch.ops.device_index import device_bytes_estimate

    n_slots = len(idx.sa)
    est = device_bytes_estimate(idx)
    budget = _device_budget_bytes(device)
    if n_slots >= 2**31 or est > budget:
        log.info(
            "index needs ~%.2f GB on device (budget %.2f GB%s) -> "
            "host-staged engine",
            est / 2**30, budget / 2**30,
            "" if n_slots < 2**31 else "; >= 2^31 SA slots",
        )
        return "staged"
    return "replicated"


def _pick_device():
    """The card, or the CPU under TQM_FORCE_CPU=1; None (after an error
    line) when neither applies."""
    import torch

    if os.environ.get("TQM_FORCE_CPU") == "1":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        log.error("no CUDA device: quasimap runs on a CUDA card; set "
                  "TQM_FORCE_CPU=1 to run the plain PyTorch path on the CPU")
        return None
    return torch.device("cuda")


def _refuse(what: str, when: str) -> int:
    log.error("%s is not ported to rapmap_tpu_torch yet: it comes with %s", what, when)
    return 1


def run_map(args) -> int:
    import contextlib
    import json

    from rapmap_tpu_torch.index.format import load_header, load_index
    from rapmap_tpu_torch.io import fastx, sam

    if args.worldSize > 1:
        return _refuse("--worldSize > 1", "the data-parallel and multi-process slice")
    if args.mates1 or args.mates2:
        return _refuse("paired-end mapping (-1/-2)", "the paired-end slice")
    if args.mappingScore:
        return _refuse("--mappingScore", "the mapping-score slice")
    if args.engine == "staged":
        return _refuse("--engine staged", "the host-staged slice")
    if not args.reads:
        log.error("provide -r for single-end or -1/-2 for paired-end reads")
        return 1

    header = load_header(args.index)
    itype = header["index_type"]
    if itype not in {"quasi", "quasi_map", "quasi_core"}:
        log.error("index at %s is type %s, expected quasi", args.index, itype)
        return 1
    if itype != "quasi":
        return _refuse(f"index type {itype}", "the index-artifact slice")
    device = _pick_device()
    if device is None:
        return 1
    idx = load_index(args.index)
    cfg = _cfg_from_args(args, idx.k)
    chd = idx.meta.get("chd") if idx.chd_dir is not None else None
    if not (chd and chd.get("canonical")):
        return _refuse("an index without the canonical CHD perfect hash",
                       "the binary-search probe slice")
    if _choose_quasi_engine(args, idx, device) == "staged":
        return _refuse("the host-staged engine", "the host-staged slice")

    from rapmap_tpu_torch.models.quasi import QuasiMapper

    mapper = QuasiMapper(idx, cfg, device=device)

    cl = " ".join(sys.argv)
    t0 = time.time()
    totals: dict[str, int] = {}

    def acc(ctr: dict):
        for key, v in ctr.items():
            totals[key] = totals.get(key, 0) + int(v)

    # ---- chunk-granular checkpoint/resume (SURVEY.md §5.3-5.4) -------------
    prog_path = f"{args.output}.tqm_progress.json" if args.output not in ("-",) else None
    skip_batches = 0
    resume_bytes = 0
    if args.resume and prog_path and os.path.exists(prog_path):
        with open(prog_path) as f:
            prog = json.load(f)
        skip_batches = prog["batches_done"]
        resume_bytes = prog["bytes_written"]
        totals.update(prog["counters"])
        log.info("resuming after %d completed batches", skip_batches)

    def save_progress(batches_done: int, out_file) -> None:
        if prog_path is None or args.noOutput:
            return
        out_file.flush()
        tmp = prog_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"batches_done": batches_done, "bytes_written": out_file.tell(),
                 "counters": totals}, f,
            )
        os.replace(tmp, prog_path)

    with contextlib.ExitStack() as stack:
        if args.noOutput:
            out = None
        elif args.output == "-":
            out = sys.stdout
        elif skip_batches:
            out = stack.enter_context(open(args.output, "r+"))
            out.truncate(resume_bytes)
            out.seek(resume_bytes)
        else:
            out = stack.enter_context(open(args.output, "w"))
        if out is not None and not skip_batches:
            out.write(sam.sam_header(idx.txp_names, np.asarray(idx.txp_lens), __version__, cl))
        write_unmapped = not args.noUnmapped
        sam_fmt = sam.get_native_formatter(idx.txp_names) if out is not None else None

        # pipeline: dispatch the next batches before fetching batch i's
        # results so the device computes while the host renders SAM
        from rapmap_tpu_torch.models import fallback as fb
        from rapmap_tpu_torch.oracle import quasimap as oracle_mod
        from rapmap_tpu_torch.utils.timers import StageTimers, device_trace

        timers = StageTimers()
        use_fallback = not args.noFallback

        def drain_se(pending):
            batch, fut = pending
            with timers.stage("fetch"):
                recsd = mapper.fetch(fut)
            if use_fallback:
                with timers.stage("fallback"):
                    recsd = fb.remap_se(
                        recsd, batch.codes, batch.lens, batch.n,
                        mapper.host_index, mapper.cfg, oracle_mod,
                    )
            acc(recsd.counters)
            if recsd.overflowed:
                log.warning("record buffer overflow in a batch; tail records dropped")
            if out is not None:
                with timers.stage("sam"):
                    sam.write_se_records_dense(
                        out, batch.names[: batch.n], batch.seqs, batch.quals,
                        recsd.recs, recsd.counts, idx.txp_names, write_unmapped,
                        formatter=sam_fmt,
                    )

        from collections import deque

        q: deque = deque()
        depth = max(1, args.pipelineDepth)
        done = [skip_batches]
        # steady-state marker: the first drained batch carries the one-off
        # costs (kernel build and load, allocator warm-up), so the
        # post-first-batch rate is the production number
        steady = [0.0, 0]

        def mark_steady():
            if steady[0] == 0.0:
                steady[0] = time.time()
                steady[1] = totals.get("reads_total", 0)

        def drained():
            mark_steady()
            done[0] += 1
            if out is not None and out is not sys.stdout:
                save_progress(done[0], out)

        with device_trace(args.traceDir):
            it = fastx.batched_reads(args.reads, args.batchSize, args.maxReadLen)
            if args.numThreads >= 2:
                it = fastx.prefetch(it, depth=max(2, args.pipelineDepth))
            bi = 0
            while True:
                with timers.stage("parse"):
                    batch = next(it, None)
                if batch is None:
                    break
                if bi >= skip_batches:
                    with timers.stage("dispatch"):
                        fut = mapper.map_se_async(batch.codes, batch.lens, n_valid=batch.n)
                    q.append((batch, fut))
                    if len(q) >= depth:
                        drain_se(q.popleft())
                        drained()
                bi += 1
            while q:
                drain_se(q.popleft())
                drained()
        if args.profile:
            timers.log(log)

    dt = time.time() - t0
    totals["wall_s"] = round(dt, 3)
    if totals.get("out_truncated"):
        log.warning(
            "%d reads had mapping records dropped by the per-read output cap "
            "(max_out < maxNumHits)", totals["out_truncated"],
        )
    if totals.get("reads_total"):
        # Fallback-rate guardrail: the host oracle remap is a per-read Python
        # loop — correct at any rate, but throughput craters if budgets are
        # sized badly. Surface the fraction and warn loudly above 1%.
        fb_frac = totals.get("host_fallback", 0) / totals["reads_total"]
        totals["host_fallback_frac"] = round(fb_frac, 6)
        if fb_frac > 0.01:
            log.warning(
                "host-oracle fallback handled %.2f%% of reads (%d of %d) — "
                "device budgets are undersized for this workload; raise "
                "--expandBudget/--maxOut or rebuild with a larger index "
                "budget to restore device-side throughput",
                100.0 * fb_frac, totals.get("host_fallback", 0),
                totals["reads_total"],
            )
        rate = 100.0 * totals.get("reads_mapped", 0) / totals["reads_total"]
        log.info(
            "Mapped %d of %d reads (%.2f%%) in %.1fs (%.0f reads/s)",
            totals.get("reads_mapped", 0), totals["reads_total"], rate, dt,
            totals["reads_total"] / max(dt, 1e-9),
        )
        if steady[0] and totals["reads_total"] > steady[1]:
            srate = (totals["reads_total"] - steady[1]) / max(
                time.time() - steady[0], 1e-9
            )
            totals["steady_reads_per_s"] = round(srate, 1)
            log.info("steady-state (after the first batch): %.0f reads/s", srate)
    if args.statsJson:
        with open(args.statsJson, "w") as f:
            json.dump(totals, f, indent=1)
    return 0


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="[tqm] %(message)s", stream=sys.stderr)
    args = build_parser().parse_args(argv)
    if args.cmd == "quasiindex":
        if args.coreIndex:
            return _refuse("--coreIndex", "the index-artifact slice")
        from rapmap_tpu_torch.index.builder import build_quasi_index

        build_quasi_index(
            args.transcripts, args.index, k=args.kmerLen, seed=args.seed,
            dedup=not args.keepDuplicates, require_chd=args.perfectHash,
        )
        return 0
    if args.cmd in ("pseudoindex", "pseudomap"):
        return _refuse(args.cmd, "the pseudo-mapping slice")
    return run_map(args)


if __name__ == "__main__":
    sys.exit(main())
