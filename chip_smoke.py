#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rapmap_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Builds the port's native host library and every CUDA kernel from the
sources in this checkout, holds each kernel (the voting sort of
csrc/sort2.cu, the anchor walk of csrc/walk.cu) against its plain PyTorch
version on the card, builds a 20 Mbp random transcriptome world from the
seed, maps 262,144 single-end 76 bp reads through QuasiMapper.map_se_async /
fetch (one batch in flight), and checks the result: map rate, reads mapped
to their true locus, both kernels' launches on the main path, and the
card's wire buffer equal to the CPU's on the first batch. Then it drives the
port's command line in process (rapmap_tpu_torch.cli.main) on the same world,
FASTQ in and SAM out: at its default flags (batches of 4,096, one program a
batch), chunked with a parser thread, with a starved expansion budget against
an ample one on a repetitive world (the host-oracle fallback), and on the card
against the CPU (SAM files equal byte for byte apart from @PG). Every phase
prints one JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero, printing no result, without a CUDA card or without the
rest of the repository beside it.

--cpu-rehearsal (with --txps/--reads small) runs the same phases on the CPU
with the plain versions, to check the script's control flow off the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor rate (data sheet, fp32)
READ_LEN = 76
BATCHES = 8  # per run; each batch is 4 chunks
K = 31
# the __global__ functions of csrc/*.cu, as the profiler names them
HAND_KERNELS = ("cluster_sort_kernel", "tile_sort_kernel", "tile_merge_kernel",
                "global_step_kernel", "anchor_walk_kernel", "extend_packed_kernel")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of fn() per call: CUDA events around `reps` calls after
    `warm` warm-up calls; host clock on the CPU rehearsal."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def __call__(self, fn, reps: int, warm: int = 3) -> float:
        import torch

        for _ in range(warm):
            fn()
        if self.cuda:
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps


def device_kernels(prof) -> dict[str, list]:
    """{kernel name: [device ms, count]} of a finished torch.profiler run:
    every kernel, copy and memset the device ran, by its own duration."""
    import torch

    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            v = by_name.setdefault(e.name[:80], [0.0, 0])
            v[0] += e.time_range.elapsed_us() / 1e3
            v[1] += 1
    return by_name


def device_ms(fn, reps: int, cuda: bool):
    """Time the DEVICE spends on one fn(): the durations of everything it
    ran during `reps` calls under torch.profiler, summed and divided by
    reps. What the host takes to issue the work is not in it (Timer's
    wrapper time has that). -> (ms, {kernel name: ms per call})."""
    if not cuda:
        return "not measured", {}
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = device_kernels(prof)
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device activity")
    return (sum(v[0] for v in by_name.values()) / reps,
            {n: v[0] / reps for n, v in by_name.items()})


def sort_inputs(n: int, kind: str, rng):
    """(hi, lo) uint32 words as int32 bit patterns: full-range random, heavy
    duplicates, or duplicates with the collate's invalid-slot sentinel
    (0xFFFFFFFF, 0xFFFFFFFF) every 7th slot."""
    if kind == "random":
        hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    else:
        hi = rng.integers(0, 4, n).astype(np.uint32)
        lo = rng.integers(0, 4, n).astype(np.uint32)
        if kind == "sentinel":
            hi[::7] = 0xFFFFFFFF
            lo[::7] = 0xFFFFFFFF
    return hi.view(np.int32), lo.view(np.int32)


def phase_sort_kernel(dev, timer):
    """bitonic_sort_pairs (CUDA kernel) against bitonic_sort_pairs_plain on
    the same card tensors (every cluster size of the one-launch path: 1, 2,
    4 and 8 blocks), and its timing at the main path's N: `ms` and
    `library_ms` are device time, the `wrapper_ms` pair CUDA events around
    the calls, host included."""
    import torch

    from rapmap_tpu_torch.ops.sort2 import (
        bitonic_sort_pairs, bitonic_sort_pairs_plain, sort_path,
    )

    def path(n):
        return sort_path(n) if dev.type == "cuda" else "plain version (CPU)"

    rng = np.random.default_rng(1)
    checks = []
    max_err = 0
    for n in (1024, 8192, 16384, 32768, 65536, 1 << 20):
        for kind in ("random", "duplicates", "sentinel"):
            h, l = sort_inputs(n, kind, rng)
            hi = torch.from_numpy(h).to(dev)
            lo = torch.from_numpy(l).to(dev)
            kh, kl = bitonic_sort_pairs(hi, lo)
            ph, pl = bitonic_sort_pairs_plain(hi, lo)
            err = max(
                int(((kh.long() & 0xFFFFFFFF) - (ph.long() & 0xFFFFFFFF)).abs().max()),
                int(((kl.long() & 0xFFFFFFFF) - (pl.long() & 0xFFFFFFFF)).abs().max()),
            )
            order = np.lexsort((l.view(np.uint32), h.view(np.uint32)))
            lex_ok = np.array_equal(kh.cpu().numpy(), h[order]) and np.array_equal(
                kl.cpu().numpy(), l[order]
            )
            max_err = max(max_err, err)
            checks.append(dict(n=n, data=kind, path=path(n), equal_plain=err == 0,
                               equal_lexsort=lex_ok))
    ok = all(c["equal_plain"] and c["equal_lexsort"] for c in checks)

    n = 65536  # expand_budget 8 x chunk 8192: the voting pool of one chunk
    h, l = sort_inputs(n, "random", rng)
    hi = torch.from_numpy(h).to(dev)
    lo = torch.from_numpy(l).to(dev)
    key = (hi.long() & 0xFFFFFFFF) << 32 | (lo.long() & 0xFFFFFFFF)
    cuda = dev.type == "cuda"
    wrapper_ms = timer(lambda: bitonic_sort_pairs(hi, lo), reps=200)
    ms, ms_by = device_ms(lambda: bitonic_sort_pairs(hi, lo), 200, cuda)
    plain_ms = timer(lambda: bitonic_sort_pairs_plain(hi, lo), reps=5, warm=1)
    library_wrapper_ms = timer(lambda: torch.sort(key), reps=200)
    library_ms, _ = device_ms(lambda: torch.sort(key), 200, cuda)
    log2n = n.bit_length() - 1
    nbytes = 16 * n                         # read hi, lo once; write them once
    ops = (n // 2) * log2n * (log2n + 1) // 2  # 64-bit compare-exchanges
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    timing = dict(
        n=n, path=path(n), ms=ms, wrapper_ms=wrapper_ms, device_ms_by_kernel=ms_by,
        plain_ms=plain_ms, library_ms=library_ms, library_wrapper_ms=library_wrapper_ms,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, compare_exchanges=ops,
    )
    emit("kernel_vs_plain", kernel="bitonic_sort_pairs", ok=ok, max_abs_err=max_err,
         checks=checks, timing=timing)
    return ok, max_err, timing


def build_index(fa: str, outdir: str | None = None):
    """The port's quasi index (k = 31, canonical CHD) of a FASTA file, saved
    as an index directory when `outdir` is given."""
    from rapmap_tpu_torch.index.builder import build_quasi_index

    return build_quasi_index(fa, outdir, k=K)


def sample_reads(idx, rng, n_reads: int, read_len: int, err_rate: float):
    """Reads of one length sampled from the index's transcripts at uniform
    loci, with substitutions at err_rate, half reverse-complemented ->
    (codes (n, read_len) int8, (transcript, position, strand))."""
    tl = np.asarray(idx.txp_lens, dtype=np.int64)
    span = np.maximum(tl - read_len + 1, 0)
    t = rng.choice(len(tl), size=n_reads, p=span / span.sum())
    pos = (rng.random(n_reads) * span[t]).astype(np.int64)
    start = np.asarray(idx.txp_offsets, dtype=np.int64)[t] + pos
    codes = np.asarray(idx.text)[start[:, None] + np.arange(read_len)[None, :]].astype(np.int8)
    err = rng.random(codes.shape) < err_rate
    codes[err] = rng.integers(1, 5, int(err.sum()))
    strand = (rng.random(n_reads) < 0.5).astype(np.int64)
    rc = strand == 1
    codes[rc] = (5 - codes[rc])[:, ::-1]
    return codes, (t, pos, strand)


def build_world(seed: int, n_txps: int, n_reads: int, workdir: str):
    """Random transcriptome (500-3,500 bp transcripts), the port's quasi
    index (k=31, canonical CHD; saved as <workdir>/idx for the command line),
    and reads sampled at known (transcript, position, strand) with 1%
    substitutions, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(500, 3501, n_txps)
    fa = os.path.join(workdir, "txome.fa")
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(fa, "w") as f:
        for i, ln in enumerate(lens):
            f.write(f">t{i}\n{bases[rng.integers(0, 4, int(ln))].tobytes().decode()}\n")
    t0 = time.time()
    idx = build_index(fa, os.path.join(workdir, "idx"))
    build_s = time.time() - t0

    codes, truth = sample_reads(idx, rng, n_reads, READ_LEN, 0.01)
    return idx, codes, np.full(n_reads, READ_LEN, np.int32), truth, build_s


def repetitive_index(rng, workdir: str):
    """A small repetitive transcriptome: 40 genes of 1,500 bp, 8 isoforms
    each that differ from their gene in 0.5% of the bases, so most 31-mers
    occur several times and the extension's searches take several trips.
    Saved as <workdir>/repetitive_idx for the command line."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    fa = os.path.join(workdir, "repetitive.fa")
    with open(fa, "w") as f:
        for g in range(40):
            gene = rng.integers(0, 4, 1500)
            for i in range(8):
                iso = gene.copy()
                mut = rng.random(1500) < 0.005
                iso[mut] = rng.integers(0, 4, int(mut.sum()))
                f.write(f">g{g}i{i}\n{bases[iso].tobytes().decode()}\n")
    return build_index(fa, os.path.join(workdir, "repetitive_idx"))


def write_fastq(path: str, codes, truth=None) -> str:
    """Reads as FASTQ, each named r<i> or, with `truth`, by its true locus:
    r<i>:<transcript>:<position>:<strand>."""
    seqs = np.frombuffer(b"NACGTN", dtype=np.uint8)[codes]
    qual = "I" * codes.shape[1]
    with open(path, "w") as f:
        for i, row in enumerate(seqs):
            name = f"r{i}" if truth is None else (
                f"r{i}:{truth[0][i]}:{truth[1][i]}:{truth[2][i]}")
            f.write(f"@{name}\n{row.tobytes().decode()}\n+\n{qual}\n")
    return path


def sam_body(path: str) -> list[str]:
    """The lines of a SAM file without @PG, which carries the command line."""
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


def sam_true_locus_share(path: str, n_reads: int) -> float:
    """Share of the reads (named by write_fastq with their truth) whose
    PRIMARY record is the true (transcript, position, strand)."""
    good = 0
    with open(path) as f:
        for ln in f:
            if ln[0] == "@":
                continue
            name, flag, rname, pos = ln.split("\t", 4)[:4]
            flag = int(flag)
            if flag & 0x104:
                continue
            _, t, p, strand = name.split(":")
            good += (rname == f"t{t}" and int(pos) - 1 == int(p)
                     and bool(flag & 0x10) == (strand == "1"))
    return good / n_reads


class StageLog(logging.Handler):
    """Keeps what the command line's --profile logs: {stage: [seconds, calls]}."""

    def __init__(self):
        super().__init__()
        self.stages: dict[str, list] = {}

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith("stage ") and record.args:
            name, seconds, calls = record.args
            self.stages[name] = [seconds, calls]


def run_cli(phase: str, argv: list[str], workdir: str, force_cpu: bool = False) -> dict:
    """One `quasimap` through rapmap_tpu_torch.cli.main in this process, with
    --statsJson and --profile, the launch counts zeroed just before it and read
    just after -> the phase's record (also printed as its JSON line). Raises
    unless the command returns 0."""
    from rapmap_tpu_torch import cli, kernels

    stats_path = os.path.join(workdir, f"{phase}.json")
    log = StageLog()
    logging.getLogger("tqm").addHandler(log)
    old = os.environ.pop("TQM_FORCE_CPU", None)
    if force_cpu:
        os.environ["TQM_FORCE_CPU"] = "1"
    kernels.reset_launches()
    t0 = time.time()
    try:
        rc = cli.main(["quasimap", *argv, "--statsJson", stats_path, "--profile"])
    finally:
        total_s = time.time() - t0
        launches = dict(kernels.LAUNCHES)
        logging.getLogger("tqm").removeHandler(log)
        os.environ.pop("TQM_FORCE_CPU", None)
        if old is not None:
            os.environ["TQM_FORCE_CPU"] = old
    if rc != 0:
        raise RuntimeError(f"{phase}: the command line returned {rc}")
    with open(stats_path) as f:
        stats = json.load(f)
    rec = dict(
        argv=argv, on="cpu" if force_cpu else "card", counters=stats, launches=launches,
        reads_per_s=stats["reads_total"] / stats["wall_s"],
        steady_reads_per_s=stats.get("steady_reads_per_s", "not measured"),
        map_rate=stats["reads_mapped"] / stats["reads_total"],
        stages_s={k: v[0] for k, v in log.stages.items()},
        stage_calls={k: v[1] for k, v in log.stages.items()},
        stage_share_of_wall={k: v[0] / stats["wall_s"] for k, v in log.stages.items()},
        total_s_with_index_load_and_upload=total_s,
    )
    emit(phase, **rec)
    return rec


def extend_packed_kernel(didx, w, b0, e0, pos, active, k: int, steps: int):
    """csrc/walk.cu's second entry, tqm_extend_packed: the extension's device
    function once per lane -> (b, e, mlen), the signature of
    ops.extend_packed.extend_packed. Only this script calls it, to tell a
    fault in the extension from one in the walk around it."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.ops.extend_packed import ext_words

    R, L = w.preads.shape
    dev = w.preads.device
    b, e, mlen = (torch.empty(R, dtype=torch.int64, device=dev) for _ in range(3))
    act = active.to(torch.uint8).contiguous()
    fn = kernels.library("walk").tqm_extend_packed
    fn.restype = ctypes.c_int
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [vp] * 9 + [i64, i32, vp, i64, i64] + [i32] * 4 + [vp] * 4
    with torch.cuda.device(dev):
        rc = fn(
            w.preads.data_ptr(), w.next_bad.data_ptr(), w.lens2.data_ptr(),
            w.col_off2.data_ptr(), b0.data_ptr(), e0.data_ptr(), pos.data_ptr(),
            act.data_ptr(), didx.sa_cmp.data_ptr(), didx.sa_cmp.shape[0],
            didx.sa_cmp.shape[1] - 3, didx.text2q.data_ptr(), didx.text2q.shape[0],
            R, L, k, steps, ext_words(L, k), b.data_ptr(), e.data_ptr(), mlen.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tqm_extend_packed launch failed: CUDA error {rc}")
    return b, e, mlen


WALK_INPUTS = ("preads", "next_bad", "lens2", "col_off2", "db2", "de2", "anc2",
               "sa_cmp", "text2q")


def walk_traffic(didx, w, k: int, H: int, ext_steps: int):
    """csrc/walk.cu's counting entry, tqm_anchor_walk_traffic: the walk
    compiled with its loads counted, which marks every 32-byte sector of every
    input tensor that it reads in a bitmap -> (ScanHits, {input: distinct
    sectors read}, sa_cmp rows compared). Only this script calls it, for the
    walk's byte bound; the main path's kernel is compiled without the count."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.ops.extend_packed import ext_words
    from rapmap_tpu_torch.ops.mmp import ScanHits

    tensors = [*w, didx.sa_cmp, didx.text2q]
    R, L = w.preads.shape
    S = w.db2.shape[1]
    dev = w.preads.device
    # one sector more than the bytes fill: a tensor need not start on a sector
    words = [((t.numel() * t.element_size() + 31) // 32 + 1 + 31) // 32 for t in tensors]
    off = np.concatenate([[0], np.cumsum(words)]).astype(np.int64)
    bits = torch.zeros(int(off[-1]), dtype=torch.int32, device=dev)
    rows = torch.zeros(1, dtype=torch.int64, device=dev)
    buf = torch.zeros((R, H, 4), dtype=torch.int64, device=dev)
    n = torch.empty((R,), dtype=torch.int64, device=dev)
    trunc = torch.empty((R,), dtype=torch.bool, device=dev)
    fn = kernels.library("walk").tqm_anchor_walk_traffic
    fn.restype = ctypes.c_int
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = ([vp] * 8 + [i64, i32, vp, i64, i64, i64] + [i32] * 6 + [vp] * 4
                   + [ctypes.POINTER(i64), vp, vp])
    with torch.cuda.device(dev):
        rc = fn(
            *(t.data_ptr() for t in w), didx.sa_cmp.data_ptr(), didx.sa_cmp.shape[0],
            didx.sa_cmp.shape[1] - 3, didx.text2q.data_ptr(), didx.text2q.shape[0],
            R, R // 2, L, S, k, H, ext_steps, ext_words(L, k),
            buf.data_ptr(), n.data_ptr(), trunc.data_ptr(), bits.data_ptr(),
            (i64 * len(words))(*off[:-1].tolist()), rows.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tqm_anchor_walk_traffic launch failed: CUDA error {rc}")
    torch.cuda.synchronize(dev)
    marks = bits.cpu().numpy().view(np.uint8)
    sectors = {
        name: int(np.unpackbits(marks[4 * off[g] : 4 * off[g + 1]]).sum())
        for g, name in enumerate(WALK_INPUTS)
    }
    hits = ScanHits(q=buf[..., 0], l=buf[..., 1], b=buf[..., 2], e=buf[..., 3],
                    n=n, truncated=trunc)
    return hits, sectors, int(rows.cpu()[0])


def phase_walk_kernel(dev, timer, mapper, idx, codes, lens, C: int, seed: int, work: str,
                      cli_batch):
    """anchor_walk (CUDA kernel) against anchor_walk_plain, all six ScanHits
    fields, and tqm_extend_packed against extend_packed, on card tensors of
    six input sets (the sixth a ragged last batch as the command line's
    reader hands it over: `cli_batch`); then, at the main path's shape, the
    walk's timing (`ms` is device time, the hit buffer's zero fill included; `wrapper_ms` CUDA
    events around the calls, host included) and its byte bound."""
    import torch

    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.ops.device_index import upload_index
    from rapmap_tpu_torch.ops.extend_packed import ext_words, extend_packed
    from rapmap_tpu_torch.ops.mmp import (
        ScanHits, anchor_walk, anchor_walk_plain, dense_phase, walk_params,
    )

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed + 2)
    n_small = min(C, 4096)

    # (ii) Ns, mixed lengths, reads shorter than k and of length exactly k
    c2 = codes[C : 2 * C].copy()
    c2[rng.random(c2.shape) < 0.02] = 5
    l2 = rng.integers(20, READ_LEN + 1, C).astype(np.int32)
    l2[::7], l2[1::7], l2[2::7] = K, K - 3, READ_LEN
    c2[np.arange(READ_LEN)[None, :] >= l2[:, None]] = 5
    # (iii) 150 bp reads: 8 words beyond depth k against 3 fused in sa_cmp
    c3, _ = sample_reads(idx, rng, n_small, 150, 0.01)
    # (iv) a repetitive world, two hit slots: lanes overflow and truncate
    ridx = repetitive_index(rng, work)
    rdidx, rst = upload_index(ridx, dev)
    c4, _ = sample_reads(ridx, rng, n_small, 120, 0.02)
    l4 = np.full(n_small, 120, np.int32)
    sets = [
        ("smoke_chunk", mapper.didx, mapper.st, mapper.cfg, codes[:C], lens[:C]),
        ("ns_mixed_lengths", mapper.didx, mapper.st, mapper.cfg, c2, l2),
        ("reads_150bp", mapper.didx, mapper.st, mapper.cfg, c3, np.full(n_small, 150, np.int32)),
        ("repetitive_2_slots", rdidx, rst, MapConfig(k=K, max_hits_per_strand=2), c4, l4),
        ("repetitive_16_slots", rdidx, rst, MapConfig(k=K), c4, l4),
        # (vi) the command line's default batch, its last one: 4,096 rows in
        # the reader's length bucket, the pad rows all N with length 0
        ("cli_ragged_batch", mapper.didx, mapper.st, mapper.cfg,
         np.ascontiguousarray(cli_batch.codes), cli_batch.lens),
    ]

    def diff(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0

    checks, max_err, main = [], 0, None
    for name, didx, st, cfg, cds, lns in sets:
        w = dense_phase(didx, st, torch.from_numpy(cds).to(dev),
                        torch.from_numpy(lns.astype(np.int64)).to(dev), cfg)
        params = walk_params(st, cfg)
        got = anchor_walk(didx, *w, **params)
        want = anchor_walk_plain(didx, *w, **params)
        errs = {f: diff(getattr(got, f), getattr(want, f)) for f in ScanHits._fields}
        # the extension alone: at each lane's first anchor, and on the whole
        # suffix array at random positions (searches of ~log2(n) trips)
        R, L = w.preads.shape
        S, k, n_sa = w.db2.shape[1], params["k"], didx.sa_cmp.shape[0]
        first = got.q[:, 0].contiguous()
        col = torch.where(torch.arange(R, device=dev) >= R // 2, w.lens2 - k - first, first)
        col = col.clamp(0, S - 1)[:, None]
        act = got.n > 0
        b0 = torch.gather(w.db2, 1, col)[:, 0].contiguous()
        e0 = torch.gather(w.de2, 1, col)[:, 0].contiguous()
        rpos = torch.from_numpy(rng.integers(0, S, R)).to(dev)
        ract = torch.from_numpy(rng.random(R) < 0.9).to(dev)
        wide = n_sa.bit_length() + 1
        ext_errs = []
        for b_, e_, p_, a_, steps in (
            (b0, e0, first, act, params["ext_steps"]),
            (torch.zeros_like(b0), torch.full_like(e0, n_sa), rpos, ract, wide),
        ):
            pl = extend_packed(didx, w.preads, w.next_bad, w.lens2, b_, e_, p_, a_, k,
                               steps, L, col_off=w.col_off2)
            kn = extend_packed_kernel(didx, w, b_, e_, p_, a_, k, steps) if cuda else pl
            ext_errs.append(max(diff(x, y) for x, y in zip(kn, pl)))
        hit = torch.arange(got.q.shape[1], device=dev)[None, :] < got.n[:, None]
        checks.append(dict(
            set=name, lanes=R, read_len=L, zero_length_lanes=int((w.lens2 == 0).sum()),
            words=ext_words(L, k),
            fused_words=didx.sa_cmp.shape[1] - 3, hit_slots=params["H"],
            hits=int(got.n.sum()), truncated_lanes=int(got.truncated.sum()),
            widest_interval=int(torch.where(hit, got.e - got.b, 0).max()),
            longest_mmp=int(got.l.max()), field_err=errs, extend_err=ext_errs,
            equal_plain=not any(errs.values()), extend_equal_plain=not any(ext_errs),
        ))
        max_err = max(max_err, *errs.values(), *ext_errs)
        if name == "smoke_chunk":
            main = (didx, w, params)
    by = {c["set"]: c for c in checks}
    covered = (
        by["reads_150bp"]["words"] > by["reads_150bp"]["fused_words"]
        and by["reads_150bp"]["longest_mmp"] > K + 48
        and by["repetitive_2_slots"]["truncated_lanes"] > 0
        and by["repetitive_16_slots"]["widest_interval"] > 1
        and by["cli_ragged_batch"]["zero_length_lanes"] > 0
        and by["cli_ragged_batch"]["hits"] > 0
    )
    ok = covered and all(c["equal_plain"] and c["extend_equal_plain"] for c in checks)

    # timing and bound at the main path's shape (one chunk: 2 x chunk lanes)
    didx, w, params = main
    wrapper_ms = timer(lambda: anchor_walk(didx, *w, **params), reps=50)
    ms, ms_by = device_ms(lambda: anchor_walk(didx, *w, **params), 50, cuda)
    plain_ms = timer(lambda: anchor_walk_plain(didx, *w, **params), reps=2, warm=1)
    hits = anchor_walk(didx, *w, **params)
    out_bytes = sum(t.numel() * t.element_size() for t in
                    (hits.q, hits.l, hits.b, hits.e, hits.n, hits.truncated))
    if cuda:
        # the bytes the function must move for THIS data: every 32-byte sector
        # of an input that the walk reads, once (counted by the kernel's
        # counting build), and every output written once
        counted, sectors, rows = walk_traffic(didx, w, **params)
        if any(diff(getattr(counted, f), getattr(hits, f)) for f in ScanHits._fields):
            raise RuntimeError("the counting build of the walk disagrees with the kernel")
        nbytes = 32 * sum(sectors.values()) + out_bytes
        ops = 32 * rows  # index arithmetic and one masked word compare a row, at least
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
        bound = dict(bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes,
                     output_bytes=out_bytes, input_sectors_read=sectors, sa_cmp_rows=rows,
                     share_of_bound=max(t_bytes, t_ops) / ms)
    else:
        bound = dict(bound_ms="not measured", bound_by="bytes")
    timing = dict(
        lanes=w.preads.shape[0], read_len=w.preads.shape[1], ms=ms, wrapper_ms=wrapper_ms,
        device_ms_by_kernel=ms_by, plain_ms=plain_ms, library_ms=None, **bound,
    )
    emit("kernel_vs_plain", kernel="anchor_walk", ok=ok, max_abs_err=max_err,
         covered=covered, checks=checks, timing=timing)
    return ok, max_err, timing


def true_locus_share(res, truth, lo: int, hi: int) -> float:
    """Share of reads [lo, hi) with a record at their sampled
    (transcript, position, strand)."""
    t, pos, strand = (a[lo:hi] for a in truth)
    rid = np.repeat(np.arange(hi - lo), res.counts)
    rec = res.recs[: len(rid)]
    m = (rec[:, 0] == t[rid]) & (rec[:, 1] == pos[rid]) & (rec[:, 2] == strand[rid])
    return float(np.bincount(rid[m], minlength=hi - lo).astype(bool).mean())


def profile_batch(mapper, codes, lens, C: int, cuda: bool) -> dict:
    """Where one batch's time goes: the device's busy share and its top
    kernels (torch.profiler), and the synchronized host time of one chunk's
    scan (dense phase, then anchor walk) and collate stages, and of the
    wire's host halves for the batch. A batch below two chunks runs as one
    program over the whole batch, as the command line's default batches do."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rapmap_tpu_torch.ops.collate import collate_batch, collate_records_se
    from rapmap_tpu_torch.ops.compact import compact_se
    from rapmap_tpu_torch.ops.mmp import anchor_walk, dense_phase, walk_params
    from rapmap_tpu_torch.ops.wire import pack_in_se, rec_spec_se

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        mapper.fetch(mapper.map_se_async(codes, lens))
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_kernels(prof) if cuda else {}
    busy_ms = sum(v[0] for v in by_name.values())
    kern = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    own = [(n, v) for n, v in by_name.items() if any(f"::{k}" in n for k in HAND_KERNELS)]

    dev = mapper.device
    chunked = bool(mapper._chunk_of(len(codes)))
    r = torch.from_numpy(codes[:C]).to(dev)
    ln = torch.from_numpy(lens[:C].astype(np.int64)).to(dev)
    spec = rec_spec_se(mapper.st, mapper.cfg)
    stage, wire = {}, {}
    res = mapper.map_se_async(codes, lens)
    for _ in range(2):  # second pass is the one kept (warm)
        # the wire's host halves: pack the reads, pin them, pin a result
        # buffer, and (the result's copy long done) unpack it
        t0 = time.perf_counter()
        win = torch.from_numpy(pack_in_se(codes, lens, len(codes)))
        t1 = time.perf_counter()
        if cuda:
            win = win.pin_memory()
        t2 = time.perf_counter()
        torch.empty(res.wire.shape, dtype=res.wire.dtype, pin_memory=cuda)
        t3 = time.perf_counter()
        mapper.fetch(res)
        wire = dict(pack_in_ms=(t1 - t0) * 1e3, pin_in_ms=(t2 - t1) * 1e3,
                    pin_out_ms=(t3 - t2) * 1e3, unpack_out_ms=(time.perf_counter() - t3) * 1e3,
                    wire_in_bytes=win.numel(), wire_out_bytes=4 * res.wire.numel())
        sync()
        t0 = time.perf_counter()
        w = dense_phase(mapper.didx, mapper.st, r, ln, mapper.cfg)
        sync()
        tw = time.perf_counter()
        hits = anchor_walk(mapper.didx, *w, **walk_params(mapper.st, mapper.cfg))
        sync()
        t1 = time.perf_counter()
        if chunked:
            collate_records_se(mapper.didx, mapper.st, hits, ln, mapper.cfg,
                               mapper.cfg.rec_slots * C, rec_spec=spec)
        else:
            compact_se(collate_batch(mapper.didx, mapper.st, hits, ln, mapper.cfg),
                       mapper.cfg.rec_slots * len(ln))
        sync()
        stage = dict(scan_ms=(t1 - t0) * 1e3, dense_ms=(tw - t0) * 1e3,
                     walk_ms=(t1 - tw) * 1e3, collate_ms=(time.perf_counter() - t1) * 1e3)
    return dict(
        batch_wall_ms=wall_ms,
        device_busy_ms=busy_ms if kern else "not measured",
        device_idle_share=1.0 - busy_ms / wall_ms if kern else "not measured",
        programs=max(1, len(codes) // C), kernel_launches=kern,
        launches_per_chunk=kern / max(1, len(codes) // C),
        top_kernels=[dict(name=n, ms=v[0], count=v[1]) for n, v in top],
        hand_kernels=[dict(name=n, ms=v[0], count=v[1]) for n, v in own],
        chunk_stages=stage, wire_host=wire,
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--txps", type=int, default=10_000)
    ap.add_argument("--reads", type=int, default=262_144)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU with the plain versions")
    args = ap.parse_args()

    import torch

    cuda = not args.cpu_rehearsal
    if cuda and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.models.quasi import QuasiMapper
    from rapmap_tpu_torch.native import bindings

    dev = torch.device("cuda" if cuda else "cpu")
    timer = Timer(cuda)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    smi = nvidia_smi_line() if cuda else "not measured"
    emit("device", kind=kind, count=torch.cuda.device_count() if cuda else 0,
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build -----------------------------------------------------------
    t0 = time.time()
    if not bindings.available():
        raise RuntimeError("native index-build library failed to build")
    native_s = time.time() - t0
    t0 = time.time()
    libs = kernels.build_all() if cuda else {}
    emit("build", native_s=native_s, kernels=sorted(libs), kernels_s=time.time() - t0)

    # ---- kernels against their plain versions ----------------------------
    sort_ok, sort_err, sort_t = phase_sort_kernel(dev, timer)
    if not sort_ok:
        raise RuntimeError("bitonic_sort_pairs kernel disagrees with its plain version")

    # ---- world -------------------------------------------------------------
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke")
    os.makedirs(work, exist_ok=True)
    idx, codes, lens, truth, build_s = build_world(args.seed, args.txps, args.reads, work)
    B = args.reads // BATCHES
    C = B // 4
    cfg = MapConfig(k=K, chunk=C, bitonic_sort=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    mapper = QuasiMapper(idx, cfg, device=dev)
    if cuda:
        torch.cuda.synchronize()
    upload_s = time.time() - t0
    emit("world", txps=args.txps, text_bases=int(idx.n_text), sa=len(idx.sa),
         kmers=len(idx.kmer_b), chd=idx.meta.get("chd"), reads=args.reads,
         read_len=READ_LEN, index_build_s=build_s, upload_s=upload_s,
         device_index_bytes=sum(t.numel() * t.element_size() for t in mapper.didx),
         max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else "not measured",
         chunk=C, voting_pool=cfg.expand_budget * C)

    # the command line's inputs: every read with its true locus in its name,
    # the head of them for the card-against-CPU run, and a file whose last
    # batch at the command line's batch size is ragged
    from rapmap_tpu_torch.io import fastx

    cli_bs = 4096 if args.reads >= 8 * 4096 else 256  # --batchSize's default, or a rehearsal's
    t0 = time.time()
    reads_fq = write_fastq(os.path.join(work, "reads.fq"), codes, truth)
    n_head = min(2 * cli_bs, args.reads)
    head_fq = write_fastq(os.path.join(work, "head.fq"), codes[:n_head], truth)
    n_ragged = min(cli_bs + cli_bs // 2 - 7, args.reads)
    ragged_fq = write_fastq(os.path.join(work, "ragged.fq"), codes[:n_ragged])
    cli_batch = list(fastx.batched_reads(ragged_fq, cli_bs, 512))[-1]
    emit("cli_inputs", reads_fq=args.reads, head_fq=n_head, ragged_fq=n_ragged,
         ragged_batch=dict(rows=cli_batch.codes.shape[0], read_len=cli_batch.codes.shape[1],
                           n_valid=cli_batch.n),
         native_parser=fastx._use_native(reads_fq), write_s=time.time() - t0)
    if cli_batch.n >= cli_batch.codes.shape[0] or cli_batch.lens[cli_batch.n:].any():
        raise RuntimeError("the ragged batch has no zero-length pad rows")

    walk_ok, walk_err, walk_t = phase_walk_kernel(
        dev, timer, mapper, idx, codes, lens, C, args.seed, work, cli_batch)
    if not walk_ok:
        raise RuntimeError("anchor_walk kernel disagrees with its plain version, or "
                           "an input set missed what it is there to exercise")

    # ---- main path: map_se_async / fetch, one batch in flight --------------
    kernels.reset_launches()
    results = []
    t0 = time.time()
    pending = mapper.map_se_async(codes[:B], lens[:B])
    for b in range(1, BATCHES + 1):
        nxt = (
            mapper.map_se_async(codes[b * B : (b + 1) * B], lens[b * B : (b + 1) * B])
            if b < BATCHES else None
        )
        results.append(mapper.fetch(pending))
        pending = nxt
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    n_chunks = args.reads // C
    ctr = {k: sum(r.counters[k] for r in results) for k in results[0].counters}
    map_rate = ctr["reads_mapped"] / ctr["reads_total"]
    truth_share = float(np.mean([
        true_locus_share(r, truth, i * B, (i + 1) * B) for i, r in enumerate(results)
    ]))
    emit("main_path", reads=args.reads, batches=BATCHES, batch=B, chunks=n_chunks,
         seconds=wall, reads_per_s=args.reads / wall, map_rate=map_rate,
         true_locus_share=truth_share, over_budget=ctr["over_budget"],
         counters=ctr, launches=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else "not measured")
    if cuda and min(launches["bitonic_sort_pairs"], launches["anchor_walk"]) < n_chunks:
        raise RuntimeError(f"kernel launches {launches} for {n_chunks} chunks")
    if map_rate < 0.9:
        raise RuntimeError(f"map rate {map_rate:.4f} below 0.9")
    for r in results:
        if r.recs.shape[1] != 4 or len(r.recs) != r.total or r.overflowed:
            raise RuntimeError("malformed wire result")

    emit("profile", **profile_batch(mapper, codes[:B], lens[:B], C, cuda))
    # one batch of the command line's default size: one program over the batch
    emit("profile_unchunked", batch=cli_bs,
         **profile_batch(mapper, codes[:cli_bs], lens[:cli_bs], C, cuda))

    # ---- the card's wire buffer equals the CPU's on the first batch --------
    if cuda:
        again = mapper.map_se_async(codes[:B], lens[:B])
        again.done.synchronize()
        card = again.wire.clone()
        del mapper, again
        torch.cuda.empty_cache()
        t0 = time.time()
        cpu_mapper = QuasiMapper(idx, cfg, device="cpu")
        host = cpu_mapper.map_se_async(codes[:B], lens[:B]).wire
        same = bool(torch.equal(card, host))
        emit("card_equals_cpu", batch=B, equal=same, cpu_s=time.time() - t0)
        if not same:
            raise RuntimeError("card wire buffer differs from the CPU's")
        del cpu_mapper, host, card

    # ---- the command line, in process: FASTQ in, SAM out ---------------------
    force_cpu = not cuda  # a rehearsal runs every command on the CPU
    idx_dir = os.path.join(work, "idx")
    n_main_mapped = ctr["reads_mapped"]
    del results, idx

    def sam(name):
        return os.path.join(work, name)

    default_bs = [] if cli_bs == 4096 else ["--batchSize", str(cli_bs)]
    cli_default = run_cli(
        "cli_default", ["-i", idx_dir, "-r", reads_fq, "-o", sam("a.sam"), *default_bs],
        work, force_cpu)
    n_batches = -(-args.reads // cli_bs)
    share = sam_true_locus_share(sam("a.sam"), args.reads)
    emit("cli_default_checks", batches=n_batches, primary_at_true_locus_share=share,
         reads_mapped_main_path=n_main_mapped)
    if cli_default["counters"]["reads_total"] != args.reads:
        raise RuntimeError("cli_default: reads_total differs from the reads written")
    if cli_default["map_rate"] < 0.9 or cli_default["counters"]["reads_mapped"] != n_main_mapped:
        raise RuntimeError("cli_default: map rate below 0.9 or unequal to the main path's")
    if share < 0.98:
        raise RuntimeError(f"cli_default: {share:.4f} of the primary records at the true locus")
    if cuda and cli_default["launches"]["anchor_walk"] != n_batches:
        raise RuntimeError(f"cli_default: walk launches {cli_default['launches']} "
                           f"for {n_batches} batches")

    cli_chunked = run_cli(
        "cli_chunked", ["-i", idx_dir, "-r", reads_fq, "-o", sam("b.sam"),
                        "--batchSize", str(B), "--chunkSize", str(C), "-t", "2"],
        work, force_cpu)
    same = sam_body(sam("a.sam")) == sam_body(sam("b.sam"))
    emit("cli_chunked_checks", chunks=n_chunks, sam_equals_cli_default=same)
    if not same:
        raise RuntimeError("cli_chunked: SAM differs from cli_default's")
    if cuda and cli_chunked["launches"]["anchor_walk"] != n_chunks:
        raise RuntimeError(f"cli_chunked: walk launches {cli_chunked['launches']} "
                           f"for {n_chunks} chunks")

    # the host-oracle fallback: a starved expansion pool against an ample one
    # on the repetitive world; half a batch of reads wants ~3 starved pools
    # of slots (~5.6 a read), and the record buffer (rec_slots x batch) still
    # holds every record of both runs
    from rapmap_tpu_torch.index.format import load_index

    rep_dir = os.path.join(work, "repetitive_idx")
    n_rep = cli_bs // 2
    rep_codes, _ = sample_reads(load_index(rep_dir), np.random.default_rng(args.seed + 3),
                                n_rep, 120, 0.02)
    rep_fq = write_fastq(os.path.join(work, "repetitive.fq"), rep_codes)
    rep = {}
    for name, budget in (("starved", 1), ("ample", 64)):
        rep[name] = run_cli(
            f"cli_fallback_{name}",
            ["-i", rep_dir, "-r", rep_fq, "-o", sam(f"rep_{name}.sam"), *default_bs,
             "--expandBudget", str(budget)], work, force_cpu)
    same = sam_body(sam("rep_starved.sam")) == sam_body(sam("rep_ample.sam"))
    n_fb = rep["starved"]["counters"].get("host_fallback", 0)
    emit("cli_fallback", reads=n_rep, host_fallback=n_fb, sam_equal=same,
         records=rep["ample"]["counters"]["records"])
    if n_fb <= 0 or rep["ample"]["counters"].get("host_fallback", 0) or not same:
        raise RuntimeError("cli_fallback: no fallback with the starved budget, fallback "
                           "with the ample one, or the two SAM files differ")
    if cuda and min(r["launches"]["anchor_walk"] for r in rep.values()) < 1:
        raise RuntimeError("cli_fallback: the walk kernel was not launched")

    # the card's SAM equals the CPU's
    if cuda:
        head = {}
        for name, on_cpu in (("card", False), ("cpu", True)):
            head[name] = run_cli(
                f"cli_head_{name}", ["-i", idx_dir, "-r", head_fq, "-o", sam(f"head_{name}.sam")],
                work, on_cpu)
        same = sam_body(sam("head_card.sam")) == sam_body(sam("head_cpu.sam"))
        emit("cli_card_equals_cpu", reads=n_head, equal=same,
             cpu_launches=head["cpu"]["launches"])
        if not same or head["cpu"]["launches"]["anchor_walk"]:
            raise RuntimeError("cli_card_equals_cpu: the card's SAM differs from the CPU's, "
                               "or the CPU run launched a kernel")

    cli_launches = {"cli_default": cli_default["launches"], "cli_chunked": cli_chunked["launches"],
                    "cli_fallback_starved": rep["starved"]["launches"],
                    "cli_fallback_ample": rep["ample"]["launches"]}

    def on_cli(kernel):
        return {path: n[kernel] for path, n in cli_launches.items()}

    print(json.dumps({"kernels": [{
        "name": "bitonic_sort_pairs", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/sort2.cu",
        "replaces": "rapmap_tpu/ops/pallas/sort2.py:153",
        "launches": launches["bitonic_sort_pairs"],
        "launches_on_cli_paths": on_cli("bitonic_sort_pairs"), "max_abs_err": sort_err,
        "matches_plain": sort_ok, "ms": sort_t["ms"], "wrapper_ms": sort_t["wrapper_ms"],
        "plain_ms": sort_t["plain_ms"], "bound_ms": sort_t["bound_ms"],
        "bound_by": sort_t["bound_by"], "library_ms": sort_t["library_ms"],
        "library_wrapper_ms": sort_t["library_wrapper_ms"],
    }, {
        "name": "anchor_walk", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/ops/mmp.py:190",
        "launches": launches["anchor_walk"],
        "launches_on_cli_paths": on_cli("anchor_walk"), "max_abs_err": walk_err,
        "matches_plain": walk_ok, "ms": walk_t["ms"], "wrapper_ms": walk_t["wrapper_ms"],
        "plain_ms": walk_t["plain_ms"], "bound_ms": walk_t["bound_ms"],
        "bound_by": walk_t["bound_by"], "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if cuda else "cpu", "kind": kind,
        "count": torch.cuda.device_count() if cuda else 0,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
