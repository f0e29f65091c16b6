#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rapmap_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Builds the port's native host library and every CUDA kernel from the
sources in this checkout, checks the wire_in pack through the mapper's
dispatch (phase_wire_pack: four batches in flight, each one's device bytes
equal to the numpy pack's, every mate block packed by the native pass),
holds each kernel (the voting sort of
csrc/sort2.cu, the anchor walk of csrc/walk.cu in its three forms and its
pseudo build, the banded DP of csrc/align.cu) against
its plain PyTorch version on the card, builds a 20 Mbp random transcriptome world from the
seed, maps 262,144 single-end 76 bp reads through QuasiMapper.map_se_async /
fetch (one batch in flight), and checks the result: map rate, reads mapped
to their true locus, both kernels' launches on the main path, and the
card's wire buffer equal to the CPU's on the first batch; it times the walk
with a warm and a cold L2 and lists one program's scan kernels by name. It
maps 131,072 pairs of 2 x 76 bp from 200-500 bp fragments of the same world
through map_pe_async / fetch (the walk and the sort twice a chunk, once per
mate) and checks the concordant share, the pairs concordant at their true
locus, the launches and the card's wire equal to the CPU's on two chunks,
and profiles one paired-end batch. Then it drives the port's command line in
process (rapmap_tpu_torch.cli.main) on the same world, FASTQ in and SAM out,
single-end and paired-end: at its default flags (batches of 4,096, one
program a batch), chunked with a parser thread, with a starved expansion
budget against an ample one on a repetitive world (the host-oracle
fallback), and on the card against the CPU (SAM files equal byte for byte
apart from @PG; for pairs also under --noOrphans --maxFragLen --pairOrder).
The same world with its CHD section dropped (what a with_chd=False build
writes) takes the binary-search probe, the full upload and the walk kernel's
forward-lanes mode (anchor_walk_lanes), and the charwise extension
(packed_extension=False) the walk's charwise build (anchor_walk_charwise):
both are held against their plain versions; the no-CHD library path
(nochd_path, nochd_pe_path), the charwise path on both index kinds
(charwise_path) and the command line on the no-CHD index (cli_nochd_default,
cli_pe_nochd_default) must give what the canonical-CHD packed path gives in
the same run, and profile_nochd splits a no-CHD chunk's probe out. The
mapping score's kernel (csrc/align.cu, banded_scores) is held against its
plain version on 22 input sets (bands 1 to 64 on either side of every change
of its group layout, live rows scattered, go == ge, 150 bp reads, windows
off transcript ends, Ns, paired-end rows, a mostly dead cap); the
same reads then map with cfg.mapping_score on the main path's upload
(score_path; pe_score_path for one batch of pairs), whose mappings must
equal main_path's and pe_path's and whose sampled scores must equal the
numpy oracle's, and the command line runs with --mappingScore
--minScoreFraction 0.65, single-end and paired-end, where 1,000 sampled
AS:i tags are recomputed by the oracle and the card's SAM must equal the
CPU's. Then the pseudo-mapping path: the world's pseudo index (the port's
build_pseudo_index of the same FASTA, saved for the command line), the walk
kernel's pseudo build (csrc/walk.cu without an extension: pseudo_walk on
strand-paired lanes, pseudo_walk_lanes on explicit lanes) held against its
plain versions on 0xFF-filled outputs (the smoke chunk, Ns and mixed lengths
with empty rows and rows shorter than k, a repetitive world at 1, 2 and 16 hit
slots and with a max_interval its shared k-mers exceed), the 262,144 reads
through PseudoMapper (pseudo_path, 1,000 sampled reads equal to the numpy
pseudo oracle), 32,768 pairs in unchunked batches of 4,096 (pseudo_pe_path,
500 sampled pairs), one batch each without the CHD (binary-search probe,
explicit lanes) and in the big-occ layout, both equal to pseudo_path's, and
the command line's pseudomap, single-end and paired-end, on the card and on
the CPU (SAM equal apart from @PG). Then the host-staged engine and the
compact artifacts (see phase_anchor_kernel, phase_artifacts, phase_staged),
the int64-SA layout on the staged engine and the genome-scale script at
0.02 Gbase with its core artifact, `quasimap --engine auto` from that core
as a child process and the core's reload by
scripts/core_artifact_genome_torch.py (phase_staged_bigsa); then
scripts/scale_world_torch.py, the production-scale transcriptome's run, as a
process at 2 Mbase with its sharded and command-line parts
(phase_scale_world); then bench.py's primary regime, the isoform
transcriptome, by scripts/isoform_world_torch.py as a process on the full
2,000-gene world at a cut depth, and the accuracy protocol by
scripts/eval_accuracy_torch.py (phase_isoform_world).
Then data parallel and the SA-sharded engine: two replicas on the card
(parallel/dp.py) against the single-device program on a batch of reads and
one of pairs (dp_path, dp_pe_path); the sharded walk (csrc/walk.cu's
sharded build, sharded_walk and sharded_walk_lanes) against its plain
version on 0xFF-filled outputs (both lane kinds, Ns and mixed lengths, a
shard whose slots nobody owns, slot64 globals past 2^31); the world's index
in 4 shards on the card (a (2, 4) mesh sharing one upload) against the
replicated engine (sharded_path, sharded_lanes_path, sharded_pe_path,
sharded_score_path, sharded_slot64_path); the split path, each data row's
shards uploaded on their own (the reference's layout on distinct cards when
the host has 8, else split_idx=True on this card): the sharded trip (K10,
tqm_sharded_trip) against its plain version on a data row's first, second
and first empty trip on each shard, the trip's home half (K11,
tqm_sharded_advance) against its plain version at the walk's begin, after
a trip (also with overflowing lanes) and at an empty trip, the split walk's
device work showing no op inside a trip, and a twin of each sharded phase
(sharded_split_path, sharded_split_lanes_path, sharded_split_pe_path,
sharded_split_score_path, sharded_split_slot64_path) equal to its stacked
twin and the replicated engine; and two command-line ranks as
processes sharing the card (--worldSize 2), single-end and paired-end, whose
record unions and global counters must equal the single-process runs'
(cli_world2_se, cli_world2_pe). Every phase prints one JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero, printing no result, without a CUDA card or without the
rest of the repository beside it.

--cpu-rehearsal (with --txps/--reads/--pairs small) runs the same phases on
the CPU with the plain versions, to check the script's control flow off the
card.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
# 32-bit integer add, min and max issue at 64 a clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions); the operations bound of every kernel is taken at that rate
# times the card's SM count and its max SM clock (int_ops_rate). The 67 T/s
# of the data sheet is the fp32 rate with an FMA counted as two operations.
INT_OPS_PER_CLOCK_PER_SM = 64
INT_OPS_PER_S = 132 * 64 * 1.98e9  # H100 SXM's nominal; main() sets the card's
# 32-bit integer operations of one compare-exchange of the bitonic sort's
# 64-bit keys, as csrc/sort2.cu's exchange() does it: the unsigned compare as
# two 32-bit compares (low word, then high with the carry) and the two 64-bit
# selects (min, max) as four 32-bit ones; its shuffle and cluster strides do
# at least as many
SORT_OPS_PER_EXCHANGE = 6
READ_LEN = 76
BATCHES = 8  # per run; each batch is 4 chunks
PE_BATCHES = 4  # paired-end batches, of 4 chunks each
K = 31
# the __global__ functions of csrc/*.cu, as the profiler names them
HAND_KERNELS = ("cluster_sort_kernel", "tile_sort_kernel", "tile_merge_kernel",
                "global_step_kernel", "anchor_walk_kernel", "extend_packed_kernel",
                "extend_charwise_kernel", "banded_group_kernel", "banded_scratch_kernel",
                "sharded_trip_kernel", "sharded_advance_kernel")
SCORE_FLAGS = ["--mappingScore", "--minScoreFraction", "0.65"]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def int_ops_rate(cuda: bool) -> dict:
    """The card's 32-bit integer operation rate: its SM count x 64 a clock x
    its max SM clock (nvidia-smi clocks.max.sm); the nominal H100 SXM rate,
    marked not measured, off the card."""
    if not cuda:
        return dict(ops_per_s=INT_OPS_PER_S, source="H100 SXM nominal (not measured)")
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    return dict(ops_per_s=sms * INT_OPS_PER_CLOCK_PER_SM * mhz * 1e6, sms=sms,
                ops_per_clock_per_sm=INT_OPS_PER_CLOCK_PER_SM, max_sm_clock_mhz=mhz,
                source="the card")


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


def device_kernels(work) -> dict[str, list]:
    """{kernel name: [device ms, count]} of what work() runs on the device
    under torch.profiler: every kernel, copy and memset, by its own duration.
    A profiler session loses its first few device events on the card (49 of
    50 walk launches were recorded without this), so eight short primer
    kernels (`torch.cuda._sleep`) run first and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        work()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
            v = by_name.setdefault(e.name[:80], [0.0, 0])
            v[0] += e.time_range.elapsed_us() / 1e3
            v[1] += 1
    return by_name


def graph_device_ms(fn, reps: int) -> float:
    """Device time of one fn() without the profiler: `reps` calls captured
    into one CUDA graph and replayed between two CUDA events, per call (the
    launches back to back, no host time between them; fn must not wait on
    the device)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int, cuda: bool):
    """Time the DEVICE spends on one fn(): the durations of everything it
    ran during `reps` calls under torch.profiler, per call. What the host
    takes to issue the work is not in it (Timer's wrapper time has that).
    A kernel recorded fewer times than its launches counts by the mean of
    its recorded durations. A process's profiler can stop recording device
    events altogether (seen on the card after hundreds of profiled windows): after
    three empty windows the time comes from graph_device_ms instead, under
    the one key "cuda_graph_replay", and a `profiler_fallback` line says so.
    -> (ms, {kernel name: ms per call})."""
    if not cuda:
        return "not measured", {}
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiled window now and then records no device event at all
        by_name = device_kernels(lambda: [fn() for _ in range(reps)])
        if by_name:
            break
    else:
        ms = graph_device_ms(fn, reps)
        emit("profiler_fallback", helper="device_ms", used="cuda_graph_replay", ms=ms)
        return ms, {"cuda_graph_replay": ms}
    per_call = {n: v[0] / v[1] * max(1, round(v[1] / reps)) for n, v in by_name.items()}
    return sum(per_call.values()), per_call


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
    exchanges = (n // 2) * log2n * (log2n + 1) // 2  # 64-bit compare-exchanges
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = exchanges * SORT_OPS_PER_EXCHANGE / INT_OPS_PER_S * 1e3
    timing = dict(
        n=n, path=path(n), ms=ms, wrapper_ms=wrapper_ms, device_ms_by_kernel=ms_by,
        plain_ms=plain_ms, library_ms=library_ms, library_wrapper_ms=library_wrapper_ms,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, compare_exchanges=exchanges, ops_per_exchange=SORT_OPS_PER_EXCHANGE,
        bytes_bound_ms=t_bytes, operations_bound_ms=t_ops,
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


def sample_pairs(idx, rng, n_pairs: int, read_len: int, err_rate: float,
                 frag_lo: int = 200, frag_hi: int = 500):
    """Read pairs of one mate length from fragments of frag_lo..frag_hi bp
    (uniform) at uniform loci of the index's transcripts, substitutions at
    err_rate: the left mate is the fragment's start, the right mate the
    reverse complement of its end, and for half the pairs the two mates are
    swapped -> (codes1, codes2 (n, read_len) int8, (transcript, mate-1
    position, mate-2 position, mate-1 strand))."""
    tl = np.asarray(idx.txp_lens, dtype=np.int64)
    frag = rng.integers(frag_lo, frag_hi + 1, n_pairs)
    t = rng.choice(len(tl), size=n_pairs, p=tl / tl.sum())
    t = np.where(tl[t] >= frag, t, int(np.argmax(tl)))
    pos = (rng.random(n_pairs) * (tl[t] - frag + 1)).astype(np.int64)
    start = np.asarray(idx.txp_offsets, dtype=np.int64)[t] + pos
    text = np.asarray(idx.text)
    cols = np.arange(read_len)[None, :]
    left = text[start[:, None] + cols].astype(np.int8)
    right = text[(start + frag - read_len)[:, None] + cols].astype(np.int8)
    for c in (left, right):
        err = rng.random(c.shape) < err_rate
        c[err] = rng.integers(1, 5, int(err.sum()))
    right = (5 - right)[:, ::-1]
    swap = rng.random(n_pairs) < 0.5
    c1 = np.where(swap[:, None], right, left)
    c2 = np.where(swap[:, None], left, right)
    p_left, p_right = pos, pos + frag - read_len
    truth = (t, np.where(swap, p_right, p_left), np.where(swap, p_left, p_right),
             swap.astype(np.int64))
    return np.ascontiguousarray(c1), np.ascontiguousarray(c2), truth


def write_fastq_pairs(path1: str, path2: str, c1, c2, truth) -> tuple[str, str]:
    """Pairs as two FASTQ files, each pair named by its true locus:
    p<i>:<transcript>:<mate-1 position>:<mate-2 position>:<mate-1 strand>."""
    names = [f"p{i}:{truth[0][i]}:{truth[1][i]}:{truth[2][i]}:{truth[3][i]}"
             for i in range(len(c1))]
    for path, codes in ((path1, c1), (path2, c2)):
        seqs = np.frombuffer(b"NACGTN", dtype=np.uint8)[codes]
        with open(path, "w") as f:
            for name, row in zip(names, seqs):
                seq = row.tobytes().decode()
                f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    return path1, path2


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


def write_fastq(path: str, codes, truth=None, lens=None) -> str:
    """Reads as FASTQ, each named r<i> or, with `truth`, by its true locus:
    r<i>:<transcript>:<position>:<strand>; with `lens`, row i cut to lens[i]."""
    seqs = np.frombuffer(b"NACGTN", dtype=np.uint8)[codes]
    with open(path, "w") as f:
        for i, row in enumerate(seqs):
            name = f"r{i}" if truth is None else (
                f"r{i}:{truth[0][i]}:{truth[1][i]}:{truth[2][i]}")
            seq = row.tobytes().decode() if lens is None else row[: lens[i]].tobytes().decode()
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
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


def sam_pe_true_locus_share(path: str, n_pairs: int) -> float:
    """Share of the pairs (named by write_fastq_pairs with their truth) whose
    PRIMARY mate-1 record is a proper pair at the true transcript with both
    true positions."""
    good = 0
    with open(path) as f:
        for ln in f:
            if ln[0] == "@":
                continue
            name, flag, rname, pos, _, _, _, pnext = ln.split("\t", 8)[:8]
            flag = int(flag)
            if flag & 0x104 or not flag & 0x40 or not flag & 0x2:
                continue
            _, t, p1, p2, _ = name.split(":")
            good += (rname == f"t{t}" and int(pos) - 1 == int(p1)
                     and int(pnext) - 1 == int(p2))
    return good / n_pairs


class StageLog(logging.Handler):
    """Keeps what the command line's --profile logs: {stage: [seconds, calls]}."""

    def __init__(self):
        super().__init__()
        self.stages: dict[str, list] = {}

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith("stage ") and record.args:
            name, seconds, calls = record.args
            self.stages[name] = [seconds, calls]


def run_cli(phase: str, argv: list[str], workdir: str, force_cpu: bool = False,
            cmd: str = "quasimap") -> dict:
    """One `quasimap` (or `cmd`) through rapmap_tpu_torch.cli.main in this process, with
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
        rc = cli.main([cmd, *argv, "--statsJson", stats_path, "--profile"])
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


def extend_charwise_kernel(didx, codes, lens, b0, e0, pos, active, k: int, steps: int):
    """csrc/walk.cu's tqm_extend_charwise: the charwise extension's device
    function once per lane -> (b, e, mlen), the signature of ops.mmp._extend
    (lane r reads row r of codes). Only this script calls it, to tell a fault
    in the charwise extension from one in the walk around it."""
    import torch

    from rapmap_tpu_torch import kernels

    R, L = codes.shape
    dev = codes.device
    b, e, mlen = (torch.empty(R, dtype=torch.int64, device=dev) for _ in range(3))
    act = active.to(torch.uint8).contiguous()
    fn = kernels.library("walk").tqm_extend_charwise
    fn.restype = ctypes.c_int
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [vp] * 7 + [i64, vp, i64, i64] + [i32] * 3 + [vp] * 4
    with torch.cuda.device(dev):
        rc = fn(
            codes.data_ptr(), lens.data_ptr(), b0.data_ptr(), e0.data_ptr(), pos.data_ptr(),
            act.data_ptr(), didx.sa.data_ptr(), didx.sa.shape[0], didx.text.data_ptr(),
            didx.text.shape[0], R, L, k, steps, b.data_ptr(), e.data_ptr(), mlen.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tqm_extend_charwise launch failed: CUDA error {rc}")
    return b, e, mlen


WALK_INPUTS = ("preads", "next_bad", "lens2", "col_off2", "bf", "ef", "br", "er", "anch_f",
               "anch_rF", "sa_cmp", "text2q")
CHAR_WALK_INPUTS = ("lens2", "bf", "ef", "br", "er", "anch_f", "anch_rF", "codes", "sa", "text")


def didx_bytes(didx) -> int:
    """Device bytes of an uploaded index (the tensors the upload kept)."""
    return sum(t.numel() * t.element_size() for t in didx if t is not None)


def walk_on_0xff(didx, w, k: int, H: int, ext_steps: int, count: bool = False,
                 paired: bool = True, codes=None):
    """csrc/walk.cu's entries called straight, on outputs that start as 0xFF
    bytes, so that a byte the kernel leaves unwritten shows in a comparison
    with the plain version (the wrapper allocates them unfilled, and a fresh
    allocation may hold zeros already). paired=False: explicit lanes, B = R.
    codes (R, L) int8: the charwise extension (tqm_anchor_walk_charwise).
    count=False: the main path's kernel -> (ScanHits, None, None).
    count=True: the walk compiled with its loads counted
    (tqm_anchor_walk_traffic / tqm_anchor_walk_charwise_traffic), which marks
    every 32-byte sector of every input tensor that it uses in a bitmap ->
    (ScanHits, {input: distinct sectors read}, sa_cmp rows compared or, for
    the charwise walk, search trips), for the walk's byte bound. Only this
    script calls them."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.ops.extend_packed import ext_words
    from rapmap_tpu_torch.ops.mmp import ScanHits

    R = w.lens2.shape[0]
    L = (w.preads if codes is None else codes).shape[1]
    B = R // 2 if paired else R
    S = w.bf.shape[1]
    dev = w.lens2.device
    buf = torch.full((R, H, 4), -1, dtype=torch.int64, device=dev)
    n = torch.full((R,), -1, dtype=torch.int64, device=dev)
    trunc = torch.full((R,), 0xFF, dtype=torch.uint8, device=dev)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib = kernels.library("walk")
    if codes is None:
        names, tensors = WALK_INPUTS, [*w, didx.sa_cmp, didx.text2q]
        argtypes = [vp] * 11 + [i64, i32, vp, i64, i64, i64] + [i32] * 6 + [vp] * 3
        args = [*(t.data_ptr() for t in w), didx.sa_cmp.data_ptr(), didx.sa_cmp.shape[0],
                didx.sa_cmp.shape[1] - 3, didx.text2q.data_ptr(), didx.text2q.shape[0],
                R, B, L, S, k, H, ext_steps, ext_words(L, k)]
        name = "tqm_anchor_walk"
    else:
        names = CHAR_WALK_INPUTS
        tensors = [w.lens2, w.bf, w.ef, w.br, w.er, w.anch_f, w.anch_rF, codes, didx.sa,
                   didx.text]
        argtypes = [vp] * 9 + [i64, vp, i64, i64, i64] + [i32] * 5 + [vp] * 3
        args = [codes.data_ptr(), *(t.data_ptr() for t in tensors[:7]), didx.sa.data_ptr(),
                didx.sa.shape[0], didx.text.data_ptr(), didx.text.shape[0],
                R, B, L, S, k, H, ext_steps]
        name = "tqm_anchor_walk_charwise"
    args += [buf.data_ptr(), n.data_ptr(), trunc.data_ptr()]
    if count:
        # one sector more than the bytes fill: a tensor need not start on a sector
        words = [((t.numel() * t.element_size() + 31) // 32 + 1 + 31) // 32 for t in tensors]
        off = np.concatenate([[0], np.cumsum(words)]).astype(np.int64)
        bits = torch.zeros(int(off[-1]), dtype=torch.int32, device=dev)
        rows = torch.zeros(1, dtype=torch.int64, device=dev)
        fn = getattr(lib, name + "_traffic")
        argtypes += [vp, ctypes.POINTER(i64), vp]
        args += [bits.data_ptr(), (i64 * len(words))(*off[:-1].tolist()), rows.data_ptr()]
    else:
        fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [vp]
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    torch.cuda.synchronize(dev)
    hits = ScanHits(q=buf[..., 0], l=buf[..., 1], b=buf[..., 2], e=buf[..., 3],
                    n=n, truncated=trunc)
    if not count:
        return hits, None, None
    marks = bits.cpu().numpy().view(np.uint8)
    sectors = {
        nm: int(np.unpackbits(marks[4 * off[g] : 4 * off[g + 1]]).sum())
        for g, nm in enumerate(names)
    }
    return hits, sectors, int(rows.cpu()[0])


def walk_cold_ms(fn, reps: int, cuda: bool, kernel: str = "anchor_walk_kernel"):
    """A kernel with a cold L2: before each call a 1 GiB fill (more than the
    card's 50 MB L2, and longer on the device than the host takes to issue
    fn()) outside the timed events -> (CUDA events around each call, mean
    ms; device time of the kernels whose name holds `kernel` alone under
    torch.profiler, mean ms, or the events' mean when three profiled
    windows recorded under half the launches, with a `profiler_fallback`
    line)."""
    if not cuda:
        return "not measured", "not measured"
    import torch

    flush = torch.empty(1 << 28, dtype=torch.int32, device="cuda")
    flush.fill_(0)
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for a, b in marks:
        flush.fill_(1)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    event_ms = sum(a.elapsed_time(b) for a, b in marks) / reps

    def work():
        for _ in range(reps):
            flush.fill_(1)
            fn()

    for _ in range(3):  # a profiled window now and then records no device event at all
        by_name = device_kernels(work)
        walk = [v for n, v in by_name.items() if kernel in n]
        if sum(v[1] for v in walk) >= reps // 2:
            cold_ms = sum(v[0] for v in walk) / sum(v[1] for v in walk)
            break
    else:
        emit("profiler_fallback", helper="walk_cold_ms", kernel=kernel, used="cuda_events",
             seen={n: v[1] for n, v in by_name.items()}, ms=event_ms)
        cold_ms = event_ms
    del flush
    torch.cuda.empty_cache()
    return event_ms, cold_ms


def phase_walk_kernel(dev, timer, mapper, idx, codes, lens, C: int, seed: int, work: str,
                      cli_batch):
    """anchor_walk (CUDA kernel) against anchor_walk_plain, all six ScanHits
    fields, and tqm_extend_packed against extend_packed, on card tensors of
    seven input sets (the sixth a ragged last batch as the command line's
    reader hands it over: `cli_batch`; the seventh 144-160 bp reads in the
    reader's 160-column bucket, past the mask words and query words the
    kernel keeps in registers); the main path's kernel on outputs that start
    as 0xFF bytes with hit slots past what a block can stage in shared memory
    for 64 lanes (H = 150 and 300: 48 and 24 lanes a block, partial warps;
    H = 8,000: lanes write the buffer directly) against the plain version's
    H = 16; then, at the main path's shape, the walk's timing (`ms` is device time with a warm L2,
    `cold_ms` with the L2 flushed before each launch; `wrapper_ms` CUDA events
    around the calls, host included) and its byte bound."""
    import torch

    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.io import fastx
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
    rdidx, rst = upload_index(ridx, dev, lean=True)
    c4, _ = sample_reads(ridx, rng, n_small, 120, 0.02)
    l4 = np.full(n_small, 120, np.int32)
    # (vii) 144-160 bp reads through the command line's reader: the 160-column
    # bucket gives S = 130 > 128 mask columns and W = 9 > 8 query words
    c7, _ = sample_reads(idx, rng, n_small, 160, 0.01)
    l7 = rng.integers(144, 161, n_small)
    l7[::4] = 160
    b7 = next(fastx.batched_reads(
        write_fastq(os.path.join(work, "bucket160.fq"), c7, lens=l7), n_small, 512))
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
        ("cli_bucket_160", mapper.didx, mapper.st, mapper.cfg,
         np.ascontiguousarray(b7.codes), b7.lens),
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
        S, k, n_sa = w.bf.shape[1], params["k"], didx.sa_cmp.shape[0]
        first = got.q[:, 0].contiguous()
        col = torch.where(torch.arange(R, device=dev) >= R // 2, w.lens2 - k - first, first)
        col = col.clamp(0, S - 1)[:, None]
        act = got.n > 0
        b0 = torch.gather(torch.cat([w.bf, w.br]), 1, col)[:, 0].contiguous()
        e0 = torch.gather(torch.cat([w.ef, w.er]), 1, col)[:, 0].contiguous()
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
            columns=S, words=ext_words(L, k),
            fused_words=didx.sa_cmp.shape[1] - 3, hit_slots=params["H"],
            hits=int(got.n.sum()), truncated_lanes=int(got.truncated.sum()),
            widest_interval=int(torch.where(hit, got.e - got.b, 0).max()),
            longest_mmp=int(got.l.max()), field_err=errs, extend_err=ext_errs,
            equal_plain=not any(errs.values()), extend_equal_plain=not any(ext_errs),
        ))
        max_err = max(max_err, *errs.values(), *ext_errs)
        if name == "smoke_chunk":
            main = (didx, w, params, want)
    by = {c["set"]: c for c in checks}
    covered = (
        by["reads_150bp"]["words"] > by["reads_150bp"]["fused_words"]
        and by["reads_150bp"]["longest_mmp"] > K + 48
        and by["repetitive_2_slots"]["truncated_lanes"] > 0
        and by["repetitive_16_slots"]["widest_interval"] > 1
        and by["cli_ragged_batch"]["zero_length_lanes"] > 0
        and by["cli_ragged_batch"]["hits"] > 0
        and by["cli_bucket_160"]["read_len"] == 160
        and by["cli_bucket_160"]["columns"] > 128  # mask words rebuilt from the row
        and by["cli_bucket_160"]["words"] > 8       # query words from global memory
        and by["cli_bucket_160"]["longest_mmp"] > K + 128  # ... that a compare reached
    )
    ok = covered and all(c["equal_plain"] and c["extend_equal_plain"] for c in checks)

    # more hit slots than a block stages for 64 lanes, on outputs that start
    # as 0xFF bytes: the smoke chunk's plain H = 16 result, no lane of which
    # truncates, padded with empty slots
    didx, w, params, want = main
    large_h = []
    if cuda:
        for H in (150, 300, 8000):
            got, _, _ = walk_on_0xff(didx, w, **{**params, "H": H})
            pad = H - want.q.shape[1]
            errs = {f: diff(getattr(got, f), torch.nn.functional.pad(getattr(want, f), (0, pad)))
                    for f in ("q", "l", "b", "e")}
            errs.update(n=diff(got.n, want.n), truncated=diff(got.truncated, want.truncated))
            large_h.append(dict(hit_slots=H, field_err=errs, equal_plain=not any(errs.values())))
            max_err = max(max_err, *errs.values())
            del got
        ok = ok and not bool(want.truncated.any()) and all(c["equal_plain"] for c in large_h)

    # timing and bound at the main path's shape (one chunk: 2 x chunk lanes)
    wrapper_ms = timer(lambda: anchor_walk(didx, *w, **params), reps=50)
    ms, ms_by = device_ms(lambda: anchor_walk(didx, *w, **params), 50, cuda)
    cold_event_ms, cold_ms = walk_cold_ms(lambda: anchor_walk(didx, *w, **params), 50, cuda)
    plain_ms = timer(lambda: anchor_walk_plain(didx, *w, **params), reps=2, warm=1)
    hits = anchor_walk(didx, *w, **params)
    out_bytes = sum(t.numel() * t.element_size() for t in
                    (hits.q, hits.l, hits.b, hits.e, hits.n, hits.truncated))
    if cuda:
        # the bytes the function must move for THIS data: every 32-byte sector
        # of an input that the walk reads, once (counted by the kernel's
        # counting build), and every output written once
        counted, sectors, rows = walk_on_0xff(didx, w, **params, count=True)
        if any(diff(getattr(counted, f), getattr(hits, f)) for f in ScanHits._fields):
            raise RuntimeError("the counting build of the walk disagrees with the kernel")
        nbytes = 32 * sum(sectors.values()) + out_bytes
        ops = 32 * rows  # index arithmetic and one masked word compare a row, at least
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound = dict(bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes=nbytes, output_bytes=out_bytes, input_sectors_read=sectors,
                     sa_cmp_rows=rows, share_of_bound=bound_ms / ms,
                     share_of_bound_cold=bound_ms / cold_ms)
    else:
        bound = dict(bound_ms="not measured", bound_by="bytes")
    timing = dict(
        lanes=w.preads.shape[0], read_len=w.preads.shape[1], ms=ms, cold_ms=cold_ms,
        cold_event_ms=cold_event_ms, wrapper_ms=wrapper_ms, device_ms_by_kernel=ms_by,
        plain_ms=plain_ms, library_ms=None, **bound,
    )
    emit("kernel_vs_plain", kernel="anchor_walk", ok=ok, max_abs_err=max_err,
         covered=covered, checks=checks, large_hit_slots=large_h, timing=timing)
    return ok, max_err, timing


def without_chd(idx):
    """The index with its CHD section dropped: what build_quasi_index(...,
    with_chd=False) writes for the same FASTA (same SA, k-mer table, text)."""
    import dataclasses

    meta = {k: v for k, v in idx.meta.items() if k != "chd"}
    return dataclasses.replace(idx, chd_dir=None, chd_perm=None, chd_cls=None, meta=meta)


def hits_err(a, b) -> dict:
    """Largest absolute difference of each ScanHits field."""
    import torch

    from rapmap_tpu_torch.ops.mmp import ScanHits

    def diff(x, y):
        return int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
    return {f: diff(getattr(a, f), getattr(b, f)) for f in ScanHits._fields}


def walk_set_record(name, didx, w, kw, got, errs, extra) -> dict:
    """One input set's line in a walk kernel_vs_plain phase."""
    import torch

    from rapmap_tpu_torch.ops.extend_packed import ext_words

    R, L = w.lens2.shape[0], (w.preads if kw["codes"] is None else kw["codes"]).shape[1]
    hit = torch.arange(got.q.shape[1], device=got.q.device)[None, :] < got.n[:, None]
    return dict(
        set=name, lanes=R, paired=kw["paired"], read_len=L, columns=w.bf.shape[1],
        words=ext_words(L, kw["k"]), hit_slots=kw["H"], hits=int(got.n.sum()),
        truncated_lanes=int(got.truncated.sum()),
        widest_interval=int(torch.where(hit, got.e - got.b, 0).max()),
        longest_mmp=int(got.l.max()), field_err=errs, equal_plain=not any(errs.values()),
        **extra,
    )


def walk_timing(didx, w, kw, plain, timer, cuda: bool) -> dict:
    """A walk's launch at a main-path shape: device ms with a warm L2 (`ms`)
    and with the L2 flushed before each launch (`cold_ms`), CUDA events
    around the calls (`wrapper_ms`), the plain version's ms, and the byte
    bound counted by the kernel's counting build (every 32-byte input sector
    the walk uses, once, plus the outputs written once); no single PyTorch
    call computes the walk (`library_ms` null)."""
    from rapmap_tpu_torch.ops.mmp import anchor_walk

    prm = {x: kw[x] for x in ("k", "H", "ext_steps")}
    run = lambda: anchor_walk(didx, *w, **kw)  # noqa: E731
    wrapper_ms = timer(run, reps=50)
    ms, ms_by = device_ms(run, 50, cuda)
    cold_event_ms, cold_ms = walk_cold_ms(run, 50, cuda)
    plain_ms = timer(lambda: plain(didx, *w, **prm, codes=kw["codes"]), reps=2, warm=1)
    hits = run()
    out_bytes = sum(t.numel() * t.element_size() for t in hits)
    if cuda:
        counted, sectors, rows = walk_on_0xff(didx, w, **prm, count=True, paired=kw["paired"],
                                              codes=kw["codes"])
        if any(hits_err(counted, hits).values()):
            raise RuntimeError("the counting build of the walk disagrees with the kernel")
        nbytes = 32 * sum(sectors.values()) + out_bytes
        # at least index arithmetic and one compare a row or a search trip
        ops = 32 * rows if kw["codes"] is None else 8 * rows
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound = dict(bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes=nbytes, output_bytes=out_bytes, input_sectors_read=sectors,
                     counted_rows_or_trips=rows, share_of_bound=bound_ms / ms,
                     share_of_bound_cold=bound_ms / cold_ms)
    else:
        bound = dict(bound_ms="not measured", bound_by="bytes")
    return dict(lanes=w.lens2.shape[0], ms=ms, cold_ms=cold_ms, cold_event_ms=cold_event_ms,
                wrapper_ms=wrapper_ms, device_ms_by_kernel=ms_by, plain_ms=plain_ms,
                library_ms=None, **bound)


def phase_lanes_walk_kernel(dev, timer, nmapper, idx, codes, lens, C: int, seed: int,
                            work: str):
    """anchor_walk with paired=False (the kernel's forward-lanes mode, the
    probe path of indexes without the canonical CHD) against
    anchor_walk_lanes_plain, all six ScanHits fields, through the wrapper and
    through the entry on outputs that start as 0xFF bytes, on the explicit
    [fwd; revcomp] lanes of: one chunk of the no-CHD world, the Ns/mixed
    length set, 150 bp reads, and the repetitive world without its CHD at 2
    and 16 hit slots; then its timing and bound on the chunk."""
    import torch

    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.index.format import load_index
    from rapmap_tpu_torch.ops.device_index import upload_index
    from rapmap_tpu_torch.ops.mmp import anchor_walk, anchor_walk_lanes_plain, scan_inputs

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed + 7)
    n_small = min(C, 4096)
    c2 = codes[C : 2 * C].copy()
    c2[rng.random(c2.shape) < 0.02] = 5
    l2 = rng.integers(20, READ_LEN + 1, C).astype(np.int32)
    l2[::7], l2[1::7], l2[2::7] = K, K - 3, READ_LEN
    c2[np.arange(READ_LEN)[None, :] >= l2[:, None]] = 5
    c3, _ = sample_reads(idx, rng, n_small, 150, 0.01)
    ridx = without_chd(load_index(os.path.join(work, "repetitive_idx")))
    rdidx, rst = upload_index(ridx, dev)
    n_rep = max(n_small, 512)  # enough lanes that some overflow 2 slots at any size
    c4, _ = sample_reads(ridx, rng, n_rep, 120, 0.02)
    l4 = np.full(n_rep, 120, np.int32)
    sets = [
        ("nochd_chunk", nmapper.didx, nmapper.st, nmapper.cfg, codes[:C], lens[:C]),
        ("ns_mixed_lengths", nmapper.didx, nmapper.st, nmapper.cfg, c2, l2),
        ("reads_150bp", nmapper.didx, nmapper.st, nmapper.cfg, c3,
         np.full(n_small, 150, np.int32)),
        ("repetitive_2_slots", rdidx, rst, MapConfig(k=K, max_hits_per_strand=2), c4, l4),
        ("repetitive_16_slots", rdidx, rst, MapConfig(k=K), c4, l4),
    ]
    checks, max_err, main = [], 0, None
    for name, didx, st, cfg, cds, lns in sets:
        w, kw = scan_inputs(didx, st, torch.from_numpy(cds).to(dev),
                            torch.from_numpy(lns.astype(np.int64)).to(dev), cfg)
        if kw["paired"] or kw["codes"] is not None:
            raise RuntimeError(f"{name}: expected the packed forward-lanes walk")
        prm = {x: kw[x] for x in ("k", "H", "ext_steps")}
        want = anchor_walk_lanes_plain(didx, *w, **prm)
        got = anchor_walk(didx, *w, **kw)
        errs = hits_err(got, want)
        if cuda:
            raw, _, _ = walk_on_0xff(didx, w, **prm, paired=False)
            errs = {f: max(v, hits_err(raw, want)[f]) for f, v in errs.items()}
        checks.append(walk_set_record(name, didx, w, kw, got, errs, {}))
        max_err = max(max_err, *errs.values())
        if name == "nochd_chunk":
            main = (didx, w, kw)
    by = {c["set"]: c for c in checks}
    covered = (by["reads_150bp"]["longest_mmp"] > K + 48
               and by["repetitive_2_slots"]["truncated_lanes"] > 0
               and by["repetitive_16_slots"]["widest_interval"] > 1
               and by["nochd_chunk"]["lanes"] == 2 * C)
    ok = covered and all(c["equal_plain"] for c in checks)
    didx, w, kw = main
    timing = walk_timing(didx, w, kw, anchor_walk_lanes_plain, timer, cuda)
    emit("kernel_vs_plain", kernel="anchor_walk_lanes", ok=ok, max_abs_err=max_err,
         covered=covered, checks=checks, timing=timing)
    del rdidx
    return ok, max_err, timing


def phase_charwise_kernel(dev, timer, cmapper, nmapper, idx, codes, lens, C: int, seed: int,
                          work: str):
    """anchor_walk with the charwise extension (kernel anchor_walk_charwise)
    against the plain walks with the plain `_extend`, all six ScanHits
    fields, through the wrapper and on 0xFF-filled outputs: strand-paired
    lanes on the CHD index (`cmapper`, full upload) and explicit lanes on the
    no-CHD index (`nmapper`), each on one chunk and on 150 bp reads, and
    strand-paired lanes on the repetitive world's index (anchor intervals up
    to 8 wide that narrow to width 1, and so into the kernel's width-1
    shortcut, in the middle of an extension); each also equal to the packed
    walk of the same reads; tqm_extend_charwise alone against `_extend` at
    every lane's first anchor and on the whole suffix array at random
    positions; then each mode's timing and bound on the chunk."""
    import dataclasses

    import torch

    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.index.format import load_index
    from rapmap_tpu_torch.ops.device_index import upload_index
    from rapmap_tpu_torch.ops.mmp import (
        _extend, anchor_walk, anchor_walk_lanes_plain, anchor_walk_plain, scan_inputs,
    )

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed + 8)
    n_small = min(C, 4096)
    c3, _ = sample_reads(idx, rng, n_small, 150, 0.01)
    l3 = np.full(n_small, 150, np.int32)
    ridx = load_index(os.path.join(work, "repetitive_idx"))
    rdidx, rst = upload_index(ridx, dev, lean=False)
    n_rep = max(n_small, 512)
    c4, _ = sample_reads(ridx, rng, n_rep, 120, 0.02)
    c, n = (cmapper.didx, cmapper.st, cmapper.cfg), (nmapper.didx, nmapper.st, nmapper.cfg)
    sets = [("paired_chunk", *c, codes[:C], lens[:C]), ("paired_150bp", *c, c3, l3),
            ("lanes_chunk", *n, codes[:C], lens[:C]), ("lanes_150bp", *n, c3, l3),
            ("paired_repetitive", rdidx, rst, MapConfig(k=K), c4, np.full(n_rep, 120, np.int32))]
    checks, max_err, mains = [], 0, {}
    for name, didx, st, cfg, cds, lns in sets:
        cfg = dataclasses.replace(cfg, packed_extension=False)
        r = torch.from_numpy(cds).to(dev)
        ln = torch.from_numpy(lns.astype(np.int64)).to(dev)
        w, kw = scan_inputs(didx, st, r, ln, cfg)
        if kw["codes"] is None or kw["paired"] != name.startswith("paired"):
            raise RuntimeError(f"{name}: expected the charwise walk")
        prm = {x: kw[x] for x in ("k", "H", "ext_steps")}
        plain = anchor_walk_plain if kw["paired"] else anchor_walk_lanes_plain
        want = plain(didx, *w, **prm, codes=kw["codes"])
        got = anchor_walk(didx, *w, **kw)
        errs = hits_err(got, want)
        pw, pkw = scan_inputs(didx, st, r, ln, dataclasses.replace(cfg, packed_extension=True))
        packed_errs = hits_err(anchor_walk(didx, *pw, **pkw), want)
        ext_errs = []
        # each lane's first anchor interval, and how many of them narrowed to
        # width 1 from a wider one
        R = w.lens2.shape[0]
        S, k, n_sa = w.bf.shape[1], prm["k"], didx.sa.shape[0]
        first = got.q[:, 0].contiguous()
        if kw["paired"]:
            col = torch.where(torch.arange(R, device=dev) >= R // 2, w.lens2 - k - first,
                              first)
            db, de = torch.cat([w.bf, w.br]), torch.cat([w.ef, w.er])
        else:
            col, db, de = first, w.bf, w.ef
        col = col.clamp(0, S - 1)[:, None]
        b0 = torch.gather(db, 1, col)[:, 0].contiguous()
        e0 = torch.gather(de, 1, col)[:, 0].contiguous()
        narrowed = int(((got.n > 0) & (e0 - b0 > 1) & (got.e[:, 0] - got.b[:, 0] == 1)).sum())
        if cuda:
            raw, _, _ = walk_on_0xff(didx, w, **prm, paired=kw["paired"], codes=kw["codes"])
            errs = {f: max(v, hits_err(raw, want)[f]) for f, v in errs.items()}
            # the extension alone: at each lane's first anchor, and on the whole
            # suffix array at random positions
            rpos = torch.from_numpy(rng.integers(0, S, R)).to(dev)
            ract = torch.from_numpy(rng.random(R) < 0.9).to(dev)
            for b_, e_, p_, a_, steps in (
                (b0, e0, first, got.n > 0, prm["ext_steps"]),
                (torch.zeros_like(b0), torch.full_like(e0, n_sa), rpos, ract,
                 n_sa.bit_length() + 1),
            ):
                pl = _extend(didx, kw["codes"], w.lens2, b_, e_, p_, a_, k, steps)
                kn = extend_charwise_kernel(didx, kw["codes"], w.lens2, b_, e_, p_, a_, k,
                                            steps)
                ext_errs.append(max(int((x - y).abs().max()) for x, y in zip(kn, pl)))
        checks.append(walk_set_record(
            name, didx, w, kw, got, errs,
            dict(packed_walk_err=packed_errs, equal_packed=not any(packed_errs.values()),
                 extend_err=ext_errs, extend_equal_plain=not any(ext_errs),
                 first_hits_narrowed_to_width_1=narrowed)))
        max_err = max(max_err, *errs.values(), *packed_errs.values(), *ext_errs)
        if name.endswith("chunk"):
            mains[name] = (didx, w, kw, plain)
    covered = all(c["hits"] > 0 for c in checks) and all(
        c["longest_mmp"] > K + 48 for c in checks if c["read_len"] == 150) and (
        checks[-1]["first_hits_narrowed_to_width_1"] > 0 and checks[-1]["widest_interval"] > 1)
    ok = covered and all(c["equal_plain"] and c["equal_packed"] and c["extend_equal_plain"]
                         for c in checks)
    timing = {name: walk_timing(didx, w, kw, plain, timer, cuda)
              for name, (didx, w, kw, plain) in mains.items()}
    emit("kernel_vs_plain", kernel="anchor_walk_charwise", ok=ok, max_abs_err=max_err,
         covered=covered, checks=checks, timing=timing)
    del rdidx, mains
    return ok, max_err, timing


def score_rows(res, C: int, cap: int):
    """The dense record rows of a fetched single-end WireResult's first C
    reads as the collate's score branch holds them: (cap, 4) int32 rows
    (t, pos, strand, read id), the live rows first, and the live mask."""
    counts = np.asarray(res.counts[:C], np.int64)
    n = int(counts.sum())
    rows = np.zeros((cap, 4), np.int32)
    rows[:n, :3] = res.recs[:n, :3]
    rows[:n, 3] = np.repeat(np.arange(C), counts)
    return rows, np.arange(cap) < n


def score_bound(idx, reads, lens, rows, valid, band: int) -> dict:
    """The least time the card could take to score these rows: the bytes the
    function must move (the live mask of every row, the four fields of each
    live row, each referenced read row, length and txp_align row once, each
    text word that a live window's in-transcript chars lie in once, the
    output once) over the memory rate, against its DP cells (min(len, L) x
    (2b+1) a live row) at 10 integer operations each over the card's 32-bit
    integer rate (INT_OPS_PER_S); the larger is the bound."""
    L = reads.shape[1]
    live = rows[valid]
    rid = np.clip(live[:, 3], 0, len(lens) - 1)
    tl = np.asarray(idx.txp_lens, np.int64)
    t = np.clip(live[:, 0], 0, len(tl) - 1)
    off = np.asarray(idx.txp_offsets, np.int64)[t]
    start = live[:, 1].astype(np.int64) - band
    p_lo = np.maximum(start, 0)
    p_hi = np.minimum(start + L + 2 * band, tl[t]) - 1
    some = p_hi >= p_lo
    w_lo, w_hi = (off + p_lo)[some] >> 4, (off + p_hi)[some] >> 4
    cnt = w_hi - w_lo + 1
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    words = np.unique(np.repeat(w_lo, cnt) + np.arange(int(cnt.sum())) - first)
    n_reads = len(np.unique(rid))
    nbytes = (len(rows) * (1 + 4) + len(live) * 16 + n_reads * (L + 8)
              + len(np.unique(t)) * 12 + 4 * len(words))
    cells = int(np.minimum(np.asarray(lens, np.int64)[rid], L).sum()) * (2 * band + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * cells / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else
                "operations", bytes=nbytes, text_words=len(words), dp_cells=cells,
                live_rows=len(live), rows=len(rows))


def phase_score_kernel(dev, timer, mapper, idx, codes, lens, res0, C: int, seed: int):
    """banded_scores (the kernel of csrc/align.cu) against score_records_plain
    on card tensors, called straight on an output filled with 0xFF bytes (so
    an element the kernel leaves unwritten shows) and through the wrapper,
    on: one smoke chunk's real single-end record rows (the main path's
    first chunk, its cap of rows, the live ones first, read as strided
    columns) at band 7 and at bands 1, 15, 16 and 40, and on either side of
    every change of the kernel's group layout (lanes a record, cells a lane:
    ops/align.py group_layout) up to the first band of the scratch build;
    the same rows in a random order, so that live rows lie anywhere;
    (ma, mp, go, ge) = (1, -3, 4, 4), the go == ge edge; 150 bp reads at their true loci, half
    shifted by up to 3 bases; reads cut from transcript heads and tails
    whose windows hang off them (transcript 0's head and the last tail
    among them); the chunk with 3% of its bases N; paired-end rows over the
    stacked [mate1; mate2] batch (mate 2 the reverse complement of mate 1)
    with has = 0 on either side; the chunk's cap with 95% of its live rows
    dead. Then, on the smoke chunk at band 7: device ms with a warm L2
    (`ms`) and a flushed one (`cold_ms`), CUDA events around the wrapper's
    calls (`wrapper_ms`), the plain version's ms, the device ms of the same
    rows in a random order (`scattered_live_rows_ms`), and the bound
    (score_bound); no single PyTorch call computes it (`library_ms` null)."""
    import dataclasses

    import torch

    from rapmap_tpu_torch.ops.align import (
        REG_BAND_MAX, banded_scores_cuda, group_layout, score_records, score_records_plain,
        stack_pe_rows,
    )

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed + 11)
    cfg = dataclasses.replace(mapper.cfg, mapping_score=True)
    didx = mapper.didx
    cap = cfg.rec_slots * C
    rows, valid = score_rows(res0, C, cap)
    tl = np.asarray(idx.txp_lens, np.int64)
    offs = np.asarray(idx.txp_offsets, np.int64)
    text = np.asarray(idx.text)

    def cut(t, start, n):  # n bases of transcript t from `start`, as read codes
        return text[(offs[t] + start)[:, None] + np.arange(n)[None, :]].astype(np.int8)

    chunk = (codes[:C], lens[:C])
    sets = [("smoke_chunk_band7", cfg, *chunk, rows, valid)]
    edges = {b_ for b in range(2, REG_BAND_MAX + 2) if b > REG_BAND_MAX
             or group_layout(b) != group_layout(b - 1) for b_ in (b - 1, b)}
    for b in sorted((edges | {1, 15, 16, 40}) - {7}):  # band 7 is the first set
        sets.append((f"smoke_chunk_band{b}", dataclasses.replace(cfg, align_band=b), *chunk,
                     rows, valid))
    perm = rng.permutation(cap)
    sets.append(("scattered_live_rows", cfg, *chunk, rows[perm], valid[perm]))
    sets.append(("go_equals_ge", dataclasses.replace(cfg, align_ma=1, align_mp=-3,
                                                     align_go=4, align_ge=4),
                 *chunk, rows, valid))
    n_small = min(C, 4096)
    c150, (t150, p150, s150) = sample_reads(idx, rng, n_small, 150, 0.01)
    shift = rng.integers(-3, 4, n_small)
    shift[::2] = 0
    r150 = np.stack([t150, p150 + shift, s150, np.arange(n_small)], 1).astype(np.int32)
    sets.append(("reads_150bp", cfg, c150, np.full(n_small, 150, np.int32), r150,
                 np.ones(n_small, bool)))
    th = rng.integers(0, len(tl), n_small)
    th[:64], th[64:128] = 0, len(tl) - 1
    tail = np.arange(n_small) % 2 == 1
    seg = np.where(tail, tl[th] - READ_LEN, 0)
    ch = cut(th, seg, READ_LEN)
    sh = rng.integers(1, cfg.align_band + 4, n_small)
    strand = rng.integers(0, 2, n_small)
    ch[strand == 1] = (5 - ch[strand == 1])[:, ::-1]
    rh = np.stack([th, np.where(tail, seg + sh, -sh), strand, np.arange(n_small)],
                  1).astype(np.int32)
    sets.append(("heads_and_tails", cfg, ch, np.full(n_small, READ_LEN, np.int32), rh,
                 np.ones(n_small, bool)))
    cn = codes[:C].copy()
    cn[rng.random(cn.shape) < 0.03] = 5
    sets.append(("reads_with_n", cfg, cn, lens[:C], rows, valid))
    r2 = np.ascontiguousarray((5 - codes[:C])[:, ::-1])
    has1 = (rng.random(cap) < 0.8).astype(np.int32)
    has2 = (rng.random(cap) < 0.8).astype(np.int32)
    pe = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        codes[:C], lens[:C].astype(np.int64), r2, lens[:C].astype(np.int64), rows[:, 3],
        rows[:, 0], rows[:, 1], rows[:, 2], has1, rows[:, 1], 1 - rows[:, 2], has2, valid)]
    pe_stack = stack_pe_rows(*pe)
    sets.append(("pe_rows_has_0", cfg, pe_stack[0], pe_stack[1], None, None))
    dead = valid.copy()
    dead[int(valid.sum()) // 20 :] = False
    sets.append(("mostly_dead_cap", cfg, *chunk, rows, dead))

    checks, max_err, main = [], 0, None
    for name, c, rd, ln, rw, vd in sets:
        if rw is None:  # the stacked paired-end set, on the card already
            args = (rd, ln, *pe_stack[2:])
            host = dict(reads=rd.cpu().numpy(), lens=ln.cpu().numpy(),
                        rows=torch.stack([pe_stack[3], pe_stack[4], pe_stack[5],
                                          pe_stack[2]], 1).cpu().numpy(),
                        valid=pe_stack[6].cpu().numpy())
        else:
            cols = torch.from_numpy(np.ascontiguousarray(rw)).to(dev)  # strided columns
            args = (torch.from_numpy(np.ascontiguousarray(rd)).to(dev),
                    torch.from_numpy(ln.astype(np.int64)).to(dev),
                    cols[:, 3], cols[:, 0], cols[:, 1], cols[:, 2],
                    torch.from_numpy(vd).to(dev))
            host = dict(reads=rd, lens=ln, rows=rw, valid=vd)
        want = score_records_plain(didx, c, *args)
        got = score_records(didx, c, *args)
        err = int((got.long() - want.long()).abs().max())
        if cuda:
            out = torch.full(want.shape, -1, dtype=torch.int32, device=dev)
            raw = banded_scores_cuda(didx, c, *args, out=out)
            torch.cuda.synchronize()
            err = max(err, int((raw.long() - want.long()).abs().max()))
        hv = host["valid"]
        hr = host["rows"][hv]
        start = hr[:, 1].astype(np.int64) - c.align_band
        W = host["reads"].shape[1] + 2 * c.align_band
        w = want.cpu().numpy()
        half = c.align_ma * host["reads"].shape[1] // 2  # half a perfect 76 (150) bp score
        checks.append(dict(
            set=name, rows=len(hv), live_rows=int(hv.sum()), band=c.align_band,
            scoring=[c.align_ma, c.align_mp, c.align_go, c.align_ge],
            read_len=host["reads"].shape[1], scored_above_half=int((w > half).sum()),
            max_score=int(w.max()), dead_rows_zero=bool((w[~hv] == 0).all()),
            off_head=int((start < 0).sum()),
            off_tail=int((start + W > tl[np.clip(hr[:, 0], 0, len(tl) - 1)]).sum()),
            max_abs_err=err, equal_plain=err == 0))
        max_err = max(max_err, err)
        if name == "smoke_chunk_band7":
            main = (c, args, host)
        if name == "scattered_live_rows":
            scattered = (c, args)
    by = {x["set"]: x for x in checks}
    covered = (
        by["smoke_chunk_band7"]["scored_above_half"] > 0.9 * by["smoke_chunk_band7"]["live_rows"]
        and by["reads_150bp"]["max_score"] >= 290
        and by["heads_and_tails"]["off_head"] > 0 and by["heads_and_tails"]["off_tail"] > 0
        and by["heads_and_tails"]["scored_above_half"] > 0.5 * n_small
        and by["pe_rows_has_0"]["live_rows"] < 2 * int(valid.sum())
        and by["smoke_chunk_band%d" % (REG_BAND_MAX + 1)]["band"] > REG_BAND_MAX
        and by["scattered_live_rows"]["live_rows"] == by["smoke_chunk_band7"]["live_rows"]
        and all(x["dead_rows_zero"] and x["scored_above_half"] > 0 for x in checks))
    ok = covered and all(x["equal_plain"] for x in checks)

    c, args, host = main
    run = lambda: score_records(didx, c, *args)  # noqa: E731
    wrapper_ms = timer(run, reps=50)
    ms, ms_by = device_ms(run, 50, cuda)
    cold_event_ms, cold_ms = walk_cold_ms(run, 50, cuda, kernel="banded_")
    plain_ms = timer(lambda: score_records_plain(didx, c, *args), reps=2, warm=1)
    scattered_ms, _ = device_ms(lambda: score_records(didx, scattered[0], *scattered[1]), 50,
                                cuda)
    bound = score_bound(idx, host["reads"], host["lens"], host["rows"], host["valid"],
                        c.align_band)
    if cuda:
        bound.update(share_of_bound=bound["bound_ms"] / ms,
                     share_of_bound_cold=bound["bound_ms"] / cold_ms)
    timing = dict(ms=ms, cold_ms=cold_ms, cold_event_ms=cold_event_ms, wrapper_ms=wrapper_ms,
                  device_ms_by_kernel=ms_by, plain_ms=plain_ms, library_ms=None,
                  scattered_live_rows_ms=scattered_ms, **bound)
    emit("kernel_vs_plain", kernel="banded_scores", ok=ok, max_abs_err=max_err,
         covered=covered, checks=checks, timing=timing)
    return ok, max_err, timing


def cli_score_cfg(idx):
    """The scoring of the command line's default flags (--ma, --mp, --go,
    --ge, --bandwidth)."""
    from rapmap_tpu_torch.cli import _cfg_from_args, build_parser

    args = build_parser().parse_args(["quasimap", "-i", "-", "-r", "-", *SCORE_FLAGS])
    return _cfg_from_args(args, idx.k)


def as_tags_equal_oracle(path: str, idx, reads1, reads2, cfg, n: int, seed: int) -> dict:
    """Recomputes the AS:i tag of n SAM records drawn at random (every
    record with a tag and a mapped position) with the port's numpy oracle,
    oracle.align.score_mapping_np, from the read as it was written (named
    r<i>:... or p<i>:... by write_fastq / write_fastq_pairs; reads2 for the
    second mates) -> {records, checked, unequal}."""
    from rapmap_tpu_torch.oracle.align import score_mapping_np

    recs = []
    with open(path) as f:
        for ln in f:
            if ln[0] == "@":
                continue
            fs = ln.rstrip("\n").split("\t")
            flag = int(fs[1])
            tags = [x for x in fs[11:] if x.startswith("AS:i:")]
            if flag & 0x4 or fs[2] == "*" or not tags:
                continue
            recs.append((int(fs[0].split(":")[0][1:]), flag, int(fs[2][1:]), int(fs[3]) - 1,
                         int(tags[0][5:])))
    pick = np.random.default_rng(seed).choice(len(recs), size=min(n, len(recs)), replace=False)
    unequal = 0
    for j in pick:
        i, flag, t, pos, score = recs[j]
        read = (reads2 if flag & 0x80 else reads1)[i]
        want = score_mapping_np(idx, read, t, pos, 1 if flag & 0x10 else 0, cfg.align_band,
                                cfg.align_ma, cfg.align_mp, cfg.align_go, cfg.align_ge)
        unequal += want != score
    return dict(records=len(recs), checked=len(pick), unequal=int(unequal))


def library_scores_equal_oracle(res, idx, reads1, reads2, cfg, n: int, seed: int) -> int:
    """Recomputes n record scores of a fetched scored WireResult (SE field 3;
    PE fields 7 and 8 of the mates present) with the numpy oracle -> how many
    differ."""
    from rapmap_tpu_torch.oracle.align import score_mapping_np

    rid = np.repeat(np.arange(len(res.counts)), res.counts)
    pick = np.random.default_rng(seed).choice(len(rid), size=min(n, len(rid)), replace=False)
    unequal = 0
    for j in pick:
        r, i = res.recs[j], rid[j]
        mates = ([(reads1[i], r[1], r[2], r[3])] if reads2 is None else
                 [(reads1[i], r[1], r[2], r[7]), (reads2[i], r[4], r[5], r[8])])
        present = [True] if reads2 is None else [r[3] != 0, r[6] != 0]
        for (read, pos, strand, score), has in zip(mates, present):
            want = score_mapping_np(idx, read, int(r[0]), int(pos), int(strand),
                                    cfg.align_band, cfg.align_ma, cfg.align_mp, cfg.align_go,
                                    cfg.align_ge) if has else 0
            unequal += want != score
    return int(unequal)


def library_path(m, codes, lens, B: int, batches: int, cuda: bool):
    """`batches` batches of B reads through m.map_se_async / m.fetch, one
    batch in flight, ending in a synchronize -> (results, seconds)."""
    import torch

    results = []
    t0 = time.time()
    pending = m.map_se_async(codes[:B], lens[:B])
    for b in range(1, batches + 1):
        nxt = (m.map_se_async(codes[b * B : (b + 1) * B], lens[b * B : (b + 1) * B])
               if b < batches else None)
        results.append(m.fetch(pending))
        pending = nxt
    if cuda:
        torch.cuda.synchronize()
    return results, time.time() - t0


def same_result(a, b) -> bool:
    """Two fetched WireResults are equal: records, counts, flags, totals and
    counters."""
    return (np.array_equal(a.recs, b.recs) and np.array_equal(a.counts, b.counts)
            and np.array_equal(a.flags, b.flags) and a.total == b.total
            and a.overflowed == b.overflowed and a.counters == b.counters)


def true_locus_share(res, truth, lo: int, hi: int) -> float:
    """Share of reads [lo, hi) with a record at their sampled
    (transcript, position, strand)."""
    t, pos, strand = (a[lo:hi] for a in truth)
    rid = np.repeat(np.arange(hi - lo), res.counts)
    rec = res.recs[: len(rid)]
    m = (rec[:, 0] == t[rid]) & (rec[:, 1] == pos[rid]) & (rec[:, 2] == strand[rid])
    return float(np.bincount(rid[m], minlength=hi - lo).astype(bool).mean())


def pair_shares(res, truth, lo: int, hi: int) -> tuple[float, float]:
    """(share of pairs [lo, hi) with a concordant record, share with a
    concordant record at their true transcript and both true positions)."""
    t, p1, p2, _ = (a[lo:hi] for a in truth)
    rid = np.repeat(np.arange(hi - lo), res.counts)
    rec = res.recs[: len(rid)]
    conc = (rec[:, 3] == 1) & (rec[:, 6] == 1)
    true = conc & (rec[:, 0] == t[rid]) & (rec[:, 1] == p1[rid]) & (rec[:, 4] == p2[rid])
    per = np.bincount(rid[conc], minlength=hi - lo).astype(bool)
    per_true = np.bincount(rid[true], minlength=hi - lo).astype(bool)
    return float(per.mean()), float(per_true.mean())


def profile_pe_batch(mapper, c1, c2, lens, C: int, cuda: bool) -> dict:
    """Where one paired-end batch's time goes: the device's busy share, its
    launches per chunk and top kernels (torch.profiler), and for one chunk
    the synchronized host time of the two mates' scans, of their two collate
    cores, and of the direct pair merge around them (`collate_records_pe`
    less the cores: `pairs_ms`), with the device time and launches of each
    (`*_device`)."""
    import torch

    from rapmap_tpu_torch.ops.collate import _collate_core
    from rapmap_tpu_torch.ops.mmp import scan_dispatch
    from rapmap_tpu_torch.ops.pairs import collate_records_pe
    from rapmap_tpu_torch.ops.wire import rec_spec_pe

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    batch = profile_one_batch(lambda: mapper.fetch(mapper.map_pe_async(c1, lens, c2, lens)),
                              max(1, len(c1) // C), cuda, 10)
    dev, cfg, didx, st = mapper.device, mapper.cfg, mapper.didx, mapper.st
    a, b = (torch.from_numpy(x[:C]).to(dev) for x in (c1, c2))
    ln = torch.from_numpy(lens[:C].astype(np.int64)).to(dev)
    spec = rec_spec_pe(st, cfg)
    capc = cfg.rec_slots * C

    def scans():
        return scan_dispatch(didx, st, a, ln, cfg), scan_dispatch(didx, st, b, ln, cfg)

    h1, h2 = scans()

    def cores():
        _collate_core(didx, st, h1, ln, cfg)
        _collate_core(didx, st, h2, ln, cfg)

    def merge():
        collate_records_pe(didx, st, h1, ln, h2, ln, cfg, capc, rec_spec=spec)

    stage = {}
    for _ in range(2):  # second pass is the one kept (warm)
        for name, fn in (("scan_ms", scans), ("cores_ms", cores), ("collate_pe_ms", merge)):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            stage[name] = (time.perf_counter() - t0) * 1e3
    stage["pairs_ms"] = stage["collate_pe_ms"] - stage["cores_ms"]
    device = {}
    if cuda:
        for name, fn in (("scan", scans), ("cores", cores), ("collate_pe", merge)):
            got = device_kernels(fn)
            device[name] = dict(ms=sum(v[0] for v in got.values()),
                                launches=sum(v[1] for v in got.values()))
        device["pairs"] = {k: device["collate_pe"][k] - device["cores"][k] for k in ("ms", "launches")}
    return dict(batch_pairs=len(c1), **batch, chunk_stages=stage,
                chunk_device=device or "not measured")


def probe_fn(mapper, r, ln):
    """The dense phase's k-mer probe alone, on the keys it probes: one
    canonical-CHD probe per forward window, or, without the canonical CHD,
    kmer_lookup (binary search) over every window of the [fwd; revcomp]
    lanes -> a function that runs it."""
    from rapmap_tpu_torch.ops import encode as denc
    from rapmap_tpu_torch.ops.extend_packed import pack_reads
    from rapmap_tpu_torch.ops.lookup import kmer_lookup, kmer_lookup_2str
    from rapmap_tpu_torch.ops.mmp import lane_codes

    st = mapper.st
    rows = r if st.chd_canonical else lane_codes(r, ln)
    L = rows.shape[1]
    hi, lo, _ = denc.kmer_keys_from_packed(pack_reads(rows), denc.next_bad_batch(rows, L),
                                           st.k, L - st.k + 1)
    fn = kmer_lookup_2str if st.chd_canonical else kmer_lookup
    return lambda: fn(mapper.didx, st, hi, lo)


def scan_kernels(mapper, r, ln, cuda: bool) -> dict:
    """The device kernels of one program's scan (dense phase, then anchor
    walk) by name, under torch.profiler, those of its k-mer probe alone, and
    those of the anchor tables that the dense phase no longer builds
    (`anchor_tables`, `next_anchor_table`, which only the plain walks run),
    on the same inputs: what left the main path."""
    if not cuda:
        return dict(scan="not measured", lookup="not measured", anchor_tables="not measured")
    import torch

    from rapmap_tpu_torch.ops.mmp import anchor_tables, anchor_walk, next_anchor_table, scan_inputs

    def run(fn):
        fn()  # warm: the allocator and the kernels' libraries
        torch.cuda.synchronize()
        by_name = sorted(device_kernels(fn).items(), key=lambda kv: -kv[1][0])
        return dict(device_ms=sum(v[0] for _, v in by_name),
                    launches=sum(v[1] for _, v in by_name),
                    kernels=[dict(name=n, ms=v[0], count=v[1]) for n, v in by_name])

    def scan():
        w, kw = scan_inputs(mapper.didx, mapper.st, r, ln, mapper.cfg)
        anchor_walk(mapper.didx, *w, **kw)

    w, kw = scan_inputs(mapper.didx, mapper.st, r, ln, mapper.cfg)
    tables = ((lambda: anchor_tables(*w[4:])) if kw["paired"]
              else (lambda: next_anchor_table(w.anch_f)))
    return dict(scan=run(scan), lookup=run(probe_fn(mapper, r, ln)),
                anchor_tables=run(tables))


def profile_one_batch(run, n_programs: int, cuda: bool, top_n: int) -> dict:
    """One batch, run() mapping and fetching it, under torch.profiler: its
    wall clock (ending in a synchronize), the device's busy time and idle
    share, its launches (a program's share too), its top kernels and the
    hand kernels among them."""
    import torch

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wall = []

    def batch():
        t0 = time.perf_counter()
        run()
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)

    sync()
    if cuda:
        by_name = device_kernels(batch)
    else:
        batch()
        by_name = {}
    busy_ms = sum(v[0] for v in by_name.values())
    kern = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    own = [(n, v) for n, v in by_name.items() if any(f"::{k}" in n for k in HAND_KERNELS)]
    return dict(
        batch_wall_ms=wall[0],
        device_busy_ms=busy_ms if kern else "not measured",
        device_idle_share=1.0 - busy_ms / wall[0] if kern else "not measured",
        programs=n_programs, kernel_launches=kern, launches_per_chunk=kern / n_programs,
        top_kernels=[dict(name=n, ms=v[0], count=v[1]) for n, v in top],
        hand_kernels=[dict(name=n, ms=v[0], count=v[1]) for n, v in own],
    )


def profile_batch(mapper, codes, lens, C: int, cuda: bool) -> dict:
    """Where one batch's time goes: the device's busy share and its top
    kernels (torch.profiler), the device kernels of one program's scan and
    of its k-mer probe by name, and the synchronized host time of one
    chunk's scan (dense phase, then anchor walk), of its probe alone
    (`lookup_ms`, part of `dense_ms`, timed on its own) and collate stages,
    and of the wire's host halves for
    the batch. A batch below two chunks runs as one program over the whole
    batch, as the command line's default batches do."""
    import torch

    from rapmap_tpu_torch.ops.collate import collate_batch, collate_records_se
    from rapmap_tpu_torch.ops.compact import compact_se
    from rapmap_tpu_torch.ops.mmp import anchor_walk, scan_inputs
    from rapmap_tpu_torch.ops.wire import pack_in_se, rec_spec_se

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    batch = profile_one_batch(lambda: mapper.fetch(mapper.map_se_async(codes, lens)),
                              max(1, len(codes) // C), cuda, 8)
    dev = mapper.device
    chunked = bool(mapper._chunk_of(len(codes)))
    r = torch.from_numpy(codes[:C]).to(dev)
    ln = torch.from_numpy(lens[:C].astype(np.int64)).to(dev)
    scan_device = scan_kernels(mapper, r, ln, cuda)
    probe = probe_fn(mapper, r, ln)
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
        probe()
        sync()
        lookup_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        w, kw = scan_inputs(mapper.didx, mapper.st, r, ln, mapper.cfg)
        sync()
        tw = time.perf_counter()
        hits = anchor_walk(mapper.didx, *w, **kw)
        sync()
        t1 = time.perf_counter()
        if chunked:
            collate_records_se(mapper.didx, mapper.st, hits, ln, mapper.cfg,
                               mapper.cfg.rec_slots * C, rec_spec=spec)
        else:
            compact_se(collate_batch(mapper.didx, mapper.st, hits, ln, mapper.cfg),
                       mapper.cfg.rec_slots * len(ln))
        sync()
        stage = dict(scan_ms=(t1 - t0) * 1e3, dense_ms=(tw - t0) * 1e3, lookup_ms=lookup_ms,
                     walk_ms=(t1 - tw) * 1e3, collate_ms=(time.perf_counter() - t1) * 1e3)
    return dict(**batch, scan_device=scan_device, chunk_stages=stage, wire_host=wire)

# ---- pseudo-mapping ---------------------------------------------------------

def dense_pseudo(didx, st, cfg, codes, lens, paired: bool, dev):
    """The pseudo dense phase of a batch on the card: strand-paired lanes
    (canonical CHD) or the explicit [fwd; revcomp] lanes -> PseudoWalkInputs."""
    import torch

    from rapmap_tpu_torch.models.pseudo import pseudo_dense_lanes, pseudo_dense_paired
    from rapmap_tpu_torch.ops import encode as denc

    r = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    ln = torch.from_numpy(lens.astype(np.int64)).to(dev)
    if st.chd_canonical != paired:
        raise RuntimeError("the index's CHD does not give the lane kind asked for")
    if paired:
        return pseudo_dense_paired(didx, st, r, ln, cfg)
    lanes = torch.cat([r, denc.revcomp_batch(r, ln)])
    return pseudo_dense_lanes(didx, st, lanes, torch.cat([ln, ln]), cfg)


def pseudo_walk_on_0xff(w, k: int, H: int, paired: bool, count: bool = False):
    """csrc/walk.cu's pseudo entries called straight (tqm_pseudo_walk, or
    with count the counting build tqm_pseudo_walk_traffic), on outputs that
    start as 0xFF bytes, as walk_on_0xff -> (ScanHits, {input: distinct
    sectors read} or None, trips or None). Only this script calls them."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.ops.mmp import ScanHits

    R, S = w.lens2.shape[0], w.bf.shape[1]
    dev = w.lens2.device
    buf = torch.full((R, H, 4), -1, dtype=torch.int64, device=dev)
    n = torch.full((R,), -1, dtype=torch.int64, device=dev)
    trunc = torch.full((R,), 0xFF, dtype=torch.uint8, device=dev)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    argtypes = [vp] * 7 + [i64, i64] + [i32] * 3 + [vp] * 3
    args = [*(t.data_ptr() for t in w), R, R // 2 if paired else R, S, k, H,
            buf.data_ptr(), n.data_ptr(), trunc.data_ptr()]
    lib = kernels.library("walk")
    if count:
        words = [((t.numel() * t.element_size() + 31) // 32 + 1 + 31) // 32 for t in w]
        off = np.concatenate([[0], np.cumsum(words)]).astype(np.int64)
        bits = torch.zeros(int(off[-1]), dtype=torch.int32, device=dev)
        rows = torch.zeros(1, dtype=torch.int64, device=dev)
        fn = lib.tqm_pseudo_walk_traffic
        argtypes += [vp, ctypes.POINTER(i64), vp]
        args += [bits.data_ptr(), (i64 * len(words))(*off[:-1].tolist()), rows.data_ptr()]
    else:
        fn = lib.tqm_pseudo_walk
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [vp]
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    torch.cuda.synchronize(dev)
    hits = ScanHits(q=buf[..., 0], l=buf[..., 1], b=buf[..., 2], e=buf[..., 3],
                    n=n, truncated=trunc)
    if not count:
        return hits, None, None
    marks = bits.cpu().numpy().view(np.uint8)
    sectors = {nm: int(np.unpackbits(marks[4 * off[g] : 4 * off[g + 1]]).sum())
               for g, nm in enumerate(w._fields)}
    return hits, sectors, int(rows.cpu()[0])


def pseudo_walk_timing(w, k: int, H: int, paired: bool, timer, cuda: bool) -> dict:
    """The pseudo walk's launch at a main-path shape, as walk_timing: device
    ms warm and cold, wrapper_ms, the plain version's ms, and the byte bound
    from the counting build (every 32-byte input sector the walk uses, once,
    plus the outputs once; 16 integer operations a trip for the operations
    bound); no single PyTorch call computes it (library_ms null)."""
    from rapmap_tpu_torch.ops.mmp import pseudo_walk, pseudo_walk_lanes_plain, pseudo_walk_plain

    run = lambda: pseudo_walk(*w, k=k, H=H, paired=paired)  # noqa: E731
    plain = pseudo_walk_plain if paired else pseudo_walk_lanes_plain
    wrapper_ms = timer(run, reps=50)
    ms, ms_by = device_ms(run, 50, cuda)
    cold_event_ms, cold_ms = walk_cold_ms(run, 50, cuda)
    plain_ms = timer(lambda: plain(*w, k=k, H=H), reps=2, warm=1)
    hits = run()
    out_bytes = sum(t.numel() * t.element_size() for t in hits)
    if cuda:
        counted, sectors, trips = pseudo_walk_on_0xff(w, k, H, paired, count=True)
        if any(hits_err(counted, hits).values()):
            raise RuntimeError("the counting build of the pseudo walk disagrees with the kernel")
        nbytes = 32 * sum(sectors.values()) + out_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 16 * trips / INT_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound = dict(bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes=nbytes, output_bytes=out_bytes, input_sectors_read=sectors,
                     trips=trips, share_of_bound=bound_ms / ms,
                     share_of_bound_cold=bound_ms / cold_ms)
    else:
        bound = dict(bound_ms="not measured", bound_by="bytes")
    return dict(lanes=w.lens2.shape[0], ms=ms, cold_ms=cold_ms, cold_event_ms=cold_event_ms,
                wrapper_ms=wrapper_ms, device_ms_by_kernel=ms_by, plain_ms=plain_ms,
                library_ms=None, **bound)


def phase_pseudo_walk_kernel(dev, timer, pmap, npmap, work: str, codes, lens, C: int,
                             seed: int):
    """pseudo_walk (the walk kernel's pseudo build) against pseudo_walk_plain
    on strand-paired lanes (the canonical-CHD index) and against
    pseudo_walk_lanes_plain on explicit lanes (the index without its CHD),
    all six ScanHits fields, through the wrapper and through the entry on
    outputs that start as 0xFF bytes, on: the smoke chunk (16,384 lanes, 76
    columns, H = 16), Ns and mixed lengths with empty rows and rows shorter
    than k, and the repetitive world's pseudo index at 1, 2 and 16 hit slots
    and with max_interval 4, which its shared k-mers exceed; then the timing
    and bound of each lane kind on the chunk."""
    import dataclasses

    import torch

    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.index.builder import build_pseudo_index
    from rapmap_tpu_torch.index.format import load_index
    from rapmap_tpu_torch.models.pseudo import upload_pseudo_index
    from rapmap_tpu_torch.ops.mmp import pseudo_walk, pseudo_walk_lanes_plain, pseudo_walk_plain

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed + 11)
    c2 = codes[C : 2 * C].copy()
    c2[rng.random(c2.shape) < 0.02] = 5
    l2 = rng.integers(20, READ_LEN + 1, C).astype(np.int32)
    l2[::7], l2[1::7], l2[2::7], l2[3::7] = K, K - 3, READ_LEN, 0
    c2[np.arange(READ_LEN)[None, :] >= l2[:, None]] = 5
    rpidx = build_pseudo_index(os.path.join(work, "repetitive.fa"), k=K)
    n_rep = max(min(C, 4096), 512)
    c4, _ = sample_reads(load_index(os.path.join(work, "repetitive_idx")), rng, n_rep, 120, 0.02)
    l4 = np.full(n_rep, 120, np.int32)
    checks, max_err, main = [], 0, {}
    for paired in (True, False):
        base = pmap if paired else npmap
        rep = upload_pseudo_index(rpidx if paired else without_chd(rpidx), dev)
        sets = [
            ("chunk", base.didx, base.st, base.cfg, codes[:C], lens[:C]),
            ("ns_mixed_lengths", base.didx, base.st, base.cfg, c2, l2),
            ("repetitive_1_slot", *rep, MapConfig(k=K, max_hits_per_strand=1), c4, l4),
            ("repetitive_2_slots", *rep, MapConfig(k=K, max_hits_per_strand=2), c4, l4),
            ("repetitive_16_slots", *rep, MapConfig(k=K), c4, l4),
            ("repetitive_max_interval_4", *rep, MapConfig(k=K, max_interval=4), c4, l4),
        ]
        for name, didx, st, cfg, cds, lns in sets:
            w = dense_pseudo(didx, st, cfg, cds, lns, paired, dev)
            H = cfg.max_hits_per_strand
            want = (pseudo_walk_plain if paired else pseudo_walk_lanes_plain)(*w, k=K, H=H)
            got = pseudo_walk(*w, k=K, H=H, paired=paired)
            errs = hits_err(got, want)
            if cuda:
                raw, _, _ = pseudo_walk_on_0xff(w, K, H, paired)
                errs = {f: max(v, hits_err(raw, want)[f]) for f, v in errs.items()}
            hit = torch.arange(H, device=got.q.device)[None, :] < got.n[:, None]
            wide = dense_pseudo(didx, st, dataclasses.replace(cfg, max_interval=1000), cds, lns,
                                paired, dev)
            checks.append(dict(
                set=name, paired=paired, lanes=w.lens2.shape[0], columns=w.bf.shape[1],
                hit_slots=H, hits=int(got.n.sum()), truncated_lanes=int(got.truncated.sum()),
                widest_interval=int(torch.where(hit, got.e - got.b, 0).max()),
                anchors_over_max_interval=int((wide.anch_f & ~w.anch_f).sum() + (
                    (wide.anch_rF & ~w.anch_rF).sum() if paired else 0)),
                empty_rows=int((w.lens2 == 0).sum()), rows_below_k=int((w.lens2 < K).sum()),
                field_err=errs, equal_plain=not any(errs.values())))
            max_err = max(max_err, *errs.values())
            if name == "chunk":
                main[paired] = w
        del rep
    by = {(c["set"], c["paired"]): c for c in checks}
    covered = all(
        by[("chunk", p)]["lanes"] == 2 * C and by[("ns_mixed_lengths", p)]["empty_rows"] > 0
        and by[("ns_mixed_lengths", p)]["rows_below_k"] > by[("ns_mixed_lengths", p)]["empty_rows"]
        and by[("repetitive_1_slot", p)]["truncated_lanes"] > 0
        and by[("repetitive_2_slots", p)]["truncated_lanes"] > 0
        and by[("repetitive_16_slots", p)]["widest_interval"] > 4
        and by[("repetitive_max_interval_4", p)]["anchors_over_max_interval"] > 0
        and by[("repetitive_max_interval_4", p)]["widest_interval"] <= 4
        for p in (True, False))
    ok = covered and all(c["equal_plain"] for c in checks)
    timing = {("paired" if p else "lanes"): pseudo_walk_timing(main[p], K, 16, p, timer, cuda)
              for p in (True, False)}
    emit("kernel_vs_plain", kernel="pseudo_walk", ok=ok, max_abs_err=max_err, covered=covered,
         checks=checks, timing=timing)
    return ok, max_err, timing


def pseudo_oracle_unequal(results, idx, c1, c2, lens1, lens2, cfg, B: int, n: int,
                          seed: int) -> dict:
    """n reads (pairs) drawn at random from the library path's fetched
    batches of B, each batch's records split by its counts, against the
    port's numpy pseudo oracle (oracle.pseudomap.map_read / map_pair): SE
    rows (t, pos, strand, score); PE rows (t, pos and strand of each mate
    present). Reads flagged FLAG_DEGRADED (the host fallback's to remap) are
    counted apart -> {checked, unequal, degraded}."""
    from rapmap_tpu_torch.oracle import pseudomap as opm
    from rapmap_tpu_torch.ops.wire import FLAG_DEGRADED

    starts = [np.concatenate([[0], np.cumsum(r.counts)]) for r in results]
    pick = np.random.default_rng(seed).choice(B * len(results), size=n, replace=False)
    unequal = degraded = 0
    for g in pick:
        res, i = results[g // B], g % B
        if res.flags[i] & FLAG_DEGRADED:
            degraded += 1
            continue
        rows = res.recs[starts[g // B][i] : starts[g // B][i + 1]]
        if c2 is None:
            got = [tuple(int(x) for x in r[:4]) for r in rows]
            want = [(m.txp, m.pos, 0 if m.fwd else 1, m.score)
                    for m in opm.map_read(idx, c1[g][: lens1[g]], cfg)]
        else:
            got = [(int(r[0]), (int(r[1]), int(r[2])) if r[3] else None,
                    (int(r[4]), int(r[5])) if r[6] else None) for r in rows]
            ms, _ = opm.map_pair(idx, c1[g][: lens1[g]], c2[g][: lens2[g]], cfg)
            want = [(m.txp, (m.pos1, 0 if m.fwd1 else 1) if m.pos1 is not None else None,
                     (m.pos2, 0 if m.fwd2 else 1) if m.pos2 is not None else None) for m in ms]
        unequal += got != want
    return dict(checked=n - degraded, unequal=int(unequal), degraded=degraded)



# ---- the host-staged engine ---------------------------------------------------

STAGED_SHARDS = 8
ANCHOR_INPUTS = ("preads", "next_bad", "lens", "col_off", "lane", "b0", "e0", "pos", "active",
                 "sa_cmp", "text2q")


def staged_anchor_inputs(sm, didx, codes, lens, A: int):
    """What stage A hands the anchor-parallel extension for one shard and one
    batch, compacted into A slots (ops as parallel/staged.py stage_a) ->
    dict(preads, next_bad, lens, b0, e0, pos, active, lane) and the shard's
    anchor count."""
    import torch

    from rapmap_tpu_torch.parallel import staged as stg

    dev = didx.sa_cmp.device
    lanes = np.concatenate([codes, stg._rc_lanes(codes, lens)])
    lt = torch.from_numpy(np.ascontiguousarray(lanes, np.int8)).to(dev)
    l2 = torch.from_numpy(np.concatenate([lens, lens]).astype(np.int64)).to(dev)
    R, L = lt.shape
    S = L - sm._st.k + 1
    preads, next_bad, live, src, db, de, n = stg._dense_anchors(didx, sm._st, sm.cfg, lt, l2, A)
    srcc = src.clamp(0, R * S - 1)
    return dict(preads=preads, next_bad=next_bad, lens=l2,
                b0=torch.where(live, db[srcc], 0), e0=torch.where(live, de[srcc], 0),
                pos=torch.where(live, src % S, 0), active=live,
                lane=torch.where(live, src // S, R).clamp(0, R - 1)), int(n)


def extend_anchors_on_0xff(didx, a: dict, k: int, steps: int, count: bool = False):
    """csrc/walk.cu's tqm_extend_packed_lanes called straight, on outputs that
    start as 0xFF bytes (a byte the kernel leaves unwritten shows in the
    comparison), or with count its counting build tqm_extend_packed_traffic
    -> ((b, e, mlen), {input: distinct 32-byte sectors read} or None,
    sa_cmp rows compared or None). Only this script calls them."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.ops.extend_packed import ext_words

    R, L = a["preads"].shape
    A = a["lane"].shape[0]
    dev = a["preads"].device
    outs = [torch.full((A,), -1, dtype=torch.int64, device=dev) for _ in range(3)]
    act = a["active"].view(torch.uint8)
    tensors = [a["preads"], a["next_bad"], a["lens"], None, a["lane"], a["b0"], a["e0"],
               a["pos"], act, didx.sa_cmp, didx.text2q]
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    argtypes = [vp] * 10 + [i64, i32, vp, i64, i64, i64] + [i32] * 4 + [vp] * 3
    args = [*(None if t is None else t.data_ptr() for t in tensors[:10]),
            didx.sa_cmp.shape[0], didx.sa_cmp.shape[1] - 3, didx.text2q.data_ptr(),
            didx.text2q.shape[0], A, R, L, k, steps, ext_words(L, k),
            *(o.data_ptr() for o in outs)]
    lib = kernels.library("walk")
    if count:
        sizes = [0 if t is None else t.numel() * t.element_size() for t in tensors]
        words = [((n + 31) // 32 + 1 + 31) // 32 for n in sizes]
        off = np.concatenate([[0], np.cumsum(words)]).astype(np.int64)
        bits = torch.zeros(int(off[-1]), dtype=torch.int32, device=dev)
        rows = torch.zeros(1, dtype=torch.int64, device=dev)
        fn = lib.tqm_extend_packed_traffic
        argtypes += [vp, ctypes.POINTER(i64), vp]
        args += [bits.data_ptr(), (i64 * len(words))(*off[:-1].tolist()), rows.data_ptr()]
    else:
        fn = lib.tqm_extend_packed_lanes
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [vp]
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    torch.cuda.synchronize(dev)
    if not count:
        return tuple(outs), None, None
    marks = bits.cpu().numpy().view(np.uint8)
    sectors = {nm: int(np.unpackbits(marks[4 * off[g] : 4 * off[g + 1]]).sum())
               for g, nm in enumerate(ANCHOR_INPUTS) if tensors[g] is not None}
    return tuple(outs), sectors, int(rows.cpu()[0])


def phase_anchor_kernel(dev, timer, idx, codes, lens, B: int, seed: int):
    """extend_anchors (csrc/walk.cu tqm_extend_packed_lanes, the host-staged
    engine's anchor-parallel extension) against its plain version
    extend_packed(..., lane=) on card tensors, through the wrapper and through
    the entry on 0xFF-filled outputs, on shard 0 of the staged path's 8 of
    the world: the compacted anchors of one 32,768-read batch at the budget
    A_max and at the full width A_full (dead tails), the same with Ns and
    mixed lengths, anchors that outnumber the rows 2 to 1 on repeated random
    lanes over the whole shard (searches of ~log2(n) trips, some dead); then
    its timing and bound at the staged path's shape (A_max)."""
    import torch

    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.ops.extend_packed import extend_anchors, extend_packed
    from rapmap_tpu_torch.parallel.staged import StagedQuasiMapper

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed + 30)
    sq = StagedQuasiMapper(idx, MapConfig(k=K), batch=B, read_len=READ_LEN,
                           n_shards=STAGED_SHARDS, device=dev)
    sm = sq.sm
    didx_np, s0 = sm._shard_arrays(0)
    didx = sm._upload(didx_np)
    k, steps = K, max(1, int(np.ceil(np.log2(min(sm.cfg.max_interval,
                                                  sm._st.max_interval_idx) + 1))) + 1)
    c2 = codes[B : 2 * B].copy()
    c2[rng.random(c2.shape) < 0.02] = 5
    l2 = rng.integers(20, READ_LEN + 1, B).astype(np.int32)
    l2[::7], l2[1::7] = K, K - 3
    c2[np.arange(READ_LEN)[None, :] >= l2[:, None]] = 5
    sets = []
    for name, cds, lns, A in (("shard_batch_A_max", codes[:B], lens[:B], sm.A_max),
                              ("shard_batch_A_full", codes[:B], lens[:B], sm.A_full),
                              ("ns_mixed_lengths", c2, l2, sm.A_max)):
        a, n = staged_anchor_inputs(sm, didx, cds, lns, A)
        sets.append((name, a, n, steps))
    # anchors that outnumber the rows 2 to 1, lanes repeated at random, whole
    # shard intervals: searches of ~log2(n) trips; 10% dead
    a = dict(sets[0][1])
    R = a["preads"].shape[0]
    n_sa = int(sm.geo.slot_cuts[1] - sm.geo.slot_cuts[0])
    A = 2 * R
    a.update(lane=torch.from_numpy(rng.integers(0, R, A)).to(dev),
             pos=torch.from_numpy(rng.integers(0, READ_LEN - K + 1, A)).to(dev),
             b0=torch.zeros(A, dtype=torch.int64, device=dev),
             e0=torch.full((A,), n_sa, dtype=torch.int64, device=dev),
             active=torch.from_numpy(rng.random(A) < 0.9).to(dev))
    sets.append(("repeated_lanes_whole_shard", a, A, n_sa.bit_length() + 1))

    def diff(x, y):
        return int((x - y).abs().max()) if x.numel() else 0

    checks, max_err = [], 0
    for name, a, n, st_ in sets:
        args = [a[f] for f in ("preads", "next_bad", "lens", "b0", "e0", "pos", "active")]
        want = extend_packed(didx, *args, k, st_, READ_LEN, lane=a["lane"])
        got = extend_anchors(didx, *args, a["lane"], k=k, ext_steps=st_)
        errs = [diff(g, w) for g, w in zip(got, want)]
        if cuda:
            raw, _, _ = extend_anchors_on_0xff(didx, a, k, st_)
            errs = [max(e, diff(g, w)) for e, g, w in zip(errs, raw, want)]
        live = a["active"]
        checks.append(dict(
            set=name, anchors=int(a["lane"].shape[0]), live=int(live.sum()), rows=R,
            anchors_over_rows=n / R, steps=st_, field_err=dict(zip(("b", "e", "mlen"), errs)),
            extended=int((want[2] > k).sum()),
            widest_result=int(torch.where(live, want[1] - want[0], 0).max()),
            equal_plain=not any(errs)))
        max_err = max(max_err, *errs)
    by = {c["set"]: c for c in checks}
    covered = (by["shard_batch_A_max"]["anchors_over_rows"] > 1
               and by["shard_batch_A_full"]["anchors"] > by["shard_batch_A_max"]["anchors"]
               and by["repeated_lanes_whole_shard"]["extended"] > 0
               and by["ns_mixed_lengths"]["live"] > 0)
    ok = covered and all(c["equal_plain"] for c in checks)

    # timing and bound at the staged path's shape: A_max anchors of a batch
    _, a, n, _ = sets[0]
    args = [a[f] for f in ("preads", "next_bad", "lens", "b0", "e0", "pos", "active")]
    run = lambda: extend_anchors(didx, *args, a["lane"], k=k, ext_steps=steps)  # noqa: E731
    wrapper_ms = timer(run, reps=50)
    ms, ms_by = device_ms(run, 50, cuda)
    cold_event_ms, cold_ms = walk_cold_ms(run, 50, cuda, kernel="extend_packed_kernel")
    plain_ms = timer(lambda: extend_packed(didx, *args, k, steps, READ_LEN, lane=a["lane"]),
                     reps=2, warm=1)
    out_bytes = 3 * 8 * a["lane"].shape[0]
    if cuda:
        counted, sectors, rows = extend_anchors_on_0xff(didx, a, k, steps, count=True)
        if any(diff(g, w) for g, w in zip(counted, run())):
            raise RuntimeError("the counting build of the extension disagrees with the kernel")
        nbytes = 32 * sum(sectors.values()) + out_bytes
        ops = 32 * rows  # index arithmetic and one masked word compare a row, at least
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound = dict(bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
                     bytes=nbytes, output_bytes=out_bytes, input_sectors_read=sectors,
                     sa_cmp_rows=rows, share_of_bound=bound_ms / ms,
                     share_of_bound_cold=bound_ms / cold_ms)
    else:
        bound = dict(bound_ms="not measured", bound_by="bytes")
    timing = dict(anchors=int(a["lane"].shape[0]), live=n, rows=R, shard_slots=n_sa, ms=ms,
                  cold_ms=cold_ms, cold_event_ms=cold_event_ms, wrapper_ms=wrapper_ms,
                  device_ms_by_kernel=ms_by, plain_ms=plain_ms, library_ms=None, **bound)
    emit("kernel_vs_plain", kernel="extend_packed_anchors", ok=ok, max_abs_err=max_err,
         covered=covered, A_max=sm.A_max, A_full=sm.A_full, checks=checks, timing=timing)
    del didx
    if cuda:
        torch.cuda.empty_cache()
    return ok, max_err, timing


SHARDED_INPUTS = WALK_INPUTS + ("slot_base",)
SHARDS = 4  # n_idx of the sharded phases: the world's index in 4 shards on one card


def sharded_walk_on_0xff(stack, w, k: int, H: int, ext_steps: int, paired: bool,
                         count: bool = False):
    """csrc/walk.cu's tqm_sharded_walk called straight, on outputs that start
    as 0xFF bytes (a byte the kernel leaves unwritten shows in the
    comparison with the plain version), or with count its counting build
    tqm_sharded_walk_traffic -> (ScanHits, {input: distinct 32-byte sectors
    read} or None, sa_cmp rows compared or None). Only this script calls
    them."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.ops.mmp import ScanHits
    from rapmap_tpu_torch.parallel.sharded import sharded_walk_args

    R = w.preads.shape[0]
    dev = w.lens2.device
    buf = torch.full((R, H, 4), -1, dtype=torch.int64, device=dev)
    n = torch.full((R,), -1, dtype=torch.int64, device=dev)
    trunc = torch.full((R,), 0xFF, dtype=torch.uint8, device=dev)
    tensors = [*w, stack.sa_cmp, stack.text2q, stack.slot_base]
    argtypes, args = sharded_walk_args(stack, w, (buf, n, trunc), k=k, H=H,
                                       ext_steps=ext_steps, paired=paired)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib = kernels.library("walk")
    if count:
        words = [((t.numel() * t.element_size() + 31) // 32 + 1 + 31) // 32 for t in tensors]
        off = np.concatenate([[0], np.cumsum(words)]).astype(np.int64)
        bits = torch.zeros(int(off[-1]), dtype=torch.int32, device=dev)
        rows = torch.zeros(1, dtype=torch.int64, device=dev)
        fn = lib.tqm_sharded_walk_traffic
        argtypes += [vp, ctypes.POINTER(i64), vp]
        args += [bits.data_ptr(), (i64 * len(words))(*off[:-1].tolist()), rows.data_ptr()]
    else:
        fn = lib.tqm_sharded_walk
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [vp]
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    torch.cuda.synchronize(dev)
    hits = ScanHits(q=buf[..., 0], l=buf[..., 1], b=buf[..., 2], e=buf[..., 3],
                    n=n, truncated=trunc)
    if not count:
        return hits, None, None
    marks = bits.cpu().numpy().view(np.uint8)
    sectors = {nm: int(np.unpackbits(marks[4 * off[g] : 4 * off[g + 1]]).sum())
               for g, nm in enumerate(SHARDED_INPUTS)}
    return hits, sectors, int(rows.cpu()[0])


def sharded_world(idx, dev, slot64: bool = False, canonical: bool = True):
    """The world's index cut into SHARDS shards (host arrays, seconds to cut)
    and stacked on `dev` -> (arrays, EngineStatic, ShardStack, seconds)."""
    from rapmap_tpu_torch.parallel import sharded

    t0 = time.time()
    arrays, st = sharded.shard_quasi_index(idx, SHARDS, slot64=slot64, canonical=canonical)
    cut_s = time.time() - t0
    (stack,) = sharded.upload_sharded(arrays, [[dev] * SHARDS])
    return arrays, st, stack, cut_s


def owner_gap(stack, p: int):
    """The stack with shard p's true slot count set to 0, so that no shard
    owns an anchor in p's slot range: the walk must then record (0, 0, 0)
    and step one column, as the reference's psum of nothing does."""
    import torch

    base = stack.slot_base.clone()
    base[p, 1] = 0
    bases = tuple((b, 0 if i == p else n) for i, (b, n) in enumerate(stack.bases))
    return stack._replace(slot_base=base, bases=bases)


def one_shard_stack(didx):
    """The replicated upload as a one-shard ShardStack, no copy: shard 0 at
    global offset 0 holding every slot, so K8 over it walks the packed walk's
    rows at the same slots and must give the packed walk's hits on the same
    walk inputs."""
    import torch

    from rapmap_tpu_torch.parallel.sharded import ShardStack

    n = didx.sa_cmp.shape[0]
    dev = didx.sa_cmp.device
    none = torch.zeros((1, 0, 4), dtype=torch.int32, device=dev)  # no probe tables: walk only
    return ShardStack(
        text2q=didx.text2q, sa_cmp=didx.sa_cmp[None], sa_meta=didx.sa_meta[None],
        kmer_rows=none, lut_rows=none[..., :2],
        slot_base=torch.tensor([[0, n]], dtype=torch.int64 if n >= 2**31 else torch.int32,
                               device=dev),
        chd_dir=None, chd_rows=None, txp_align=didx.txp_align, bases=((0, n),))


def shard_edge_reads(idx, stack, fill_codes, fill_lens, C: int):
    """C reads whose first k-mer's SA interval begins at chosen global
    slots of the stack: each shard's first and last owned k-mer interval
    and, for each short shard (true count < S_pad) but the last, the first
    two and the last k-mer starts in its padding range (the next shard's
    slots); each read is the text from that slot's suffix, up to READ_LEN
    bases or the transcript's end; the rest of the chunk is fill_codes ->
    (codes (C, READ_LEN) int8, lens (C,), {"first", "last", "padding":
    target slots}, each shard's last owned slot less its last target)."""
    kb = np.unique(np.asarray(idx.kmer_b, dtype=np.int64))
    sa = np.asarray(idx.sa, dtype=np.int64)
    text = np.asarray(idx.text)
    s_pad = stack.sa_cmp.shape[1]
    targets = {"first": [], "last": [], "padding": []}
    last_gap = []
    for p, (base, n) in enumerate(stack.bases):
        lo, hi = np.searchsorted(kb, [base, base + n])
        targets["first"].append(int(kb[lo]))
        targets["last"].append(int(kb[hi - 1]))
        last_gap.append(base + n - 1 - int(kb[hi - 1]))
        if n < s_pad and p + 1 < len(stack.bases):
            plo, phi = np.searchsorted(kb, [base + n, base + s_pad])
            targets["padding"] += sorted({int(kb[i]) for i in (plo, plo + 1, phi - 1)
                                          if plo <= i < phi})
    codes = np.ascontiguousarray(fill_codes[:C]).copy()
    lens = np.asarray(fill_lens[:C], dtype=np.int32).copy()
    for i, t in enumerate(t for v in targets.values() for t in v):
        win = text[sa[t] : sa[t] + READ_LEN]
        bad = np.flatnonzero((win < 1) | (win > 4))
        ln = int(bad[0]) if len(bad) else len(win)
        codes[i] = 5
        codes[i, :ln] = win[:ln]
        lens[i] = ln
    return codes, lens, targets, last_gap


def shifted(arrays, B0: int):
    """slot64 arrays with every global carrier moved up by B0 (slot_base col
    0 and the class rows' intervals): the genome-geometry rehearsal of the
    reference's tests, global slots past 2^31 through the whole path."""
    sb = arrays.slot_base.copy()
    sb[:, 0] += B0
    rows = arrays.chd_rows.copy()
    real = rows[..., 0] != -1
    for c in range(2, 6):
        rows[..., c] = np.where(real, rows[..., c] + B0, rows[..., c])
    return arrays._replace(slot_base=sb, chd_rows=rows)


def sharded_bound(stack, w, kw, hits) -> dict:
    """K8's byte bound on one launch, from its counting build (every 32-byte
    input sector the walk uses, once, the shard table included, plus the
    outputs written once), with the operations it must at least do."""
    counted, sectors, rows = sharded_walk_on_0xff(stack, w, **kw, count=True)
    if any(hits_err(counted, hits).values()):
        raise RuntimeError("the counting build of the sharded walk disagrees with the kernel")
    out_bytes = sum(t.numel() * t.element_size() for t in hits)
    nbytes = 32 * sum(sectors.values()) + out_bytes
    ops = 32 * rows  # index arithmetic and one masked word compare a row, at least
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes,
                output_bytes=out_bytes, input_sectors_read=sectors, sa_cmp_rows=rows)


def phase_sharded_kernel(dev, timer, idx, mapper, codes, lens, C: int, B: int, seed: int):
    """sharded_walk (csrc/walk.cu tqm_sharded_walk, the sharded engine's
    walk) against its plain version sharded_walk_plain on card tensors,
    through the wrapper and through the entry on 0xFF-filled outputs: one
    data row's program of phase_sharded (B / 2 reads) and one chunk of C
    reads on the canonical-class shards (strand-paired lanes) and on
    per-strand CHD shards (explicit lanes), the chunk with Ns and mixed
    lengths, the paired chunk with shard 1's slots owned by no shard, under
    slot64 with every global slot moved past 2^31, over a one-shard stack
    of the mapper's replicated upload (whose hits must also equal the packed
    walk's on the same inputs), and a chunk whose anchors begin at each
    shard's first and last owned k-mer interval and inside the short
    shards' padding; then its timing and bound on each lane kind's data-row
    program, the shape of most of its launches on the sharded paths, beside
    K8 over the one-shard stack and the packed walk on that row."""
    import torch

    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.ops import mmp
    from rapmap_tpu_torch.parallel.sharded import (
        scan_inputs, sharded_walk, sharded_walk_plain, upload_sharded,
    )

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed + 40)
    cfg = MapConfig(k=K)
    arr_c, st_c, stack_c, cut_s = sharded_world(idx, dev)
    arr_l, st_l, stack_l, _ = sharded_world(idx, dev, canonical=False)
    arr_64, st_64, _, _ = sharded_world(idx, "cpu", slot64=True)
    (stack_64,) = upload_sharded(shifted(arr_64, 2**31 + 12345), [[dev] * SHARDS])
    stack_1 = one_shard_stack(mapper.didx)
    c2 = codes[C : 2 * C].copy()
    c2[rng.random(c2.shape) < 0.02] = 5
    l2 = rng.integers(20, READ_LEN + 1, C).astype(np.int32)
    l2[::7], l2[1::7] = K, K - 3
    c2[np.arange(READ_LEN)[None, :] >= l2[:, None]] = 5
    c3, l3, edges, last_gap = shard_edge_reads(idx, stack_c, codes[2 * C :], lens[2 * C :], C)

    def batch(c, ln):
        return (torch.from_numpy(np.ascontiguousarray(c)).to(dev),
                torch.from_numpy(ln.astype(np.int64)).to(dev))

    def replicated(r, ln):  # the packed walk's inputs and arguments (strand-paired)
        w, kw = mmp.scan_inputs(mapper.didx, mapper.st, r, ln, cfg)
        return w, {x: kw[x] for x in ("k", "H", "ext_steps", "paired")}

    chunk, mixed = batch(codes[:C], lens[:C]), batch(c2, l2)
    row = batch(codes[: B // 2], lens[: B // 2])
    sets = [("paired_row", stack_c, st_c, row), ("lanes_row", stack_l, st_l, row),
            ("paired_chunk", stack_c, st_c, chunk), ("lanes_chunk", stack_l, st_l, chunk),
            ("paired_ns_mixed_lengths", stack_c, st_c, mixed),
            ("lanes_ns_mixed_lengths", stack_l, st_l, mixed),
            ("paired_no_owner", owner_gap(stack_c, 1), st_c, chunk),
            ("paired_slot64_past_2pow31", stack_64, st_c, chunk),
            ("paired_one_shard", stack_1, None, chunk),
            ("paired_shard_edges", stack_c, st_c, batch(c3, l3))]
    checks, max_err, inputs = [], 0, {}
    for name, stack, st, (r, ln) in sets:
        w, kw = scan_inputs(stack, st, r, ln, cfg) if st is not None else replicated(r, ln)
        want = sharded_walk_plain(stack, *w, **kw)
        got = sharded_walk(stack, w, **kw)
        errs = hits_err(got, want)
        if cuda:
            raw, _, _ = sharded_walk_on_0xff(stack, w, **kw)
            errs = {f: max(errs[f], v) for f, v in hits_err(raw, want).items()}
        hit = torch.arange(want.q.shape[1], device=dev)[None, :] < want.n[:, None]
        unowned = hit & (want.l == 0)
        extra = {}
        if name == "paired_one_shard":  # global slots are local ones: the packed walk's hits
            packed = mmp.anchor_walk(mapper.didx, *w, **kw)
            extra["equal_packed_walk"] = not any(hits_err(packed, want).values())
        if name == "paired_shard_edges":  # anchors at the edges, from the dense phase's output
            at = lambda t: int(((w.bf[:, 0] == t) & w.anch_f[:, 0]).sum())  # noqa: E731
            extra.update(edge_targets=edges, last_owned_slot_minus_last_target=last_gap,
                         edge_anchors={c: [at(t) for t in v] for c, v in edges.items()})
        if cuda and name in ("paired_chunk", "lanes_chunk"):
            extra["bound"] = sharded_bound(stack, w, kw, got)
        checks.append(dict(
            set=name, lanes=w.lens2.shape[0], paired=kw["paired"], shards=len(stack.bases),
            slot64=stack.slot64, hits=int(want.n.sum()),
            truncated_lanes=int(want.truncated.sum()), unowned_hits=int(unowned.sum()),
            extended=int((want.l > K).sum()), largest_slot=int(torch.where(hit, want.e, 0).max()),
            field_err=errs, equal_plain=not any(errs.values()), **extra))
        max_err = max(max_err, *errs.values())
        inputs[name] = (stack, w, kw)
    by = {c["set"]: c for c in checks}
    edge_counts = [n for v in by["paired_shard_edges"]["edge_anchors"].values() for n in v]
    covered = (by["paired_no_owner"]["unowned_hits"] > 0
               and by["paired_chunk"]["unowned_hits"] == 0
               and by["paired_slot64_past_2pow31"]["largest_slot"] > 2**31
               and by["lanes_ns_mixed_lengths"]["hits"] > 0
               and by["paired_one_shard"]["equal_packed_walk"]
               and len(edges["padding"]) > 0 and min(edge_counts) > 0
               and all(c["extended"] > 0 for c in checks))
    ok = covered and all(c["equal_plain"] for c in checks)

    timing = {}
    for kind in ("paired_row", "lanes_row"):
        stack, w, kw = inputs[kind]
        run = lambda: sharded_walk(stack, w, **kw)  # noqa: E731
        wrapper_ms = timer(run, reps=50)
        ms, ms_by = device_ms(run, 50, cuda)
        cold_event_ms, cold_ms = walk_cold_ms(run, 50, cuda)
        plain_ms = timer(lambda: sharded_walk_plain(stack, *w, **kw), reps=2, warm=1)
        if cuda:
            bound = sharded_bound(stack, w, kw, run())
            bound.update(share_of_bound=bound["bound_ms"] / ms,
                         share_of_bound_cold=bound["bound_ms"] / cold_ms)
        else:
            bound = dict(bound_ms="not measured", bound_by="bytes")
        timing[kind] = dict(lanes=w.lens2.shape[0], shards=SHARDS, ms=ms, cold_ms=cold_ms,
                            cold_event_ms=cold_event_ms, wrapper_ms=wrapper_ms,
                            device_ms_by_kernel=ms_by, plain_ms=plain_ms, library_ms=None,
                            **bound)
    # the yardsticks on the same row: K8 over one shard, and the packed walk
    w, kw = replicated(*row)
    yard = {}
    for what, run in (("one_shard", lambda: sharded_walk(stack_1, w, **kw)),
                      ("packed_walk", lambda: mmp.anchor_walk(mapper.didx, *w, **kw))):
        ms, _ = device_ms(run, 50, cuda)
        _, cold_ms = walk_cold_ms(run, 50, cuda)
        yard[what] = dict(ms=ms, cold_ms=cold_ms)
    if cuda:
        p4, one = timing["paired_row"], yard["one_shard"]["ms"]
        yard.update(lanes=w.lens2.shape[0], paired_row_over_one_shard=p4["ms"] / one,
                    paired_row_over_packed_walk=p4["ms"] / yard["packed_walk"]["ms"],
                    one_shard_share_of_paired_row_bound=p4["bound_ms"] / one)
    timing["row_yardsticks"] = yard
    emit("kernel_vs_plain", kernel="sharded_walk", ok=ok, max_abs_err=max_err,
         covered=covered, shard_cut_s=cut_s, shard_slots=[n for _, n in stack_c.bases],
         checks=checks, timing=timing)
    del inputs, stack_64, stack_1
    if cuda:
        torch.cuda.empty_cache()
    return ok, max_err, timing, dict(paired=(st_c, stack_c, arr_c), lanes=(st_l, stack_l, arr_l),
                                     slot64=(st_64, arr_64))


TRIP_SECTORS = ("preads", "next_bad", "lens2", "col_off2", "b0", "e0", "pos", "act", "sa_cmp",
                "text2q")


def trip_on_0xff(didx, base: int, n_local: int, lanes, k: int, steps: int, count: bool = False):
    """csrc/walk.cu's tqm_sharded_trip called straight, on outputs that start
    as 0xFF bytes, or with count its counting build tqm_sharded_trip_traffic
    -> ((b, e, mlen), {input: distinct 32-byte sectors read} or None, sa_cmp
    rows compared or None). Only this script calls them."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.parallel.sharded import sharded_trip_args

    dev = lanes[0].device
    out = tuple(torch.full(lanes[2].shape, -1, dtype=torch.int64, device=dev) for _ in range(3))
    argtypes, args = sharded_trip_args(didx, base, n_local, lanes, out, k=k, ext_steps=steps)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib = kernels.library("walk")
    if count:
        tensors = [*lanes, didx.sa_cmp, didx.text2q]
        words = [((t.numel() * t.element_size() + 31) // 32 + 1 + 31) // 32 for t in tensors]
        off = np.concatenate([[0], np.cumsum(words)]).astype(np.int64)
        bits = torch.zeros(int(off[-1]), dtype=torch.int32, device=dev)
        rows = torch.zeros(1, dtype=torch.int64, device=dev)
        fn = lib.tqm_sharded_trip_traffic
        argtypes += [vp, ctypes.POINTER(i64), vp]
        args += [bits.data_ptr(), (i64 * len(words))(*off[:-1].tolist()), rows.data_ptr()]
    else:
        fn = lib.tqm_sharded_trip
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [vp]
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    torch.cuda.synchronize(dev)
    if not count:
        return out, None, None
    marks = bits.cpu().numpy().view(np.uint8)
    sectors = {nm: int(np.unpackbits(marks[4 * off[g] : 4 * off[g + 1]]).sum())
               for g, nm in enumerate(TRIP_SECTORS)}
    return out, sectors, int(rows.cpu()[0])


def trip_bound(didx, base: int, n_local: int, lanes, k: int, steps: int, got) -> dict:
    """K10's bound on one launch, from its counting build: every 32-byte
    input sector the trip uses, once, plus the three (R,) outputs written
    once; the operations at 32 a compared sa_cmp row."""
    counted, sectors, rows = trip_on_0xff(didx, base, n_local, lanes, k, steps, count=True)
    if not all(bool((a == b).all()) for a, b in zip(counted, got)):
        raise RuntimeError("the counting build of the sharded trip disagrees with the kernel")
    out_bytes = sum(t.numel() * t.element_size() for t in got)
    nbytes = 32 * sum(sectors.values()) + out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 32 * rows / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes,
                output_bytes=out_bytes, input_sectors_read=sectors, sa_cmp_rows=rows)


def advance_on_0xff(t, k: int, H: int):
    """csrc/walk.cu's tqm_sharded_advance called straight in its begin mode,
    on a state whose every byte starts as 0xFF -> the WalkState it wrote.
    Only this script calls it."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.ops.mmp import WalkState
    from rapmap_tpu_torch.parallel.sharded import sharded_advance_args

    dev, R = t.lens2.device, t.lens2.shape[0]

    def ff(*shape, dt=torch.int64):
        return torch.full(shape, -1, dtype=dt, device=dev) if dt != torch.bool else \
            torch.full(shape, 0xFF, dtype=torch.uint8, device=dev).view(torch.bool)

    s = WalkState(pos=ff(R), n=ff(R), trunc=ff(R, dt=torch.bool), buf=ff(R, H, 4),
                  act=ff(R, dt=torch.bool), posc=ff(R), b0=ff(R), e0=ff(R))
    argtypes, args = sharded_advance_args(t, s, None, k=k)
    fn = kernels.library("walk").tqm_sharded_advance
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tqm_sharded_advance launch failed: CUDA error {rc}")
    torch.cuda.synchronize(dev)
    return s


def state_clone(s):
    return None if s is None else type(s)(*(x.clone() for x in s))


def state_err(a, b) -> dict:
    """Largest absolute difference of each WalkState field (bools as 0/1)."""
    import torch

    return {f: int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
            for f, x, y in zip(a._fields, a, b)}


def sectors_bytes(index, elem: int) -> int:
    """32 bytes for each distinct 32-byte sector that the elements at the
    flat `index` of a tensor of `elem`-byte elements fall in."""
    import torch

    return 32 * int(torch.unique(index.reshape(-1) * elem // 32).numel())


def advance_bound(t, s, terms, k: int, H: int) -> dict:
    """K11's bound on one launch, from what this state needs. The begin:
    lens2, is_rc and one sector of anc2, db2 and de2 a lane read, the
    whole state written (the hit buffer's zeros included). A trip: every
    lane's act byte, then on its active lanes the sectors of their P
    terms, posc, n, lens2, is_rc and the table entries read, and of their
    hit slot (or trunc), n, pos, act, posc, b0 and e0 written. Operations
    at 3P + 32 integer operations an active lane."""
    import torch

    from rapmap_tpu_torch.ops.mmp import walk_advance, walk_begin

    R, S = t.db2.shape
    lane = torch.arange(R, device=t.lens2.device)
    rows = lane * S

    def cols(p):  # the table column of lane-local position p, clamped
        return torch.where(t.is_rc, t.lens2 - k - p, p).clamp(0, S - 1)

    if terms is None:
        p0 = torch.zeros_like(t.lens2)
        nbytes = 9 * R + sectors_bytes(rows + cols(p0), 8)
        s1 = walk_begin(t, k=k, H=H)
        nbytes += 2 * sectors_bytes(rows + cols(s1.posc), 8)
        nbytes += R * (5 * 8 + 2) + s1.buf.numel() * 8
        lanes = R
        P = 0
    else:
        P = terms.shape[0]
        a = lane[s.act]
        lanes = int(a.numel())
        b1, e1, mlen = terms.sum(0)
        nxt = s.posc + (mlen - k + 1).clamp(min=1)
        nbytes = R + sum(sectors_bytes(q * 3 * R + i * R + a, 8) for q in range(P)
                         for i in range(3))
        nbytes += 3 * sectors_bytes(a, 8) + sectors_bytes(a, 1)
        nbytes += sectors_bytes(a * S + cols(nxt)[a], 8)
        s1 = walk_advance(t, state_clone(s), b1, e1, mlen, k=k, H=H)
        nbytes += 2 * sectors_bytes(a * S + cols(s1.posc)[a], 8)
        written = lane[s.act & (s.n < H)]
        over = lane[s.act & (s.n >= H)]
        nbytes += 32 * int(written.numel()) + sectors_bytes(written, 8)
        nbytes += sectors_bytes(over, 1)
        nbytes += 4 * sectors_bytes(a, 8) + sectors_bytes(a, 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * P + 32) * lanes / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes,
                active_lanes=lanes)


def named_kernel_ms(work, reps: int, key: str, cuda: bool) -> float | str:
    """Device ms of one launch of the kernels whose name holds `key` in
    work() (reps launches, other kernels in it left out), under
    torch.profiler; a window that recorded under half the launches runs
    again, three times at most, then the CUDA events around work(),
    everything in it, with a `profiler_fallback` line."""
    if not cuda:
        return "not measured"
    import torch

    work()
    torch.cuda.synchronize()
    for _ in range(3):
        by_name = device_kernels(work)
        hit = [v for n, v in by_name.items() if key in n]
        if sum(v[1] for v in hit) >= reps // 2:
            return sum(v[0] for v in hit) / sum(v[1] for v in hit)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    work()
    b.record()
    b.synchronize()
    emit("profiler_fallback", helper="named_kernel_ms", kernel=key, used="cuda_events",
         ms=a.elapsed_time(b) / reps)
    return a.elapsed_time(b) / reps


def trip_loop_ops(sset, w, kw, cuda: bool) -> dict:
    """The device work of one split walk (sharded_walk over a ShardSet), in
    start order under torch.profiler: K10's and K11's launches, the other
    ops by name, and those that start after K11's first launch (the walk's
    begin), which must be none: no op runs inside a trip. The window runs
    the walk twice with a marker kernel (torch.cuda._sleep) between them
    and reads the second (a profiler session can lose its first device
    events); a window that still missed any of the second walk's K10 or K11
    launches runs again, three times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rapmap_tpu_torch.parallel import sharded

    if not cuda:
        return dict(measured=False)
    H = kw["H"]
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sharded.sharded_walk(sset, w, **kw)
            torch.cuda._sleep(1000)
            sharded.sharded_walk(sset, w, **kw)
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.name[:80]) for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        marks = [i for i, (_, n) in enumerate(events) if "spin_kernel" in n]
        events = events[marks[-1] + 1:] if marks else []
        k10 = [t for t, n in events if "sharded_trip_kernel" in n]
        k11 = [t for t, n in events if "sharded_advance_kernel" in n]
        if len(k10) == SHARDS * (H + 1) and len(k11) == H + 2:
            break
    else:
        emit("profiler_fallback", helper="trip_loop_ops", used="none",
             seen=dict(sharded_trip=len(k10), sharded_advance=len(k11)))
        return dict(measured=False)
    other = [(t, n) for t, n in events
             if "sharded_trip_kernel" not in n and "sharded_advance_kernel" not in n]
    by_name: dict[str, int] = {}
    for _, n in other:
        by_name[n] = by_name.get(n, 0) + 1
    inside = sorted({n for t, n in other if t > k11[0]})
    return dict(measured=True, trips=H + 1, sharded_trip=len(k10), sharded_advance=len(k11),
                other_ops=len(other), other_by_name=by_name, ops_inside_trips=inside,
                none_inside_a_trip=not inside)


def phase_trip_kernel(dev, timer, worlds: dict, codes, lens, B: int):
    """The split path's two kernels against their plain versions on card
    tensors: the world's canonical-class cut uploaded shard by shard on
    `dev` (split_idx=True), one data row's program of the split path (B / 2
    reads) walked through the trip loop (its hits equal to K8's over the
    stack on the same inputs), and the trip inputs and states recorded.
    sharded_trip (csrc/walk.cu tqm_sharded_trip, K10, one shard's trip)
    against sharded_trip_plain at the program's first trip, its second
    (trip 1) and its first trip with no active lane, on each of the SHARDS
    shards, through the wrapper and through the entry on 0xFF-filled
    outputs. sharded_advance (tqm_sharded_advance, K11, the trip's home
    half) against sharded_advance_plain in its begin mode (wrapper, and the
    entry on a 0xFF-filled state), after the first trip, after it with
    every fourth active lane's hit slots full (overflow), and at the empty
    trip, on clones of the same state. Each set is timed (device ms warm
    and cold, the wrapper's CUDA events) beside its bound and the plain
    version; and the split walk's device work by kernel shows no op
    between K10 and K11 launches -> (ok, max error, timing)."""
    import torch

    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.parallel import sharded

    cuda = dev.type == "cuda"
    st, stack, arr = worlds["paired"]
    (sset,) = sharded.upload_sharded(arr, [[dev] * SHARDS], split_idx=True)
    r, ln = to_dev(dev, codes[: B // 2], lens[: B // 2])
    w, kw = sharded.scan_inputs(sset, st, r, ln, MapConfig(k=K))
    saved = []  # (trip, shard, the shard's index, base, count, its lane inputs)
    states = []  # (the state before the advance or None, its terms or None)
    tables = []

    def recorder(didx, base, n_local, *lanes, k, ext_steps, out=None):
        trip, p = divmod(len(saved), SHARDS)
        # the program's lane inputs are the same tensors every trip
        saved.append((trip, p, didx, base, n_local, lanes[:4] + tuple(t.clone()
                                                                     for t in lanes[4:])))
        return sharded.sharded_trip(didx, base, n_local, *lanes, k=k, ext_steps=ext_steps,
                                    out=out)

    def advancer(t, s, terms, k, H):
        tables[:] = [t]
        states.append((state_clone(s), None if terms is None else terms.clone()))
        return sharded.sharded_advance(t, s, terms, k=k, H=H)

    hits = sharded.trip_loop(sset, w, recorder, advancer, **kw)
    k8 = sharded.sharded_walk(stack, w, **kw)
    loop_equal_k8 = not any(hits_err(hits, k8).values())
    k, steps, H = kw["k"], kw["ext_steps"], kw["H"]
    t = tables[0]
    active = [int(x[5][7].sum()) for x in saved[::SHARDS]]
    empty = active.index(0) if 0 in active else None
    trips = (0, 1, empty)
    saved = [x for x in saved if x[0] in trips]
    checks, timing, max_err = [], [], 0
    for trip, p, didx, base, n_local, lanes in saved:
        want = sharded.sharded_trip_plain(didx, base, n_local, *lanes, k=k, ext_steps=steps)
        got = sharded.sharded_trip(didx, base, n_local, *lanes, k=k, ext_steps=steps)
        errs = [int((a - b).abs().max()) for a, b in zip(got, want)]
        if cuda:
            raw, _, _ = trip_on_0xff(didx, base, n_local, lanes, k, steps)
            errs = [max(e, int((a - b).abs().max())) for e, a, b in zip(errs, raw, want)]
        act, b0 = lanes[7], lanes[4]
        owned = act & (b0 - base >= 0) & (b0 - base < n_local)
        checks.append(dict(trip=trip, shard=p, lanes=int(act.shape[0]), active=int(act.sum()),
                           owned=int(owned.sum()), extended=int((want[2] > k).sum()),
                           field_err=dict(zip(("b", "e", "mlen"), errs)),
                           equal_plain=not any(errs)))
        max_err = max(max_err, *errs)
        run = lambda: sharded.sharded_trip(didx, base, n_local, *lanes, k=k,  # noqa: E731
                                           ext_steps=steps)
        wrapper_ms = timer(run, reps=30)
        ms, _ = device_ms(run, 30, cuda)
        cold_event_ms, cold_ms = walk_cold_ms(run, 20, cuda, kernel="sharded_trip_kernel")
        plain_ms = timer(lambda: sharded.sharded_trip_plain(didx, base, n_local, *lanes, k=k,
                                                            ext_steps=steps), reps=2, warm=1)
        if cuda:
            bound = trip_bound(didx, base, n_local, lanes, k, steps, run())
            bound.update(share_of_bound=bound["bound_ms"] / ms,
                         share_of_bound_cold=bound["bound_ms"] / cold_ms)
        else:
            bound = dict(bound_ms="not measured", bound_by="bytes")
        timing.append(dict(trip=trip, shard=p, ms=ms, cold_ms=cold_ms,
                           cold_event_ms=cold_event_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                           library_ms=None, **bound))

    def mean_of(trip):
        rows = [x for x in timing if x["trip"] == trip]
        m = {x: (sum(r[x] for r in rows) / len(rows) if cuda else "not measured")
             for x in ("ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms")}
        m.update(bound_by=rows[0]["bound_by"], library_ms=None)
        return m

    covered = (empty is not None and len(checks) == 3 * SHARDS
               and all(c["owned"] > 0 and c["extended"] > 0 for c in checks[:SHARDS])
               and all(c["active"] > 0 for c in checks[SHARDS:2 * SHARDS])
               and all(c["active"] == 0 for c in checks[2 * SHARDS:]) and loop_equal_k8)
    k10_ok = covered and all(c["equal_plain"] for c in checks)
    means = {name: mean_of(trip) for name, trip in (("first", 0), ("trip1", 1), ("empty", empty))
             if trip is not None}
    emit("kernel_vs_plain", kernel="sharded_trip", ok=k10_ok, max_abs_err=max_err,
         covered=covered, lanes=int(w.lens2.shape[0]), trips=trips, active_lanes_by_trip=active,
         trip_loop_equals_k8=loop_equal_k8, checks=checks, timing=timing,
         mean_per_launch=means)

    # K11: the begin, the first trip's advance (natural and with overflowing
    # lanes) and the empty trip's, each on clones of the recorded state
    s0, terms0 = states[1]
    over = state_clone(s0)
    full = torch.nonzero(over.act).flatten()[::4]
    over.n[full] = H
    sets = {"begin": (None, None), "first_trip": (s0, terms0), "first_trip_overflow":
            (over, terms0), "empty_trip": states[1 + empty] if empty is not None else (None, None)}
    a_checks, a_timing, a_err = [], [], 0
    for name, (s_in, terms) in sets.items():
        want = sharded.sharded_advance_plain(t, state_clone(s_in), terms, k=k, H=H)
        got = sharded.sharded_advance(t, state_clone(s_in), terms, k=k, H=H)
        errs = state_err(got, want)
        if cuda and s_in is None:
            raw = advance_on_0xff(t, k, H)
            errs = {f: max(e, v) for (f, e), v in zip(errs.items(),
                                                       state_err(raw, want).values())}
        a_err = max(a_err, *errs.values())
        act = s_in.act if s_in is not None else want.act
        a_checks.append(dict(
            set=name, active=int(act.sum()),
            overflowing=0 if s_in is None else int((s_in.act & (s_in.n >= H)).sum()),
            hits_written=int((want.n.sum() - (0 if s_in is None else s_in.n.sum()))),
            field_err=errs, equal_plain=not any(errs.values())))
        work_s = state_clone(s_in)

        def restore(src=s_in, dst=work_s):
            # what steers the kernel (the hit buffer is only written), so
            # that a timed launch finds the tables where the walk leaves them
            if src is not None:
                for f, a, b in zip(src._fields, dst, src):
                    if f != "buf":
                        a.copy_(b)

        def call(dst=work_s, terms=terms):
            return sharded.sharded_advance(t, dst, terms, k=k, H=H)

        def warm_work(n=30):
            for _ in range(n):
                restore()
                call()

        ms = named_kernel_ms(warm_work, 30, "sharded_advance_kernel", cuda)
        if cuda:
            flush = torch.empty(1 << 28, dtype=torch.int32, device=dev)

            def cold_work(n=20):
                for _ in range(n):
                    restore()
                    flush.fill_(1)
                    call()

            cold_ms = named_kernel_ms(cold_work, 20, "sharded_advance_kernel", cuda)
            del flush
            torch.cuda.empty_cache()
        else:
            cold_ms = "not measured"
        restore()
        wrapper_ms = timer(call, reps=30)  # the walk runs on from the state, as a program does
        plain_ms = timer(lambda: sharded.sharded_advance_plain(t, state_clone(s_in), terms, k=k,
                                                               H=H), reps=2, warm=1)
        bound = advance_bound(t, s_in, terms, k, H)
        if cuda:
            bound.update(share_of_bound=bound["bound_ms"] / ms,
                         share_of_bound_cold=bound["bound_ms"] / cold_ms)
        a_timing.append(dict(set=name, ms=ms, cold_ms=cold_ms, wrapper_ms=wrapper_ms,
                             plain_ms=plain_ms, library_ms=None, **bound))
    a_covered = (empty is not None and a_checks[1]["active"] > 0
                 and a_checks[2]["overflowing"] > 0 and a_checks[3]["active"] == 0)
    k11_ok = a_covered and all(c["equal_plain"] for c in a_checks)
    ops = trip_loop_ops(sset, w, kw, cuda)
    emit("kernel_vs_plain", kernel="sharded_advance", ok=k11_ok, max_abs_err=a_err,
         covered=a_covered, lanes=int(w.lens2.shape[0]), shards=SHARDS, checks=a_checks,
         timing=a_timing, split_walk_device_ops=ops)
    if cuda and ops["measured"] and not ops["none_inside_a_trip"]:
        raise RuntimeError(f"the split walk runs device work inside its trips: {ops}")
    del saved, states, tables, sset
    if cuda:
        torch.cuda.empty_cache()
    by_set = {x["set"]: x for x in a_timing}
    return (k10_ok and k11_ok, max(max_err, a_err),
            dict(k10=means, k11=by_set, k10_err=max_err, k11_err=a_err, k10_ok=k10_ok,
                 k11_ok=k11_ok))


def to_dev(dev, *arrays):
    """numpy read codes and lengths -> card tensors (int8 codes, int64 lengths)."""
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int8 if a.ndim == 2 else np.int64))
                 .to(dev) for a in arrays)


def tuples_equal(a, b) -> bool:
    """Two NamedTuples of tensors are equal, field for field."""
    import torch

    return all(x.shape == y.shape and bool(torch.equal(x.to(torch.int64), y.to(torch.int64)))
               for x, y in zip(a, b))


def counters_of(ctr) -> dict:
    return {f: int(v) for f, v in ctr._asdict().items()}


def timed(fn, cuda: bool):
    """fn() with the launch counts zeroed before it and read after, ending in
    a synchronize -> (result, seconds, launches)."""
    import torch

    from rapmap_tpu_torch import kernels

    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.time() - t0, dict(kernels.LAUNCHES)


def phase_dp(dev, mapper, codes, lens, pc1, pc2, plens, B: int, cuda: bool) -> dict:
    """Data parallel on one card (parallel/dp.py): two replicas on the same
    device over B reads (dp_path) and B pairs (dp_pe_path), each equal to
    the single-device program on the same batch, MapOut, PairOut and
    counters alike -> {phase: launches}."""
    import torch

    from rapmap_tpu_torch.models.quasi import map_batch_pe, map_batch_se
    from rapmap_tpu_torch.parallel import dp

    mesh = dp.make_mesh(2, devices=[dev, dev])
    nv = dp.split_valid(B, 2, B // 2)
    nv_all = torch.tensor(B, device=dev)
    r, ln = to_dev(dev, codes[:B], lens[:B])
    p1, p2, pl = to_dev(dev, pc1[:B], pc2[:B], plens[:B])
    out = {}
    for phase, single, parallel in (
            ("dp_path", lambda: map_batch_se(mapper.didx, mapper.st, r, ln, nv_all, mapper.cfg),
             lambda: dp.map_batch_se_dp(mapper.didx, mapper.st, r, ln, nv, mapper.cfg, mesh)),
            ("dp_pe_path",
             lambda: map_batch_pe(mapper.didx, mapper.st, p1, pl, p2, pl, nv_all, mapper.cfg),
             lambda: dp.map_batch_pe_dp(mapper.didx, mapper.st, p1, pl, p2, pl, nv, mapper.cfg,
                                        mesh))):
        want, want_s, _ = timed(single, cuda)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        got, got_s, launches = timed(parallel, cuda)
        same = all(tuples_equal(a, b) for a, b in zip(got, want))
        emit(phase, replicas=len(mesh), devices=[str(d) for d in mesh], rows=B, seconds=got_s,
             rows_per_s=B / got_s, single_device_seconds=want_s,
             equal_single_device=same, counters=counters_of(got[-1]), launches=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else "not measured")
        if not same:
            raise RuntimeError(f"{phase}: the replicas' result differs from the single "
                               "device's on the same batch")
        if cuda and launches["anchor_walk"] < (2 if phase == "dp_path" else 4):
            raise RuntimeError(f"{phase}: kernel launches {launches}")
        out[phase] = launches
    return out


def phase_sharded(dev, mapper, worlds: dict, codes, lens, pc1, pc2, plens, B: int,
                  cuda: bool) -> dict:
    """The SA-sharded engine on one card (parallel/sharded.py): the world's
    index in SHARDS shards on `dev`, a (2, SHARDS) mesh sharing one upload.
    sharded_path maps two batches of B reads, each equal to the replicated
    single-device MapOut of the same batch; sharded_lanes_path the first
    batch on the per-strand CHD cut (explicit lanes, sharded_walk_lanes),
    equal to sharded_path's; sharded_pe_path one batch of B / 2 pairs; sharded_score_path one batch with the mapping score, whose
    scores equal the replicated wire path's; sharded_slot64_path one batch
    on the slot64 cut (global slots in int64), equal to sharded_path's ->
    ({phase: launches}, {phase: (the call's inputs as the split twins take
    them, its result, the replicated engine's or None, rows/s)})."""
    import dataclasses

    import torch

    from rapmap_tpu_torch.models.quasi import map_batch_pe, map_batch_se
    from rapmap_tpu_torch.parallel import sharded

    st_sh, stack, _ = worlds["paired"]
    cfg = mapper.cfg
    mesh = sharded.make_mesh_2d(2, SHARDS, devices=[dev])
    stacks = [stack, stack]  # both data rows on the one card: one upload
    nv = np.array([B // 2, B // 2], np.int32)
    nv_all = torch.tensor(B, device=dev)
    out, firsts, results = {}, [], {}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    seconds, launches_all, same, wants = 0.0, {}, [], []
    for b in range(2):
        r, ln = to_dev(dev, codes[b * B : (b + 1) * B], lens[b * B : (b + 1) * B])
        want, _, _ = timed(lambda: map_batch_se(mapper.didx, mapper.st, r, ln, nv_all, cfg),
                           cuda)
        got, s, launches = timed(
            lambda: sharded.map_batch_se_sharded(stacks, st_sh, r, ln, nv, cfg, mesh), cuda)
        seconds += s
        launches_all = {k: launches_all.get(k, 0) + v for k, v in launches.items()}
        same.append(tuples_equal(got[0], want[0]) and counters_of(got[1]) == counters_of(want[1]))
        firsts.append(got)
        wants.append(want)
    emit("sharded_path", shards=SHARDS, data_rows=len(mesh), reads=2 * B, batches=2, batch=B,
         shard_slots=[n for _, n in stack.bases], seconds=seconds, reads_per_s=2 * B / seconds,
         equal_replicated_batches=same, launches=launches_all,
         launches_per_program=launches_all["sharded_walk"] / (2 * len(mesh)),
         stack_bytes=didx_bytes([t for t in stack[:-1] if t is not None]),
         max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else "not measured")
    if not all(same):
        raise RuntimeError("sharded_path: a batch differs from the replicated engine's")
    if cuda and launches_all["sharded_walk"] != 2 * len(mesh):
        raise RuntimeError(f"sharded_path: kernel launches {launches_all}")
    out["sharded_path"] = launches_all
    r, ln = to_dev(dev, codes[:B], lens[:B])
    results["sharded_path"] = ((r, ln, nv), firsts[0], wants[0], 2 * B / seconds)

    # explicit lanes: the per-strand CHD cut, the first batch
    st_l, stack_l, _ = worlds["lanes"]
    got, s, launches = timed(lambda: sharded.map_batch_se_sharded(
        [stack_l, stack_l], st_l, r, ln, nv, cfg, mesh), cuda)
    same = tuples_equal(got[0], firsts[0][0])
    results["sharded_lanes_path"] = ((r, ln, nv), got, wants[0], B / s)
    emit("sharded_lanes_path", shards=SHARDS, reads=B, chd_canonical=st_l.chd_canonical,
         seconds=s, reads_per_s=B / s, equal_sharded_path=same, launches=launches)
    if not same or (cuda and launches["sharded_walk_lanes"] != len(mesh)):
        raise RuntimeError(f"sharded_lanes_path: unequal to sharded_path's first batch, or "
                           f"kernel launches {launches}")
    out["sharded_lanes_path"] = launches

    # pairs
    P2 = B // 2
    p1, p2, pl = to_dev(dev, pc1[:P2], pc2[:P2], plens[:P2])
    pv = np.array([P2 // 2, P2 // 2], np.int32)
    want, _, _ = timed(lambda: map_batch_pe(mapper.didx, mapper.st, p1, pl, p2, pl,
                                            torch.tensor(P2, device=dev), cfg), cuda)
    got, s, launches = timed(lambda: sharded.map_batch_pe_sharded(
        stacks, st_sh, p1, pl, p2, pl, pv, cfg, mesh), cuda)
    same = all(tuples_equal(a, b) for a, b in zip(got[:3], want[:3])) and \
        counters_of(got[3]) == counters_of(want[3])
    results["sharded_pe_path"] = ((p1, pl, p2, pl, pv), got, want, P2 / s)
    emit("sharded_pe_path", shards=SHARDS, pairs=P2, seconds=s, pairs_per_s=P2 / s,
         concordant_share=float(got[2].concordant.float().mean()),
         equal_replicated=same, launches=launches)
    if not same or (cuda and launches["sharded_walk"] != 2 * len(mesh)):
        raise RuntimeError(f"sharded_pe_path: unequal to the replicated engine's, or kernel "
                           f"launches {launches}")
    out["sharded_pe_path"] = launches

    # the mapping score, against the replicated wire path's scored records
    cfg_s = dataclasses.replace(cfg, mapping_score=True)
    smapper = copy.copy(mapper)
    smapper.cfg = cfg_s
    wr = smapper.fetch(smapper.map_se_async(codes[:B], lens[:B]))
    r, ln = to_dev(dev, codes[:B], lens[:B])
    got, s, launches = timed(
        lambda: sharded.map_batch_se_sharded(stacks, st_sh, r, ln, nv, cfg_s, mesh), cuda)
    mo = [x.cpu().numpy() for x in (got[0].t, got[0].pos, got[0].strand, got[0].score)]
    MO = mo[0].shape[1]
    checked, unequal, base = 0, 0, 0
    for i in range(B):
        cnt = int(wr.counts[i])
        for j in range(min(cnt, MO)):
            rec = wr.recs[base + j]
            checked += 1
            unequal += any(int(m[i, j]) != int(v) for m, v in zip(mo, rec[:4]))
        base += cnt
    results["sharded_score_path"] = ((r, ln, nv), got, None, B / s)
    emit("sharded_score_path", shards=SHARDS, reads=B, seconds=s, reads_per_s=B / s,
         records_checked=checked, unequal_to_wire=unequal, launches=launches)
    if unequal or checked < B // 2 or (cuda and not launches["banded_scores"]):
        raise RuntimeError("sharded_score_path: scores unequal to the replicated wire path's, "
                           f"too few records, or kernel launches {launches}")
    out["sharded_score_path"] = launches
    del smapper, wr

    # slot64: the same first batch on the int64 cut
    st64, arr64 = worlds["slot64"]
    (stack64,) = sharded.upload_sharded(arr64, [[dev] * SHARDS])
    r, ln = to_dev(dev, codes[:B], lens[:B])
    got, s, launches = timed(lambda: sharded.map_batch_se_sharded(
        [stack64, stack64], st64, r, ln, nv, cfg, mesh), cuda)
    same = tuples_equal(got[0], firsts[0][0])
    results["sharded_slot64_path"] = ((r, ln, nv), got, wants[0], B / s)
    emit("sharded_slot64_path", shards=SHARDS, reads=B, slot_base_dtype=str(arr64.slot_base.dtype),
         seconds=s, reads_per_s=B / s, equal_sharded_path=same, launches=launches)
    if not same or (cuda and launches["sharded_walk"] != len(mesh)):
        raise RuntimeError(f"sharded_slot64_path: unequal to sharded_path's first batch, or "
                           f"kernel launches {launches}")
    out["sharded_slot64_path"] = launches
    del stack64
    if cuda:
        torch.cuda.empty_cache()
    return out, results


def phase_sharded_split(dev, mapper, worlds: dict, results: dict, B: int, cuda: bool) -> dict:
    """The split path (parallel/sharded.py, a ShardSet a data row: each
    shard its own upload, the trip loop with K10 and K11), a twin of each
    phase_sharded phase on the same inputs, cut and (2, SHARDS) mesh:
    sharded_split_path (canonical-class cut, paired lanes),
    sharded_split_lanes_path (per-strand CHD cut, explicit lanes),
    sharded_split_pe_path, sharded_split_score_path, sharded_split_slot64_path.
    Each result must equal its stacked twin's (MapOut, PairOut, Counters)
    and the replicated engine's where the twin has one; `sharded_trip` runs
    SHARDS x (H + 1) times a program, `sharded_advance` H + 2 times and K8
    not at all. The first phase is profiled beside its stacked twin
    (profile_sharded_split: launches a program of each). With SHARDS x 2 cards
    the shards lie on distinct cards (the reference's layout); with fewer,
    every shard is on `dev` (split_idx=True) -> {phase: launches}."""
    import dataclasses

    import torch

    from rapmap_tpu_torch.parallel import sharded

    n_rows = 2
    distinct = cuda and torch.cuda.device_count() >= n_rows * SHARDS
    mesh = sharded.make_mesh_2d(n_rows, SHARDS, devices=None if distinct else [dev])
    layout = "distinct cards" if distinct else f"all on {mesh[0][0]}"
    H = mapper.cfg.max_hits_per_strand
    cfg_s = dataclasses.replace(mapper.cfg, mapping_score=True)
    out = {}
    for phase, world, cfg, pe in (
            ("sharded_split_path", "paired", mapper.cfg, False),
            ("sharded_split_lanes_path", "lanes", mapper.cfg, False),
            ("sharded_split_pe_path", "paired", mapper.cfg, True),
            ("sharded_split_score_path", "paired", cfg_s, False),
            ("sharded_split_slot64_path", "slot64", mapper.cfg, False)):
        twin = phase.replace("_split", "")
        inputs, stacked, replicated, stacked_rate = results[twin]
        st, arr = worlds[world][0], worlds[world][-1]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        uploads = sharded.upload_sharded(arr, mesh, split_idx=None if distinct else True)
        upload_s = time.time() - t0
        fn = sharded.map_batch_pe_sharded if pe else sharded.map_batch_se_sharded
        got, s, launches = timed(lambda: fn(uploads, st, *inputs, cfg, mesh), cuda)
        rows = int(inputs[0].shape[0])
        programs = n_rows * (2 if pe else 1)
        equal_stacked = all(tuples_equal(a, b) for a, b in zip(got, stacked))
        equal_replicated = replicated is None or (
            all(tuples_equal(a, b) for a, b in zip(got[:-1], replicated[:-1]))
            and counters_of(got[-1]) == counters_of(replicated[-1]))
        emit(phase, shards=SHARDS, data_rows=n_rows, shards_on=layout,
             devices=[[str(d) for d in row] for row in mesh], rows=rows, seconds=s,
             rows_per_s=rows / s, stacked_rows_per_s=stacked_rate,
             over_stacked=rows / s / stacked_rate, upload_s=upload_s,
             equal_stacked=equal_stacked, equal_replicated=equal_replicated,
             launches=launches, sharded_trip_per_program=launches["sharded_trip"] / programs,
             sharded_advance_per_program=launches["sharded_advance"] / programs,
             max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else "not measured")
        if not (equal_stacked and equal_replicated):
            raise RuntimeError(f"{phase}: the split path's result differs from its stacked twin's "
                               "or the replicated engine's")
        if cuda and (launches["sharded_trip"] != programs * SHARDS * (H + 1)
                     or launches["sharded_advance"] != programs * (H + 2)
                     or launches["sharded_walk"] or launches["sharded_walk_lanes"]
                     or (cfg.mapping_score and not launches["banded_scores"])):
            raise RuntimeError(f"{phase}: kernel launches {launches}")
        out[phase] = launches
        if phase == "sharded_split_path":  # where a program's time goes, beside the stack's
            stacks = [worlds[world][1]] * n_rows
            prof = {name: profile_one_batch(lambda: fn(ups, st, *inputs, cfg, mesh), n_rows,
                                            cuda, 6)
                    for name, ups in (("split", uploads), ("stacked", stacks))}
            per = {name: p["launches_per_chunk"] for name, p in prof.items()}
            emit("profile_sharded_split", shards_on=layout, launches_per_program=per,
                 split_over_stacked_launches=per["split"] / per["stacked"] if cuda else
                 "not measured",
                 split_over_stacked_wall=prof["split"]["batch_wall_ms"]
                 / prof["stacked"]["batch_wall_ms"], **prof)
        del uploads, got
        if cuda:
            torch.cuda.empty_cache()
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sam_records(path: str) -> list[str]:
    with open(path) as f:
        return sorted(ln for ln in f.read().splitlines() if ln and not ln.startswith("@"))


def phase_cli_world2(idx_dir: str, work: str, single: dict, force_cpu: bool) -> None:
    """Two command-line ranks as processes sharing the card (--worldSize 2,
    coordinator on localhost), on the default runs' reads and pairs at their
    batch size: each record union must equal the single-process SAM, and
    every rank's global counters the single process's. single: {"se"|"pe":
    (the reads' argv, the single-process SAM, its --statsJson, batch size)}."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("TQM_FORCE_CPU", None)
    if force_cpu:
        env["TQM_FORCE_CPU"] = "1"
    for ends, (reads_argv, single_sam, single_stats, bs) in single.items():
        port = free_port()
        out = os.path.join(work, f"world2_{ends}.sam")
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "rapmap_tpu_torch.cli", "quasimap", "-i", idx_dir,
             *reads_argv, "-o", out, "--batchSize", str(bs),
             "--statsJson", os.path.join(work, f"world2_{ends}_{rank}.json"),
             "--worldSize", "2", "--rank", str(rank), "--coordinator", f"localhost:{port}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=repo)
            for rank in range(2)]
        errs = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                _, err = p.communicate()
            errs.append(err)
        wall = time.time() - t0
        if any(p.returncode for p in procs):
            raise RuntimeError(f"cli_world2 {ends}: a rank failed: "
                               + " | ".join(e[-600:] for e in errs))
        shards = [sam_records(f"{out}.{rank:04d}") for rank in range(2)]
        with open(single_stats) as f:
            want = json.load(f)
        stats = []
        for rank in range(2):
            with open(os.path.join(work, f"world2_{ends}_{rank}.json")) as f:
                stats.append(json.load(f))
        keys = ("reads_total", "reads_mapped", "records", "too_ambiguous")
        union_equal = sorted(shards[0] + shards[1]) == sam_records(single_sam)
        counters_equal = all(s[k] == want[k] for s in stats for k in keys)
        emit(f"cli_world2_{ends}", ranks=2, batch=bs, records_per_rank=[len(s) for s in shards],
             seconds=wall, union_equals_single=union_equal,
             global_counters_equal_single=counters_equal,
             counters={k: stats[0][k] for k in keys})
        if not (union_equal and counters_equal and all(shards)):
            raise RuntimeError(f"cli_world2 {ends}: the ranks' union or counters differ from "
                               "the single process's, or a rank wrote no record")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_artifacts(dev, idx, cfg, codes, lens, B: int, results, work: str, cuda: bool):
    """The compact artifacts of the world's index: the core one (saved,
    reloaded with its derived arrays checked against the save-time hashes,
    then main_path's batches mapped from a fresh upload of the reload, every
    wire equal to main_path's) and the mapping-only one (saved, loaded with
    verification) -> the mapping-only index."""
    import torch

    from rapmap_tpu_torch.index.format import load_index, save_core_index, save_mapping_index
    from rapmap_tpu_torch.models.quasi import QuasiMapper

    full = dir_bytes(os.path.join(work, "idx"))
    core_dir, map_dir = os.path.join(work, "core_idx"), os.path.join(work, "map_idx")
    t0 = time.time()
    info = save_core_index(idx, core_dir)
    save_s = time.time() - t0
    t0 = time.time()
    cidx = load_index(core_dir)
    load_s = time.time() - t0
    t0 = time.time()
    cm = QuasiMapper(cidx, cfg, device=dev)
    if cuda:
        torch.cuda.synchronize()
    upload_s = time.time() - t0
    got, wall = library_path(cm, codes, lens, B, len(results), cuda)
    same = [same_result(a, b) for a, b in zip(got, results)]
    emit("core_index", bytes_on_disk=dir_bytes(core_dir), per_array=info["per_array"],
         full_index_bytes_on_disk=full, share_of_full=dir_bytes(core_dir) / full,
         save_s=save_s, reload_verified_s=load_s, upload_s=upload_s, batches=len(results),
         seconds=wall, reads_per_s=len(results) * B / wall, equal_main_path_batches=same)
    if not all(same):
        raise RuntimeError("core_index: a batch mapped from the reloaded core index differs "
                           "from main_path's")
    del cm, cidx, got
    t0 = time.time()
    info = save_mapping_index(idx, map_dir)
    save_s = time.time() - t0
    t0 = time.time()
    midx = load_index(map_dir, verify=True)
    load_s = time.time() - t0
    emit("mapping_index", bytes_on_disk=dir_bytes(map_dir), per_array=info["per_array"],
         full_index_bytes_on_disk=full, share_of_full=dir_bytes(map_dir) / full, save_s=save_s,
         load_verified_s=load_s, index_type=type(midx).__name__,
         sa_dtype=str(np.asarray(midx.sa).dtype))
    if type(midx).__name__ != "MappingQuasiIndex":
        raise RuntimeError("mapping_index: the artifact did not load as a mapping-only index")
    return midx, map_dir, core_dir


def staged_run(phase, sq, items, refs, cuda: bool, **extra):
    """Queue `items` (("se", codes, lens) or ("pe", c1, l1, c2, l2)) on a
    StagedQuasiMapper / StagedPseudoMapper and fetch them all: one sweep of
    the shards serves every batch. Each WireResult must equal the replicated
    engine's `refs` -> the phase's record (printed)."""
    import torch

    from rapmap_tpu_torch import kernels

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    hs = [sq.map_se_async(it[1], it[2]) if it[0] == "se"
          else sq.map_pe_async(it[1], it[2], it[3], it[4]) for it in items]
    got = [sq.fetch(h) for h in hs]
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    same = [same_result(a, b) for a, b in zip(got, refs)]
    n_reads = sum(len(it[2]) for it in items)
    timings = sq.sm.shard_timings
    rec = dict(shards=sq.sm.n_shards, batches=len(items), batch=sq.sm.C, read_len=sq.sm.L,
               reads=n_reads, seconds=wall, reads_per_s=n_reads / wall,
               A_max=sq.sm.A_max, A_full=sq.sm.A_full,
               upload_s=[t["upload_s"] for t in timings],
               slice_s=[t["slice_s"] for t in timings],
               device_union_s=[t["device_union_s"] for t in timings],
               exposed_wait_s=[t["exposed_wait_s"] for t in timings],
               upload_mb=[t["upload_mb"] for t in timings], launches=launches,
               launches_per_shard=launches["extend_packed_anchors"] / sq.sm.n_shards,
               max_memory_allocated=(torch.cuda.max_memory_allocated() if cuda
                                     else "not measured"),
               equal_replicated=same, **extra)
    emit(phase, **rec)
    if not all(same):
        raise RuntimeError(f"{phase}: a batch differs from the replicated engine's")
    return rec


def stage_a_device_ms(sq, codes, lens, cuda: bool) -> dict:
    """Device ms of one stage A (shard 0, one batch) and its kernels by name."""
    import torch

    from rapmap_tpu_torch.parallel import staged as stg

    sm = sq.sm
    didx = sm._upload(sm._shard_arrays(0)[0])
    lanes = torch.from_numpy(np.concatenate([codes, stg._rc_lanes(codes, lens)])).to(sm.device)
    l2 = torch.from_numpy(np.concatenate([lens, lens]).astype(np.int64)).to(sm.device)
    ms, by = device_ms(lambda: sm._stage_a(didx, lanes, l2, sm.A_max), 5, cuda)
    hand = {n: v for n, v in by.items() if "extend_packed_kernel" in n}
    return dict(stage_a_device_ms=ms, stage_a_kernel_ms=sum(hand.values()),
                stage_a_top=sorted(by.items(), key=lambda kv: -kv[1])[:6])


def phase_staged(dev, idx, midx, cfg, codes, lens, B: int, refs: dict, pidx, pcfg, pc1, pc2,
                 plens, cuda: bool) -> dict:
    """The host-staged engine on the card, 8 shards, 76 bp reads, batches of
    32,768: staged_path (the mapping-only artifact, two batches in one
    sweep), staged_overlap_path (the same with the upload overlap),
    staged_pe_path (one batch of pairs), staged_score_path (the full index,
    --mappingScore) and staged_pseudo_path (the pseudo index), each equal to
    the replicated engine's results on the same reads -> launch counts by
    phase."""
    import dataclasses

    from rapmap_tpu_torch.parallel.staged import StagedPseudoMapper, StagedQuasiMapper

    se = [("se", codes[i * B : (i + 1) * B], lens[i * B : (i + 1) * B]) for i in range(2)]
    launches = {}
    sq = StagedQuasiMapper(midx, cfg, batch=B, read_len=READ_LEN, n_shards=STAGED_SHARDS,
                           device=dev)
    rec = staged_run("staged_path", sq, se, refs["se"], cuda, index="quasi_map",
                     **stage_a_device_ms(sq, codes[:B], lens[:B], cuda))
    launches["staged_path"] = rec["launches"]
    sq.sm.upload_overlap = True
    rec = staged_run("staged_overlap_path", sq, se, refs["se"], cuda, index="quasi_map")
    launches["staged_overlap_path"] = rec["launches"]
    if any(t is None for t in rec["exposed_wait_s"]):
        raise RuntimeError("staged_overlap_path: the sweep did not overlap its uploads")
    sq = StagedQuasiMapper(idx, cfg, batch=B, read_len=READ_LEN, n_shards=STAGED_SHARDS,
                           device=dev)
    rec = staged_run("staged_pe_path", sq, [("pe", pc1[:B], plens[:B], pc2[:B], plens[:B])],
                     [refs["pe"]], cuda, index="quasi")
    launches["staged_pe_path"] = rec["launches"]
    sq = StagedQuasiMapper(idx, dataclasses.replace(cfg, mapping_score=True), batch=B,
                           read_len=READ_LEN, n_shards=STAGED_SHARDS, device=dev)
    rec = staged_run("staged_score_path", sq, se[:1], [refs["score"]], cuda, index="quasi")
    launches["staged_score_path"] = rec["launches"]
    sq = StagedPseudoMapper(pidx, pcfg, batch=B, read_len=READ_LEN, n_shards=STAGED_SHARDS,
                            device=dev)
    rec = staged_run("staged_pseudo_path", sq, se[:1], [refs["pseudo"]], cuda, index="pseudo")
    launches["staged_pseudo_path"] = rec["launches"]
    quasi = ("staged_path", "staged_overlap_path", "staged_pe_path", "staged_score_path")
    if cuda and (min(launches[p]["extend_packed_anchors"] for p in quasi) < STAGED_SHARDS
                 or launches["staged_pseudo_path"]["extend_packed_anchors"]):
        raise RuntimeError(f"staged paths: kernel launches {launches}")
    return launches


def phase_staged_bigsa(dev, cfg, work: str, B: int, n_txps: int, seed: int, cuda: bool,
                       force_cpu: bool, cli_bs: int) -> dict:
    """The int64-SA layout on the host-staged engine: a second quasi index
    of the world's first n_txps transcripts built with big_sa=True (its SA
    int64), and the default int32 one of the same FASTA; one batch of B
    reads sampled from them mapped staged over STAGED_SHARDS shards on both
    (staged_bigsa_path, staged_bigsa_int32_twin), each equal to the
    replicated engine on the int32 index; the command line's `quasimap
    --engine staged` on the big-SA index (cli_bigsa_staged), its SAM equal
    to the int32 index's replicated SAM apart from @PG; then
    scripts/genome_scale_torch.py as a process at 0.02 Gbase (--big-sa, 4
    shards, its own reads and oracle sample; --save-core --cli: the command
    line from the core as a child, every read's records equal to the
    library sweep's, K9 once a shard), whose JSON line is this phase's
    record, and scripts/core_artifact_genome_torch.py reloading that core
    with every hash checked -> launch counts by path."""
    import torch

    from rapmap_tpu_torch.index.builder import build_quasi_index
    from rapmap_tpu_torch.parallel.staged import StagedQuasiMapper

    t0 = time.time()
    fa = os.path.join(work, "bigsa.fa")
    with open(os.path.join(work, "txome.fa")) as f, open(fa, "w") as g:
        for i, line in enumerate(f):
            if i >= 2 * n_txps:
                break
            g.write(line)
    big_dir, small_dir = os.path.join(work, "bigsa_idx"), os.path.join(work, "int32_idx")
    big = build_quasi_index(fa, big_dir, k=K, big_sa=True)
    small = build_quasi_index(fa, small_dir, k=K)
    build_s = time.time() - t0
    dtypes = (str(np.asarray(big.sa).dtype), str(np.asarray(small.sa).dtype))
    if dtypes != ("int64", "int32") or not np.array_equal(big.sa, small.sa):
        raise RuntimeError(f"staged_bigsa_path: SA layouts {dtypes}, or the two SAs differ")
    codes, truth = sample_reads(small, np.random.default_rng(seed + 40), B, READ_LEN, 0.01)
    lens = np.full(B, READ_LEN, np.int32)
    from rapmap_tpu_torch.models.quasi import QuasiMapper

    rep = QuasiMapper(small, cfg, device=dev)
    want = rep.fetch(rep.map_se_async(codes, lens))
    del rep
    if cuda:
        torch.cuda.empty_cache()
    launches = {}
    for phase, ix, kind in (("staged_bigsa_path", big, "quasi, int64 SA"),
                            ("staged_bigsa_int32_twin", small, "quasi, int32 SA")):
        sq = StagedQuasiMapper(ix, cfg, batch=B, read_len=READ_LEN, n_shards=STAGED_SHARDS,
                               device=dev)
        rec = staged_run(phase, sq, [("se", codes, lens)], [want], cuda, index=kind,
                         sa_dtype=str(np.asarray(ix.sa).dtype), txps=n_txps,
                         index_build_s=build_s, map_rate=want.counters["reads_mapped"] / B)
        launches[phase] = rec["launches"]
        if cuda and rec["launches"]["extend_packed_anchors"] < STAGED_SHARDS:
            raise RuntimeError(f"{phase}: kernel launches {rec['launches']}")
        del sq
    fq = write_fastq(os.path.join(work, "bigsa.fq"), codes[: 2 * cli_bs], truth)
    rep_sam, st_sam = os.path.join(work, "bigsa_int32_rep.sam"), os.path.join(work, "bigsa.sam")
    run_cli("cli_bigsa_int32_replicated", ["-i", small_dir, "-r", fq, "-o", rep_sam,
                                           "--engine", "replicated"], work, force_cpu)
    r = run_cli("cli_bigsa_staged", ["-i", big_dir, "-r", fq, "-o", st_sam, "--engine",
                                     "staged"], work, force_cpu)
    launches["cli_bigsa_staged"] = r["launches"]
    same = sam_body(st_sam) == sam_body(rep_sam)
    emit("cli_bigsa_staged_checks", sam_equals_int32_replicated=same)
    if not same or (cuda and not r["launches"]["extend_packed_anchors"]):
        raise RuntimeError("cli_bigsa_staged: SAM differs from the int32 index's replicated "
                           f"SAM, or no kernel launched ({r['launches']})")
    del big, small

    # the genome-scale script as a process at a size the smoke affords, with
    # its core artifact and `quasimap --engine auto` from it as a child
    # process (the device budget made tiny so that auto picks the staged
    # engine, as an index past the card's memory does), then the core
    # reloaded by the twin of scripts/core_artifact_genome.py
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    size = (["--gbase", "0.02", "--reads", "8192", "--batch", "8192", "--oracle-sample", "512"]
            if cuda else ["--gbase", "0.001", "--reads", "512", "--batch", "512",
                          "--oracle-sample", "64", "--device", "cpu"])
    gwork = os.path.join(work, "genome")
    argv = [sys.executable, os.path.join(scripts, "genome_scale_torch.py"), *size,
            "--allow-small", "--big-sa", "--shards", "4", "--workdir", gwork,
            "--save-core", "--cli"]
    env = dict(os.environ, TQM_HBM_GB="0.000001")
    t0 = time.time()
    out = subprocess.run(argv, capture_output=True, text=True, timeout=600, env=env)
    wall = time.time() - t0
    lines = out.stdout.strip().splitlines()
    rec = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    emit("genome_scale_script", argv=argv[2:], rc=out.returncode, wall_s=wall, record=rec,
         stderr_tail=None if rec else out.stderr[-3000:])
    n_or = rec and rec["oracle_parity"].split("/")
    cli = rec and rec["cli"]
    if rec is None or n_or[0] != n_or[1] or not rec["every_shard_swept"] or (
            cuda and rec["launches"]["extend_packed_anchors"] < 4):
        raise RuntimeError("genome_scale_script: the run failed, its oracle parity is not "
                           "full, or a shard was not swept through K9")
    if (not cli or cli["rc"] != 0 or cli["reads_unequal"] or cli["reads_not_in_batch"]
            or cli["engine"] != "staged" or (
                cuda and cli["launches"]["extend_packed_anchors"] < cli["want_shards"])):
        raise RuntimeError("genome_scale_script: the command line's child failed, picked "
                           "another engine, launched K9 less than once a shard or wrote "
                           "other records")
    launches["genome_scale_script"] = rec["launches"]
    launches["genome_scale_script_cli"] = cli["launches"]
    argv = [sys.executable, os.path.join(scripts, "core_artifact_genome_torch.py"),
            "--core", os.path.join(gwork, "core")]
    t0 = time.time()
    out = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    lines = out.stdout.strip().splitlines()
    twin = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    emit("core_artifact_script", argv=argv[2:], rc=out.returncode, wall_s=wall, record=twin,
         stderr_tail=None if twin else out.stderr[-3000:])
    if twin is None or twin["n_text"] != rec["n_text"] or twin["sa_dtype"] != "int64":
        raise RuntimeError("core_artifact_script: the reload failed its hashes or does not "
                           "hold the genome run's index")
    return launches


def script_record(argv: list[str], timeout: int) -> tuple[dict | None, list[str], dict]:
    """A script as a process -> (its last line's JSON or None, its standard
    output's lines, its exit code, wall seconds and, when it failed, the
    tail of its standard error)."""
    t0 = time.time()
    out = subprocess.run(argv, capture_output=True, text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    try:
        rec = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        rec = None
    return rec, lines, dict(rc=out.returncode, wall_s=time.time() - t0,
                            stderr_tail=out.stderr[-3000:] if out.returncode else None)


def phase_scale_world(work: str, cuda: bool) -> dict:
    """scripts/scale_world_torch.py as a process at a size the smoke affords
    (2 Mbase, 65,536 reads in one batch; on the CPU rehearsal 0.05 Mbase):
    its SE, PE and bitonic passes, the CPU's plain batches, 512 reads and
    256 pairs held to the oracle after the fallback, `quasimap --engine auto`
    as child processes (SE and PE, every read's SAM lines against the
    library's), and the 96 slot64 sharded reads; its JSON line is this
    phase's record -> launch counts by path (K1, the walk and K8 must each
    launch on the card)."""
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    size = (["--mbase", "2", "--reads", "65536", "--batch", "65536", "--oracle-sample", "512"]
            if cuda else ["--mbase", "0.05", "--reads", "512", "--batch", "256",
                          "--oracle-sample", "64", "--device", "cpu"])
    argv = [sys.executable, os.path.join(scripts, "scale_world_torch.py"), *size,
            "--sharded", "--cli", "--workdir", os.path.join(work, "scale")]
    rec, _, ran = script_record(argv, 600)
    emit("scale_world_script", argv=argv[2:], **ran, record=rec)
    if ran["rc"] != 0 or rec is None:
        raise RuntimeError("scale_world_script: the run failed (a read, a pair, a SAM line or "
                           "a sharded read differs, or a kernel did not launch)")
    orc, cli, sh = rec["oracle"], rec["cli"], rec["sharded"]
    launches = {"scale_world_script_se": rec["se"]["launches"],
                "scale_world_script_pe": rec["pe"]["launches"],
                "scale_world_script_bitonic": rec["bitonic_pass"]["launches"],
                "scale_world_script_sharded": sh["launches"],
                "scale_world_script_cli_se": cli["se"]["launches"],
                "scale_world_script_cli_pe": cli["pe"]["launches"]}
    equal = (not orc["oracle_se"]["unequal"] and not orc["oracle_pe"]["unequal"]
             and rec["cpu_plain"]["se_equal"] and rec["cpu_plain"]["pe_equal"]
             and rec["bitonic_pass"]["equal_twin"] and not sh["unequal"]
             and all(c["engine"] == "replicated" and not c["unequal"] and not c["extra"]
                     for c in cli.values()))
    launched = not cuda or all(launches[path].get(kernel, 0) > 0 for path, kernel in (
        ("scale_world_script_bitonic", "bitonic_sort_pairs"),
        ("scale_world_script_se", "anchor_walk"), ("scale_world_script_pe", "anchor_walk"),
        ("scale_world_script_sharded", "sharded_walk"),
        ("scale_world_script_cli_se", "anchor_walk"),
        ("scale_world_script_cli_pe", "anchor_walk")))
    if not (equal and launched):
        raise RuntimeError("scale_world_script: a compared read differs, the command line did "
                           f"not pick the replicated engine, or a kernel did not launch "
                           f"({launches})")
    return launches


def phase_isoform_world(work: str, cuda: bool) -> dict:
    """bench.py's primary regime, the isoform transcriptome (2,000 genes of
    2-8 isoforms, ~17 Mbase, its reads mapping to several transcripts), by
    scripts/isoform_world_torch.py as a process at a cut depth (131,072
    reads and 65,536 pairs; on the CPU rehearsal 40 genes): the auto-sized
    budget with the pair pool, SE and PE passes, the bitonic pass (K1),
    the CPU's plain batches, 512 reads and 256 pairs held to the oracle
    (reads and pairs cut by a full record buffer or winner list counted
    apart, in overflowed batches only), K2+K3 against its plain version,
    and `quasimap` at its default flags as child processes, every SAM line
    against the library's; then scripts/eval_accuracy_torch.py --isoform on
    4,096 reads, plain and with --chimeraFrac 0.1 --mappingScore
    --minScoreFraction 0.65. Their JSON lines are this phase's records ->
    launch counts by path (the walk on SE, PE and both children, K1 in the
    bitonic pass, the banded DP in the scored accuracy run)."""
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    size = (["--reads", "131072", "--oracle-sample", "512"] if cuda else
            ["--genes", "40", "--reads", "1024", "--batch", "512", "--chunk", "256",
             "--oracle-sample", "64", "--cli-batch", "256", "--device", "cpu"])
    argv = [sys.executable, os.path.join(scripts, "isoform_world_torch.py"), *size, "--cli",
            "--workdir", os.path.join(work, "isoform")]
    rec, _, ran = script_record(argv, 900)
    emit("isoform_world_script", argv=argv[2:], **ran, record=rec)
    if ran["rc"] != 0 or rec is None or rec.get("failed"):
        raise RuntimeError("isoform_world_script: the run failed "
                           f"({(rec or {}).get('failed')})")
    cli = rec["cli"]
    launches = {"isoform_world_script_se": rec["se"]["launches"],
                "isoform_world_script_pe": rec["pe"]["launches"],
                "isoform_world_script_bitonic": rec["bitonic_pass"]["launches"],
                "isoform_world_script_cli_se": cli["se"]["launches"],
                "isoform_world_script_cli_pe": cli["pe"]["launches"]}
    for name, flags in (("accuracy_script", []),
                        ("accuracy_score_script", ["--chimeraFrac", "0.1", "--mappingScore",
                                                   "--minScoreFraction", "0.65"])):
        argv = [sys.executable, os.path.join(scripts, "eval_accuracy_torch.py"), "--isoform",
                "-n", "4096" if cuda else "512", *flags, *([] if cuda else ["--device", "cpu"])]
        result, lines, ran = script_record(argv, 600)
        run = json.loads(lines[-2]) if ran["rc"] == 0 and len(lines) >= 2 else None
        emit(name, argv=argv[2:], **ran, run=run, result=result)
        if run is None:
            raise RuntimeError(f"{name}: the accuracy run failed")
        launches[name] = run["launches"]
    equal = (rec["config"]["expand_pairs"]
             and all(cli[k]["engine"] == "replicated" and not cli[k]["unequal"]
                     for k in ("se", "pe")))
    launched = not cuda or all(launches[path].get(kernel, 0) > 0 for path, kernel in (
        ("isoform_world_script_se", "anchor_walk"), ("isoform_world_script_pe", "anchor_walk"),
        ("isoform_world_script_cli_se", "anchor_walk"),
        ("isoform_world_script_cli_pe", "anchor_walk"),
        ("isoform_world_script_bitonic", "bitonic_sort_pairs"),
        ("accuracy_script", "anchor_walk"), ("accuracy_score_script", "banded_scores")))
    if not (equal and launched):
        raise RuntimeError("isoform_world_script: the pair pool was off, the command line "
                           f"differs, or a kernel did not launch ({launches})")
    return launches


def head_of(path: str, n: int) -> list[str]:
    """A SAM file's lines without @PG, of its first n reads (pairs) only:
    read names start r<i>: or p<i>:."""
    return [ln for ln in sam_body(path)
            if ln[0] == "@" or int(ln.split(":", 1)[0][1:]) < n]


def wire_probe(device):
    """A mapper whose program hands its device wire_in back as its
    wire_out: `_Mapper._dispatch` as the mappers run it (pack into pinned
    memory, upload, program, pinned copy out) with nothing mapped."""
    from rapmap_tpu_torch.models.quasi import _Mapper

    class WireProbe(_Mapper):
        def _program(self, kind, win, B, L):
            return win.clone(), 0, 0, None

    probe = WireProbe()
    probe.device = device
    return probe


def numpy_wire_in(mates, lens, n_valid: int) -> np.ndarray:
    """The wire_in bytes of ops/wire.py's numpy pack (`_pack_codes_np`)."""
    from rapmap_tpu_torch.ops import wire

    parts = [a.reshape(-1) for c in mates for a in wire._pack_codes_np(np.asarray(c, np.int8))]
    parts += [np.asarray(ln, np.uint16).view(np.uint8) for ln in lens]
    return np.concatenate(parts + [np.array([n_valid], np.int32).view(np.uint8)])


def phase_wire_pack(dev, cuda: bool, seed: int, B: int = 65536, L: int = READ_LEN,
                    in_flight: int = 4) -> dict:
    """The wire_in pack on the card, through `_Mapper._dispatch`: `in_flight`
    SE batches, then as many PE batches, of distinct seeded codes (0..5 and
    the whole int8 range, ragged lens), dispatched one after another while
    the stream is held by a sleep, so that every upload waits behind the
    packs and each batch's pinned buffer is dropped (back to PyTorch's
    caching host allocator) long before its copy runs. Each batch's device
    wire_in must equal the numpy pack's bytes: a block handed out again
    before its copy completed would carry a later batch's bytes. Every mate
    block must go through the native pass (`PACKS`). Reports the host's
    `pack_ms` (span `tqm.pack_in`) and the numpy pack's ms beside it."""
    import torch

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.ops import wire
    from rapmap_tpu_torch.utils.timers import StageTimers, recording

    rng = np.random.default_rng(seed + 22)
    probe = wire_probe(dev)
    out = {}
    for kind, mates in (("se", 1), ("pe", 2)):
        batches = []
        for _ in range(in_flight):
            cs = [np.where(rng.random((B, L)) < 0.9, rng.integers(0, 6, (B, L), dtype=np.int8),
                           rng.integers(-128, 128, (B, L), dtype=np.int8))
                  for _ in range(mates)]
            ls = [rng.integers(L // 2, L + 1, B).astype(np.int32) for _ in range(mates)]
            batches.append((cs, ls, int(rng.integers(B // 2, B + 1))))
        t0 = time.perf_counter()
        want = [numpy_wire_in(cs, ls, nv) for cs, ls, nv in batches]
        numpy_ms = (time.perf_counter() - t0) * 1e3 / in_flight

        def dispatch_all():
            if kind == "se":
                return [probe.map_se_async(cs[0], ls[0], nv) for cs, ls, nv in batches]
            return [probe.map_pe_async(cs[0], ls[0], cs[1], ls[1], nv)
                    for cs, ls, nv in batches]

        for h in dispatch_all():  # fills the allocator's cache: no cudaHostAlloc below
            if h.done is not None:
                h.done.synchronize()
        kernels.reset_launches()
        held = None
        if cuda:
            torch.cuda.synchronize()
            torch.cuda._sleep(400_000_000)  # ~0.2 s at the H100's clock
            slept = torch.cuda.Event()
            slept.record()
        timers = StageTimers()
        with recording(timers):
            handles = dispatch_all()
            if cuda:
                held = not slept.query()  # the device still asleep: every upload waited
        equal = []
        for h, w in zip(handles, want):
            if h.done is not None:
                h.done.synchronize()
            equal.append(bool(np.array_equal(h.wire.numpy(), w)))
        distinct = len({w.tobytes() for w in want}) == in_flight
        packs = dict(wire.PACKS)
        out[kind] = dict(
            equal=equal, distinct=distinct, held=held, packs=packs,
            pack_ms=timers.totals["tqm.pack_in"] * 1e3 / in_flight,
            upload_ms=timers.totals["tqm.upload"] * 1e3 / in_flight,
            numpy_pack_ms=numpy_ms, wire_in_bytes=len(want[0]),
        )
        if not (all(equal) and distinct and held is not False
                and packs == {"native": mates * in_flight, "numpy": 0}):
            emit("wire_pack", ok=False, **out)
            raise RuntimeError(f"wire_pack {kind}: device wire_in differs from the numpy "
                               "pack, the stream was not held, or a block went through numpy")
    emit("wire_pack", ok=True, batch=B, read_len=L, in_flight=in_flight, **out)
    return out


def main() -> int:
    t_start = time.time()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--txps", type=int, default=10_000)
    ap.add_argument("--reads", type=int, default=262_144)
    ap.add_argument("--pairs", type=int, default=131_072)
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
    global INT_OPS_PER_S
    rate = int_ops_rate(cuda)
    INT_OPS_PER_S = rate["ops_per_s"]
    emit("int_ops_rate", **rate)

    # ---- build -----------------------------------------------------------
    t0 = time.time()
    if not bindings.available():
        raise RuntimeError("native index-build library failed to build")
    native_s = time.time() - t0
    t0 = time.time()
    libs = kernels.build_all() if cuda else {}
    emit("build", native_s=native_s, kernels=sorted(libs), kernels_s=time.time() - t0)
    phase_wire_pack(dev, cuda, args.seed, B=65536 if cuda else 2048)

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
         device_index_bytes=didx_bytes(mapper.didx),
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

    # ---- the same world without its CHD: the binary-search probe path -------
    # (what build_quasi_index(with_chd=False) writes for the same FASTA: same
    # SA, k-mer table and reads, so every mapping must be the same), saved for
    # the command line; and the CHD index's full upload for the charwise path
    import dataclasses

    from rapmap_tpu_torch.index.format import save_index
    from rapmap_tpu_torch.ops.device_index import device_bytes_estimate

    nidx = without_chd(idx)
    nochd_dir = os.path.join(work, "nochd_idx")
    t0 = time.time()
    save_index(nidx, nochd_dir)
    save_s = time.time() - t0
    cfg_c = dataclasses.replace(cfg, packed_extension=False)
    uploads = {}
    for name, ix, c in (("nochd", nidx, cfg), ("nochd_charwise", nidx, cfg_c),
                        ("chd_charwise", idx, cfg_c)):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        m = QuasiMapper(ix, c, device=dev)
        if cuda:
            torch.cuda.synchronize()
        uploads[name] = (m, time.time() - t0)
    nmapper, nmapper_c, cmapper = (uploads[n][0] for n in ("nochd", "nochd_charwise",
                                                            "chd_charwise"))
    up = {name: dict(upload_s=t, device_index_bytes=didx_bytes(m.didx),
                     estimate_bytes=device_bytes_estimate(m.host_index,
                                                          lean=m.didx.sa_ext is None),
                     tensors={f: didx_bytes([getattr(m.didx, f)]) for f in m.didx._fields
                              if getattr(m.didx, f) is not None})
          for name, (m, t) in uploads.items()}
    emit("nochd_world", save_s=save_s, lookup_steps=nmapper.st.lookup_steps,
         prefix_bases=nmapper.st.prefix_bases, use_chd=nmapper.st.use_chd, uploads=up,
         max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else "not measured")
    if nmapper.st.use_chd or any(u["device_index_bytes"] > u["estimate_bytes"]
                                 for u in up.values()):
        raise RuntimeError("nochd_world: the index kept a CHD, or an upload exceeds its "
                           "device_bytes_estimate")
    del uploads

    lanes_ok, lanes_err, lanes_t = phase_lanes_walk_kernel(
        dev, timer, nmapper, idx, codes, lens, C, args.seed, work)
    if not lanes_ok:
        raise RuntimeError("anchor_walk_lanes kernel disagrees with its plain version, or "
                           "an input set missed what it is there to exercise")
    char_ok, char_err, char_t = phase_charwise_kernel(
        dev, timer, cmapper, nmapper, idx, codes, lens, C, args.seed, work)
    if not char_ok:
        raise RuntimeError("anchor_walk_charwise kernel disagrees with its plain version or "
                           "the packed walk, or an input set missed what it is there to "
                           "exercise")

    # ---- main path: map_se_async / fetch, one batch in flight --------------
    if cuda:  # the peak of the index and the main path, not of the checks above
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    results, wall = library_path(mapper, codes, lens, B, BATCHES, cuda)
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
    main_reads_per_s = args.reads / wall

    # ---- the same reads on the index without its CHD --------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    n_results, wall = library_path(nmapper, codes, lens, B, BATCHES, cuda)
    nochd_launches = dict(kernels.LAUNCHES)
    same = [same_result(a, b) for a, b in zip(n_results, results)]
    emit("nochd_path", reads=args.reads, batches=BATCHES, batch=B, chunks=n_chunks,
         seconds=wall, reads_per_s=args.reads / wall,
         reads_per_s_over_main_path=args.reads / wall / main_reads_per_s,
         equal_main_path_batches=same, launches=nochd_launches,
         max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else "not measured")
    # the canonical-CHD path again, now that the process is as warm as it was
    # for the no-CHD run (the first path pays first-use costs: pinned buffers)
    again, again_s = library_path(mapper, codes, lens, B, BATCHES, cuda)
    emit("main_path_repeat", reads=args.reads, seconds=again_s, reads_per_s=args.reads / again_s,
         nochd_path_over_repeat=again_s / wall,
         equal_main_path_batches=[same_result(a, b) for a, b in zip(again, results)])
    if not all(same):
        raise RuntimeError("nochd_path: a batch differs from main_path's on the same reads")
    del again
    if cuda and (min(nochd_launches["anchor_walk_lanes"],
                     nochd_launches["bitonic_sort_pairs"]) < n_chunks
                 or nochd_launches["anchor_walk"]):
        raise RuntimeError(f"nochd_path: kernel launches {nochd_launches} for {n_chunks} chunks")
    del n_results

    # ---- the mapping score: the kernel against its plain version, then the
    # same reads with cfg.mapping_score on the main path's upload ---------------
    score_ok, score_err, score_t = phase_score_kernel(dev, timer, mapper, idx, codes, lens,
                                                      results[0], C, args.seed)
    if not score_ok:
        raise RuntimeError("banded_scores kernel disagrees with its plain version, or an "
                           "input set missed what it is there to exercise")
    smapper = copy.copy(mapper)  # the same upload and host index, with scores
    smapper.cfg = dataclasses.replace(mapper.cfg, mapping_score=True)
    kernels.reset_launches()
    s_results, wall = library_path(smapper, codes, lens, B, BATCHES, cuda)
    score_launches = dict(kernels.LAUNCHES)
    same = [np.array_equal(a.recs[:, :3], b.recs[:, :3]) and np.array_equal(a.counts, b.counts)
            and np.array_equal(a.flags, b.flags) and a.counters == b.counters
            for a, b in zip(s_results, results)]
    unequal = library_scores_equal_oracle(s_results[0], idx, codes[:B], None, smapper.cfg,
                                          500, args.seed)
    prof = profile_one_batch(lambda: smapper.fetch(smapper.map_se_async(codes[:B], lens[:B])),
                             B // C, cuda, 8)
    banded = [h for h in prof["hand_kernels"] if "banded_" in h["name"]]
    emit("score_path", reads=args.reads, batches=BATCHES, batch=B, chunks=n_chunks,
         seconds=wall, reads_per_s=args.reads / wall,
         reads_per_s_over_main_path_repeat=again_s / wall,
         equal_main_path_mappings=same, sampled_scores_unequal_oracle=unequal,
         launches=score_launches, launches_per_chunk=prof["launches_per_chunk"],
         kernel_device_ms_per_chunk=(sum(h["ms"] for h in banded) / (B // C) if cuda
                                     else "not measured"),
         device_busy_ms=prof["device_busy_ms"], device_idle_share=prof["device_idle_share"],
         score_mean=float(np.mean(s_results[0].recs[:, 3])))
    if cuda and score_launches["banded_scores"] < n_chunks:
        raise RuntimeError(f"score_path: kernel launches {score_launches} for {n_chunks} chunks")
    if not all(same) or unequal:
        raise RuntimeError("score_path: a batch's mappings differ from main_path's, or a "
                           "sampled score differs from the oracle's")
    score_ref = s_results[0]  # the staged score path's reference
    del s_results

    # ---- the charwise extension (packed_extension=False), both index kinds ----
    kernels.reset_launches()
    charwise = {}
    for name, m in (("chd", cmapper), ("nochd", nmapper_c)):
        t0 = time.time()
        got = m.fetch(m.map_se_async(codes[:B], lens[:B]))
        if cuda:
            torch.cuda.synchronize()
        charwise[name] = dict(seconds=time.time() - t0, equal_packed=same_result(got, results[0]),
                              scan="paired" if m.st.chd_canonical else "explicit lanes")
    charwise_launches = dict(kernels.LAUNCHES)
    emit("charwise_path", reads=B, chunks_each=B // C, runs=charwise, launches=charwise_launches)
    if not all(c["equal_packed"] for c in charwise.values()):
        raise RuntimeError("charwise_path: a charwise result differs from the packed one")
    if cuda and (charwise_launches["anchor_walk_charwise"] < 2 * (B // C)
                 or charwise_launches["anchor_walk"] or charwise_launches["anchor_walk_lanes"]):
        raise RuntimeError(f"charwise_path: kernel launches {charwise_launches}")
    del cmapper, nmapper_c

    emit("profile", **profile_batch(mapper, codes[:B], lens[:B], C, cuda))
    # one batch of the command line's default size: one program over the batch
    emit("profile_unchunked", batch=cli_bs,
         **profile_batch(mapper, codes[:cli_bs], lens[:cli_bs], C, cuda))
    emit("profile_nochd", **profile_batch(nmapper, codes[:B], lens[:B], C, cuda))

    # ---- paired-end library path: map_pe_async / fetch, one batch in flight --
    # 2 x 76 bp pairs from 200-500 bp fragments of the same world, the chunk
    # and voting pool of the single-end path: the walk and the sort kernel
    # each run twice a chunk, once per mate
    n_pairs = args.pairs
    pc1, pc2, ptruth = sample_pairs(idx, np.random.default_rng(args.seed + 5), n_pairs,
                                    READ_LEN, 0.01)
    plens = np.full(n_pairs, READ_LEN, np.int32)
    PB = n_pairs // PE_BATCHES
    if PB // 4 != C:
        raise RuntimeError("the paired-end batches must have the single-end chunk")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    pe_results = []
    t0 = time.time()
    pending = mapper.map_pe_async(pc1[:PB], plens[:PB], pc2[:PB], plens[:PB])
    for b in range(1, PE_BATCHES + 1):
        rows = slice(b * PB, (b + 1) * PB)
        nxt = (mapper.map_pe_async(pc1[rows], plens[rows], pc2[rows], plens[rows])
               if b < PE_BATCHES else None)
        pe_results.append(mapper.fetch(pending))
        pending = nxt
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    pe_launches = dict(kernels.LAUNCHES)
    pe_chunks = n_pairs // C
    pctr = {k: sum(r.counters[k] for r in pe_results) for k in pe_results[0].counters}
    shares = [pair_shares(r, ptruth, i * PB, (i + 1) * PB) for i, r in enumerate(pe_results)]
    conc_share = float(np.mean([x[0] for x in shares]))
    true_share = float(np.mean([x[1] for x in shares]))
    emit("pe_path", pairs=n_pairs, batches=PE_BATCHES, batch=PB, chunks=pe_chunks,
         seconds=wall, pairs_per_s=n_pairs / wall, reads_per_s=2 * n_pairs / wall,
         concordant_share=conc_share, concordant_at_true_locus_share=true_share,
         map_rate=pctr["reads_mapped"] / pctr["reads_total"], counters=pctr,
         launches=pe_launches,
         max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else "not measured")
    if cuda and min(pe_launches["bitonic_sort_pairs"], pe_launches["anchor_walk"]) < 2 * pe_chunks:
        raise RuntimeError(f"pe_path: kernel launches {pe_launches} for {pe_chunks} chunks "
                           "of two mates")
    if conc_share < 0.9 or true_share < 0.95:
        raise RuntimeError(f"pe_path: concordant share {conc_share:.4f} below 0.9 or "
                           f"{true_share:.4f} of the pairs concordant at their true locus")
    for r in pe_results:
        if r.recs.shape[1] != 7 or len(r.recs) != r.total or r.overflowed:
            raise RuntimeError("malformed paired-end wire result")
    n_pe_mapped = pctr["reads_mapped"]
    pe_first = pe_results[0]
    del pe_results

    # one paired-end batch on the index without its CHD
    kernels.reset_launches()
    t0 = time.time()
    got = nmapper.fetch(nmapper.map_pe_async(pc1[:PB], plens[:PB], pc2[:PB], plens[:PB]))
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    nochd_pe_launches = dict(kernels.LAUNCHES)
    same = same_result(got, pe_first)
    emit("nochd_pe_path", pairs=PB, chunks=PB // C, seconds=wall, pairs_per_s=PB / wall,
         equal_pe_path_first_batch=same, launches=nochd_pe_launches)
    if not same:
        raise RuntimeError("nochd_pe_path: the batch differs from pe_path's first batch")
    if cuda and min(nochd_pe_launches["anchor_walk_lanes"],
                    nochd_pe_launches["bitonic_sort_pairs"]) < 2 * (PB // C):
        raise RuntimeError(f"nochd_pe_path: kernel launches {nochd_pe_launches} for "
                           f"{PB // C} chunks of two mates")

    # one paired-end batch with the mapping score: both mates of a chunk's
    # records scored in one launch
    kernels.reset_launches()
    t0 = time.time()
    got = smapper.fetch(smapper.map_pe_async(pc1[:PB], plens[:PB], pc2[:PB], plens[:PB]))
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    pe_score_launches = dict(kernels.LAUNCHES)
    same = (got.recs.shape[1] == 9 and np.array_equal(got.recs[:, :7], pe_first.recs)
            and np.array_equal(got.counts, pe_first.counts)
            and np.array_equal(got.flags, pe_first.flags) and got.counters == pe_first.counters)
    unequal = library_scores_equal_oracle(got, idx, pc1[:PB], pc2[:PB], smapper.cfg, 250,
                                          args.seed)
    emit("pe_score_path", pairs=PB, chunks=PB // C, seconds=wall, pairs_per_s=PB / wall,
         equal_pe_path_first_batch_fields_0_6=same, sampled_scores_unequal_oracle=unequal,
         launches=pe_score_launches)
    if not same or unequal:
        raise RuntimeError("pe_score_path: fields 0-6 differ from pe_path's first batch, or "
                           "a sampled score differs from the oracle's")
    if cuda and pe_score_launches["banded_scores"] < PB // C:
        raise RuntimeError(f"pe_score_path: kernel launches {pe_score_launches} for "
                           f"{PB // C} chunks")
    pe_ref = pe_first  # the staged paired-end path's reference
    del got, pe_first
    # the command line's paired-end inputs: every pair with its true locus in
    # its name, and the head of them for the card-against-CPU runs
    n_head_pe = min(4096, n_pairs)
    pe_fq = write_fastq_pairs(os.path.join(work, "pe_1.fq"), os.path.join(work, "pe_2.fq"),
                              pc1, pc2, ptruth)
    head_pe_fq = write_fastq_pairs(os.path.join(work, "head_pe_1.fq"),
                                   os.path.join(work, "head_pe_2.fq"), pc1[:n_head_pe],
                                   pc2[:n_head_pe], [x[:n_head_pe] for x in ptruth])

    emit("profile_pe", **profile_pe_batch(mapper, pc1[:PB], pc2[:PB], plens[:PB], C, cuda))

    # ---- the card's wire buffers equal the CPU's: the single-end path's first
    # batch, the paired-end path's first two chunks ---------------------------
    if cuda:
        again = mapper.map_se_async(codes[:B], lens[:B])
        again_pe = mapper.map_pe_async(pc1[: 2 * C], plens[: 2 * C], pc2[: 2 * C],
                                       plens[: 2 * C])
        again.done.synchronize()
        again_pe.done.synchronize()
        card, card_pe = again.wire.clone(), again_pe.wire.clone()
        del mapper, smapper, nmapper, again, again_pe
        torch.cuda.empty_cache()
        t0 = time.time()
        cpu_mapper = QuasiMapper(idx, cfg, device="cpu")
        host = cpu_mapper.map_se_async(codes[:B], lens[:B]).wire
        same = bool(torch.equal(card, host))
        emit("card_equals_cpu", batch=B, equal=same, cpu_s=time.time() - t0)
        if not same:
            raise RuntimeError("card wire buffer differs from the CPU's")
        t0 = time.time()
        host_pe = cpu_mapper.map_pe_async(pc1[: 2 * C], plens[: 2 * C], pc2[: 2 * C],
                                          plens[: 2 * C])
        same = bool(torch.equal(card_pe, host_pe.wire)) and host_pe.C == C
        emit("pe_card_equals_cpu", pairs=2 * C, chunks=2, equal=same, cpu_s=time.time() - t0)
        if not same:
            raise RuntimeError("the card's paired-end wire buffer differs from the CPU's")
        del cpu_mapper, host, card, host_pe, card_pe

    # ---- the command line, in process: FASTQ in, SAM out ---------------------
    force_cpu = not cuda  # a rehearsal runs every command on the CPU
    idx_dir = os.path.join(work, "idx")
    n_main_mapped = ctr["reads_mapped"]
    if not cuda:
        del nmapper, smapper
    main_results = results  # the artifact and staged paths' reference
    del results, nidx  # idx stays: the oracle recomputes sampled AS:i tags

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

    cli_nochd = run_cli(
        "cli_nochd_default", ["-i", nochd_dir, "-r", reads_fq, "-o", sam("n.sam"), *default_bs],
        work, force_cpu)
    same = sam_body(sam("a.sam")) == sam_body(sam("n.sam"))
    emit("cli_nochd_default_checks", batches=n_batches, sam_equals_cli_default=same)
    if not same:
        raise RuntimeError("cli_nochd_default: SAM differs from cli_default's")
    if cuda and (cli_nochd["launches"]["anchor_walk_lanes"] != n_batches
                 or cli_nochd["launches"]["anchor_walk"]):
        raise RuntimeError(f"cli_nochd_default: walk launches {cli_nochd['launches']} "
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

    # ---- the command line with the mapping score: AS:i tags and the filter ----
    cli_score = run_cli(
        "cli_score_default", ["-i", idx_dir, "-r", reads_fq, "-o", sam("s.sam"), *default_bs,
                              *SCORE_FLAGS], work, force_cpu)
    share = sam_true_locus_share(sam("s.sam"), args.reads)
    as_check = as_tags_equal_oracle(sam("s.sam"), idx, codes, None, cli_score_cfg(idx), 1000,
                                    args.seed)
    emit("cli_score_default_checks", batches=n_batches, primary_at_true_locus_share=share,
         score_filtered=cli_score["counters"].get("score_filtered", 0),
         reads_mapped_cli_default=cli_default["counters"]["reads_mapped"],
         reads_per_s_over_cli_default=cli_score["reads_per_s"] / cli_default["reads_per_s"],
         as_tags=as_check)
    if share < 0.98 or as_check["unequal"] or as_check["checked"] < min(1000, args.reads // 2):
        raise RuntimeError(f"cli_score_default: {share:.4f} of the primary records at the true "
                           f"locus, or AS:i tags unequal to the oracle's: {as_check}")
    if cuda and cli_score["launches"]["banded_scores"] != n_batches:
        raise RuntimeError(f"cli_score_default: kernel launches {cli_score['launches']} for "
                           f"{n_batches} batches")
    if cuda:
        head = {}
        for name, on_cpu in (("card", False), ("cpu", True)):
            head[name] = run_cli(
                f"cli_score_head_{name}", ["-i", idx_dir, "-r", head_fq,
                                           "-o", sam(f"head_score_{name}.sam"), *SCORE_FLAGS],
                work, on_cpu)
        same = sam_body(sam("head_score_card.sam")) == sam_body(sam("head_score_cpu.sam"))
        emit("cli_score_card_equals_cpu", reads=n_head, equal=same,
             card_launches=head["card"]["launches"], cpu_launches=head["cpu"]["launches"])
        if (not same or head["cpu"]["launches"]["banded_scores"]
                or not head["card"]["launches"]["banded_scores"]):
            raise RuntimeError("cli_score_card_equals_cpu: the card's SAM differs from the "
                               "CPU's, or the kernel ran on the CPU or not on the card")

    # ---- the paired-end command line ---------------------------------------
    pe_default = run_cli(
        "cli_pe_default", ["-i", idx_dir, "-1", pe_fq[0], "-2", pe_fq[1], "-o", sam("pa.sam"),
                           *default_bs], work, force_cpu)
    pe_batches = -(-n_pairs // cli_bs)
    share = sam_pe_true_locus_share(sam("pa.sam"), n_pairs)
    emit("cli_pe_default_checks", batches=pe_batches,
         primary_proper_pair_at_true_locus_share=share, reads_mapped_pe_path=n_pe_mapped)
    if pe_default["counters"]["reads_total"] != n_pairs:
        raise RuntimeError("cli_pe_default: reads_total differs from the pairs written")
    if pe_default["counters"]["reads_mapped"] != n_pe_mapped or share < 0.95:
        raise RuntimeError("cli_pe_default: pairs mapped unequal to the library path's, or "
                           f"{share:.4f} of the primary pairs at their true locus")
    if cuda and pe_default["launches"]["anchor_walk"] != 2 * pe_batches:
        raise RuntimeError(f"cli_pe_default: walk launches {pe_default['launches']} "
                           f"for {pe_batches} batches of two mates")

    pe_nochd = run_cli(
        "cli_pe_nochd_default", ["-i", nochd_dir, "-1", pe_fq[0], "-2", pe_fq[1],
                                 "-o", sam("pn.sam"), *default_bs], work, force_cpu)
    same = sam_body(sam("pa.sam")) == sam_body(sam("pn.sam"))
    emit("cli_pe_nochd_default_checks", batches=pe_batches, sam_equals_cli_pe_default=same)
    if not same:
        raise RuntimeError("cli_pe_nochd_default: SAM differs from cli_pe_default's")
    if cuda and (pe_nochd["launches"]["anchor_walk_lanes"] != 2 * pe_batches
                 or pe_nochd["launches"]["anchor_walk"]):
        raise RuntimeError(f"cli_pe_nochd_default: walk launches {pe_nochd['launches']} "
                           f"for {pe_batches} batches of two mates")

    pe_chunked = run_cli(
        "cli_pe_chunked", ["-i", idx_dir, "-1", pe_fq[0], "-2", pe_fq[1], "-o", sam("pb.sam"),
                           "--batchSize", str(PB), "--chunkSize", str(C), "-t", "2"],
        work, force_cpu)
    same = sam_body(sam("pa.sam")) == sam_body(sam("pb.sam"))
    emit("cli_pe_chunked_checks", chunks=pe_chunks, sam_equals_cli_pe_default=same)
    if not same:
        raise RuntimeError("cli_pe_chunked: SAM differs from cli_pe_default's")
    if cuda and pe_chunked["launches"]["anchor_walk"] != 2 * pe_chunks:
        raise RuntimeError(f"cli_pe_chunked: walk launches {pe_chunked['launches']} "
                           f"for {pe_chunks} chunks of two mates")

    # the card's paired-end SAM equals the CPU's, plain and with the pair options
    if cuda:
        checks = []
        for variant, extra in (("plain", []),
                               ("pair_options", ["--noOrphans", "--maxFragLen", "600",
                                                 "--pairOrder"])):
            head = {}
            for name, on_cpu in (("card", False), ("cpu", True)):
                head[name] = run_cli(
                    f"cli_pe_head_{variant}_{name}",
                    ["-i", idx_dir, "-1", head_pe_fq[0], "-2", head_pe_fq[1],
                     "-o", sam(f"head_pe_{variant}_{name}.sam"), *extra], work, on_cpu)
            same = (sam_body(sam(f"head_pe_{variant}_card.sam"))
                    == sam_body(sam(f"head_pe_{variant}_cpu.sam")))
            checks.append(dict(variant=variant, argv_extra=extra, equal=same,
                               card_walk_launches=head["card"]["launches"]["anchor_walk"],
                               cpu_launches=head["cpu"]["launches"]))
        emit("cli_pe_card_equals_cpu", pairs=n_head_pe, checks=checks)
        if not all(c["equal"] and c["card_walk_launches"] >= 2
                   and not c["cpu_launches"]["anchor_walk"] for c in checks):
            raise RuntimeError("cli_pe_card_equals_cpu: the card's SAM differs from the CPU's, "
                               "the card skipped the walk kernel, or the CPU launched it")

    # the paired-end command line with the mapping score
    pe_score = run_cli(
        "cli_pe_score_default", ["-i", idx_dir, "-1", pe_fq[0], "-2", pe_fq[1],
                                 "-o", sam("ps.sam"), *default_bs, *SCORE_FLAGS],
        work, force_cpu)
    share = sam_pe_true_locus_share(sam("ps.sam"), n_pairs)
    as_check = as_tags_equal_oracle(sam("ps.sam"), idx, pc1, pc2, cli_score_cfg(idx), 1000,
                                    args.seed + 1)
    emit("cli_pe_score_default_checks", batches=pe_batches,
         primary_proper_pair_at_true_locus_share=share,
         score_filtered=pe_score["counters"].get("score_filtered", 0),
         pairs_per_s_over_cli_pe_default=pe_score["reads_per_s"] / pe_default["reads_per_s"],
         as_tags=as_check)
    if share < 0.95 or as_check["unequal"] or as_check["checked"] < min(1000, n_pairs):
        raise RuntimeError(f"cli_pe_score_default: {share:.4f} of the primary pairs at their "
                           f"true locus, or AS:i tags unequal to the oracle's: {as_check}")
    if cuda and pe_score["launches"]["banded_scores"] != pe_batches:
        raise RuntimeError(f"cli_pe_score_default: kernel launches {pe_score['launches']} for "
                           f"{pe_batches} batches")
    if cuda:
        head = {}
        for name, on_cpu in (("card", False), ("cpu", True)):
            head[name] = run_cli(
                f"cli_pe_score_head_{name}",
                ["-i", idx_dir, "-1", head_pe_fq[0], "-2", head_pe_fq[1],
                 "-o", sam(f"head_pe_score_{name}.sam"), *SCORE_FLAGS], work, on_cpu)
        same = sam_body(sam("head_pe_score_card.sam")) == sam_body(sam("head_pe_score_cpu.sam"))
        emit("cli_pe_score_card_equals_cpu", pairs=n_head_pe, equal=same,
             card_launches=head["card"]["launches"], cpu_launches=head["cpu"]["launches"])
        if (not same or head["cpu"]["launches"]["banded_scores"]
                or not head["card"]["launches"]["banded_scores"]):
            raise RuntimeError("cli_pe_score_card_equals_cpu: the card's SAM differs from the "
                               "CPU's, or the kernel ran on the CPU or not on the card")

    # the host-oracle fallback on pairs: a starved expansion pool against an
    # ample one on the repetitive world (1,024 pairs of 2 x 100 bp: the record
    # buffer, rec_slots x batch, holds 16 records a pair)
    n_rep_pe = cli_bs // 4
    rc1, rc2, _ = sample_pairs(load_index(rep_dir), np.random.default_rng(args.seed + 6),
                               n_rep_pe, 100, 0.02, 200, 400)
    rep_pe_fq = write_fastq_pairs(os.path.join(work, "repetitive_1.fq"),
                                  os.path.join(work, "repetitive_2.fq"), rc1, rc2,
                                  [np.zeros(n_rep_pe, np.int64)] * 4)
    rep_pe = {}
    for name, budget in (("starved", 1), ("ample", 64)):
        rep_pe[name] = run_cli(
            f"cli_pe_fallback_{name}",
            ["-i", rep_dir, "-1", rep_pe_fq[0], "-2", rep_pe_fq[1],
             "-o", sam(f"rep_pe_{name}.sam"), *default_bs, "--expandBudget", str(budget)],
            work, force_cpu)
    same = sam_body(sam("rep_pe_starved.sam")) == sam_body(sam("rep_pe_ample.sam"))
    n_fb = rep_pe["starved"]["counters"].get("host_fallback", 0)
    emit("cli_pe_fallback", pairs=n_rep_pe, host_fallback=n_fb, sam_equal=same,
         records=rep_pe["ample"]["counters"]["records"])
    if n_fb <= 0 or rep_pe["ample"]["counters"].get("host_fallback", 0) or not same:
        raise RuntimeError("cli_pe_fallback: no fallback with the starved budget, fallback "
                           "with the ample one, or the two SAM files differ")
    if cuda and min(r["launches"]["anchor_walk"] for r in rep_pe.values()) < 2:
        raise RuntimeError("cli_pe_fallback: the walk kernel was not launched for both mates")

    # ---- pseudo-mapping: pseudoindex / pseudomap on the same world -----------
    # the port's build of the world's FASTA, saved for the command line; the
    # same index without its CHD (binary-search probe, explicit lanes) and in
    # the big-occ layout must map every read as it does
    from rapmap_tpu_torch.index.builder import build_pseudo_index
    from rapmap_tpu_torch.models.pseudo import PseudoMapper

    pidx_dir = os.path.join(work, "pidx")
    t0 = time.time()
    pidx = build_pseudo_index(os.path.join(work, "txome.fa"), pidx_dir, k=K)
    pbuild_s = time.time() - t0
    pcfg = MapConfig(k=K, chunk=C)
    pups = {}
    for name, ix, kw in (("chd", pidx, {}), ("nochd", without_chd(pidx), {}),
                         ("bigocc", pidx, dict(force_big_occ=True))):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.time()
        m = PseudoMapper(ix, pcfg, device=dev, **kw)
        if cuda:
            torch.cuda.synchronize()
        pups[name] = (m, time.time() - t0)
    pmap, npmap, bpmap = (pups[n][0] for n in ("chd", "nochd", "bigocc"))
    emit("pseudo_world", kmers=len(pidx.kmer_hi), occurrences=int(pidx.kmer_off[-1]),
         chd=pidx.meta.get("chd"), index_build_s=pbuild_s,
         expand_budget=pmap.cfg.expand_budget,
         uploads={name: dict(upload_s=t, device_index_bytes=didx_bytes(m.didx),
                             occ_pairs=m.st.occ_pairs, chd_canonical=m.st.chd_canonical,
                             lookup_steps=m.st.lookup_steps,
                             tensors={f: didx_bytes([getattr(m.didx, f)])
                                      for f in m.didx._fields if getattr(m.didx, f) is not None})
                  for name, (m, t) in pups.items()})
    if not pmap.st.chd_canonical or npmap.st.use_chd or not bpmap.st.occ_pairs:
        raise RuntimeError("pseudo_world: an upload is not of the kind asked for")
    del pups

    ps_ok, ps_err, ps_t = phase_pseudo_walk_kernel(dev, timer, pmap, npmap, work, codes, lens, C,
                                                   args.seed)
    if not ps_ok:
        raise RuntimeError("pseudo_walk kernel disagrees with its plain version, or an input "
                           "set missed what it is there to exercise")

    if cuda:  # the peak of the three pseudo uploads and the pseudo path
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    ps_results, wall = library_path(pmap, codes, lens, B, BATCHES, cuda)
    ps_launches = dict(kernels.LAUNCHES)
    ps_peak = torch.cuda.max_memory_allocated() if cuda else "not measured"
    pctr_s = {k: sum(r.counters[k] for r in ps_results) for k in ps_results[0].counters}
    ps_rate = pctr_s["reads_mapped"] / pctr_s["reads_total"]
    ps_oracle = pseudo_oracle_unequal(ps_results, pidx, codes, None, lens, None, pmap.cfg, B,
                                      min(1000, args.reads), args.seed + 21)
    prof = profile_one_batch(lambda: pmap.fetch(pmap.map_se_async(codes[:B], lens[:B])),
                             B // C, cuda, 8)
    emit("pseudo_path", reads=args.reads, batches=BATCHES, batch=B, chunks=n_chunks,
         seconds=wall, reads_per_s=args.reads / wall, map_rate=ps_rate,
         true_locus_share=float(np.mean([true_locus_share(r, truth, i * B, (i + 1) * B)
                                         for i, r in enumerate(ps_results)])),
         counters=pctr_s, launches=ps_launches, launches_per_chunk=prof["launches_per_chunk"],
         device_busy_ms=prof["device_busy_ms"], device_idle_share=prof["device_idle_share"],
         top_kernels=prof["top_kernels"], hand_kernels=prof["hand_kernels"],
         oracle=ps_oracle, max_memory_allocated=ps_peak)
    if cuda and (ps_launches["pseudo_walk"] < n_chunks or ps_launches["anchor_walk"]
                 or ps_launches["bitonic_sort_pairs"]):
        raise RuntimeError(f"pseudo_path: kernel launches {ps_launches} for {n_chunks} chunks")
    if ps_rate < 0.9 or ps_oracle["unequal"] or ps_oracle["checked"] < 0.9 * min(1000, args.reads):
        raise RuntimeError(f"pseudo_path: map rate {ps_rate:.4f} below 0.9, or sampled reads "
                           f"unequal to the oracle's: {ps_oracle}")
    for r in ps_results:
        if r.recs.shape[1] != 4 or len(r.recs) != r.total or r.overflowed:
            raise RuntimeError("pseudo_path: malformed wire result")

    ps_other = {}
    for name, m, kernel in (("pseudo_nochd_path", npmap, "pseudo_walk_lanes"),
                            ("pseudo_bigocc_path", bpmap, "pseudo_walk")):
        kernels.reset_launches()
        t0 = time.time()
        got = m.fetch(m.map_se_async(codes[:B], lens[:B]))
        if cuda:
            torch.cuda.synchronize()
        wall = time.time() - t0
        ps_other[name] = dict(kernels.LAUNCHES)
        same = same_result(got, ps_results[0])
        emit(name, reads=B, chunks=B // C, seconds=wall, reads_per_s=B / wall,
             equal_pseudo_path_first_batch=same, launches=ps_other[name])
        other = "pseudo_walk" if kernel == "pseudo_walk_lanes" else "pseudo_walk_lanes"
        if not same or (cuda and (ps_other[name][kernel] < B // C or ps_other[name][other])):
            raise RuntimeError(f"{name}: the batch differs from pseudo_path's first batch, or "
                               f"kernel launches {ps_other[name]}")
        del got
    ps_ref = ps_results[0]  # the staged pseudo path's reference
    del ps_results, npmap, bpmap

    # pairs: unchunked batches of 4,096 (the reference has no chunked pseudo
    # PE program), one in flight
    n_ps_pairs = min(32_768, n_pairs)
    PSB = n_ps_pairs // 8
    kernels.reset_launches()
    ps_pe, t0 = [], time.time()
    pending = pmap.map_pe_async(pc1[:PSB], plens[:PSB], pc2[:PSB], plens[:PSB])
    for b in range(1, 9):
        rows = slice(b * PSB, (b + 1) * PSB)
        nxt = pmap.map_pe_async(pc1[rows], plens[rows], pc2[rows], plens[rows]) if b < 8 else None
        ps_pe.append(pmap.fetch(pending))
        pending = nxt
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    ps_pe_launches = dict(kernels.LAUNCHES)
    pctr_p = {k: sum(r.counters[k] for r in ps_pe) for k in ps_pe[0].counters}
    shares = [pair_shares(r, ptruth, i * PSB, (i + 1) * PSB) for i, r in enumerate(ps_pe)]
    pe_oracle = pseudo_oracle_unequal(ps_pe, pidx, pc1, pc2, plens, plens, pmap.cfg, PSB,
                                      min(500, n_ps_pairs), args.seed + 22)
    prof = profile_one_batch(lambda: pmap.fetch(pmap.map_pe_async(
        pc1[:PSB], plens[:PSB], pc2[:PSB], plens[:PSB])), 1, cuda, 8)
    emit("pseudo_pe_path", pairs=n_ps_pairs, batches=8, batch=PSB, seconds=wall,
         pairs_per_s=n_ps_pairs / wall, map_rate=pctr_p["reads_mapped"] / pctr_p["reads_total"],
         concordant_share=float(np.mean([x[0] for x in shares])),
         concordant_at_true_locus_share=float(np.mean([x[1] for x in shares])),
         counters=pctr_p, launches=ps_pe_launches, launches_per_batch=prof["launches_per_chunk"],
         device_busy_ms=prof["device_busy_ms"], device_idle_share=prof["device_idle_share"],
         oracle=pe_oracle)
    if cuda and ps_pe_launches["pseudo_walk"] < 2 * 8:
        raise RuntimeError(f"pseudo_pe_path: kernel launches {ps_pe_launches} for 8 batches "
                           "of two mates")
    if (pctr_p["reads_mapped"] < 0.9 * pctr_p["reads_total"] or pe_oracle["unequal"]
            or pe_oracle["checked"] < 0.9 * min(500, n_ps_pairs)):
        raise RuntimeError(f"pseudo_pe_path: map rate below 0.9, or sampled pairs unequal to "
                           f"the oracle's: {pe_oracle}")
    for r in ps_pe:
        if r.recs.shape[1] != 7 or len(r.recs) != r.total or r.overflowed:
            raise RuntimeError("pseudo_pe_path: malformed wire result")
    del ps_pe, pmap
    if cuda:
        torch.cuda.empty_cache()

    # the command line's pseudomap: every read and pair at the default
    # flags, then the heads on the card and on the CPU
    cli_ps = run_cli("cli_pseudo_default", ["-i", pidx_dir, "-r", reads_fq, "-o", sam("q.sam"),
                                            *default_bs], work, force_cpu, cmd="pseudomap")
    cli_ps_pe = run_cli("cli_pseudo_pe_default", ["-i", pidx_dir, "-1", pe_fq[0], "-2", pe_fq[1],
                                                  "-o", sam("qp.sam"), *default_bs],
                        work, force_cpu, cmd="pseudomap")
    emit("cli_pseudo_default_checks", batches=n_batches, pe_batches=pe_batches,
         primary_at_true_locus_share=sam_true_locus_share(sam("q.sam"), args.reads),
         reads_mapped_pseudo_path=pctr_s["reads_mapped"],
         reads_per_s_over_cli_default=cli_ps["reads_per_s"] / cli_default["reads_per_s"],
         pairs_per_s_over_cli_pe_default=cli_ps_pe["reads_per_s"] / pe_default["reads_per_s"])
    if (cli_ps["counters"]["reads_mapped"] != pctr_s["reads_mapped"] or cli_ps["map_rate"] < 0.9
            or cli_ps_pe["map_rate"] < 0.9):
        raise RuntimeError("cli_pseudo_default: reads mapped unequal to pseudo_path's, or a map "
                           "rate below 0.9")
    if cuda and (cli_ps["launches"]["pseudo_walk"] != n_batches
                 or cli_ps_pe["launches"]["pseudo_walk"] != 2 * pe_batches):
        raise RuntimeError(f"cli_pseudo_default: walk launches {cli_ps['launches']}, "
                           f"{cli_ps_pe['launches']} for {n_batches} and {pe_batches} batches")
    cli_ps_heads = {}
    if cuda:  # the heads on the CPU against the same reads of the card's runs
        checks = []
        for ends, argv, card_sam, n in (
                ("single", ["-r", head_fq], "q.sam", n_head),
                ("paired", ["-1", head_pe_fq[0], "-2", head_pe_fq[1]], "qp.sam", n_head_pe)):
            phase = f"cli_pseudo_head_{ends}_cpu"
            head = run_cli(phase, ["-i", pidx_dir, *argv, "-o", sam(f"{phase}.sam")], work, True,
                           cmd="pseudomap")
            cli_ps_heads[phase] = head["launches"]
            card = [ln for ln in sam_body(sam(card_sam))
                    if ln[0] == "@" or int(ln.split(":", 1)[0][1:]) < n]
            checks.append(dict(ends=ends, reads=n, equal=sam_body(sam(f"{phase}.sam")) == card,
                               cpu_launches=sum(head["launches"].values())))
        emit("cli_pseudo_card_equals_cpu", checks=checks)
        if not all(c["equal"] and not c["cpu_launches"] for c in checks):
            raise RuntimeError("cli_pseudo_card_equals_cpu: the card's SAM differs from the "
                               "CPU's on the same reads, or the CPU launched a kernel")
    # ---- the host-staged engine and the compact index artifacts -------------
    # the anchor-parallel extension against its plain version; the core and
    # mapping-only artifacts of the world's index; the staged engine on the
    # card (8 shards, batches of 32,768) against the replicated engine's
    # results; then the command line on the artifacts and the staged engine,
    # on the head reads, against the replicated runs' SAM of the same reads
    if cuda:
        torch.cuda.empty_cache()
    anch_ok, anch_err, anch_t = phase_anchor_kernel(dev, timer, idx, codes, lens, B, args.seed)
    if not anch_ok:
        raise RuntimeError("extend_packed_anchors kernel disagrees with its plain version, or "
                           "an input set missed what it is there to exercise")
    midx, map_dir, _ = phase_artifacts(dev, idx, cfg, codes, lens, B, main_results, work, cuda)
    staged_launches = phase_staged(
        dev, idx, midx, cfg, codes, lens, B,
        dict(se=main_results[:2], pe=pe_ref, score=score_ref, pseudo=ps_ref),
        pidx, pcfg, pc1, pc2, plens, cuda)
    del midx, main_results, pe_ref, score_ref, ps_ref
    from rapmap_tpu_torch import cli as port_cli

    rep_core = os.path.join(work, "repetitive_core_idx")
    t0 = time.time()
    if port_cli.main(["quasiindex", "-t", os.path.join(work, "repetitive.fa"), "-i", rep_core,
                      "-k", str(K), "--coreIndex"]) != 0:
        raise RuntimeError("cli_core_default: quasiindex --coreIndex failed")
    core_build_s = time.time() - t0
    staged_cli = {}
    for phase, argv, cmd, want in (
            ("cli_core_default", ["-i", rep_core, "-r", rep_fq, *default_bs,
                                  "--expandBudget", "64"], "quasimap",
             sam_body(sam("rep_ample.sam"))),
            ("cli_map_artifact", ["-i", map_dir, "-r", head_fq], "quasimap",
             head_of(sam("a.sam"), n_head)),
            ("cli_staged_default", ["-i", idx_dir, "-r", head_fq, "--engine", "staged"],
             "quasimap", head_of(sam("a.sam"), n_head)),
            ("cli_pe_staged_default", ["-i", idx_dir, "-1", head_pe_fq[0], "-2", head_pe_fq[1],
                                       "--engine", "staged"], "quasimap",
             head_of(sam("pa.sam"), n_head_pe)),
            ("cli_pseudo_staged_default", ["-i", pidx_dir, "-r", head_fq, "--engine", "staged"],
             "pseudomap", head_of(sam("q.sam"), n_head))):
        r = run_cli(phase, [*argv, "-o", sam(f"{phase}.sam")], work, force_cpu, cmd=cmd)
        same = sam_body(sam(f"{phase}.sam")) == want
        staged_cli[phase] = r["launches"]
        emit(f"{phase}_checks", sam_equals_replicated=same,
             **(dict(core_index_build_s=core_build_s, core_bytes=dir_bytes(rep_core))
                if phase == "cli_core_default" else {}))
        if not same:
            raise RuntimeError(f"{phase}: SAM differs from the replicated engine's")
        quasi_staged = phase in ("cli_map_artifact", "cli_staged_default",
                                 "cli_pe_staged_default")
        if cuda and quasi_staged != bool(r["launches"]["extend_packed_anchors"]):
            raise RuntimeError(f"{phase}: kernel launches {r['launches']}")
    # the int64-SA layout on the staged engine, and the genome-scale script
    if cuda:
        torch.cuda.empty_cache()
    staged_cli.update(phase_staged_bigsa(dev, cfg, work, B, min(2000, args.txps), args.seed,
                                         cuda, force_cpu, cli_bs))
    staged_path_launches = {**staged_launches, **staged_cli}
    # the production-scale transcriptome's script (BASELINE.json config 4)
    if cuda:
        torch.cuda.empty_cache()
    scale_launches = phase_scale_world(work, cuda)
    # bench.py's primary regime, the isoform transcriptome, and the accuracy protocol
    if cuda:
        torch.cuda.empty_cache()
    iso_launches = phase_isoform_world(work, cuda)

    # ---- data parallel, the SA-sharded engine, two command-line ranks -------
    # two replicas on the card against the single-device program; the
    # sharded walk against its plain version; the world's index in SHARDS
    # shards on the card against the replicated engine; then two ranks of
    # the command line as processes against the single-process runs above
    if cuda:
        torch.cuda.empty_cache()
    qm = QuasiMapper(idx, cfg, device=dev)
    dp_launches = phase_dp(dev, qm, codes, lens, pc1, pc2, plens, B, cuda)
    k8_ok, k8_err, k8_t, sh_worlds = phase_sharded_kernel(dev, timer, idx, qm, codes, lens, C,
                                                          B, args.seed)
    if not k8_ok:
        raise RuntimeError("sharded_walk kernel disagrees with its plain version, or an input "
                           "set missed what it is there to exercise")
    sh_launches, sh_results = phase_sharded(dev, qm, sh_worlds, codes, lens, pc1, pc2, plens, B,
                                            cuda)
    # the split path: K10 and K11 against their plain versions, then a twin
    # of each sharded phase with every data row's shards uploaded on their own
    trip_ok, _, trip_t = phase_trip_kernel(dev, timer, sh_worlds, codes, lens, B)
    if not trip_ok:
        raise RuntimeError("sharded_trip or sharded_advance disagrees with its plain version, "
                           "or an input set missed what it is there to exercise")
    sh_launches.update(phase_sharded_split(dev, qm, sh_worlds, sh_results, B, cuda))
    del qm, sh_worlds, sh_results
    if cuda:
        torch.cuda.empty_cache()
    phase_cli_world2(idx_dir, work, {
        "se": (["-r", reads_fq], sam("a.sam"), os.path.join(work, "cli_default.json"), cli_bs),
        "pe": (["-1", pe_fq[0], "-2", pe_fq[1]], sam("pa.sam"),
               os.path.join(work, "cli_pe_default.json"), cli_bs)}, force_cpu)
    par_path_launches = {**dp_launches, **sh_launches}

    def on_par(kernel):
        return {path: n[kernel] for path, n in par_path_launches.items()}

    def on_staged(kernel):
        return {path: n[kernel] for path, n in staged_path_launches.items()}

    def on_scale(kernel):
        return {path: n.get(kernel, 0) for path, n in scale_launches.items()}

    def on_iso(kernel):
        return {path: n.get(kernel, 0) for path, n in iso_launches.items()}

    cli_launches = {"cli_default": cli_default["launches"], "cli_chunked": cli_chunked["launches"],
                    "cli_fallback_starved": rep["starved"]["launches"],
                    "cli_fallback_ample": rep["ample"]["launches"],
                    "cli_score_default": cli_score["launches"]}
    pe_path_launches = {"pe_path": pe_launches, "cli_pe_default": pe_default["launches"],
                        "cli_pe_chunked": pe_chunked["launches"],
                        "cli_pe_fallback_starved": rep_pe["starved"]["launches"],
                        "cli_pe_fallback_ample": rep_pe["ample"]["launches"],
                        "pe_score_path": pe_score_launches,
                        "cli_pe_score_default": pe_score["launches"]}

    def on_pe(kernel):
        return {path: n[kernel] for path, n in pe_path_launches.items()}

    def on_cli(kernel):
        return {path: n[kernel] for path, n in cli_launches.items()}

    ps_path_launches = {"pseudo_path": ps_launches, **ps_other,
                        "pseudo_pe_path": ps_pe_launches,
                        "cli_pseudo_default": cli_ps["launches"],
                        "cli_pseudo_pe_default": cli_ps_pe["launches"], **cli_ps_heads}

    def on_ps(kernel):
        return {path: n[kernel] for path, n in ps_path_launches.items()}

    emit("run", seconds=time.time() - t_start)
    print(json.dumps({"kernels": [{
        "name": "bitonic_sort_pairs", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/sort2.cu",
        "replaces": "rapmap_tpu/ops/pallas/sort2.py:153",
        "launches": launches["bitonic_sort_pairs"],
        "launches_on_cli_paths": on_cli("bitonic_sort_pairs"),
        "launches_on_pe_paths": on_pe("bitonic_sort_pairs"),
        "launches_on_pseudo_paths": on_ps("bitonic_sort_pairs"),
        "launches_on_scale_paths": on_scale("bitonic_sort_pairs"),
        "launches_on_isoform_paths": on_iso("bitonic_sort_pairs"), "max_abs_err": sort_err,
        "matches_plain": sort_ok, "ms": sort_t["ms"], "wrapper_ms": sort_t["wrapper_ms"],
        "plain_ms": sort_t["plain_ms"], "bound_ms": sort_t["bound_ms"],
        "bound_by": sort_t["bound_by"], "bytes_bound_ms": sort_t["bytes_bound_ms"],
        "operations_bound_ms": sort_t["operations_bound_ms"], "library_ms": sort_t["library_ms"],
        "library_wrapper_ms": sort_t["library_wrapper_ms"],
    }, {
        "name": "anchor_walk", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/ops/mmp.py:190",
        "launches": launches["anchor_walk"],
        "launches_on_cli_paths": on_cli("anchor_walk"),
        "launches_on_pe_paths": on_pe("anchor_walk"),
        "launches_on_pseudo_paths": on_ps("anchor_walk"),
        "launches_on_scale_paths": on_scale("anchor_walk"),
        "launches_on_isoform_paths": on_iso("anchor_walk"), "max_abs_err": walk_err,
        "matches_plain": walk_ok, "ms": walk_t["ms"], "cold_ms": walk_t["cold_ms"],
        "wrapper_ms": walk_t["wrapper_ms"], "plain_ms": walk_t["plain_ms"],
        "bound_ms": walk_t["bound_ms"], "bound_by": walk_t["bound_by"], "library_ms": None,
    }, {
        "name": "anchor_walk_lanes", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/ops/mmp.py:419",
        "launches": nochd_launches["anchor_walk_lanes"],
        "launches_on_other_paths": {
            "nochd_pe_path": nochd_pe_launches["anchor_walk_lanes"],
            "cli_nochd_default": cli_nochd["launches"]["anchor_walk_lanes"],
            "cli_pe_nochd_default": pe_nochd["launches"]["anchor_walk_lanes"]},
        "launches_on_cli_paths": on_cli("anchor_walk_lanes"),
        "launches_on_pe_paths": on_pe("anchor_walk_lanes"), "max_abs_err": lanes_err,
        "matches_plain": lanes_ok, "ms": lanes_t["ms"], "cold_ms": lanes_t["cold_ms"],
        "wrapper_ms": lanes_t["wrapper_ms"], "plain_ms": lanes_t["plain_ms"],
        "bound_ms": lanes_t["bound_ms"], "bound_by": lanes_t["bound_by"], "library_ms": None,
    }, {
        "name": "anchor_walk_charwise", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/ops/mmp.py:74",
        "launches": charwise_launches["anchor_walk_charwise"],
        "launches_on_cli_paths": on_cli("anchor_walk_charwise"),
        "launches_on_pe_paths": on_pe("anchor_walk_charwise"), "max_abs_err": char_err,
        "matches_plain": char_ok, "ms": char_t["paired_chunk"]["ms"],
        "cold_ms": char_t["paired_chunk"]["cold_ms"],
        "wrapper_ms": char_t["paired_chunk"]["wrapper_ms"],
        "plain_ms": char_t["paired_chunk"]["plain_ms"],
        "bound_ms": char_t["paired_chunk"]["bound_ms"],
        "bound_by": char_t["paired_chunk"]["bound_by"], "library_ms": None,
        "lanes_mode": {x: char_t["lanes_chunk"][x] for x in
                       ("ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
    }, {
        "name": "banded_scores", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/align.cu",
        "replaces": "rapmap_tpu/ops/align.py:111",
        "launches": score_launches["banded_scores"],
        "launches_on_cli_paths": on_cli("banded_scores"),
        "launches_on_pe_paths": on_pe("banded_scores"),
        "launches_on_isoform_paths": on_iso("banded_scores"), "max_abs_err": score_err,
        "matches_plain": score_ok, "ms": score_t["ms"], "cold_ms": score_t["cold_ms"],
        "wrapper_ms": score_t["wrapper_ms"], "plain_ms": score_t["plain_ms"],
        "bound_ms": score_t["bound_ms"], "bound_by": score_t["bound_by"], "library_ms": None,
    }, {
        "name": "pseudo_walk", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/models/pseudo.py:353",
        "launches": ps_launches["pseudo_walk"],
        "launches_on_pseudo_paths": on_ps("pseudo_walk"), "max_abs_err": ps_err,
        "matches_plain": ps_ok, **{x: ps_t["paired"][x] for x in (
            "ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "pseudo_walk_lanes", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/models/pseudo.py:268",
        "launches": ps_other["pseudo_nochd_path"]["pseudo_walk_lanes"],
        "launches_on_pseudo_paths": on_ps("pseudo_walk_lanes"), "max_abs_err": ps_err,
        "matches_plain": ps_ok, **{x: ps_t["lanes"][x] for x in (
            "ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "extend_packed_anchors", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/ops/extend_packed.py:286",
        "launches": staged_launches["staged_path"]["extend_packed_anchors"],
        "launches_on_staged_paths": on_staged("extend_packed_anchors"),
        "launches_on_cli_paths": on_cli("extend_packed_anchors"),
        "launches_on_pe_paths": on_pe("extend_packed_anchors"),
        "launches_on_pseudo_paths": on_ps("extend_packed_anchors"), "max_abs_err": anch_err,
        "matches_plain": anch_ok, **{x: anch_t[x] for x in (
            "ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "sharded_walk", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/parallel/sharded.py:619",
        "launches": sh_launches["sharded_path"]["sharded_walk"],
        "launches_on_parallel_paths": on_par("sharded_walk"),
        "launches_on_scale_paths": on_scale("sharded_walk"),
        "max_abs_err": k8_err, "matches_plain": k8_ok, **{x: k8_t["paired_row"][x] for x in (
            "ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "sharded_walk_lanes", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/parallel/sharded.py:469",
        "launches": sh_launches["sharded_lanes_path"]["sharded_walk_lanes"],
        "launches_on_parallel_paths": on_par("sharded_walk_lanes"),
        "max_abs_err": k8_err, "matches_plain": k8_ok, **{x: k8_t["lanes_row"][x] for x in (
            "ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "sharded_trip", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/parallel/sharded.py:583",
        "launches": sh_launches["sharded_split_path"]["sharded_trip"],
        "launches_on_parallel_paths": on_par("sharded_trip"),
        "max_abs_err": trip_t["k10_err"], "matches_plain": trip_t["k10_ok"],
        "timed_as": "mean per launch over the first trip's shards of one data row's program",
        **{x: trip_t["k10"]["first"][x] for x in (
            "ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        **{f"{name}_trip": {x: v[x] for x in ("ms", "cold_ms", "wrapper_ms", "plain_ms",
                                              "bound_ms", "bound_by")}
           for name, v in trip_t["k10"].items() if name != "first"},
    }, {
        "name": "sharded_advance", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/walk.cu",
        "replaces": "rapmap_tpu/parallel/sharded.py:600",
        "launches": sh_launches["sharded_split_path"]["sharded_advance"],
        "launches_on_parallel_paths": on_par("sharded_advance"),
        "max_abs_err": trip_t["k11_err"], "matches_plain": trip_t["k11_ok"],
        "timed_as": "the advance after the first trip of one data row's program",
        **{x: trip_t["k11"]["first_trip"][x] for x in (
            "ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        **{name: {x: v[x] for x in ("ms", "cold_ms", "wrapper_ms", "plain_ms", "bound_ms",
                                    "bound_by")}
           for name, v in trip_t["k11"].items() if name != "first_trip"},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if cuda else "cpu", "kind": kind,
        "count": torch.cuda.device_count() if cuda else 0,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
