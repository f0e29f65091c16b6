#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rapmap_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Builds the port's native index library and every CUDA kernel from the
sources in this checkout, holds each kernel against its plain PyTorch
version on the card, builds a 20 Mbp random transcriptome world from the
seed, maps 262,144 single-end 76 bp reads through QuasiMapper.map_se_async /
fetch (one batch in flight), and checks the result: map rate, reads mapped
to their true locus, the sort kernel's launches on the main path, and the
card's wire buffer equal to the CPU's on the first batch. Every phase prints
one JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero, printing no result, without a CUDA card or without the
rest of the repository beside it.

--cpu-rehearsal (with --txps/--reads small) runs the same phases on the CPU
with the plain versions, to check the script's control flow off the card.
"""

from __future__ import annotations

import argparse
import json
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
    the same card tensors, and its timing at the main path's N."""
    import torch

    from rapmap_tpu_torch.ops.sort2 import bitonic_sort_pairs, bitonic_sort_pairs_plain

    rng = np.random.default_rng(1)
    checks = []
    max_err = 0
    for n in (1024, 65536, 1 << 20):
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
            checks.append(dict(n=n, data=kind, equal_plain=err == 0, equal_lexsort=lex_ok))
    ok = all(c["equal_plain"] and c["equal_lexsort"] for c in checks)

    n = 65536  # expand_budget 8 x chunk 8192: the voting pool of one chunk
    h, l = sort_inputs(n, "random", rng)
    hi = torch.from_numpy(h).to(dev)
    lo = torch.from_numpy(l).to(dev)
    key = (hi.long() & 0xFFFFFFFF) << 32 | (lo.long() & 0xFFFFFFFF)
    ms = timer(lambda: bitonic_sort_pairs(hi, lo), reps=200)
    plain_ms = timer(lambda: bitonic_sort_pairs_plain(hi, lo), reps=5, warm=1)
    library_ms = timer(lambda: torch.sort(key), reps=200)
    log2n = n.bit_length() - 1
    nbytes = 16 * n                         # read hi, lo once; write them once
    ops = (n // 2) * log2n * (log2n + 1) // 2  # 64-bit compare-exchanges
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    timing = dict(
        n=n, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, compare_exchanges=ops,
    )
    emit("kernel_vs_plain", kernel="bitonic_sort_pairs", ok=ok, max_abs_err=max_err,
         checks=checks, timing=timing)
    return ok, max_err, timing


def build_world(seed: int, n_txps: int, n_reads: int, workdir: str):
    """Random transcriptome (500-3,500 bp transcripts), the port's quasi
    index (k=31, canonical CHD), and reads sampled at known
    (transcript, position, strand) with 1% substitutions, half reverse-
    complemented."""
    from rapmap_tpu_torch.index.builder import build_quasi_index

    rng = np.random.default_rng(seed)
    lens = rng.integers(500, 3501, n_txps)
    fa = os.path.join(workdir, "txome.fa")
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(fa, "w") as f:
        for i, ln in enumerate(lens):
            f.write(f">t{i}\n{bases[rng.integers(0, 4, int(ln))].tobytes().decode()}\n")
    t0 = time.time()
    idx = build_quasi_index(fa, k=K)
    build_s = time.time() - t0

    tl = np.asarray(idx.txp_lens, dtype=np.int64)
    span = tl - READ_LEN + 1
    t = rng.choice(len(tl), size=n_reads, p=span / span.sum())
    pos = (rng.random(n_reads) * span[t]).astype(np.int64)
    start = np.asarray(idx.txp_offsets, dtype=np.int64)[t] + pos
    codes = np.asarray(idx.text)[start[:, None] + np.arange(READ_LEN)[None, :]].astype(np.int8)
    err = rng.random(codes.shape) < 0.01
    codes[err] = rng.integers(1, 5, int(err.sum()))
    strand = (rng.random(n_reads) < 0.5).astype(np.int64)
    rc = strand == 1
    codes[rc] = (5 - codes[rc])[:, ::-1]
    lens_r = np.full(n_reads, READ_LEN, np.int32)
    return idx, codes, lens_r, (t, pos, strand), build_s


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
    scan and collate stages."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rapmap_tpu_torch.ops.collate import collate_records_se
    from rapmap_tpu_torch.ops.mmp import scan_dispatch
    from rapmap_tpu_torch.ops.wire import rec_spec_se

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        mapper.fetch(mapper.map_se_async(codes, lens))
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name: dict[str, list] = {}
    for e in kern:
        v = by_name.setdefault(e.name[:80], [0.0, 0])
        v[0] += e.time_range.elapsed_us() / 1e3
        v[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]

    dev = mapper.device
    r = torch.from_numpy(codes[:C]).to(dev)
    ln = torch.from_numpy(lens[:C].astype(np.int64)).to(dev)
    spec = rec_spec_se(mapper.st, mapper.cfg)
    stage = {}
    for _ in range(2):  # second pass is the one kept (warm)
        sync()
        t0 = time.perf_counter()
        hits = scan_dispatch(mapper.didx, mapper.st, r, ln, mapper.cfg)
        sync()
        t1 = time.perf_counter()
        collate_records_se(mapper.didx, mapper.st, hits, ln, mapper.cfg,
                           mapper.cfg.rec_slots * C, rec_spec=spec)
        sync()
        stage = dict(scan_ms=(t1 - t0) * 1e3, collate_ms=(time.perf_counter() - t1) * 1e3)
    return dict(
        batch_wall_ms=wall_ms,
        device_busy_ms=busy_ms if kern else "not measured",
        device_idle_share=1.0 - busy_ms / wall_ms if kern else "not measured",
        kernel_launches=len(kern), launches_per_chunk=len(kern) / (len(codes) // C),
        top_kernels=[dict(name=n, ms=v[0], count=v[1]) for n, v in top],
        chunk_stages=stage,
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
    if cuda and launches["bitonic_sort_pairs"] < n_chunks:
        raise RuntimeError(f"sort kernel launched {launches} times for {n_chunks} chunks")
    if map_rate < 0.9:
        raise RuntimeError(f"map rate {map_rate:.4f} below 0.9")
    for r in results:
        if r.recs.shape[1] != 4 or len(r.recs) != r.total or r.overflowed:
            raise RuntimeError("malformed wire result")

    emit("profile", **profile_batch(mapper, codes[:B], lens[:B], C, cuda))

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

    print(json.dumps({"kernels": [{
        "name": "bitonic_sort_pairs", "route": "cuda",
        "source": "rapmap_tpu_torch/csrc/sort2.cu",
        "replaces": "rapmap_tpu/ops/pallas/sort2.py:153",
        "launches": launches["bitonic_sort_pairs"], "max_abs_err": sort_err,
        "matches_plain": sort_ok, "ms": sort_t["ms"], "kernel_ms": sort_t["ms"],
        "plain_ms": sort_t["plain_ms"], "bound_ms": sort_t["bound_ms"],
        "bound_by": sort_t["bound_by"], "library_ms": sort_t["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if cuda else "cpu", "kind": kind,
        "count": torch.cuda.device_count() if cuda else 0,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
