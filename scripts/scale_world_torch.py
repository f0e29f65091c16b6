#!/usr/bin/env python3
"""The production-scale transcriptome on one CUDA card (BASELINE.json config
4, "full human transcriptome index, PE 76bp at production batch sizes"):
the twin of scripts/bench_scale.py, SE and --pe, and of
scripts/demo_sharded_scale.py for rapmap_tpu_torch.

The world is bench_scale.py's, byte for byte (its build_scale_world and
build_scale_pe are copied here, not imported: that script configures JAX):
a synthetic transcriptome of lognormal lengths (seed 11) of --mbase Mbase,
indexed by rapmap_tpu_torch's build_quasi_index at k = 31 with the canonical
CHD, N_READS 76 bp reads (seed 12, 1% substitutions, the first half
reverse-complemented) and N_READS / 2 inward pairs from 250 bp fragments
(seed 13). On it, under bench.py's bench_cfg (chunk 8,192, 4 hit slots,
expansion budget 3, 2 record slots, 16 records a read):

- the library runs: QuasiMapper on the lean upload, SE over every read and
  PE over every pair in batches of --batch with up to --depth in flight, as
  bench_scale.py's loop; one more SE pass with bitonic_sort=True (K1), which
  needs a power-of-two voting pool, so it runs at expansion budget 4 and is
  held to its twin at budget 4 without the bitonic sort, batch for batch;
- the plain versions: one SE and one PE batch mapped again with
  device="cpu" on the same index, int32 for int32 equal to the card's;
- the kernels of the path on card tensors against their plain versions: K1
  at the bitonic pass's pool, K2+K3 (anchor_walk) on one chunk of SE reads
  and one of mate-2 reads, with the SE chunk's warm and cold device time
  and counted byte bound; K8 (sharded_walk) on a data row of --sharded;
- the oracle: the reads and pairs that the wire flags go through the host
  fallback (models/fallback.py remap_se, remap_pe), as the command line
  does, and a sample drawn from every batch must then equal
  oracle/quasimap.py map_read / map_pair record for record;
- --cli: the reads and pairs as FASTQ through `python -m
  rapmap_tpu_torch.cli quasimap --engine auto --batchSize <batch>
  --statsJson --profile` as child processes (SE, then -1/-2), each of which
  must pick the replicated engine and write, for every read and pair, the
  SAM lines that the library's records after the fallback give;
- --sharded: demo_sharded_scale.py on this index: shard_quasi_index(idx, 2,
  slot64=True), a 2 x 2 mesh on the one device, the demo's 96 reads (seed
  17) through map_batch_se_sharded, every read equal to the oracle.

Before the build a preflight reckons the host's and the card's peaks and
the disk the run writes against MemAvailable, the card's free memory and
the free space of --workdir; when one is short it prints one JSON line with
"skipped", the figures and the plan, and exits 2. It never maps a smaller
world instead. Run alone.

    python3 scripts/scale_world_torch.py [--mbase 100] [--reads 393216]
        [--batch 65536] [--depth 6] [--oracle-sample 4096] [--sharded] [--cli] [--workdir build/scale] [--json-out PATH]
        [--device cuda|cpu]

On the CPU (plain versions of every kernel), at a toy size:
    python3 scripts/scale_world_torch.py --device cpu --mbase 0.05
        --reads 512 --batch 256 --sharded --cli

The last line of standard output is the run's JSON record (exit 0 when
every check held, 1 when one failed or there is no card).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import io
import json
import logging
import os
import re
import subprocess
import sys
import time
from collections import deque
from contextlib import contextmanager

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (ROOT, HERE) if p not in sys.path]

from genome_scale_torch import (  # noqa: E402
    MemWatch, cli_profile, disk_free_bytes, log, mem_available_bytes, rss_gb, run_child,
)

READ_LEN = 76
CHUNK = 8192          # bench.py's CHUNK (TQM_CHUNK unset)
N_DATA, N_IDX = 2, 2  # demo_sharded_scale.py's mesh
N_SHARDED_READS = 96  # demo_sharded_scale.py's N_READS
GIB = 2**30


# ---- the world: scripts/bench_scale.py's build_scale_world and build_scale_pe ----


def build_scale_world(cache: str, target_mbase: float, n_reads: int, rec: dict):
    """bench_scale.py's build_scale_world with its module constants as
    arguments (CACHE, TARGET_MBASE, N_READS) and the port's builder; the
    build's seconds by stage, its peak RSS and the load go into `rec`."""
    from rapmap_tpu_torch.index.builder import build_quasi_index
    from rapmap_tpu_torch.index.format import load_index

    os.makedirs(cache, exist_ok=True)
    idx_dir = os.path.join(cache, "idx_scale_v1")
    if not os.path.exists(os.path.join(idx_dir, "header.json")):
        t0 = time.time()
        rng = np.random.default_rng(11)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        fa = os.path.join(cache, "txome_scale.fa")
        total = 0
        with open(fa, "w") as f:
            i = 0
            while total < target_mbase * 1_000_000:
                # lognormal transcript lengths, median ~900 bp (GENCODE-like)
                L = int(np.clip(rng.lognormal(6.8, 0.75), 200, 20_000))
                f.write(f">t{i}\n{bases[rng.integers(0, 4, L)].tobytes().decode()}\n")
                total += L
                i += 1
        rec.update(fasta_s=time.time() - t0, fasta_txps=i, fasta_bases=total)
        log(f"txome: {i} txps, {total / 1e6:.1f} Mbase ({rec['fasta_s']:.0f}s)")
        t0 = time.time()
        with index_log() as lines:
            build_quasi_index(fa, outdir=idx_dir, k=31)
        rec.update(build_s=time.time() - t0, build_stages=build_stages(lines),
                   peak_rss_gb_build=rss_gb())
        log(f"index built ({rec['build_s']:.0f}s): {rec['build_stages']}")
    t0 = time.time()
    idx = load_index(idx_dir, mmap=False)
    rec["load_s"] = time.time() - t0
    if getattr(idx, "chd_dir", None) is None or not idx.meta.get("chd", {}).get("canonical"):
        from rapmap_tpu_torch.index.chd import attach_chd

        t0 = time.time()
        attach_chd(idx, save_dir=idx_dir)
        rec["chd_attach_s"] = time.time() - t0
        log(f"CHD attached ({rec['chd_attach_s']:.0f}s)")

    reads_npz = os.path.join(cache, "reads_scale_v1.npz")
    if not os.path.exists(reads_npz):
        t0 = time.time()
        rng = np.random.default_rng(12)
        text = np.asarray(idx.text[: idx.n_text])
        codes = np.empty((n_reads, READ_LEN), dtype=np.int8)
        starts = rng.integers(0, idx.n_text - READ_LEN, size=n_reads)
        for i, p in enumerate(starts):
            w = text[p : p + READ_LEN].copy()
            bad = w < 1
            if bad.any():
                w[bad] = rng.integers(1, 5, int(bad.sum()))
            nerr = rng.binomial(READ_LEN, 0.01)
            if nerr:
                pos = rng.integers(0, READ_LEN, nerr)
                w[pos] = rng.integers(1, 5, nerr)
            codes[i] = w
        half = n_reads // 2
        rc = codes[:half]
        codes[:half] = np.where((rc >= 1) & (rc <= 4), 5 - rc, 5)[:, ::-1].astype(np.int8)
        np.savez(reads_npz, codes=codes)
        log(f"reads simulated ({time.time() - t0:.0f}s)")
    return idx, np.load(reads_npz)["codes"]


def build_scale_pe(idx, cache: str, n_reads: int):
    """bench_scale.py's build_scale_pe: inward-facing 76 bp mates from ~250
    bp fragments of the scale txome."""
    pe_npz = os.path.join(cache, "reads_scale_pe_v1.npz")
    if not os.path.exists(pe_npz):
        t0 = time.time()
        rng = np.random.default_rng(13)
        text = np.asarray(idx.text[: idx.n_text])
        FRAG = 250
        n = n_reads // 2
        c1 = np.empty((n, READ_LEN), dtype=np.int8)
        c2 = np.empty((n, READ_LEN), dtype=np.int8)
        starts = rng.integers(0, idx.n_text - FRAG, size=n)
        for i, p in enumerate(starts):
            frag = text[p : p + FRAG].copy()
            bad = frag < 1
            if bad.any():
                frag[bad] = rng.integers(1, 5, int(bad.sum()))
            m1 = frag[:READ_LEN].copy()
            m2 = (5 - frag[FRAG - READ_LEN :])[::-1].astype(np.int8)
            for m in (m1, m2):
                nerr = rng.binomial(READ_LEN, 0.01)
                if nerr:
                    pos = rng.integers(0, READ_LEN, nerr)
                    m[pos] = rng.integers(1, 5, nerr)
            c1[i], c2[i] = m1, m2
        np.savez(pe_npz, c1=c1, c2=c2)
        log(f"PE reads simulated ({time.time() - t0:.0f}s)")
    d = np.load(pe_npz)
    return d["c1"], d["c2"]


def bench_cfg(idx, chunk: int = CHUNK):
    """bench.py's bench_cfg: device buffers sized to the bench-read regime
    (~1.07 expansion slots and <= 2 MMP hits a read); overflow degrades to
    flagged reads, never to wrong output."""
    from rapmap_tpu_torch.config import MapConfig

    return MapConfig(k=idx.k, chunk=chunk, max_hits_per_strand=4, expand_budget=3,
                     rec_slots=2, max_out=16)


# ---- the build's log ----------------------------------------------------------------


@contextmanager
def index_log():
    """The messages of the "tqm.index" logger while the block runs, at INFO."""
    lines: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("tqm.index")
    h, level = Keep(), logger.level
    logger.addHandler(h)
    logger.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)


_STAGES = (
    ("concat_s", r"concat \d+ transcripts, \d+ bases \(([\d.]+)s\)"),
    ("sa_s", r"suffix array \+ text pack built \(([\d.]+)s"),
    ("kmer_table_s", r"k-mer table: \d+ distinct \d+-mers \(([\d.]+)s\)"),
    ("chd_classes_s", r"canonical classes: \d+ of \d+ keys \(([\d.]+)s\)"),
    ("derived_s", r"lut/pack/sa_txp derived \(([\d.]+)s\)"),
    ("presave_s", r"non-CHD arrays saved under the CHD join \(([\d.]+)s\)"),
    ("chd_beyond_derived_s", r"canonical CHD perfect hash built \(overlapped; ([\d.]+)s"),
)


def build_stages(lines: list[str]) -> dict:
    """index/builder.py's stage seconds from its log lines. The CHD runs on
    a thread from the end of the k-mer table to its join, beside the
    derived arrays and the early save: chd_s is that span."""
    out = {}
    for name, pat in _STAGES:
        for ln in lines:
            m = re.search(pat, ln)
            if m:
                out[name] = float(m.group(1))
    out["chd_s"] = sum(out.get(x, 0.0) for x in ("derived_s", "presave_s",
                                                  "chd_beyond_derived_s"))
    return out


# ---- preflight ---------------------------------------------------------------------


# Measured on the H100's host (runs/scale_torch_r17_*.json): a process with
# the torch and CUDA runtime held 5.77 GB at 5 Mbase, whose index is 0.24 GB;
# the build's transients above the index came to 26 and 36 bytes a slot at
# 100 and 300 Mbase, the sharded cut's above the index and the two shards'
# tables to 220 at 100 Mbase; the card held 0.11 GB beside its index at
# depth 6 at both sizes.
RUNTIME_OVER = 6 * 10**9
BUILD_PER_SLOT = 48
SHARDED_PER_SLOT = 250
DEVICE_WORK = 2 * 10**9
# rows of one piece of the upload's tables times the threads that make them
# (ops/device_index.py: _PIECE_ROWS x _PIECE_THREADS, ~100 B a row at most)
PIECES = 8 * (1 << 20) * 100


def plan_bytes(target: int, n_reads: int, sharded: bool, cli: bool) -> dict:
    """What a run at `target` bases holds, from the shapes of its arrays:
    n SA slots and ~n k-mers (a random text's 31-mers are distinct), as
    many canonical classes, the CHD's 2^t slots and 2^m buckets
    (index/chd.py::chd_params).

    Host, the largest of its peaks, each beside RUNTIME_OVER: the index
    (text 1, text2b 0.25, SA 4, sa_txp/sa_tpos 8 bytes a slot; k-mer hi, lo,
    b, e 16 and classes 8 a k-mer; the CHD's slots and buckets 4 each) and
    the build's transients; the index with the upload's widest table (24
    bytes a slot or a CHD slot) and its pieces; the same with the CPU copy
    of the device index (device_bytes_estimate's terms) for the plain
    check; with --sharded the two shards' tables (2 x the device index) and
    the cut's transients; with --cli the child's load and upload beside the
    parent, which holds no index by then. Card: the lean upload and
    DEVICE_WORK. Disk: the FASTA, the saved index, and with --cli the FASTQ
    and SAM files."""
    from rapmap_tpu_torch.index.chd import chd_params

    n = K = int(target)
    m_bits, t_bits, _ = chd_params(K)
    T, M = 2**t_bits, 2**m_bits
    index = int(n * (1 + 0.25 + 4 + 8) + 16 * K + 8 * K + 4 * T + 4 * M)
    device = int(n * (24 + 16) + n + 4 * M + 24 * T)
    widest = 24 * max(n, T) + PIECES
    host = dict(build=index + BUILD_PER_SLOT * n, card_upload=index + widest,
                cpu_plain_check=index + device + widest)
    if sharded:
        host["sharded"] = index + 2 * device + SHARDED_PER_SLOT * n
    if cli:
        host["cli_child"] = index + widest
    host = {k: v + RUNTIME_OVER for k, v in host.items()}
    disk = dict(fasta=int(1.01 * target), index=index)
    if cli:
        disk["fastq_and_sam"] = int(n_reads * 2 * (2 * READ_LEN + 24 + 300))
    return dict(slots=n, chd_t_bits=t_bits, chd_m_bits=m_bits, index_bytes=index,
                device_index_bytes=device, host=host, host_total=max(host.values()),
                device_total=device + DEVICE_WORK, disk=disk,
                disk_total=sum(disk.values()))


def card_free_bytes(device) -> int | None:
    """The card's free memory (cudaMemGetInfo), None off the card."""
    if device.type != "cuda":
        return None
    import torch

    return int(torch.cuda.mem_get_info(device)[0])


def preflight(args, device, cache: str) -> dict:
    """The plan against the machine -> its record; "short" lists what the
    machine lacks (empty when the run fits)."""
    have_idx = os.path.exists(os.path.join(cache, "idx_scale_v1", "header.json"))
    plan = plan_bytes(int(args.mbase * 1e6), args.reads, args.sharded, args.cli)
    if have_idx:
        plan["disk_total"] -= plan["disk"]["fasta"] + plan["disk"]["index"]
    mem, disk = mem_available_bytes(), disk_free_bytes(args.workdir)
    card = card_free_bytes(device)
    short = [what for what, need, got in (
        ("host memory", plan["host_total"], mem), ("disk", plan["disk_total"], disk),
        ("card memory", plan["device_total"], card)) if got is not None and need > got]
    return dict(plan=plan, mem_available_bytes=mem, disk_free_bytes=disk,
                card_free_bytes=card, workdir=os.path.abspath(args.workdir), short=short)


# ---- wire results ---------------------------------------------------------------


def recs_of(wr, i: int, offsets) -> list[tuple]:
    """Read (pair) i's records of a WireResult as int tuples."""
    return [tuple(int(x) for x in r) for r in wr.recs[offsets[i] : offsets[i + 1]]]


def offsets_of(wr) -> np.ndarray:
    off = np.zeros(len(wr.counts) + 1, np.int64)
    np.cumsum(np.asarray(wr.counts, np.int64), out=off[1:])
    return off


def wire_equal(a, b) -> bool:
    """Two WireResults equal int32 for int32 (records, counts, flags, total,
    overflow and counters)."""
    return (np.array_equal(a.recs, b.recs) and np.array_equal(a.counts, b.counts)
            and np.array_equal(a.flags, b.flags) and a.total == b.total
            and a.overflowed == b.overflowed and a.counters == b.counters)


def sum_counters(results) -> dict:
    out: dict = {}
    for wr in results:
        for k, v in wr.counters.items():
            out[k] = out.get(k, 0) + int(v)
    return out


def with_cfg(mapper, cfg):
    """The mapper's upload under another config (no second upload)."""
    m = copy.copy(mapper)
    m.cfg = cfg
    return m


def timed_pass(mapper, submit, n_batches: int, depth: int, n_rows: int) -> tuple[dict, list]:
    """bench_scale.py's loop: the first batch alone (its one-off costs),
    then every batch with up to `depth` in flight, timed from the first
    submit to the last fetch -> (record, WireResult of each batch)."""
    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.ops.wire import FLAG_DEGRADED

    t0 = time.time()
    mapper.fetch(submit(0))
    first_s = time.time() - t0
    kernels.reset_launches()
    t0 = time.time()
    q: deque = deque()
    out = []
    for i in range(n_batches):
        q.append(submit(i))
        if len(q) >= depth:
            out.append(mapper.fetch(q.popleft()))
    while q:
        out.append(mapper.fetch(q.popleft()))
    dt = time.time() - t0
    ctr = sum_counters(out)
    total = n_batches * n_rows
    return dict(batches=n_batches, batch=n_rows, rows=total, first_batch_s=first_s,
                seconds=dt, rows_per_s=total / dt,
                map_rate=ctr["reads_mapped"] / total, counters=ctr,
                flagged=sum(int(((wr.flags & FLAG_DEGRADED) != 0).sum()) for wr in out),
                overflowed_batches=sum(bool(wr.overflowed) for wr in out),
                launches={k: v for k, v in kernels.LAUNCHES.items() if v}), out


# ---- the kernels of the path against their plain versions -------------------------


def kernel_checks(mapper, codes, c2, lens, cuda: bool, bitonic_n: int) -> dict:
    """K1 at the bitonic pass's voting pool (random keys; device ms, plain
    ms, torch.sort's ms, its byte and operations bounds), and K2+K3 on one
    chunk of SE reads and one of mate-2 reads (through the wrapper and, on
    the card, the entry on 0xFF-filled outputs), the SE chunk timed with a
    warm and a cold L2 beside its counted byte bound (chip_smoke.py's
    helpers; on the card only)."""
    import torch

    import chip_smoke as cs
    from rapmap_tpu_torch.ops import mmp
    from rapmap_tpu_torch.ops.sort2 import bitonic_sort_pairs, bitonic_sort_pairs_plain

    dev = mapper.device
    if cuda:
        cs.INT_OPS_PER_S = cs.int_ops_rate(True)["ops_per_s"]
    timer = cs.Timer(cuda)
    rng = np.random.default_rng(15)
    h, lo = cs.sort_inputs(bitonic_n, "random", rng)
    hi, lo = torch.from_numpy(h).to(dev), torch.from_numpy(lo).to(dev)
    kh, kl = bitonic_sort_pairs(hi, lo)
    ph, pl = bitonic_sort_pairs_plain(hi, lo)
    k1_err = max(int((kh.long() - ph.long()).abs().max()), int((kl.long() - pl.long()).abs().max()))
    key = (hi.long() & 0xFFFFFFFF) << 32 | (lo.long() & 0xFFFFFFFF)
    log2n = bitonic_n.bit_length() - 1
    exchanges = (bitonic_n // 2) * log2n * (log2n + 1) // 2
    ops_rate = cs.INT_OPS_PER_S
    t_bytes = 16 * bitonic_n / cs.HBM_BYTES_PER_S * 1e3
    t_ops = exchanges * cs.SORT_OPS_PER_EXCHANGE / ops_rate * 1e3
    # off the card a time says how fast the CPU runs the plain version: none is taken
    times = dict(
        ms=cs.device_ms(lambda: bitonic_sort_pairs(hi, lo), 200, cuda)[0],
        wrapper_ms=timer(lambda: bitonic_sort_pairs(hi, lo), reps=200),
        plain_ms=timer(lambda: bitonic_sort_pairs_plain(hi, lo), reps=3, warm=1),
        library_ms=cs.device_ms(lambda: torch.sort(key), 200, cuda)[0],
    ) if cuda else dict.fromkeys(("ms", "wrapper_ms", "plain_ms", "library_ms"), "not measured")
    k1 = dict(n=bitonic_n, max_abs_err=k1_err, equal_plain=k1_err == 0, **times,
              compare_exchanges=exchanges, ops_per_exchange=cs.SORT_OPS_PER_EXCHANGE,
              bound_ms=max(t_bytes, t_ops),
              bound_by="bytes" if t_bytes >= t_ops else "operations",
              bytes_bound_ms=t_bytes, operations_bound_ms=t_ops)

    C = min(mapper.cfg.chunk or len(lens), len(lens))
    ln = torch.from_numpy(lens[:C].astype(np.int64)).to(dev)
    sets, se_inputs = [], None
    for name, cds in (("se_chunk", codes[:C]), ("pe_mate2_chunk", c2[:C])):
        r = torch.from_numpy(np.ascontiguousarray(cds)).to(dev)
        w, kw = mmp.scan_inputs(mapper.didx, mapper.st, r, ln, mapper.cfg)
        prm = {x: kw[x] for x in ("k", "H", "ext_steps")}
        want = mmp.anchor_walk_plain(mapper.didx, *w, **prm)
        errs = cs.hits_err(mmp.anchor_walk(mapper.didx, *w, **kw), want)
        if cuda:
            raw, _, _ = cs.walk_on_0xff(mapper.didx, w, **prm)
            errs = {f: max(errs[f], v) for f, v in cs.hits_err(raw, want).items()}
        sets.append(dict(set=name, lanes=int(w.lens2.shape[0]), hits=int(want.n.sum()),
                         truncated_lanes=int(want.truncated.sum()), field_err=errs,
                         equal_plain=not any(errs.values())))
        if se_inputs is None:
            se_inputs = (w, kw)
    w, kw = se_inputs
    timing = (cs.walk_timing(mapper.didx, w, kw, mmp.anchor_walk_plain, timer, cuda) if cuda
              else dict(ms="not measured", bound_ms="not measured"))
    timing["sa_cmp_bytes"] = int(mapper.didx.sa_cmp.numel() * 4)
    k23 = dict(sets=sets, equal_plain=all(s["equal_plain"] for s in sets),
               max_abs_err=max(max(s["field_err"].values()) for s in sets), timing=timing)
    return dict(bitonic_sort_pairs=k1, anchor_walk=k23)


# ---- the oracle -----------------------------------------------------------------------


def oracle_rows_se(idx, read, cfg) -> list[tuple]:
    """map_read's records as the fallback writes them: (t, pos, strand, support)."""
    from rapmap_tpu_torch.oracle import quasimap as qm

    return [(m.txp, m.pos, 0 if m.fwd else 1, m.score) for m in qm.map_read(idx, read, cfg)]


def oracle_rows_pe(idx, r1, r2, cfg) -> list[tuple]:
    """map_pair's records as the fallback writes them: (t, p1, s1, has1, p2,
    s2, has2), a missing mate's fields 0."""
    from rapmap_tpu_torch.oracle import quasimap as qm

    ms, _ = qm.map_pair(idx, r1, r2, cfg)
    return [(m.txp, m.pos1 if m.pos1 is not None else 0, 0 if m.fwd1 else 1,
             int(m.pos1 is not None), m.pos2 if m.pos2 is not None else 0,
             0 if m.fwd2 else 1, int(m.pos2 is not None)) for m in ms]


def program_rows(B: int, chunk: int = CHUNK) -> int:
    """Rows of one device program of a batch of B: the chunk when the batch
    is a multiple (>= 2) of it (models/quasi.py::_chunk_of), else B."""
    return chunk if chunk and chunk < B and B % chunk == 0 else B


def cut_rows(wr, C: int, slots: int) -> np.ndarray:
    """Rows whose records a full record buffer may have cut: in each
    program of C rows whose slots x C records all went out, the row that
    reaches the buffer's end and every row after it (a program's counts are
    clamped to what it wrote, ops/collate.py)."""
    counts = np.asarray(wr.counts, np.int64)
    C = C or len(counts)
    out = np.zeros(len(counts), bool)
    for c0 in range(0, len(counts), C):
        ends = np.cumsum(counts[c0 : c0 + C])
        if len(ends) and ends[-1] >= slots * C:
            out[c0 + int(np.argmax(ends >= slots * C)) : c0 + C] = True
    return out


def side_lists(mapper, c1, c2, pe_batch: int, n_batches: int) -> list:
    """Where the PE merge's per-mate winner lists overflowed, batch by batch.
    ops/pairs.py::collate_records_pe compacts each mate's winner rows into
    rec_slots x C rows before it joins them, and drops the rest without a
    flag (rapmap_tpu's ops/pairs.py alike), so a pair whose mate lost its
    rows there comes out as orphans. Each mate's list is what an SE batch of
    that mate's reads emits under the same config and chunk, so the mates
    mapped as SE batches give the cut: -> [(pairs whose list a full buffer
    may have cut, either mate's list overflowed)] a batch."""
    lens = np.full(pe_batch, READ_LEN, np.int32)
    C, slots, out = program_rows(pe_batch, mapper.cfg.chunk), mapper.cfg.rec_slots, []
    for b in range(n_batches):
        sl = slice(b * pe_batch, (b + 1) * pe_batch)
        s1, s2 = (mapper.fetch(mapper.map_se_async(m[sl], lens)) for m in (c1, c2))
        out.append((cut_rows(s1, C, slots) | cut_rows(s2, C, slots),
                    bool(s1.overflowed or s2.overflowed)))
    return out


def fallback_and_oracle(idx, cfg, raw_se, raw_pe, codes, c1, c2, se_batch: int,
                        pe_batch: int, n_sample: int, seed: int = 21, side=None):
    """Every batch through the host fallback (the flagged reads and pairs
    remapped by the oracle and spliced in), as the command line does, then a
    sample drawn from every batch held to the oracle, record for record. A
    sampled read (pair) that differs is cut_by_overflow when its records are
    a strict prefix of the oracle's and it lies where a full record buffer
    cut (cut_rows); a pair is cut_by_side_list when it lies where a mate's
    winner list was cut (side_lists' `side`, when given); else it is
    unequal. cut_outside_overflow counts the cut ones of batches whose
    buffer or lists did not overflow -> (record, SE results after the
    fallback, PE results after the fallback)."""
    from rapmap_tpu_torch.models import fallback as fb
    from rapmap_tpu_torch.oracle import quasimap as qm
    from rapmap_tpu_torch.ops.wire import FLAG_DEGRADED

    lens = np.full(max(se_batch, pe_batch), READ_LEN, np.int32)
    rec: dict = {}
    t0 = time.time()
    se, pe = [], []
    for b, wr in enumerate(raw_se):
        se.append(fb.remap_se(wr._replace(counters=dict(wr.counters)),
                              codes[b * se_batch : (b + 1) * se_batch], lens, len(wr.counts),
                              idx, cfg, qm))
    for b, wr in enumerate(raw_pe):
        sl = slice(b * pe_batch, (b + 1) * pe_batch)
        pe.append(fb.remap_pe(wr._replace(counters=dict(wr.counters)), c1[sl], lens, c2[sl],
                              lens, len(wr.counts), idx, cfg, qm))
    rec["fallback_s"] = time.time() - t0
    rec["fallback_reads"] = sum(int(r.counters.get("host_fallback", 0)) for r in se)
    rec["fallback_pairs"] = sum(int(r.counters.get("host_fallback", 0)) for r in pe)

    rng = np.random.default_rng(seed)
    t0 = time.time()
    for kind, results, raw, batch, n_want in (
            ("se", se, raw_se, se_batch, n_sample), ("pe", pe, raw_pe, pe_batch, n_sample // 2)):
        per = -(-n_want // max(1, len(results)))
        checked = unequal = flagged = flagged_unequal = cut = cut_side = cut_outside = 0
        for b, wr in enumerate(results):
            off = offsets_of(wr)
            may_cut = cut_rows(raw[b], program_rows(batch, cfg.chunk), cfg.rec_slots)
            side_cut, side_ovf = (side[b] if kind == "pe" and side
                                  else (np.zeros_like(may_cut), False))
            for i in rng.choice(len(wr.counts), min(per, len(wr.counts)), replace=False):
                i = int(i)
                g = b * batch + i
                want = (oracle_rows_se(idx, codes[g], cfg) if kind == "se"
                        else oracle_rows_pe(idx, c1[g], c2[g], cfg))
                got = recs_of(wr, i, off)
                was_flagged = bool(raw[b].flags[i] & FLAG_DEGRADED)
                checked += 1
                flagged += was_flagged
                if got == want:
                    continue
                if may_cut[i] and len(got) < len(want) and got == want[: len(got)]:
                    cut += 1
                    cut_outside += not raw[b].overflowed
                elif side_cut[i]:
                    cut_side += 1
                    cut_outside += not side_ovf
                else:
                    unequal += 1
                    flagged_unequal += was_flagged
                    log(f"MISMATCH {kind} {g}: {got[:3]} oracle {want[:3]}")
        rec[f"oracle_{kind}"] = dict(
            checked=checked, unequal=unequal, flagged=flagged, flagged_unequal=flagged_unequal,
            cut_by_overflow=cut, cut_by_side_list=cut_side, cut_outside_overflow=cut_outside,
            parity=f"{checked - unequal - cut - cut_side}/{checked}")
    rec["oracle_s"] = time.time() - t0
    return rec, se, pe


# ---- the command line ---------------------------------------------------------------


_SEQ = np.frombuffer(b"NACGTN", dtype=np.uint8)


def fastq_lines(names: list[str], codes) -> tuple[list[bytes], str]:
    """(sequences, FASTQ text) of reads named `names`, quality I throughout."""
    seqs = [row.tobytes() for row in _SEQ[codes]]
    q = "I" * codes.shape[1]
    return seqs, "".join(f"@{n}\n{s.decode()}\n+\n{q}\n" for n, s in zip(names, seqs))


def sam_groups(text: str) -> dict[str, list[str]]:
    """A SAM text's record lines by read name, in order (header lines out)."""
    out: dict[str, list[str]] = {}
    for ln in text.splitlines():
        if ln and ln[0] != "@":
            out.setdefault(ln.split("\t", 1)[0], []).append(ln)
    return out


def library_sam(kind: str, results, names, seqs, seqs2, txp_names, batch: int) -> str:
    """The SAM lines the command line writes for these WireResults
    (io/sam.py's dense writers, the native formatter where it builds)."""
    from rapmap_tpu_torch.io import sam

    fmt = sam.get_native_formatter(txp_names)
    out = io.StringIO()
    for b, wr in enumerate(results):
        sl = slice(b * batch, (b + 1) * batch)
        qual = [b"I" * READ_LEN] * len(names[sl])
        if kind == "se":
            sam.write_se_records_dense(out, names[sl], seqs[sl], qual, wr.recs, wr.counts,
                                       txp_names, True, formatter=fmt)
        else:
            sam.write_pe_records_dense(out, names[sl], seqs[sl], qual, seqs2[sl], qual,
                                       wr.recs, wr.counts, txp_names, True, formatter=fmt)
    return out.getvalue()


def cli_child(kind: str, index_dir: str, inputs: list[str], flags: list[str], work: str,
              device: str, want: dict[str, list[str]]) -> dict:
    """`python -m rapmap_tpu_torch.cli quasimap <flags> --statsJson
    --profile` as a child process: its wall, its largest VmRSS read every
    0.2 s (wait4's maxrss would start from this process's peak), the lowest
    MemAvailable, the engine it picked, its stage seconds and kernel
    launches under --profile, its --statsJson, the record-buffer overflow
    warnings it logged, and every read's (pair's) SAM lines against
    `want`."""
    sam_path, stats, err_path = (os.path.join(work, f"cli_{kind}{x}") for x in (
        ".sam", "_stats.json", ".err"))
    env = {k: v for k, v in os.environ.items() if k != "TQM_FORCE_CPU"}
    if device == "cpu":
        env["TQM_FORCE_CPU"] = "1"
    argv = [sys.executable, "-m", "rapmap_tpu_torch.cli", "quasimap", "-i", index_dir,
            *inputs, "-o", sam_path, *flags, "--statsJson", stats, "--profile"]
    ch = run_child(argv, env, err_path)
    rec = dict(argv=argv[2:], rc=ch["rc"], wall_s=ch["wall_s"],
               child_rss_polled_max_gb=ch["rss_polled_max_gb"],
               mem_available_low_bytes=ch["mem_available_low_bytes"])
    if ch["rc"] != 0:
        return dict(rec, stderr_tail=ch["log"][-3000:])
    stage, launches = cli_profile(ch["log"])
    with open(stats) as f:
        st = json.load(f)
    with open(sam_path) as f:
        got = sam_groups(f.read())
    os.remove(sam_path)
    unequal = sum(got.get(name) != lines for name, lines in want.items())
    return dict(rec, engine="staged" if "-> host-staged engine" in ch["log"] else "replicated",
                stages_s=stage, launches=launches, stats=st,
                steady_reads_per_s=st.get("steady_reads_per_s"),
                overflow_warnings=ch["log"].count("record buffer overflow"), checked=len(want),
                unequal=unequal, extra=len(set(got) - set(want)))


# ---- the SA-sharded engine: scripts/demo_sharded_scale.py -------------------------


def demo_reads(idx):
    """demo_sharded_scale.py's 96 exact reads (seed 17), padded to the
    mesh's data rows -> (codes, lens, per)."""
    rng = np.random.default_rng(17)
    text = np.asarray(idx.text)
    off = np.asarray(idx.txp_offsets)
    tl = np.asarray(idx.txp_lens)
    seqs = []
    while len(seqs) < N_SHARDED_READS:
        t = int(rng.integers(0, idx.n_txps))
        if tl[t] < READ_LEN + 1:
            continue
        p = int(rng.integers(0, tl[t] - READ_LEN))
        w = text[off[t] + p : off[t] + p + READ_LEN]
        if (w >= 1).all():
            seqs.append(w.astype(np.int8))
    per = -(-N_SHARDED_READS // N_DATA)
    B = N_DATA * per
    codes = np.full((B, READ_LEN), 5, np.int8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        codes[i] = s
        lens[i] = len(s)
    return codes, lens, per


def sharded_run(idx, device, cuda: bool) -> dict:
    """The 100 Mbase index cut into 2 slot64 shards, a 2 x 2 mesh on the one
    device (each data row a ShardStack: K8), the demo's reads through
    map_batch_se_sharded, each held to the oracle; and K8 against its plain
    version on data row 0."""
    import torch

    import chip_smoke as cs
    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.oracle import quasimap as qm
    from rapmap_tpu_torch.parallel import sharded

    t0 = time.time()
    arr, st = sharded.shard_quasi_index(idx, N_IDX, slot64=True)
    cut_s = time.time() - t0
    codes, lens, per = demo_reads(idx)
    cfg = MapConfig(k=idx.k, max_hits_per_strand=8, expand_budget=64, max_out=32)
    mesh = sharded.make_mesh_2d(N_DATA, N_IDX, devices=[device])
    t0 = time.time()
    uploads = sharded.upload_sharded(arr, mesh)
    upload_s = time.time() - t0
    slot_dtype = str(arr.slot_base.dtype)
    del arr
    gc.collect()
    r = torch.from_numpy(codes).to(device)
    ln = torch.from_numpy(lens.astype(np.int64)).to(device)
    kernels.reset_launches()
    t0 = time.time()
    out, ctr = sharded.map_batch_se_sharded(uploads, st, r, ln, np.full(N_DATA, per, np.int32),
                                            cfg, mesh)
    out = [x.cpu().numpy() for x in (out.t, out.pos, out.strand, out.score)]
    map_s = time.time() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    unequal = 0
    for i in range(N_SHARDED_READS):
        want = qm.map_read(idx, codes[i][: lens[i]], cfg)
        got = [(int(out[0][i, j]), int(out[1][i, j]), out[2][i, j] == 0, int(out[3][i, j]))
               for j in range(out[0].shape[1]) if out[0][i, j] != -1]
        if got != [(m.txp, m.pos, m.fwd, m.score) for m in want]:
            unequal += 1
            log(f"MISMATCH sharded read {i}: {got[:3]}")
    # K8 on data row 0 against its plain version
    rows = slice(0, per)
    w, kw = sharded.scan_inputs(uploads[0], st, r[rows], ln[rows], cfg)
    want = sharded.sharded_walk_plain(uploads[0], *w, **kw)
    errs = cs.hits_err(sharded.sharded_walk(uploads[0], w, **kw), want)
    if cuda:
        raw, _, _ = cs.sharded_walk_on_0xff(uploads[0], w, **kw)
        errs = {f: max(errs[f], v) for f, v in cs.hits_err(raw, want).items()}
    del uploads
    if cuda:
        torch.cuda.empty_cache()
    return dict(mesh=f"{N_DATA}x{N_IDX}", shards=N_IDX, slot_base_dtype=slot_dtype,
                cut_s=cut_s, upload_s=upload_s, map_s=map_s, reads=N_SHARDED_READS,
                mapped=int(ctr.reads_mapped), checked=N_SHARDED_READS, unequal=unequal,
                parity=f"{N_SHARDED_READS - unequal}/{N_SHARDED_READS}", launches=launches,
                k8_field_err=errs, k8_equal_plain=not any(errs.values()))


# ---- main ----------------------------------------------------------------------------


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mbase", type=float, default=100.0)
    ap.add_argument("--reads", type=int, default=393_216)
    ap.add_argument("--batch", type=int, default=65_536)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--oracle-sample", type=int, default=4096,
                    help="SE reads held to the oracle (and half as many pairs)")
    ap.add_argument("--sharded", action="store_true",
                    help="also demo_sharded_scale.py's slot64 SA-sharded run on a 2 x 2 mesh")
    ap.add_argument("--cli", action="store_true",
                    help="also map the reads and pairs with `quasimap --engine auto` as "
                         "child processes and hold every read's SAM lines to the library's")
    ap.add_argument("--workdir", default=os.path.join(ROOT, "build", "scale"))
    ap.add_argument("--json-out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) fails without a card; cpu runs the plain versions")
    return ap


def check_args(ap, args) -> None:
    n_pairs = args.reads // 2
    pe_batch = min(args.batch, n_pairs)
    if args.reads % args.batch or n_pairs % pe_batch:
        ap.error("--reads must be a multiple of --batch, and its pairs of the PE batch "
                 "(min(batch, reads / 2))")


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    return run(parser(), argv)[0]


def run(ap: argparse.ArgumentParser, argv: list[str] | None = None):
    """The run -> (exit code, its record or None)."""
    args = ap.parse_args(argv)
    check_args(ap, args)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("no CUDA device: this run maps on a CUDA card (--device cpu runs the plain "
            "versions on the CPU)")
        return 1, None
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    os.makedirs(args.workdir, exist_ok=True)
    cache = os.path.join(args.workdir, f"m{args.mbase:g}_r{args.reads}")
    pre = preflight(args, device, cache)
    if pre["short"]:
        print(json.dumps(dict(metric="scale_world", mbase=args.mbase,
                              skipped="not enough " + " and ".join(pre["short"]), **pre)),
              flush=True)
        return 2, None
    watch = MemWatch()
    log(f"preflight: host plan {pre['plan']['host_total'] / 1e9:.1f} GB of "
        f"{pre['mem_available_bytes'] / 1e9:.1f} GB available, card plan "
        f"{pre['plan']['device_total'] / 1e9:.1f} GB of {pre['card_free_bytes']}, disk plan "
        f"{pre['plan']['disk_total'] / 1e9:.1f} GB of {pre['disk_free_bytes'] / 1e9:.1f} GB")

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.models.quasi import QuasiMapper
    from rapmap_tpu_torch.ops.device_index import device_bytes_estimate

    card = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(),
                nvidia_smi=subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                    check=True, capture_output=True, text=True, timeout=60,
                ).stdout.strip().splitlines()[0]) if cuda else dict(platform="cpu")
    if cuda:
        t0 = time.time()
        kernels.build_all()
        log(f"kernels built ({time.time() - t0:.0f}s)")

    rec: dict = {"metric": "scale_world", "device": card, "mbase": args.mbase,
                 "reads": args.reads, "batch": args.batch, "depth": args.depth}
    failed: list[str] = []
    idx, codes = build_scale_world(cache, args.mbase, args.reads, rec)
    c1, c2 = build_scale_pe(idx, cache, args.reads)
    chd = idx.meta.get("chd", {})
    rec.update(n_text=int(idx.n_text), n_txps=int(idx.n_txps), sa_slots=len(idx.sa),
               kmers=len(idx.kmer_b), chd=chd,
               chd_classes=None if idx.chd_cls is None else len(idx.chd_cls),
               chd_slots=None if idx.chd_perm is None else len(idx.chd_perm),
               peak_rss_gb_world=rss_gb())
    if not chd.get("canonical"):
        failed.append("the canonical CHD was not built")
    cfg = bench_cfg(idx)
    n_pairs = len(c1)
    pe_batch = min(args.batch, n_pairs)
    lens = np.full(args.batch, READ_LEN, np.int32)

    # ---- the lean upload, measured beside its estimate ------------------------------
    if cuda:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
    t0 = time.time()
    mapper = QuasiMapper(idx, cfg, device=device)
    if cuda:
        torch.cuda.synchronize()
    rec["upload_s"] = time.time() - t0
    est = device_bytes_estimate(idx)
    measured = torch.cuda.memory_allocated() - before if cuda else sum(
        t.numel() * t.element_size() for t in mapper.didx if t is not None)
    rec.update(device_index_bytes=measured, device_index_bytes_measured_by=(
        "torch.cuda.memory_allocated" if cuda else "tensor sizes (CPU)"),
        device_bytes_estimate=est, estimate_over_measured=est / measured,
        peak_rss_gb_upload=rss_gb())
    log(f"lean upload {measured / GIB:.2f} GiB in {rec['upload_s']:.1f}s "
        f"(estimate {est / GIB:.2f} GiB)")
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- library runs: SE, PE, and the bitonic pass with its twin -------------------
    n_se = args.reads // args.batch
    se, raw_se = timed_pass(
        mapper, lambda i: mapper.map_se_async(codes[i * args.batch : (i + 1) * args.batch],
                                              lens), n_se, args.depth, args.batch)
    pe_lens = lens[:pe_batch]
    pe, raw_pe = timed_pass(
        mapper, lambda i: mapper.map_pe_async(c1[i * pe_batch : (i + 1) * pe_batch], pe_lens,
                                              c2[i * pe_batch : (i + 1) * pe_batch], pe_lens),
        n_pairs // pe_batch, args.depth, pe_batch)
    log(f"SE {se['rows_per_s']:,.0f} reads/s (map rate {se['map_rate']:.4f}, flagged "
        f"{se['flagged']}); PE {pe['rows_per_s']:,.0f} pairs/s (map rate {pe['map_rate']:.4f}, "
        f"flagged {pe['flagged']})")
    # the voting pool must be a power of two for the bitonic network: bench_cfg's
    # 3 x chunk is not, so the pass runs at expansion budget 4 beside its twin
    eb4 = dataclasses.replace(cfg, expand_budget=4)
    m4, m4b = with_cfg(mapper, eb4), with_cfg(mapper, dataclasses.replace(eb4, bitonic_sort=True))
    twin, raw_twin = timed_pass(
        m4, lambda i: m4.map_se_async(codes[i * args.batch : (i + 1) * args.batch], lens),
        n_se, args.depth, args.batch)
    bit, raw_bit = timed_pass(
        m4b, lambda i: m4b.map_se_async(codes[i * args.batch : (i + 1) * args.batch], lens),
        n_se, args.depth, args.batch)
    pool = eb4.expand_budget * program_rows(args.batch)
    bit.update(expand_budget=4, voting_pool=pool, twin_rows_per_s=twin["rows_per_s"],
               twin_launches=twin["launches"],
               equal_twin=all(wire_equal(a, b) for a, b in zip(raw_bit, raw_twin)))
    del raw_twin, raw_bit
    rec.update(se=se, pe=pe, bitonic_pass=bit,
               max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None)
    for name, p in (("SE", se), ("PE", pe)):
        if p["map_rate"] < 0.9 or p["overflowed_batches"]:
            failed.append(f"the {name} pass mapped under 90% or overflowed a record buffer")
    if not bit["equal_twin"] or (cuda and not bit["launches"].get("bitonic_sort_pairs")):
        failed.append("the bitonic pass differs from its twin or did not launch K1")

    # ---- the kernels against their plain versions -------------------------------------
    rec["kernels"] = kernel_checks(mapper, codes, c2, lens, cuda, pool)
    if not (rec["kernels"]["bitonic_sort_pairs"]["equal_plain"]
            and rec["kernels"]["anchor_walk"]["equal_plain"]):
        failed.append("a kernel disagrees with its plain version")
    del mapper, m4, m4b
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the plain versions on the CPU: one SE and one PE batch ----------------------
    t0 = time.time()
    cm = QuasiMapper(idx, cfg, device="cpu")
    cpu_upload_s = time.time() - t0
    t0 = time.time()
    cse = cm.fetch(cm.map_se_async(codes[: args.batch], lens))
    cse_s = time.time() - t0
    t0 = time.time()
    cpe = cm.fetch(cm.map_pe_async(c1[:pe_batch], pe_lens, c2[:pe_batch], pe_lens))
    cpe_s = time.time() - t0
    rec["cpu_plain"] = dict(upload_s=cpu_upload_s, se_s=cse_s, pe_s=cpe_s,
                            se_equal=wire_equal(cse, raw_se[0]),
                            pe_equal=wire_equal(cpe, raw_pe[0]), peak_rss_gb=rss_gb())
    del cm, cse, cpe
    gc.collect()
    if not (rec["cpu_plain"]["se_equal"] and rec["cpu_plain"]["pe_equal"]):
        failed.append("the CPU's plain batch differs from the card's")
    log(f"CPU plain check: {rec['cpu_plain']}")

    # ---- the fallback and the oracle -------------------------------------------------------
    orc, se_res, pe_res = fallback_and_oracle(idx, cfg, raw_se, raw_pe, codes, c1, c2,
                                              args.batch, pe_batch, args.oracle_sample)
    rec["oracle"] = orc
    del raw_se, raw_pe
    if orc["oracle_se"]["unequal"] or orc["oracle_pe"]["unequal"]:
        failed.append("a sampled read or pair differs from the oracle")
    log(f"oracle: SE {orc['oracle_se']['parity']}, PE {orc['oracle_pe']['parity']} "
        f"(fallback {orc['fallback_reads']} reads, {orc['fallback_pairs']} pairs)")

    # ---- the SA-sharded engine ----------------------------------------------------------
    rec["sharded"] = None
    if args.sharded:
        sh = rec["sharded"] = sharded_run(idx, device, cuda)
        log(f"sharded: {sh['parity']}, launches {sh['launches']}")
        if (sh["unequal"] or sh["slot_base_dtype"] != "int64" or not sh["k8_equal_plain"]
                or (cuda and not sh["launches"].get("sharded_walk"))):
            failed.append("the sharded run differs from the oracle, is not slot64, or K8 did "
                          "not launch or differs from its plain version")

    # ---- the command line, as child processes -------------------------------------------
    rec["cli"] = None
    if args.cli:
        txp_names = list(idx.txp_names)
        idx_dir = os.path.join(cache, "idx_scale_v1")
        del idx
        gc.collect()
        rec["cli"] = {}
        for kind, results, n, batch in (("se", se_res, args.reads, args.batch),
                                        ("pe", pe_res, n_pairs, pe_batch)):
            pre_name = "r" if kind == "se" else "p"
            names = [f"{pre_name}{i}" for i in range(n)]
            if kind == "se":
                seqs, text = fastq_lines(names, codes)
                seqs2 = None
                paths = [os.path.join(cache, "reads.fq")]
                with open(paths[0], "w") as f:
                    f.write(text)
                inputs = ["-r", paths[0]]
            else:
                paths = [os.path.join(cache, f"pairs_{m}.fq") for m in (1, 2)]
                seqs, text = fastq_lines(names, c1)
                with open(paths[0], "w") as f:
                    f.write(text)
                seqs2, text = fastq_lines(names, c2)
                with open(paths[1], "w") as f:
                    f.write(text)
                inputs = ["-1", paths[0], "-2", paths[1]]
            del text
            want = sam_groups(library_sam(kind, results, names, seqs, seqs2, txp_names, batch))
            del seqs, seqs2
            c = rec["cli"][kind] = cli_child(
                kind, idx_dir, inputs, ["--engine", "auto", "--batchSize", str(args.batch)],
                cache, args.device, want)
            for p in paths:
                os.remove(p)
            del want
            log(f"quasimap {kind}: rc {c['rc']}, {c.get('engine')}, {c.get('unequal')} of "
                f"{c.get('checked')} unequal, {c['wall_s']:.1f}s")
            if (c["rc"] != 0 or c["engine"] != "replicated" or c["unequal"] or c["extra"]
                    or (cuda and not c["launches"].get("anchor_walk"))):
                failed.append(f"the command line ({kind}) failed, picked the staged engine, "
                              "launched no walk or wrote other records")

    rec.update(peak_rss_gb=rss_gb(), mem_available_low_bytes=watch.low, preflight=pre,
               failed=failed)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    if failed:
        log("FAILED: " + "; ".join(failed))
    return int(bool(failed)), rec


if __name__ == "__main__":
    sys.exit(main())
