#!/usr/bin/env python3
"""The isoform transcriptome, bench.py's primary regime (isoform_se), on one
CUDA card: the twin of bench.py's isoform world and config for
rapmap_tpu_torch, single-end and paired-end, library and command line.

The world is bench.py's, byte for byte (its build_isoform_world and
build_pe_reads are copied here, not imported: bench.py configures JAX): the
FASTA of scripts/txome_sim.py's gen_isoform_txome (seed 3, --genes genes of
2-8 isoforms: shared exons and paralogs, so reads map to several
transcripts), indexed by rapmap_tpu_torch's build_quasi_index at k = 31
with the canonical CHD, --reads 76 bp reads (seed 4, 1% substitutions, the
first half reverse-complemented) and --reads / 2 inward pairs from 250 bp
fragments (seed 2). On it, under bench.py's isoform config (chunk 8,192, 4
hit slots, expansion budget 0 = sized from the index at the mapper's
start, 4 record slots, 32 records a read), which on this repetitive index
turns on the pair pool (expand_pairs: each pool slot two SA positions):

- the library runs: QuasiMapper on the lean upload, SE over every read and
  PE over every pair in batches of --batch with up to --depth in flight,
  each pass's rate, counters, overflowed batches and the records their
  record buffers dropped, launches, one profiled batch and peak device
  memory; one more SE pass with bitonic_sort=True (K1), which needs a
  power-of-two voting pool, so it runs at the power of two at or above the
  chosen budget and is held to its twin at that budget without the bitonic
  sort, batch for batch;
- the plain versions: one SE and one PE batch mapped again with
  device="cpu", int32 for int32 equal to the card's, overflow included;
- the kernels of the path on card tensors against their plain versions: K1
  at the bitonic pass's pool, K2+K3 (anchor_walk) on one chunk of SE reads
  and one of mate-2 reads, the SE chunk's warm and cold device time beside
  its counted byte bound and the sa_cmp rows its bound searches compared;
- the oracle: every batch through the host fallback (models/fallback.py
  remap_se, remap_pe), then a sample drawn from every batch held to
  oracle/quasimap.py map_read / map_pair record for record. A read (pair)
  whose records its chunk's full record buffer cut off is not equal: it is
  counted apart (cut_by_overflow), and must lie in an overflowed batch. So
  is a pair whose mate lost its winner rows where the PE merge compacts
  each mate's list into the same number of rows (cut_by_side_list; the
  mates mapped as SE batches show where, side_lists);
- --cli: the reads and pairs as FASTQ through `python -m
  rapmap_tpu_torch.cli quasimap` at its default flags (batches of 4,096,
  the budget sized from the index) with --statsJson --profile, as child
  processes (SE, then -1/-2); each must pick the replicated engine and
  write, for every read and pair, the SAM lines that the library writes
  for the same batches under the command line's own config after the
  fallback. The record gives the overflow warnings it logged and the
  records that its batches dropped.

Run alone. Without enough host memory, card memory or disk for the plan it
prints one JSON line with "skipped" and exits 2.

    python3 scripts/isoform_world_torch.py [--genes 2000] [--reads 786432]
        [--batch 32768] [--chunk 8192] [--depth 6] [--oracle-sample 4096] [--cli]
        [--cli-batch N] [--workdir build/isoform] [--json-out PATH] [--device cuda|cpu]

On the CPU (plain versions of every kernel), at a toy size:
    python3 scripts/isoform_world_torch.py --device cpu --genes 40
        --reads 1024 --batch 512 --chunk 256 --oracle-sample 64 --cli --cli-batch 256

The last line of standard output is the run's JSON record (exit 0 when
every check held, 1 when one failed or there is no card).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import logging
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (ROOT, HERE) if p not in sys.path]

import scale_world_torch as sw  # noqa: E402
from genome_scale_torch import (  # noqa: E402
    MemWatch, disk_free_bytes, log, mem_available_bytes, rss_gb,
)

READ_LEN = 76
CHUNK = 8192           # bench.py's CHUNK (TQM_CHUNK unset)
BASES_PER_GENE = 8600  # gen_isoform_txome's mean at its defaults: 17.0 Mbase at 2,000 genes


# ---- the world: bench.py's build_isoform_world and build_pe_reads -----------------


def build_isoform_world(cache: str, n_genes: int, n_reads: int, rec: dict):
    """bench.py's build_isoform_world with its module constants as arguments
    (CACHE, the 2,000 genes, N_READS) and the port's builder; the build's
    seconds go into `rec`."""
    from txome_sim import gen_isoform_txome, write_fasta

    from rapmap_tpu_torch.index.builder import build_quasi_index
    from rapmap_tpu_torch.index.format import load_index

    os.makedirs(cache, exist_ok=True)
    idx_dir = os.path.join(cache, "idx_iso_v1")
    if not os.path.exists(os.path.join(idx_dir, "header.json")):
        t0 = time.time()
        rng = np.random.default_rng(3)
        fa = os.path.join(cache, "txome_iso.fa")
        write_fasta(gen_isoform_txome(rng, n_genes=n_genes, isoforms_per_gene=(2, 8)), fa)
        rec["fasta_s"] = time.time() - t0
        t0 = time.time()
        build_quasi_index(fa, outdir=idx_dir, k=31)
        rec["build_s"] = time.time() - t0
        log(f"isoform index built ({rec['fasta_s']:.1f}s FASTA, {rec['build_s']:.1f}s build)")
    t0 = time.time()
    idx = load_index(idx_dir, mmap=False)
    rec["load_s"] = time.time() - t0
    if getattr(idx, "chd_dir", None) is None or not idx.meta.get("chd", {}).get("canonical"):
        from rapmap_tpu_torch.index.chd import attach_chd

        attach_chd(idx, save_dir=idx_dir)

    reads_npz = os.path.join(cache, "reads_iso_v1.npz")
    if not os.path.exists(reads_npz):
        t0 = time.time()
        rng = np.random.default_rng(4)
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
        rec["reads_s"] = time.time() - t0
    return idx, np.load(reads_npz)["codes"]


def build_pe_reads(idx, cache: str, n_reads: int, tag: str = "pe_iso_v1"):
    """bench.py's build_pe_reads: mate 1 the fragment's start (forward), mate
    2 the reverse complement of its end, from ~250 bp fragments."""
    pe_npz = os.path.join(cache, f"reads_{tag}.npz")
    if not os.path.exists(pe_npz):
        rng = np.random.default_rng(2)
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
            m2 = frag[FRAG - READ_LEN :].copy()
            m2 = (5 - m2)[::-1].astype(np.int8)  # rc
            for m in (m1, m2):
                nerr = rng.binomial(READ_LEN, 0.01)
                if nerr:
                    pos = rng.integers(0, READ_LEN, nerr)
                    m[pos] = rng.integers(1, 5, nerr)
            c1[i], c2[i] = m1, m2
        np.savez(pe_npz, c1=c1, c2=c2)
    d = np.load(pe_npz)
    return d["c1"], d["c2"]


def isoform_cfg(idx, chunk: int = CHUNK):
    """bench.py's isoform_se config: the expansion pool sized from the
    index's interval widths (and, when they are wide, the pair pool) at the
    mapper's start; up to 32 records a read, 4 record slots."""
    from rapmap_tpu_torch.config import MapConfig

    return MapConfig(k=idx.k, chunk=chunk, max_hits_per_strand=4, expand_budget=0,
                     max_out=32, rec_slots=4)


# ---- overflow ---------------------------------------------------------------------


def drop_stats(results) -> dict:
    """The batches whose record buffer overflowed and the records it
    dropped: the records the programs made (`total`) less the rows kept."""
    total = sum(int(wr.total) for wr in results)
    kept = sum(len(wr.recs) for wr in results)
    return dict(overflowed_batches=sum(bool(wr.overflowed) for wr in results),
                records_made=total, records_kept=kept, records_dropped=total - kept,
                dropped_share=(total - kept) / max(total, 1))


# ---- the voting sort's sizes ------------------------------------------------------------


@contextmanager
def sort_sizes():
    """The element counts (NEL) that ops/collate.py::_sort_packed is handed
    while the block runs: the voting pool the bitonic network must take."""
    from rapmap_tpu_torch.ops import collate

    seen: set[int] = set()
    orig = collate._sort_packed

    def spy(hi0, lo0, cfg):
        seen.add(int(hi0.shape[0]))
        return orig(hi0, lo0, cfg)

    collate._sort_packed = spy
    try:
        yield seen
    finally:
        collate._sort_packed = orig


# ---- the command line ---------------------------------------------------------------


def cli_flags(batch: int | None) -> list[str]:
    """The command line's flags beside its inputs: its defaults, or batches
    of `batch` reads."""
    return [] if batch is None else ["--batchSize", str(batch)]


def cli_defaults(mapper, batch: int | None):
    """The command line's own MapConfig at its default flags (and
    cli_flags(batch)), with the budget and pair pool its QuasiMapper sizes
    from this index (the same as the library mapper's), its batch size and
    its longest read."""
    from rapmap_tpu_torch import cli

    args = cli.build_parser().parse_args(["quasimap", "-i", "-", "-r", "-", *cli_flags(batch)])
    cfg = cli._cfg_from_args(args, mapper.cfg.k)
    if cfg.expand_budget != 0:
        raise RuntimeError("the command line's default expansion budget is no longer auto")
    cfg = dataclasses.replace(cfg, expand_budget=mapper.cfg.expand_budget,
                              expand_pairs=mapper.cfg.expand_pairs)
    return cfg, args.batchSize, args.maxReadLen


def library_cli_sam(mapper, kind: str, paths: list[str], batch: int, max_len: int) -> tuple:
    """The reads (pairs) of the FASTQ files in the command line's batches,
    mapped by the library and sent through the fallback, written by the
    command line's SAM writers -> (SAM text, raw WireResults' drop_stats)."""
    import io

    from rapmap_tpu_torch.io import fastx, sam
    from rapmap_tpu_torch.models import fallback as fb
    from rapmap_tpu_torch.oracle import quasimap as qm

    idx, cfg = mapper.host_index, mapper.cfg
    fmt = sam.get_native_formatter(idx.txp_names)
    out = io.StringIO()
    raw = []
    if kind == "se":
        for b in fastx.batched_reads(paths[0], batch, max_len):
            wr = mapper.fetch(mapper.map_se_async(b.codes, b.lens, n_valid=b.n))
            raw.append(wr._replace(recs=np.empty((len(wr.recs), 0))))
            wr = fb.remap_se(wr, b.codes, b.lens, b.n, idx, cfg, qm)
            sam.write_se_records_dense(out, b.names[: b.n], b.seqs, b.quals, wr.recs, wr.counts,
                                       idx.txp_names, True, formatter=fmt)
    else:
        for b1, b2 in fastx.batched_read_pairs(paths[0], paths[1], batch, max_len):
            wr = mapper.fetch(mapper.map_pe_async(b1.codes, b1.lens, b2.codes, b2.lens,
                                                  n_valid=b1.n))
            raw.append(wr._replace(recs=np.empty((len(wr.recs), 0))))
            wr = fb.remap_pe(wr, b1.codes, b1.lens, b2.codes, b2.lens, b1.n, idx, cfg, qm)
            sam.write_pe_records_dense(out, b1.names[: b1.n], b1.seqs, b1.quals, b2.seqs,
                                       b2.quals, wr.recs, wr.counts, idx.txp_names, True,
                                       formatter=fmt)
    return out.getvalue(), drop_stats(raw)


def cli_runs(mapper, codes, c1, c2, idx_dir: str, cache: str, device: str,
             cli_batch: int | None) -> dict:
    """The SE and PE children at the default flags (batches of cli_batch
    where it is given), each held to the library's SAM of the same batches
    under the command line's config."""
    cfg, batch, max_len = cli_defaults(mapper, cli_batch)
    lib = sw.with_cfg(mapper, cfg)
    out = dict(config=dict(batch=batch, chunk=cfg.chunk, expand_budget=cfg.expand_budget,
                           expand_pairs=cfg.expand_pairs, rec_slots=cfg.rec_slots,
                           max_out=cfg.max_out, max_hits_per_strand=cfg.max_hits_per_strand))
    for kind in ("se", "pe"):
        if kind == "se":
            paths = [os.path.join(cache, "reads.fq")]
            inputs = ["-r", paths[0]]
            parts = [("r", codes)]
        else:
            paths = [os.path.join(cache, f"pairs_{m}.fq") for m in (1, 2)]
            inputs = ["-1", paths[0], "-2", paths[1]]
            parts = [("p", c1), ("p", c2)]
        for path, (pre, cds) in zip(paths, parts):
            names = [f"{pre}{i}" for i in range(len(cds))]
            with open(path, "w") as f:
                f.write(sw.fastq_lines(names, cds)[1])
        t0 = time.time()
        text, drops = library_cli_sam(lib, kind, paths, batch, max_len)
        want = sw.sam_groups(text)
        del text
        lib_s = time.time() - t0
        c = out[kind] = sw.cli_child(kind, idx_dir, inputs, cli_flags(cli_batch), cache,
                                     device, want)
        c.update(library_s=lib_s, library_drops=drops)
        for p in paths:
            os.remove(p)
        del want
        gc.collect()
        log(f"quasimap {kind}: rc {c['rc']}, {c.get('engine')}, {c.get('unequal')} of "
            f"{c.get('checked')} unequal, {c.get('overflow_warnings')} overflow warnings, "
            f"{drops['records_dropped']} records dropped, {c['wall_s']:.1f}s")
    return out


# ---- preflight ---------------------------------------------------------------------


def preflight(args, device, cache: str) -> dict:
    """scale_world_torch.py's plan at this world's size (its bases reckoned
    at BASES_PER_GENE) against the machine; "short" lists what it lacks."""
    plan = sw.plan_bytes(BASES_PER_GENE * args.genes, args.reads, False, args.cli)
    mem, disk = mem_available_bytes(), disk_free_bytes(args.workdir)
    card = sw.card_free_bytes(device)
    short = [what for what, need, got in (
        ("host memory", plan["host_total"], mem), ("disk", plan["disk_total"], disk),
        ("card memory", plan["device_total"], card)) if got is not None and need > got]
    return dict(plan=plan, mem_available_bytes=mem, disk_free_bytes=disk,
                card_free_bytes=card, workdir=os.path.abspath(args.workdir), short=short)


# ---- main ----------------------------------------------------------------------------


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genes", type=int, default=2000)
    ap.add_argument("--reads", type=int, default=786_432)
    ap.add_argument("--batch", type=int, default=32_768)
    ap.add_argument("--chunk", type=int, default=CHUNK,
                    help="device program rows when the batch is larger (bench.py's rule)")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--oracle-sample", type=int, default=4096,
                    help="SE reads held to the oracle (and half as many pairs)")
    ap.add_argument("--cli", action="store_true",
                    help="also map the reads and pairs with `quasimap` at its default flags "
                         "as child processes and hold every read's SAM lines to the library's")
    ap.add_argument("--cli-batch", type=int, default=None,
                    help="--batchSize of the command line (default: its own, 4,096)")
    ap.add_argument("--workdir", default=os.path.join(ROOT, "build", "isoform"))
    ap.add_argument("--json-out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) fails without a card; cpu runs the plain versions")
    return ap


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    return run(parser(), argv)[0]


def pass_record(name: str, p: dict, raw, mapper, profile_run, cuda: bool) -> dict:
    """A timed pass's record with its drops, launches a program and one
    profiled batch (device busy ms and idle share)."""
    import chip_smoke as cs

    programs = p["batch"] // sw.program_rows(p["batch"], mapper.cfg.chunk)
    launched = sum(p["launches"].values())
    p.update(drop_stats(raw), hand_launches_per_program=launched / (p["batches"] * programs),
             programs_per_batch=programs,
             profile=cs.profile_one_batch(profile_run, programs, cuda, 8))
    log(f"{name}: {p['rows_per_s']:,.0f} rows/s, map rate {p['map_rate']:.4f}, "
        f"{p['overflowed_batches']} of {p['batches']} batches overflowed, "
        f"{p['records_dropped']} of {p['records_made']} records dropped")
    return p


def run(ap: argparse.ArgumentParser, argv: list[str] | None = None):
    """The run -> (exit code, its record or None)."""
    args = ap.parse_args(argv)
    n_pairs = args.reads // 2
    pe_batch = min(args.batch, n_pairs)
    if args.reads % args.batch or n_pairs % pe_batch:
        ap.error("--reads must be a multiple of --batch, and its pairs of the PE batch "
                 "(min(batch, reads / 2))")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("no CUDA device: this run maps on a CUDA card (--device cpu runs the plain "
            "versions on the CPU)")
        return 1, None
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    os.makedirs(args.workdir, exist_ok=True)
    cache = os.path.join(args.workdir, f"g{args.genes}_r{args.reads}")
    pre = preflight(args, device, cache)
    if pre["short"]:
        print(json.dumps(dict(metric="isoform_world", genes=args.genes,
                              skipped="not enough " + " and ".join(pre["short"]), **pre)),
              flush=True)
        return 2, None
    watch = MemWatch()

    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.config import sampled_width
    from rapmap_tpu_torch.models.quasi import QuasiMapper

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

    rec: dict = {"metric": "isoform_world", "device": card, "genes": args.genes,
                 "reads": args.reads, "pairs": n_pairs, "batch": args.batch, "depth": args.depth}
    failed: list[str] = []
    t0 = time.time()
    idx, codes = build_isoform_world(cache, args.genes, args.reads, rec)
    c1, c2 = build_pe_reads(idx, cache, args.reads)
    rec["world_s"] = time.time() - t0
    chd = idx.meta.get("chd", {})
    widths = np.asarray(idx.kmer_e, np.int64) - np.asarray(idx.kmer_b, np.int64)
    rec.update(n_text=int(idx.n_text), n_txps=int(idx.n_txps), sa_slots=len(idx.sa),
               kmers=len(idx.kmer_b), chd=chd, table_mean_width=float(widths.mean()),
               sampled_width=sampled_width(widths), widest_interval=int(widths.max()))
    if not chd.get("canonical"):
        failed.append("the canonical CHD was not built")
    cfg = isoform_cfg(idx, args.chunk if args.batch > args.chunk else 0)
    lens = np.full(args.batch, READ_LEN, np.int32)
    pe_lens = lens[:pe_batch]

    if cuda:
        torch.cuda.synchronize()
    t0 = time.time()
    mapper = QuasiMapper(idx, cfg, device=device)
    if cuda:
        torch.cuda.synchronize()
    rec["upload_s"] = time.time() - t0
    mc = mapper.cfg
    rows = sw.program_rows(args.batch, mc.chunk)
    rec["config"] = dict(chunk=mc.chunk, max_hits_per_strand=mc.max_hits_per_strand,
                         max_out=mc.max_out, rec_slots=mc.rec_slots,
                         expand_budget=mc.expand_budget, expand_pairs=mc.expand_pairs,
                         voting_pool=mc.expand_budget * rows,
                         pool_slots=-(-mc.expand_budget * rows // (2 if mc.expand_pairs else 1)))
    log(f"auto budget {mc.expand_budget}, expand_pairs {mc.expand_pairs}, widths: table mean "
        f"{rec['table_mean_width']:.3f}, sampled {rec['sampled_width']:.3f}")

    # ---- library runs: SE, PE, the bitonic pass and its twin ------------------------
    n_se = args.reads // args.batch
    passes = {}
    for name, submit, n, rows_ in (
            ("se", lambda i: mapper.map_se_async(codes[i * args.batch : (i + 1) * args.batch],
                                                 lens), n_se, args.batch),
            ("pe", lambda i: mapper.map_pe_async(c1[i * pe_batch : (i + 1) * pe_batch], pe_lens,
                                                 c2[i * pe_batch : (i + 1) * pe_batch], pe_lens),
             n_pairs // pe_batch, pe_batch)):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        p, raw = sw.timed_pass(mapper, submit, n, args.depth, rows_)
        p["max_memory_allocated"] = torch.cuda.max_memory_allocated() if cuda else None
        passes[name] = (pass_record(name, p, raw, mapper,
                                    lambda s=submit: mapper.fetch(s(0)), cuda), raw)
    (se, raw_se), (pe, raw_pe) = passes["se"], passes["pe"]
    side = sw.side_lists(mapper, c1, c2, pe_batch, len(raw_pe))
    pe["side_lists"] = dict(overflowed_batches=sum(o for _, o in side),
                            pairs_in_cut_region=sum(int(m.sum()) for m, _ in side))
    # the bitonic network takes a power-of-two pool only: the pass runs at the
    # power of two at or above the chosen budget, beside its twin without it
    eb = 1 << (mc.expand_budget - 1).bit_length()
    cfg_b = dataclasses.replace(mc, expand_budget=eb)
    mt, mb = sw.with_cfg(mapper, cfg_b), sw.with_cfg(mapper, dataclasses.replace(
        cfg_b, bitonic_sort=True))
    twin, raw_twin = sw.timed_pass(
        mt, lambda i: mt.map_se_async(codes[i * args.batch : (i + 1) * args.batch], lens),
        n_se, args.depth, args.batch)
    with sort_sizes() as nel:
        bit, raw_bit = sw.timed_pass(
            mb, lambda i: mb.map_se_async(codes[i * args.batch : (i + 1) * args.batch], lens),
            n_se, args.depth, args.batch)
    pool = eb * rows
    bit.update(drop_stats(raw_bit), expand_budget=eb, voting_pool=pool, sort_nel=sorted(nel),
               twin_rows_per_s=twin["rows_per_s"], twin_launches=twin["launches"],
               equal_twin=all(sw.wire_equal(a, b) for a, b in zip(raw_bit, raw_twin)))
    del raw_twin, raw_bit
    rec.update(se=se, pe=pe, bitonic_pass=bit)
    for name, p in (("SE", se), ("PE", pe)):
        if p["map_rate"] < 0.9:
            failed.append(f"the {name} pass mapped under 90%")
    if (not bit["equal_twin"] or bit["sort_nel"] != [pool] or pool & (pool - 1)
            or (cuda and not bit["launches"].get("bitonic_sort_pairs"))):
        failed.append("the bitonic pass differs from its twin, sorted another pool than its "
                      "power of two, or did not launch K1")

    # ---- the kernels against their plain versions -------------------------------------
    rec["kernels"] = sw.kernel_checks(mapper, codes, c2, lens, cuda, pool)
    if not (rec["kernels"]["bitonic_sort_pairs"]["equal_plain"]
            and rec["kernels"]["anchor_walk"]["equal_plain"]):
        failed.append("a kernel disagrees with its plain version")

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
                            se_equal=sw.wire_equal(cse, raw_se[0]),
                            pe_equal=sw.wire_equal(cpe, raw_pe[0]),
                            se_overflowed=bool(cse.overflowed), pe_overflowed=bool(cpe.overflowed))
    del cm, cse, cpe
    gc.collect()
    if not (rec["cpu_plain"]["se_equal"] and rec["cpu_plain"]["pe_equal"]):
        failed.append("the CPU's plain batch differs from the card's")

    # ---- the fallback and the oracle -------------------------------------------------------
    orc, _, _ = sw.fallback_and_oracle(idx, mc, raw_se, raw_pe, codes, c1, c2, args.batch,
                                       pe_batch, args.oracle_sample, side=side)
    rec["oracle"] = orc
    del raw_se, raw_pe
    if any(orc[f"oracle_{k}"]["unequal"] or orc[f"oracle_{k}"]["cut_outside_overflow"]
           for k in ("se", "pe")):
        failed.append("a sampled read or pair differs from the oracle, or one cut by a full "
                      "record buffer or winner list lies in a batch where none overflowed")
    log(f"oracle: SE {orc['oracle_se']['parity']} (cut {orc['oracle_se']['cut_by_overflow']}), "
        f"PE {orc['oracle_pe']['parity']} (cut {orc['oracle_pe']['cut_by_overflow']}, by a "
        f"winner list {orc['oracle_pe']['cut_by_side_list']}); fallback "
        f"{orc['fallback_reads']} reads, {orc['fallback_pairs']} pairs")

    # ---- the command line, as child processes -------------------------------------------
    rec["cli"] = None
    if args.cli:
        cl = rec["cli"] = cli_runs(mapper, codes, c1, c2, os.path.join(cache, "idx_iso_v1"),
                                   cache, args.device, args.cli_batch)
        for kind in ("se", "pe"):
            c = cl[kind]
            if (c["rc"] != 0 or c["engine"] != "replicated" or c["unequal"] or c["extra"]
                    or c["overflow_warnings"] != c["library_drops"]["overflowed_batches"]
                    or (cuda and not c["launches"].get("anchor_walk"))):
                failed.append(f"the command line ({kind}) failed, picked the staged engine, "
                              "launched no walk, wrote other records or warned of another "
                              "number of overflows")

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
