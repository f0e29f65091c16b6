#!/usr/bin/env python3
"""Genome-scale (>= 2^31 bases) build and map on one CUDA card through the
port's host-staged engine: the twin of scripts/genome_scale.py for
rapmap_tpu_torch (upstream: src/RapMapSAIndexer.cpp's divsufsort64 bigSA
regime, SURVEY.md §3.1/§5.7).

Builds a ~2.2 Gbase synthetic transcriptome from a seed (which forces the
int64 SA and the int64 k-mer-interval layout), maps read batches with
rapmap_tpu_torch.parallel.staged.StagedMapper (one shard on the card at a
time: the ~88 GB of shard arrays never has to fit the card's 80 GB; stage A
is csrc/walk.cu's tqm_extend_packed_lanes, counter extend_packed_anchors),
and holds a read sample to the numpy oracle (rapmap_tpu_torch.oracle).

Host plan: text 1 + SA 8 + k-mer hi/lo 8 + b/e 16 + sa_txp/sa_tpos 8 +
text2b 0.25 ~= 41 B a base (~90 GB at 2.2 Gbase), where the build peaks
too, plus one shard's transients in the sweep; --save-index writes about as
much to disk. --save-core --cli writes the core artifact (~5 B a base) and
then maps the reads with `python -m rapmap_tpu_torch.cli quasimap --engine
auto` from it as a child process, once this process has dropped its index:
the child's core load rebuilds the same arrays holding a chunk besides them,
and every read's SAM records must equal the library sweep's. Before any FASTA or
build work a preflight reckons that plan against MemAvailable and the free
space of --workdir; when either is short it prints one JSON line with
"skipped", both figures and the plan, and exits 2. It never maps a smaller
index instead. Run alone.

    python3 scripts/genome_scale_torch.py [--gbase 2.2] [--reads 32768]
        [--batch 32768] [--oracle-sample 2000] [--shards N] [--k9-check]
        [--overlap-upload] [--save-index] [--save-core] [--cli]
        [--workdir build/genome] [--json-out PATH] [--device cuda|cpu]

On the CPU (plain versions of every kernel), at a toy size:
    python3 scripts/genome_scale_torch.py --device cpu --allow-small --big-sa
        --gbase 0.0003 --reads 256 --batch 128 --shards 3 --oracle-sample 256

The last line of standard output is the run's JSON record; --json-out also
writes it with the per-shard timings. A sweep cut short resumes from
<workdir>/sweep_ckpt.npz when the same command runs again with the same
workdir (the FASTA, and with --save-index the index, are reused too).
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import os
import resource
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READ_LEN = 76
GIB = 2**30


def log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def proc_status_kb(pid, key: str) -> int:
    """A kB line of /proc/<pid>/status (0 once the process has exited)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def rss_gb() -> float:
    """This process's peak resident set, in GB: VmHWM where the kernel
    keeps it, else getrusage's maxrss (which, across fork and exec, starts
    from the parent's peak on Linux)."""
    kb = proc_status_kb("self", "VmHWM:")
    return (kb or resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024 / 1e9


def gen_fasta(path: str, target_chars: int, seed: int = 5):
    """Random transcripts of lognormal lengths (2,000-200,000 bp) until the
    target is reached; the same bytes as scripts/genome_scale.py's."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    total = 0
    i = 0
    with open(path, "w") as f:
        while total < target_chars:
            L = int(np.clip(rng.lognormal(9.5, 0.8), 2_000, 200_000))
            seq = bases[rng.integers(0, 4, L)].tobytes().decode()
            f.write(f">g{i}\n{seq}\n")
            total += L
            i += 1
    return i, total


# ---- preflight ---------------------------------------------------------------


def mem_available_bytes() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


class MemWatch:
    """The lowest MemAvailable seen, sampled once a second by a daemon
    thread for the rest of the process."""

    def __init__(self):
        import threading

        self.low = mem_available_bytes()

        def watch():
            while True:
                time.sleep(1.0)
                self.low = min(self.low, mem_available_bytes())

        threading.Thread(target=watch, daemon=True).start()


def disk_free_bytes(path: str) -> int:
    return shutil.disk_usage(path).free


# What each process holds above the mapping arrays, measured at 2.2 Gbase
# on the H100's host (runs/genome_torch_r16.json, whose index is 90.80 GB):
# the build's process peaked at 99.50 GB (torch, the CUDA runtime, the heap
# its FASTA parse leaves), the library sweep at 103.14 GB and the command
# line's child at 99.88 GB, each beside 3 shards' transients (6.44 GB), the
# child's exec'd parent holding 0.10 GB.
BUILD_OVER = 8_700_000_000
SWEEP_OVER = 5_900_000_000
CLI_OVER = 2_800_000_000


def plan_bytes(target: int, big_sa: bool, shard_gb: float, fasta: bool, save_index: bool,
               save_core: bool, ckpt_bytes: int, cli: bool = False) -> dict:
    """What a run at `target` bases holds in host memory and writes to disk,
    with w = 8 bytes a slot in the int64 layout, else 4.

    Host, the largest of three peaks, each the mapping arrays (text 1, SA
    w, k-mer hi/lo 8, b/e 2w, sa_txp and sa_tpos 8, text2b 0.25 bytes a
    base) and what its process holds above them (measured, above). The
    build (index/builder.py) peaks at the arrays: its k-mer scan and 2-bit
    pack hold one chunk besides their results, and sa_txp_tpos's position
    map is as large as sa_tpos and gone before it. The sweep adds one
    shard's transients (its slice peaks at ~2x its finished arrays while
    the previous shard's arrays go up: 3 shards' bytes). With --cli the
    command line maps from the saved index or the core artifact as a child
    process: its load peaks at the arrays (index/format.py's core load
    holds a chunk besides them), its sweep as the sweep, and its parent is
    a fresh process holding no index. Disk: the FASTA (~1 byte a base)
    unless it is there, the saved index (the mapping arrays), the core
    artifact (text 1 + SA 4, or 8 past 2^32) and the sweep checkpoint."""
    w = 8 if big_sa else 4
    per_base = 1 + w + 8 + 2 * w + 8 + 0.25
    index = int(per_base * target)
    shards = int(3 * shard_gb * GIB)
    build = index + BUILD_OVER
    sweep = dict(index=index, shard_transients=shards, runtime=SWEEP_OVER)
    child = dict(index=index, shard_transients=shards, runtime=CLI_OVER) if cli else {}
    core_w = 4 if target < 2**32 else 8
    disk = dict(fasta=int(1.01 * target) if fasta else 0,
                index=index if save_index else 0,
                core=int((1 + core_w) * target) if save_core else 0,
                checkpoint=ckpt_bytes)
    return dict(host_bytes_per_base=per_base, host_build=build, host_sweep=sweep,
                host_cli=child,
                host_total=max(build, sum(sweep.values()), sum(child.values())), disk=disk,
                disk_total=sum(disk.values()))


def preflight(args, target: int, fa: str, idx_dir: str) -> dict:
    """The plan against the machine -> its record; "short" lists what the
    machine lacks (empty when the run fits)."""
    have_idx = os.path.exists(os.path.join(idx_dir, "header.json"))
    shard_gb = float(os.environ.get("TQM_STAGED_SHARD_GB", "2"))
    S = READ_LEN - 31 + 1
    n_batches = -(-args.reads // args.batch)
    plan = plan_bytes(
        target, big_sa=args.big_sa or target >= 2**31 - 2, shard_gb=shard_gb,
        fasta=not (os.path.exists(fa) and os.path.getsize(fa) >= target),
        save_index=args.save_index and not have_idx, save_core=args.save_core,
        ckpt_bytes=n_batches * 2 * args.batch * S * 21, cli=args.cli)
    mem, disk = mem_available_bytes(), disk_free_bytes(args.workdir)
    short = [what for what, need, got in (("host memory", plan["host_total"], mem),
                                          ("disk", plan["disk_total"], disk)) if need > got]
    return dict(plan=plan, mem_available_bytes=mem, disk_free_bytes=disk,
                workdir=os.path.abspath(args.workdir), short=short)


# ---- the run's parts -----------------------------------------------------------


def sample_reads(idx, n_reads: int):
    """Reads sampled from the text with seed 6: 76 bp, 1% substitutions, the
    first half reverse-complemented (scripts/genome_scale.py's reads)."""
    rng = np.random.default_rng(6)
    n_text = idx.n_text
    text = np.asarray(idx.text[:n_text])
    codes = np.empty((n_reads, READ_LEN), np.int8)
    starts = rng.integers(0, n_text - READ_LEN, size=n_reads)
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
    rcb = codes[:half]
    codes[:half] = np.where((rcb >= 1) & (rcb <= 4), 5 - rcb, rcb)[:, ::-1].astype(np.int8)
    return codes, rng


def cli_engine_choice(idx, device) -> dict:
    """What the command line's `quasimap --engine auto` picks for this index
    on this device (cli._choose_quasi_engine), with its log line."""
    from rapmap_tpu_torch import cli

    lines: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    h = Keep()
    cli.log.addHandler(h)
    try:
        engine = cli._choose_quasi_engine(argparse.Namespace(engine="auto"), idx, device)
    finally:
        cli.log.removeHandler(h)
    return dict(engine=engine, log=lines)


def k9_check(sm, codes, batch: int) -> dict:
    """extend_anchors (csrc/walk.cu's tqm_extend_packed_lanes) on the card
    against its plain version extend_packed(..., lane=) on the same card
    tensors: shard 0 of the index and the run's first batch, the compacted
    anchors at the budget A_max (as stage A hands them over), through the
    wrapper and the entry on 0xFF-filled outputs; then its device ms with a
    warm and a cold L2, the wrapper's ms, and the byte bound from the
    counting build tqm_extend_packed_traffic, with its share."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rapmap_tpu_torch.ops.extend_packed import extend_anchors, extend_packed

    k = sm.idx.k
    lens = np.full(batch, READ_LEN, np.int32)
    t0 = time.time()
    didx_np, _ = sm._shard_arrays(0)
    slice_s = time.time() - t0
    didx = sm._upload(didx_np)
    del didx_np
    a, n = cs.staged_anchor_inputs(sm, didx, codes[:batch], lens, sm.A_max)
    steps = max(1, int(np.ceil(np.log2(min(sm.cfg.max_interval,
                                            sm._st.max_interval_idx) + 1))) + 1)
    args = [a[f] for f in ("preads", "next_bad", "lens", "b0", "e0", "pos", "active")]
    want = extend_packed(didx, *args, k, steps, READ_LEN, lane=a["lane"])
    got = extend_anchors(didx, *args, a["lane"], k=k, ext_steps=steps)
    raw, _, _ = cs.extend_anchors_on_0xff(didx, a, k, steps)

    def diff(x, y):
        return int((x - y).abs().max()) if x.numel() else 0

    err = max(max(diff(g, w) for g, w in zip(got, want)),
              max(diff(g, w) for g, w in zip(raw, want)))
    run = lambda: extend_anchors(didx, *args, a["lane"], k=k, ext_steps=steps)  # noqa: E731
    timer = cs.Timer(True)
    wrapper_ms = timer(run, reps=50)
    ms, ms_by = cs.device_ms(run, 50, True)
    cold_event_ms, cold_ms = cs.walk_cold_ms(run, 50, True, kernel="extend_packed_kernel")
    plain_ms = timer(lambda: extend_packed(didx, *args, k, steps, READ_LEN, lane=a["lane"]),
                     reps=2, warm=1)
    counted, sectors, rows = cs.extend_anchors_on_0xff(didx, a, k, steps, count=True)
    if any(diff(g, w) for g, w in zip(counted, want)):
        raise RuntimeError("the counting build of the extension disagrees with the kernel")
    out_bytes = 3 * 8 * a["lane"].shape[0]
    nbytes = 32 * sum(sectors.values()) + out_bytes
    ops_rate = cs.int_ops_rate(True)["ops_per_s"]
    t_bytes = nbytes / cs.HBM_BYTES_PER_S * 1e3
    t_ops = 32 * rows / ops_rate * 1e3
    bound_ms = max(t_bytes, t_ops)
    rec = dict(kernel="extend_packed_anchors", shard=0, shard_slots=int(
        sm.geo.slot_cuts[1] - sm.geo.slot_cuts[0]), sa_cmp_bytes=int(didx.sa_cmp.numel() * 4),
        slice_s=slice_s, anchors=int(a["lane"].shape[0]), live=n, rows=int(a["preads"].shape[0]),
        steps=steps, max_abs_err=err, equal_plain=err == 0,
        extended=int((want[2] > k).sum()), ms=ms, cold_ms=cold_ms,
        cold_event_ms=cold_event_ms, wrapper_ms=wrapper_ms, device_ms_by_kernel=ms_by,
        plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
        bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes,
        output_bytes=out_bytes, input_sectors_read=sectors, sa_cmp_rows=rows,
        share_of_bound=bound_ms / ms, share_of_bound_cold=bound_ms / cold_ms)
    del didx, a, args, want, got, raw, counted
    torch.cuda.empty_cache()
    return rec


def sam_records(path: str) -> dict[str, list]:
    """A SAM file's mapped records by read name: [(rname, reverse, pos)]."""
    out: dict[str, list] = {}
    with open(path) as f:
        for ln in f:
            if ln[0] == "@":
                continue
            qn, flag, rname, pos = ln.split("\t", 4)[:4]
            if not int(flag) & 4:
                out.setdefault(qn, []).append((rname, bool(int(flag) & 16), int(pos)))
    return {q: sorted(v) for q, v in out.items()}


def rss_now_gb() -> float:
    """This process's resident set now (VmRSS), in GB."""
    return proc_status_kb("self", "VmRSS:") * 1024 / 1e9


def run_child(argv: list[str], env: dict, err_path: str) -> dict:
    """argv as a child process from the checkout's root, its standard error
    to err_path -> its exit code, wall seconds, wait4's maxrss (on Linux it
    starts from this process's peak), the largest VmRSS read every 0.2 s,
    the lowest MemAvailable while it ran, and its standard error."""
    watch = MemWatch()
    t0 = time.time()
    with open(err_path, "w") as err:
        child = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                                 stderr=err)
        polled = 0
        while True:
            pid, status, usage = os.wait4(child.pid, os.WNOHANG)
            if pid:
                break
            polled = max(polled, proc_status_kb(child.pid, "VmRSS:"))
            time.sleep(0.2)
    wall = time.time() - t0
    with open(err_path) as f:
        log_text = f.read()
    return dict(rc=os.waitstatus_to_exitcode(status), wall_s=wall,
                maxrss_gb=usage.ru_maxrss * 1024 / 1e9, rss_polled_max_gb=polled * 1024 / 1e9,
                mem_available_low_bytes=watch.low, log=log_text)


def cli_profile(log_text: str) -> tuple[dict, dict]:
    """The stage seconds and the kernel launches that `quasimap --profile`
    logs -> ({stage: seconds}, {kernel: launches})."""
    from rapmap_tpu_torch import kernels

    stage = {}
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    for line in log_text.splitlines():
        body = line.split("] ", 1)[-1]
        if body.startswith("stage "):
            name, secs = body.split()[1:3]
            stage[name] = float(secs.rstrip("s"))
        elif body.startswith("kernel launches: "):
            launches.update(json.loads(body[len("kernel launches: "):]))
    return stage, launches


def cli_run(index_dir: str, want: list, workdir: str, device: str, want_shards: int) -> dict:
    """`python -m rapmap_tpu_torch.cli quasimap --engine auto --batchSize
    <reads> --profile` over the run's reads (workdir/reads.fq), as a child
    process (one batch, so one sweep): its peak RSS (wait4's maxrss, which
    on Linux starts from this process's peak: cli_stage runs in a fresh
    one; and the largest VmRSS read every 0.2 s), the index load
    and engine set-up seconds and kernel launches it logs under --profile,
    its --statsJson, and every read's SAM records against `want` (the
    library sweep's, as [txp name, reverse, 1-based pos] lists). Parent and
    child share the host's memory: the parent holds no index."""
    fq, sam, stats, err_path = (os.path.join(workdir, f) for f in (
        "reads.fq", "reads.sam", "reads_stats.json", "cli_child.err"))
    env = {k: v for k, v in os.environ.items() if k != "TQM_FORCE_CPU"}
    if device == "cpu":
        env["TQM_FORCE_CPU"] = "1"
    argv = [sys.executable, "-m", "rapmap_tpu_torch.cli", "quasimap", "-i", index_dir,
            "-r", fq, "-o", sam, "--engine", "auto", "--batchSize", str(len(want)),
            "--statsJson", stats, "--profile"]
    parent_rss = rss_now_gb()
    ch = run_child(argv, env, err_path)
    log_text = ch["log"]
    rec = dict(argv=argv[2:], index=index_dir, rc=ch["rc"], wall_s=ch["wall_s"],
               parent_rss_gb_at_start=parent_rss, child_peak_rss_gb=ch["maxrss_gb"],
               child_rss_polled_max_gb=ch["rss_polled_max_gb"],
               mem_available_low_bytes=ch["mem_available_low_bytes"], want_shards=want_shards)
    if ch["rc"] != 0:
        return dict(rec, stderr_tail=log_text[-3000:])
    stage, launches = cli_profile(log_text)
    with open(stats) as f:
        st = json.load(f)
    got = sam_records(sam)
    unequal = sum(got.pop(f"r{i}", []) != [tuple(r) for r in w] for i, w in enumerate(want))
    return dict(rec, engine="staged" if "-> host-staged engine" in log_text else "replicated",
                load_s=stage.get("index_load"), engine_setup_s=stage.get("engine_setup"),
                sweep_s=st["wall_s"], stages_s=stage, launches=launches, stats=st,
                reads_checked=len(want), reads_unequal=unequal, reads_not_in_batch=len(got))


# ---- main ------------------------------------------------------------------------


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gbase", type=float, default=2.2)
    ap.add_argument("--shards", type=int, default=None,
                    help="shard count (default: staged_shards(idx), the command line's)")
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--oracle-sample", type=int, default=2000)
    ap.add_argument("--workdir", default=os.path.join(ROOT, "build", "genome"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) fails without a card; cpu runs the plain versions")
    ap.add_argument("--allow-small", action="store_true",
                    help="skip the >= 2^31 size assertions")
    ap.add_argument("--big-sa", action="store_true",
                    help="force the int64 SA layout at any size (build_quasi_index big_sa)")
    ap.add_argument("--save-index", action="store_true",
                    help="save the index under workdir/idx, drop the in-RAM build and "
                         "map the saved one file-backed (a rerun loads it)")
    ap.add_argument("--save-core", action="store_true",
                    help="also write the core artifact (text + SA) under workdir/core")
    ap.add_argument("--drop-fasta", action="store_true",
                    help="delete the FASTA once the index is built or loaded (the build is "
                         "its only reader; a filesystem held in memory gives its bytes back)")
    ap.add_argument("--overlap-upload", action="store_true",
                    help="upload shard p+1 on a side stream while shard p runs")
    ap.add_argument("--k9-check", action="store_true",
                    help="hold K9 to its plain version on shard 0 and time it (card only)")
    ap.add_argument("--cli", action="store_true",
                    help="also map the reads with `quasimap --engine auto` from the saved "
                         "index (--save-index) or core artifact (--save-core), as a child "
                         "process once this one has dropped its index")
    ap.add_argument("--json-out", default=None,
                    help="also write the record, with the per-shard timings, here")
    return ap


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    ap = parser()
    ap.add_argument("--cli-from", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cli_from:
        return cli_stage(args.cli_from)[0]
    rc, out, _, _ = run(ap, argv, cli_inline=False)
    if out is not None and "cli_state" in out:
        # the command line's run in a fresh process, this one's memory gone
        sys.stdout.flush()
        sys.stderr.flush()
        os.execv(sys.executable, [sys.executable, os.path.abspath(__file__),
                                  "--cli-from", out["cli_state"]])
    return rc


def run(ap: argparse.ArgumentParser, argv: list[str] | None = None, cli_inline: bool = True):
    """The run -> (exit code, its record or None, the per-batch records of
    the staged engine or None, the read codes or None). With --cli it
    writes the command line's state file; cli_inline runs the command line
    from it here, else the record carries the file as "cli_state" (main()
    then execs into the command line's stage)."""
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("no CUDA device: this run maps on a CUDA card (--device cpu runs the plain "
            "versions on the CPU)")
        return 1, None, None, None
    if args.k9_check and args.device != "cuda":
        ap.error("--k9-check times the kernel on the card; it needs --device cuda")
    if args.cli and not (args.save_index or args.save_core):
        ap.error("--cli maps from a saved index: add --save-index or --save-core")
    target = int(args.gbase * 1e9)
    if not args.allow_small and target < 2**31:
        ap.error("this run exists to exercise the >= 2^31 regime (or pass --allow-small)")

    os.makedirs(args.workdir, exist_ok=True)
    fa = os.path.join(args.workdir, "genome.fa")
    idx_dir = os.path.join(args.workdir, "idx")
    pre = preflight(args, target, fa, idx_dir)
    if pre["short"]:
        print(json.dumps(dict(metric="genome_scale_staged", gbase=args.gbase,
                              skipped="not enough " + " and ".join(pre["short"]), **pre)),
              flush=True)
        return 2, None, None, None
    watch = MemWatch()
    log(f"preflight: host plan {pre['plan']['host_total'] / 1e9:.1f} GB of "
        f"{pre['mem_available_bytes'] / 1e9:.1f} GB available, disk plan "
        f"{pre['plan']['disk_total'] / 1e9:.1f} GB of {pre['disk_free_bytes'] / 1e9:.1f} GB free")

    sys.path.insert(0, ROOT)
    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.index.builder import build_quasi_index
    from rapmap_tpu_torch.index.format import load_index, save_core_index
    from rapmap_tpu_torch.oracle import quasimap as qm
    from rapmap_tpu_torch.parallel.staged import (
        StagedMapper, staged_device_bytes, staged_shards,
    )

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    card = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(),
                nvidia_smi=subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                    check=True, capture_output=True, text=True, timeout=60,
                ).stdout.strip().splitlines()[0]) if cuda else dict(platform="cpu")

    if cuda:  # stage A's kernel, built while the host's memory is still free
        t0 = time.time()
        kernels.build_all(["walk"])
        log(f"csrc/walk.cu built ({time.time() - t0:.0f}s)")
    t0 = time.time()
    fasta_s = 0.0
    if not os.path.exists(fa) or os.path.getsize(fa) < target:
        n_seq, total = gen_fasta(fa, target)
        fasta_s = time.time() - t0
        log(f"fasta: {n_seq} seqs, {total / 1e9:.4f} Gbase ({fasta_s:.0f}s)")

    t0 = time.time()
    loaded = os.path.exists(os.path.join(idx_dir, "header.json"))
    if loaded:
        idx = load_index(idx_dir, mmap=True)
        t_build = time.time() - t0
        log(f"index loaded from {idx_dir} ({t_build:.0f}s, mmap)")
    else:
        idx = build_quasi_index(fa, outdir=idx_dir if args.save_index else None, k=31,
                                with_chd=False, big_sa=args.big_sa or None)
        t_build = time.time() - t0
        if args.save_index:
            # drop the in-RAM build and map the saved one file-backed: its pages
            # are reclaimable under the sweep's own host transients
            del idx
            gc.collect()
            idx = load_index(idx_dir, mmap=True)
            log("build dropped from RAM; remapped file-backed for the sweep")
    if args.drop_fasta:
        os.remove(fa)
    n_text = idx.n_text
    sa_dtype = np.asarray(idx.sa).dtype
    log(f"index: n_text={n_text:,} ({n_text / 2**31:.3f} x 2^31), SA dtype {sa_dtype}, "
        f"{len(idx.kmer_b):,} k-mers, {t_build:.0f}s, peak RSS {rss_gb():.1f} GB")
    assert args.allow_small or (n_text >= 2**31 and sa_dtype == np.int64)
    rss_build = rss_gb()
    device_bytes = staged_device_bytes(idx)
    card_bytes = torch.cuda.get_device_properties(0).total_memory if cuda else None
    engine_auto = cli_engine_choice(idx, device)
    cli_shards = staged_shards(idx)  # the command line's own shard count
    log(f"shard arrays {device_bytes / 1e9:.2f} GB; card {card_bytes}; "
        f"quasimap --engine auto: {engine_auto}")

    core = None
    if args.save_core:
        t0 = time.time()
        info = save_core_index(idx, os.path.join(args.workdir, "core"))
        core = dict(bytes=info["bytes"], seconds=time.time() - t0)
        log(f"core artifact: {info['bytes'] / 2**30:.2f} GiB in {core['seconds']:.0f}s")

    codes, rng = sample_reads(idx, args.reads)
    cfg = MapConfig(k=31, max_hits_per_strand=8)
    n_shards = args.shards or staged_shards(idx)
    sm = StagedMapper(idx, cfg, n_shards=n_shards, read_len=READ_LEN, batch=args.batch,
                      device=device)
    # a resumable sweep: the geometry and the reads are deterministic, so a
    # rerun resumes at the last snapshot (removed once the sweep completes)
    sm.checkpoint_path = os.path.join(args.workdir, "sweep_ckpt.npz")
    sm.checkpoint_every = 4
    sm.upload_overlap = args.overlap_upload
    geo = sm.geo
    log(f"geometry: {n_shards} shards, S_pad={geo.S_pad:,} slots, K_pad={geo.K_pad:,} rows "
        f"(a shard's sa_cmp ~{geo.S_pad * 24 / 1e9:.2f} GB)")

    n_reads = args.reads
    batches = [codes[i : i + args.batch] for i in range(0, n_reads, args.batch)]
    if len(batches[-1]) < args.batch:  # the engine maps whole batches
        pad = np.zeros((args.batch - len(batches[-1]), READ_LEN), np.int8)
        batches[-1] = np.concatenate([batches[-1], pad])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    results, stats = sm.map_batches(batches)
    if cuda:
        torch.cuda.synchronize()
    t_map = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    max_mem = torch.cuda.max_memory_allocated() if cuda else None
    mapped = sum(1 for i in range(n_reads) if results[i // args.batch][i % args.batch])
    timings = list(sm.shard_timings)
    t_upload = sum(t["upload_s"] for t in timings)
    t_slice = sum(t["slice_s"] for t in timings)
    t_dev = sum(t["device_union_s"] for t in timings)
    up_mb = sum(t["upload_mb"] for t in timings)
    rss_sweep = rss_gb()
    log(f"mapped {mapped}/{n_reads} reads in {t_map:.1f}s = {n_reads / t_map:,.1f} reads/s "
        f"amortized at depth {n_reads:,} (slice {t_slice:.1f}s, upload {t_upload:.1f}s, "
        f"device+union {t_dev:.1f}s); {launches}; peak RSS {rss_sweep:.1f} GB")
    swept = len(timings) == n_shards and (
        not cuda or launches.get("extend_packed_anchors", 0) >= n_shards * len(batches))

    k9 = k9_check(sm, codes, args.batch) if args.k9_check else None
    if k9 is not None:
        log(f"K9 at shard 0: err {k9['max_abs_err']}, {k9['ms']} ms warm, "
            f"{k9['cold_ms']} cold, bound {k9['bound_ms']} ({k9['share_of_bound']:.3f})")

    # the oracle sample: free the staged mapper first (the sweep ends near the
    # host's memory ceiling at genome scale)
    del sm
    gc.collect()
    t0 = time.time()
    ns = min(args.oracle_sample, n_reads)
    sel = rng.choice(n_reads, ns, replace=False)
    bad = 0
    for i in sel:
        bi, ri = divmod(int(i), args.batch)
        want = [(m.txp, m.pos, 0 if m.fwd else 1, m.score)
                for m in qm.map_read(idx, codes[i], cfg)]
        if results[bi][ri] != want:
            bad += 1
            log(f"MISMATCH read {i}: staged {results[bi][ri][:3]} oracle {want[:3]}")
    oracle_s = time.time() - t0
    log(f"oracle parity: {ns - bad}/{ns} reads exact ({oracle_s:.0f}s)")

    out = {
        "metric": "genome_scale_staged",
        "device": card,
        "gbase": args.gbase,
        "n_text": int(n_text),
        "n_text_over_2_31": n_text / 2**31,
        "sa_dtype": str(sa_dtype),
        "int64_sa": sa_dtype == np.int64,
        "index_loaded": loaded,
        "fasta_s": fasta_s,
        "build_s": t_build,
        "queue_depth": int(n_reads),
        "batch": int(args.batch),
        "n_shards": int(n_shards),
        "S_pad": int(geo.S_pad),
        "K_pad": int(geo.K_pad),
        "device_bytes": int(device_bytes),
        "card_bytes": card_bytes,
        "device_bytes_over_card": device_bytes / card_bytes if card_bytes else None,
        "cli_engine_auto": engine_auto,
        "map_wall_s": t_map,
        "map_reads_per_s_amortized": n_reads / t_map,
        "map_rate_pct": 100.0 * mapped / n_reads,
        "slice_s_total": t_slice,
        "upload_s_total": t_upload,
        "upload_gib_total": up_mb / 1024,
        "upload_MBps": up_mb / max(t_upload, 1e-9),
        "device_union_s_total": t_dev,
        "launches": launches,
        "every_shard_swept": swept,
        "anchor_overflow": int(stats.get("anchor_overflow", 0)),
        "max_memory_allocated": max_mem,
        "oracle_parity": f"{ns - bad}/{ns}",
        "oracle_s": oracle_s,
        "peak_rss_gb_build": rss_build,
        "peak_rss_gb_sweep": rss_sweep,
        "peak_rss_gb": rss_gb(),
        "mem_available_low_bytes": watch.low,
        "k9_check": k9,
        "core": core,
        "cli": None,
        "preflight": pre,
    }

    if args.json_out:  # kept should a later step not come back
        write_record(args.json_out, out, timings)
    failed = [what for what, bad_ in (
        ("oracle parity", bad), ("a shard was not swept through K9", not swept),
        ("K9 disagrees with its plain version", k9 is not None and k9["max_abs_err"]))
        if bad_]
    if not args.cli:
        return finish(out, failed), out, results, codes
    # the command line's run, from a state file: what it maps and what its
    # records must be (every read's, from the library sweep)
    names = list(idx.txp_names)
    src = os.path.abspath(idx_dir if args.save_index else os.path.join(args.workdir, "core"))
    state = os.path.join(os.path.abspath(args.workdir), "cli_state.json")
    write_fastq(os.path.join(args.workdir, "reads.fq"), codes)
    with open(state, "w") as f:
        json.dump(dict(record=out, timings=timings, failed=failed, index_dir=src,
                       workdir=os.path.abspath(args.workdir), device=args.device,
                       json_out=args.json_out, want_shards=cli_shards,
                       want=[sorted((names[t], s_ == 1, max(p_, 0) + 1)
                                    for t, p_, s_, _ in results[i // args.batch][
                                        i % args.batch]) for i in range(n_reads)]), f)
    del idx, names
    if not cli_inline:
        return 0, dict(out, cli_state=state), results, codes
    rc, out = cli_stage(state)
    return rc, out, results, codes


def write_fastq(path: str, codes) -> None:
    with open(path, "w") as f:
        for i, c in enumerate(codes):
            f.write(f"@r{i}\n{''.join('NACGTN'[int(x)] for x in c)}\n+\n{'I' * len(c)}\n")


def write_record(path: str, out: dict, timings: list) -> None:
    with open(path, "w") as f:
        json.dump({**out, "shard_timings": timings}, f, indent=1)
    log(f"record written to {path}")


def finish(out: dict, failed: list[str]) -> int:
    """Print the record as the last line of standard output -> exit code."""
    print(json.dumps(out), flush=True)
    if failed:
        log("FAILED: " + "; ".join(failed))
    return int(bool(failed))


def cli_stage(state_path: str):
    """The command line's run of a state file that run() wrote: `quasimap
    --engine auto` as a child process (cli_run), its records against every
    read's, added to the record -> (exit code, record). main() runs it in
    a fresh process (run() execs into it), so that the library run's
    torch, CUDA context and heap are gone while the child holds the index."""
    sys.path.insert(0, ROOT)
    with open(state_path) as f:
        st = json.load(f)
    out = st["record"]
    cli = out["cli"] = cli_run(st["index_dir"], st["want"], st["workdir"], st["device"],
                               st["want_shards"])
    if cli["rc"] == 0:
        log(f"quasimap --engine auto ({cli['engine']}, child process): {cli['wall_s']:.1f}s "
            f"(load {cli['load_s']:.1f}s, sweep {cli['sweep_s']:.1f}s), peak RSS "
            f"{cli['child_peak_rss_gb']:.2f} GB beside this process's "
            f"{cli['parent_rss_gb_at_start']:.2f}; {cli['launches']}; "
            f"{cli['reads_unequal']} of {cli['reads_checked']} reads unequal")
    else:
        log(f"quasimap returned {cli['rc']}:\n{cli['stderr_tail']}")
    if st["json_out"]:
        write_record(st["json_out"], out, st["timings"])
    cli_bad = (cli["rc"] != 0 or cli["reads_unequal"] or cli["reads_not_in_batch"]
               or cli["engine"] != out["cli_engine_auto"]["engine"]
               or (st["device"] == "cuda" and cli["engine"] == "staged"
                   and cli["launches"]["extend_packed_anchors"] < st["want_shards"]))
    failed = st["failed"] + (["the command line failed, picked another engine, skipped K9 "
                              "on a shard or wrote other records"] if cli_bad else [])
    return finish(out, failed), out


if __name__ == "__main__":
    sys.exit(main())
