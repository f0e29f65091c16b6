#!/usr/bin/env python3
"""Genome-scale core-artifact measurement on the port: the twin of
scripts/core_artifact_genome.py for rapmap_tpu_torch (host only; no card).

Writes the quasi_core artifact (text + SA, uint32 below 2^32 + transcript
geometry) of a saved index (--idx, memory-mapped), or takes one written by
`scripts/genome_scale_torch.py --save-core` (--core: a 90.8 GB full index at
2.2 Gbase does not fit every host's disk, its 11 GB core does). Then it
reloads the core through rapmap_tpu_torch.index.format.load_index, which
re-derives the k-mer interval table, prefix LUT, 2-bit text and
sa_txp/sa_tpos, holding a chunk besides them, and checks every array
against its save-time hash. It prints one JSON line with the reference's
record keys, plus the lowest MemAvailable seen during the reload.

Run it alone, in a process of its own: the reload holds the whole index
(~41 bytes a base, ~91 GB at 2.2 Gbase).

    python3 scripts/core_artifact_genome_torch.py --idx build/genome/idx
        [--out build/genome/core] [--keep] [--json-out PATH]
    python3 scripts/core_artifact_genome_torch.py --core build/genome/core
        [--json-out PATH]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def peak_rss_kb() -> int:
    """This process's peak resident set in kB: VmHWM where the kernel keeps
    it, else getrusage's maxrss (which, across fork and exec, starts from
    the parent's peak on Linux)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1])
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def card_line() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None on
    a host without one (this measurement does not use it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def npy_bytes(d: str) -> dict[str, int]:
    return {f[:-4]: os.path.getsize(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".npy")}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--idx", help="a saved full index: write its core, then reload it")
    src.add_argument("--core", help="a core artifact already written: reload it")
    ap.add_argument("--out", default=None,
                    help="where --idx's core goes (default: <idx>/../core)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the core --idx wrote (a --core input is always kept)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from rapmap_tpu_torch.index.format import load_index, save_core_index

    full_bytes = t_save = None
    if args.idx:
        core = args.out or os.path.join(os.path.dirname(os.path.abspath(args.idx)), "core")
        t0 = time.time()
        idx = load_index(args.idx, mmap=True)
        log(f"full index mmap-loaded ({time.time() - t0:.0f}s): n_text={idx.n_text:,}, "
            f"{len(idx.kmer_b):,} k-mers")
        full_bytes = sum(npy_bytes(args.idx).values())
        t0 = time.time()
        save_core_index(idx, core)
        t_save = time.time() - t0
        del idx
        gc.collect()
    else:
        core = args.core
    per = npy_bytes(core)
    core_bytes = sum(per.values())
    log(f"core artifact: {core_bytes / 2**30:.2f} GiB"
        + (f" written in {t_save:.0f}s (full index on disk: {full_bytes / 2**30:.1f} GiB)"
           if t_save is not None else ""))

    low = [mem_available_bytes()]
    done = threading.Event()

    def watch():
        while not done.wait(0.5):
            low[0] = min(low[0], mem_available_bytes())

    th = threading.Thread(target=watch, daemon=True)
    th.start()
    t0 = time.time()
    ridx = load_index(core)  # re-derives and hash-checks every array
    t_reload = time.time() - t0
    done.set()
    th.join()
    low[0] = min(low[0], mem_available_bytes())
    peak = peak_rss_kb() * 1024 / 1e9
    log(f"core reload (derive + hash verify): {t_reload:.1f}s, peak RSS {peak:.2f} GB, "
        f"MemAvailable as low as {low[0] / 1e9:.2f} GB; {len(ridx.kmer_b):,} k-mers")
    held = sum(a.nbytes for a in vars(ridx).values() if hasattr(a, "nbytes"))

    out = {
        "artifact": "quasi_core, reloaded by rapmap_tpu_torch",
        "idx_dir": args.idx,
        "core_dir": core,
        "full_index_disk_bytes": full_bytes,
        "core_disk_bytes": int(core_bytes),
        "core_per_array_bytes": per,
        "ratio": full_bytes / core_bytes if full_bytes else None,
        "t_save_s": t_save,
        "t_reload_verify_s": t_reload,
        "peak_rss_gb": peak,
        "index_bytes": int(held),
        "mem_available_low_bytes": low[0],
        "n_text": int(ridx.n_text),
        "n_kmers": int(len(ridx.kmer_b)),
        "sa_dtype": str(ridx.sa.dtype),
        "verified": "all stored + derived arrays hash-checked bit-exact",
        "host_cores": os.cpu_count(),
        "card": card_line(),
    }
    print(json.dumps(out), flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        log(f"record written to {args.json_out}")
    if args.idx and not args.keep:
        shutil.rmtree(core)
        log("core dir removed (pass --keep to retain)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
