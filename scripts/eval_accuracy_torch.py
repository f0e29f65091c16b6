#!/usr/bin/env python3
"""Mapping accuracy on simulated reads, the paper's protocol, on a CUDA card:
the twin of scripts/eval_accuracy.py for rapmap_tpu_torch.

Reads with a known (transcript, position, strand) are simulated from a
FASTA (substitutions, Ns, optional indels and half-random chimeras), mapped
by the port's QuasiMapper under MapConfig's defaults (expansion budget 8, 4
record slots a read; with --mappingScore the banded score and, above 0,
the --minScoreFraction filter), and scored: a read is a true positive when
its mappings hold the true locus; precision counts the reported loci that
are the true one (or, for the equivalent precision, sequence-identical to
it).

The flags, the one seeded generator and the order of its draws (world,
index, simulate, mapping) are the reference's, and `simulate` is copied
from it (that script configures JAX when imported), so on the same flags
the last line of standard output is the reference's JSON object, key for
key and value for value. The lines before it say what else the run
measured: the card's name and power limit, the kernels' launches, the
batches whose record buffer overflowed and the records they dropped.

    python3 scripts/eval_accuracy_torch.py --isoform [-n 20000]
        [--chimeraFrac 0.1 --mappingScore --minScoreFraction 0.65]
        [--indelRate 0.01] [--device cuda|cpu]

--device cuda (the default) exits 1 without a card; --device cpu runs the
plain versions of every kernel on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (ROOT, HERE) if p not in sys.path]

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def simulate(txps, n_reads, read_len, err, n_rate, rng, chimera_frac=0.0,
             indel_rate=0.0):
    """-> (reads, truth) with truth rows (txp, pos, rc, pos_tol): pos_tol is
    the net coordinate slack an indel read's reported position may carry —
    quasi-mapping has no gapped alignment (CIGAR is <len>M, paper §2), so an
    MMP chain broken by an indel legitimately votes positions shifted by up
    to the total indel length (SEMANTICS.md §3/§4)."""
    reads, truth = [], []
    lens = np.array([len(s) for _, s in txps])
    ok = np.nonzero(lens >= read_len + 16)[0]
    for i in range(n_reads):
        t = int(ok[rng.integers(0, len(ok))])
        seq = txps[t][1]
        if chimera_frac and rng.random() < chimera_frac:
            # half-true/half-random junction read: SHOULD stay unmapped, but
            # its true half anchors MMPs — the --minScoreFraction testbed
            p = int(rng.integers(0, len(seq) - read_len + 1))
            r = bytearray(seq[p : p + read_len])
            half = read_len // 2
            r[half:] = BASES[rng.integers(0, 4, read_len - half)].tobytes()
            reads.append(bytes(r))
            truth.append((-1, -1, False, 0))
            continue
        tol = 0
        if indel_rate:
            # copy reference bases from p, injecting indel events, until
            # exactly read_len read bases exist; tol = total indel length
            p = int(rng.integers(0, len(seq) - read_len - 12))
            r = bytearray()
            sp = p
            while len(r) < read_len and sp < len(seq):
                if rng.random() < indel_rate:
                    ilen = min(int(rng.geometric(0.6)), 3)
                    tol += ilen
                    if rng.random() < 0.5:  # insertion: novel bases
                        r += BASES[rng.integers(0, 4, ilen)].tobytes()
                        continue
                    sp += ilen  # deletion: skip reference bases
                    continue
                r.append(seq[sp])
                sp += 1
            if len(r) < read_len:  # ran off the transcript: degenerate, retry
                r += BASES[rng.integers(0, 4, read_len - len(r))].tobytes()
            r = r[:read_len]
        else:
            p = int(rng.integers(0, len(seq) - read_len + 1))
            r = bytearray(seq[p : p + read_len])
        for j in range(read_len):
            u = rng.random()
            if u < err:
                r[j] = BASES[int(rng.integers(0, 4))]
            elif u < err + n_rate:
                r[j] = ord("N")
        rc = bool(rng.random() < 0.5)
        if rc:
            r = bytearray(bytes(r).translate(COMP)[::-1])
        reads.append(bytes(r))
        truth.append((t, p, rc, tol))
    return reads, truth


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-t", "--transcripts")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument(
        "--isoform", action="store_true",
        help="isoform-style synthetic txome (shared exons + paralogs) — real "
        "multimapping pressure; see scripts/txome_sim.py",
    )
    ap.add_argument("-n", "--numReads", type=int, default=20000)
    ap.add_argument("-l", "--readLen", type=int, default=76)
    ap.add_argument("-e", "--errorRate", type=float, default=0.01)
    ap.add_argument("--nRate", type=float, default=0.002)
    ap.add_argument("-k", "--kmerLen", type=int, default=31)
    ap.add_argument("--batchSize", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--chimeraFrac", type=float, default=0.0,
                    help="fraction of half-true/half-random junction reads "
                    "(no true locus; should be reported unmapped)")
    ap.add_argument("--indelRate", type=float, default=0.0,
                    help="per-base probability of an indel event (1-3 bp, "
                    "ins/del 50/50); recall then tolerates the indel-induced "
                    "position shift (quasi-mapping emits no gapped alignment)")
    ap.add_argument("--mappingScore", action="store_true",
                    help="score mappings (SEMANTICS.md §9)")
    ap.add_argument("--minScoreFraction", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) fails without a card; cpu runs the plain versions")
    return ap


def card_record(cuda: bool) -> dict:
    """The device the run mapped on, with nvidia-smi's name and power limit."""
    import torch

    if not cuda:
        return dict(platform="cpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), nvidia_smi=smi.stdout.strip().splitlines()[0])


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("eval_accuracy_torch: no CUDA device; this run maps on a CUDA card "
              "(--device cpu runs the plain versions on the CPU)", file=sys.stderr)
        return 1
    cuda = args.device == "cuda"
    t_start = time.time()
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="tqm_eval_") as tmp:
        if args.isoform:
            from txome_sim import gen_isoform_txome, write_fasta

            fa = os.path.join(tmp, "txome_isoform.fa")
            write_fasta(gen_isoform_txome(rng), fa)
            args.transcripts = fa
        elif args.synthetic or not args.transcripts:
            fa = os.path.join(tmp, "txome.fa")
            with open(fa, "w") as f:
                for i in range(2000):
                    L = int(rng.integers(300, 3000))
                    f.write(f">t{i}\n{BASES[rng.integers(0, 4, L)].tobytes().decode()}\n")
            args.transcripts = fa
        return evaluate(args, rng, cuda, t_start)


def evaluate(args, rng, cuda: bool, t_start: float) -> int:
    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.index.builder import build_quasi_index
    from rapmap_tpu_torch.index.encode import encode_reads
    from rapmap_tpu_torch.io.fastx import read_fasta
    from rapmap_tpu_torch.models import scorefilter
    from rapmap_tpu_torch.models.quasi import QuasiMapper

    if cuda:
        kernels.build_all()
    txps = [(n, s) for n, s in read_fasta(args.transcripts)]
    idx = build_quasi_index(args.transcripts, k=args.kmerLen)
    name_to_id = {n: i for i, n in enumerate(idx.txp_names)}
    reads, truth = simulate(txps, args.numReads, args.readLen, args.errorRate,
                            args.nRate, rng, args.chimeraFrac, args.indelRate)

    cfg = MapConfig(k=idx.k, mapping_score=args.mappingScore,
                    min_score_fraction=args.minScoreFraction)
    mapper = QuasiMapper(idx, cfg, device=args.device)
    id_to_seq = {name_to_id[n]: s for n, s in txps}
    B = args.batchSize
    L = args.readLen
    tp = fn = 0
    chim_total = chim_mapped = 0
    reported = 0
    correct_reported = 0
    equivalent_reported = 0
    ctr_tot: dict[str, int] = {}
    batches = overflowed = dropped = 0
    kernels.reset_launches()
    t_map = time.time()
    for s in range(0, len(reads), B):
        chunk = reads[s : s + B]
        codes = np.full((B, L), 5, dtype=np.int8)
        for i, r in enumerate(chunk):
            codes[i] = encode_reads(np.frombuffer(r, dtype=np.uint8))
        lens = np.full(B, L, np.int32)
        wr = mapper.fetch(mapper.map_se_async(codes, lens, n_valid=len(chunk)))
        batches += 1
        overflowed += bool(wr.overflowed)
        dropped += int(wr.total) - len(wr.recs)
        if cfg.mapping_score and cfg.min_score_fraction > 0.0:
            wr = scorefilter.filter_se(wr, lens, cfg)
        for key, val in wr.counters.items():
            ctr_tot[key] = ctr_tot.get(key, 0) + int(val)
        off = 0
        for i in range(len(chunk)):
            c = int(wr.counts[i])
            locs = {
                (int(wr.recs[off + j][0]), int(wr.recs[off + j][1]), int(wr.recs[off + j][2]))
                for j in range(c)
            }
            off += c
            t, p, rc, tol = truth[s + i]
            if t == -1:  # chimeric read: any mapping is a false positive
                chim_total += 1
                chim_mapped += int(bool(locs))
                continue
            s_true = 1 if rc else 0
            tid = name_to_id[txps[t][0]]
            true_w = txps[t][1][p : p + L]
            true_w_rc = true_w.translate(COMP)[::-1]
            reported += len(locs)
            hit = False
            for t2, p2, s2 in locs:
                # pos_tol-window match (exact for substitution-only reads)
                if t2 == tid and s2 == s_true and abs(p2 - p) <= tol:
                    hit = True
                    correct_reported += 1
                w2 = id_to_seq.get(t2, b"")[p2 : p2 + L]
                if w2 == (true_w if s2 == s_true else true_w_rc):
                    equivalent_reported += 1  # sequence-identical locus:
                    # a correct mapping under real multimapping
            if hit:
                tp += 1
            else:
                fn += 1
    map_s = time.time() - t_map
    print(json.dumps(dict(
        metric="accuracy_run", device=card_record(cuda), expand_pairs=mapper.cfg.expand_pairs,
        batches=batches, overflowed_batches=overflowed, records_dropped=dropped,
        launches={k: v for k, v in kernels.LAUNCHES.items() if v},
        map_and_score_s=map_s, seconds=time.time() - t_start)), flush=True)
    recall = tp / max(tp + fn, 1)
    precision = correct_reported / max(reported, 1)
    print(json.dumps({
        "reads": len(reads), "read_len": args.readLen, "error_rate": args.errorRate,
        "txome": "isoform" if args.isoform else os.path.basename(args.transcripts),
        "expand_budget": mapper.cfg.expand_budget,
        "recall_true_locus": round(recall, 4),
        "precision_reported_loci": round(precision, 4),
        "precision_equivalent_loci": round(equivalent_reported / max(reported, 1), 4),
        "mean_loci_per_read": round(reported / len(reads), 3),
        "over_budget_reads": ctr_tot.get("over_budget", 0),
        "too_ambiguous_reads": ctr_tot.get("too_ambiguous", 0),
        **({"chimera_reads": chim_total, "chimera_mapped": chim_mapped,
            "score_filtered_records": ctr_tot.get("score_filtered", 0)}
           if args.chimeraFrac or args.mappingScore else {}),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
