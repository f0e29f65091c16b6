"""Index construction: quasiindex and pseudoindex (offline, host-side; copy
of rapmap_tpu.index.builder).

Covers the reference's RapMapSAIndexer / RapMapIndexer (SURVEY.md §2.1 #2, #9):
FASTA -> $-concatenated coded text -> suffix array (native SA-IS when built,
numpy fallback) -> k-mer interval table / CSR occurrence lists -> flat arrays.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from rapmap_tpu_torch.index import encode
from rapmap_tpu_torch.index.format import PseudoIndex, QuasiIndex, save_index
from rapmap_tpu_torch.index.kmer_table import (
    build_kmer_table,
    build_prefix_lut,
    pack_text_2bit,
)
from rapmap_tpu_torch.index.suffix_array import suffix_array_numpy
from rapmap_tpu_torch.io.fastx import read_fasta

log = logging.getLogger("tqm.index")

PAD_TAIL = 1024  # trailing zero pad on text so device gathers never go OOB


def concat_transcriptome(fasta_path: str, seed: int = 0, dedup: bool = True):
    """Read FASTA, encode, dedup identical sequences (logged, as the reference
    does [MED]), concatenate with '$' after every transcript.

    Returns (text int8 codes incl. PAD_TAIL zeros, n_text, names, offsets int64,
    lens int32).
    """
    names: list[str] = []
    lens: list[int] = []
    offsets: list[int] = []
    chunks: list[np.ndarray] = []
    seen: dict[bytes, str] = {}
    pos = 0
    n_dup = 0
    for name, seq in read_fasta(fasta_path):
        if dedup:
            h = seq.upper()
            if h in seen:
                n_dup += 1
                log.info("duplicate transcript %s == %s; dropped", name, seen[h])
                continue
            seen[h] = name
        codes = encode.encode_transcript(np.frombuffer(seq, dtype=np.uint8), pos, seed)
        names.append(name)
        lens.append(len(codes))
        offsets.append(pos)
        chunks.append(codes)
        chunks.append(np.zeros(1, dtype=np.int8))  # '$'
        pos += len(codes) + 1
    if not names:
        raise ValueError(f"no transcripts in {fasta_path}")
    if n_dup:
        log.info("dropped %d duplicate transcripts", n_dup)
    chunks.append(np.zeros(PAD_TAIL, dtype=np.int8))
    text = np.concatenate(chunks)
    return (
        text,
        pos,
        names,
        np.array(offsets, dtype=np.int64),
        np.array(lens, dtype=np.int32),
    )


def _build_sa(text: np.ndarray, n_text: int) -> np.ndarray:
    try:
        from rapmap_tpu_torch.native import bindings as nat

        if nat.available():
            return nat.suffix_array(text[:n_text])
    except Exception as exc:  # pragma: no cover - native build issues
        log.warning("native SA builder unavailable (%s); numpy fallback", exc)
    return suffix_array_numpy(text[:n_text])


def sa_txp_tpos(sa: np.ndarray, txp_offsets: np.ndarray, txp_lens: np.ndarray,
                chunk: int = 1 << 26) -> tuple[np.ndarray, np.ndarray]:
    """(sa_txp, sa_tpos) int32: each SA slot's transcript and its position in
    it. Transcript t owns global positions [off_t, off_t + len_t] (incl. its
    '$'); a pos->txp map is materialized once and gathered, one O(1) load a
    slot instead of a binary search over the offsets. Both come out in
    chunks of slots, so no int64 temporary spans the SA (one would take 17.6
    GB at 2.2e9 slots), and the pos->txp map is gone before sa_tpos is
    allocated: the peak is the two results' bytes and a chunk's."""
    spans = txp_lens.astype(np.int64) + 1
    pos2txp = np.repeat(np.arange(len(txp_lens), dtype=np.int32), spans)
    sa = np.asarray(sa)
    sa_txp = np.empty(len(sa), np.int32)
    for s in range(0, len(sa), chunk):
        # clip: indices are in range, and take() buffers its out= otherwise
        np.take(pos2txp, sa[s : s + chunk], out=sa_txp[s : s + chunk], mode="clip")
    del pos2txp
    off = np.asarray(txp_offsets, dtype=np.int64)
    sa_tpos = np.empty(len(sa), np.int32)
    for s in range(0, len(sa), chunk):
        sa_tpos[s : s + chunk] = sa[s : s + chunk] - off[sa_txp[s : s + chunk]]
    return sa_txp, sa_tpos


def build_quasi_index(
    fasta_path: str,
    outdir: str | None = None,
    k: int = 31,
    prefix_bases: int | None = None,
    seed: int = 0,
    dedup: bool = True,
    big_sa: bool | None = None,
    require_chd: bool = False,
    with_chd: bool = True,
) -> QuasiIndex:
    """big_sa: force the int64 SA layout (upstream divsufsort64 dispatch,
    SURVEY.md §3.1). Default None = automatic by text size; True lets tests
    exercise the bigSA device path on small texts.

    require_chd: `-x/--perfectHash` semantics — fail the build if the CHD
    perfect hash cannot be constructed (instead of silently falling back to
    the binary-search probe at map time).

    with_chd=False skips CHD construction entirely (genome-scale builds: a
    ~2G-key table would need a 2^32-slot permutation; the staged/sharded
    mappers build per-shard tables or use the binary-search probe)."""
    if not (1 <= k <= 32):
        raise ValueError("k must be in [1, 32]")
    t0 = time.time()
    text, n_text, names, offsets, lens = concat_transcriptome(fasta_path, seed, dedup)
    log.info("concat %d transcripts, %d bases (%.1fs)", len(names), n_text, time.time() - t0)
    t0 = time.time()
    # SA-IS runs in a worker thread (the native call releases the GIL) while
    # the main thread packs the text — the pack only needs `text` and the
    # single-threaded SA build leaves cores idle otherwise
    import threading

    sa_box: dict = {}

    def _sa_job():
        try:
            sa_box["sa"] = _build_sa(text, n_text)
        except BaseException as exc:  # re-raised at join
            sa_box["exc"] = exc

    th_sa = threading.Thread(target=_sa_job, name="tqm-sa")
    th_sa.start()
    text2b, smask2b = pack_text_2bit(text)  # one pack serves scan + device text
    th_sa.join()
    if "exc" in sa_box:
        raise sa_box["exc"]
    sa = sa_box.pop("sa")  # the box must not keep a second SA alive
    if big_sa:
        sa = sa.astype(np.int64, copy=False)
    log.info("suffix array + text pack built (%.1fs, overlapped)", time.time() - t0)
    t0 = time.time()
    khi, klo, kb, ke = build_kmer_table(
        text[:n_text], sa, k, packed_smask=(text2b, smask2b)
    )
    del smask2b
    log.info("k-mer table: %d distinct %d-mers (%.1fs)", len(kb), k, time.time() - t0)
    t0 = time.time()
    # canonical-class CHD perfect hash (BooPHF role): the device resolves
    # BOTH strands of a window with one 2-gather probe (ops/lookup.py).
    # It only needs the k-mer keys, so it runs in a worker thread (native,
    # internally OpenMP) overlapped with the derived-array stage below.
    from rapmap_tpu_torch.index.chd import build_canonical_chd

    chd_box: dict = {}
    th_chd = None
    if with_chd:

        def _chd_job():
            try:
                chd_box["chd"] = build_canonical_chd(khi, klo, k, seed0=seed + 1)
            except BaseException as exc:
                chd_box["exc"] = exc

        th_chd = threading.Thread(target=_chd_job, name="tqm-chd")
        th_chd.start()
    elif require_chd:
        raise ValueError("require_chd and with_chd=False are incompatible")

    if prefix_bases is None:
        # aim for ~1 entry/bucket: p ~ log4(#kmers)+1, capped to keep the LUT
        # small relative to the table (4^p ints <= ~2x entries), and <= 12
        import math as _math

        nk = max(1, len(kb))
        prefix_bases = max(4, min(k, 12, _math.ceil(_math.log(nk, 4)) + 1))
    lut = build_prefix_lut(khi, klo, k, prefix_bases)
    sa_txp, sa_tpos = sa_txp_tpos(sa, offsets, lens)
    log.info("lut/pack/sa_txp derived (%.1fs)", time.time() - t0)
    t0 = time.time()
    pre_hashes: dict = {}
    if outdir and th_chd is not None:
        # stream the big non-CHD arrays to disk while the CHD displacement
        # search finishes; save_index below skips the already-written names
        from rapmap_tpu_torch.index.format import save_arrays

        pre_hashes = save_arrays(outdir, {
            "text": text, "text2b": text2b, "sa": sa, "sa_txp": sa_txp,
            "sa_tpos": sa_tpos, "kmer_hi": khi, "kmer_lo": klo,
            "kmer_b": kb, "kmer_e": ke, "prefix_lut": lut,
            "txp_offsets": offsets, "txp_lens": lens,
        })
        log.info("non-CHD arrays saved under the CHD join (%.1fs)", time.time() - t0)
        t0 = time.time()
    if th_chd is not None:
        th_chd.join()
        if "exc" in chd_box:
            raise chd_box["exc"]
        chd = chd_box.get("chd")
    else:
        chd = None
    meta = {}
    chd_dir = chd_perm = chd_cls = None
    if chd is not None:
        chd_dir, chd_perm, chd_cls = chd["dir"], chd["perm"], chd["cls"]
        meta["chd"] = {k_: chd[k_] for k_ in ("seed", "m_bits", "t_bits", "p_bits", "canonical")}
        log.info(
            "canonical CHD perfect hash built (overlapped; %.1fs beyond the "
            "derived stage)", time.time() - t0,
        )
    elif require_chd:
        raise RuntimeError(
            "--perfectHash: CHD perfect hash construction failed for this "
            "k-mer set (native builder unavailable or displacement search "
            "exhausted); rebuild without -x to use the binary-search probe"
        )
    idx = QuasiIndex(
        k=k, text=text, text2b=text2b, sa=sa, sa_txp=sa_txp,
        sa_tpos=sa_tpos,
        kmer_hi=khi, kmer_lo=klo, kmer_b=kb, kmer_e=ke, prefix_lut=lut,
        txp_offsets=offsets, txp_lens=lens, txp_names=names,
        n_text=n_text, prefix_bases=prefix_bases, seed=seed,
        chd_dir=chd_dir, chd_perm=chd_perm, chd_cls=chd_cls, meta=meta,
    )
    if outdir:
        save_index(idx, outdir, pre_hashes=pre_hashes)
        log.info("index written to %s", outdir)
    return idx


def build_pseudo_index(
    fasta_path: str, outdir: str | None = None, k: int = 31, seed: int = 0, dedup: bool = True
) -> PseudoIndex:
    """k-mer -> (txp, pos) occurrence CSR (reference RapMapIndexer role), built
    via the suffix array: occurrences of k-mer i = SA[b_i:e_i], ordered by
    (k-mer, txp, pos) with one lexsort."""
    q = build_quasi_index(fasta_path, None, k=k, seed=seed, dedup=dedup)
    n_k = len(q.kmer_b)
    counts = (q.kmer_e - q.kmer_b).astype(np.int64)
    off = np.zeros(n_k + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    total = int(off[-1])
    sa = np.asarray(q.sa, dtype=np.int64)
    kmer_of = np.repeat(np.arange(n_k, dtype=np.int64), counts)
    slot = (np.arange(total, dtype=np.int64) - np.repeat(off[:-1], counts)
            + np.repeat(q.kmer_b.astype(np.int64), counts))
    t_all = q.sa_txp[slot]
    p_all = (sa[slot] - q.txp_offsets[t_all]).astype(np.int32)
    order = np.lexsort((p_all, t_all, kmer_of))
    occ_txp = t_all[order].astype(np.int32)
    occ_pos = p_all[order]
    # canonical-class CHD perfect hash over the k-mer set: one 2-gather probe
    # answers both strands of a window
    from rapmap_tpu_torch.index.chd import build_canonical_chd

    t0 = time.time()
    chd = build_canonical_chd(
        np.asarray(q.kmer_hi, np.uint32), np.asarray(q.kmer_lo, np.uint32), k,
        seed0=seed + 7,
    )
    meta = {}
    chd_dir = chd_perm = chd_cls = None
    if chd is not None:
        chd_dir, chd_perm, chd_cls = chd["dir"], chd["perm"], chd["cls"]
        meta["chd"] = {k_: chd[k_] for k_ in ("seed", "m_bits", "t_bits", "p_bits", "canonical")}
        log.info("canonical CHD perfect hash built (%.1fs)", time.time() - t0)
    idx = PseudoIndex(
        k=k, kmer_hi=q.kmer_hi, kmer_lo=q.kmer_lo, kmer_off=off,
        occ_txp=occ_txp, occ_pos=occ_pos,
        txp_offsets=q.txp_offsets, txp_lens=q.txp_lens, txp_names=q.txp_names, seed=seed,
        chd_dir=chd_dir, chd_perm=chd_perm, chd_cls=chd_cls, meta=meta,
    )
    if outdir:
        save_index(idx, outdir)
        log.info("pseudo index written to %s", outdir)
    return idx
