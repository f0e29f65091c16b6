"""Device-resident quasi index: flat tensors on the card + static engine facts.

Port of rapmap_tpu.ops.device_index. Every hot probe reads one multi-column
row:

  chd_rows  (2^t, 6|4) [chi, clo, b_fwd, e_fwd, b_rc, e_rc] canonical class
            rows, or [hi, lo, b, e] legacy per-strand rows   one per CHD probe
  kmer_rows (K, 4)   [hi, lo, b, e]                          one per search trip
  lut_rows  (4^p, 2) [lut[v], lut[v+1]]                      one per prefix bucket
  sa_cmp    (n, 6)   [wi, sub, tleft, w0, w1, w2]            one per extension compare
  sa_ext    (n, 3)   [wi, sub, tleft]                        (full upload only)
  sa_meta   (n, 2|4) [sa_txp, sa_tpos (, next pair)]         one per expansion slot
  text2q    (nw, 4)  packed words w..w+3                     long-read compare tails
  text, sa  the flat int8 text and int32 SA of the charwise extension
  txp_align (n_txps, 3) [off >> 4, off & 15, txp_len]    one per scored record

The lean upload (what the canonical-CHD + packed-extension path gathers)
drops sa_ext, kmer_rows, lut_rows, text and sa; the full upload keeps them,
except text and sa for an int64 (big) SA; both keep the tiny txp_align.
Words keep the reference's int32 bit patterns (ops.bits widens them on
gather). All derived at upload from the on-disk arrays (disk format
unchanged).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from rapmap_tpu_torch.index.format import QuasiIndex
from rapmap_tpu_torch.ops.align import make_txp_align


class DeviceQuasiIndex(NamedTuple):
    """Tensors the mapping path gathers from (int32 but `text`, int8, all on
    one device); None where the upload drops them."""

    text2q: torch.Tensor    # (nw, 4): packed words i..i+3
    sa_meta: torch.Tensor   # (n, 2) [sa_txp, sa_tpos] or (n, 4) pair rows
    sa_cmp: torch.Tensor    # (n, 3 + SA_CMP_WORDS)
    chd_dir: torch.Tensor | None = None   # (2^m_bits,); None: no CHD
    chd_rows: torch.Tensor | None = None  # (2^t_bits, 6) canonical or (2^t_bits, 4) legacy
    # full upload only (None under lean upload):
    sa_ext: torch.Tensor | None = None    # (n, 3) [(SA+k) >> 4, (SA+k) & 15, tend - (SA+k)]
    kmer_rows: torch.Tensor | None = None  # (K, 4) [hi, lo, b, e]: the binary search
    lut_rows: torch.Tensor | None = None   # (4^p, 2) [lut[v], lut[v+1]]
    # the charwise extension's flat arrays; None under lean upload and for a big SA
    text: torch.Tensor | None = None  # int8 codes
    sa: torch.Tensor | None = None    # int32
    # transcript geometry of the mapping score (ops.align); tiny, always uploaded
    txp_align: torch.Tensor | None = None  # (n_txps, 3) int32


@dataclass(frozen=True)
class EngineStatic:
    """Hashable static facts about the index the engine sizes itself by."""

    k: int
    prefix_bases: int
    lookup_steps: int   # binary-search trips covering the largest LUT bucket
    pad_tail: int       # trailing text zero-pad (bounds max read length)
    max_interval_idx: int = 1 << 30  # widest k-mer interval in the table
    # collate sort-key packing stats (0 = unknown -> unpacked multi-key sorts)
    n_txps: int = 0
    max_tpos: int = 0   # longest transcript (bounds any mapping position)
    # CHD perfect-hash probe (2 gathers) when the index carries one
    use_chd: bool = False
    chd_seed: int = 0
    chd_m_bits: int = 0
    chd_t_bits: int = 0
    chd_p_bits: int = 0  # partitioned slot formula (0 = legacy, pre-partition)
    chd_canonical: bool = False  # rows carry both strands' intervals

    @staticmethod
    def for_index(idx: QuasiIndex, use_chd: bool | None = None) -> "EngineStatic":
        lut = np.asarray(idx.prefix_lut)
        max_bucket = int(np.max(np.diff(lut))) if len(lut) > 1 else 1
        steps = max(1, int(np.ceil(np.log2(max_bucket + 1))) + 1)
        pad_tail = len(idx.text) - idx.n_text
        widths = np.asarray(idx.kmer_e) - np.asarray(idx.kmer_b)
        max_w = int(widths.max()) if len(widths) else 1
        chd = idx.meta.get("chd") if getattr(idx, "chd_dir", None) is not None else None
        if use_chd is None:
            use_chd = chd is not None
        tl = np.asarray(idx.txp_lens)
        return EngineStatic(
            k=idx.k, prefix_bases=idx.prefix_bases, lookup_steps=steps,
            pad_tail=pad_tail, max_interval_idx=max_w,
            n_txps=int(idx.n_txps),
            max_tpos=int(tl.max()) if len(tl) else 0,
            use_chd=bool(use_chd and chd is not None),
            chd_seed=int(chd["seed"]) if chd else 0,
            chd_m_bits=int(chd["m_bits"]) if chd else 0,
            chd_t_bits=int(chd["t_bits"]) if chd else 0,
            chd_p_bits=int(chd.get("p_bits", 0)) if chd else 0,
            chd_canonical=bool(chd.get("canonical")) if chd else False,
        )


def sa_ext_cols(sa, tend, k: int) -> np.ndarray:
    """(n, 3) int32 [(SA+k) >> 4, (SA+k) & 15, tend - (SA+k)]; int64-safe."""
    gpk = np.asarray(sa, dtype=np.int64) + k
    return np.stack(
        [
            (gpk >> 4).astype(np.int32),
            (gpk & 15).astype(np.int32),
            (np.asarray(tend, dtype=np.int64) - gpk).astype(np.int32),
        ],
        axis=1,
    )


SA_CMP_WORDS = 3  # fused text words per sa_cmp row (reads to k + 48 bases)


def sa_cmp_rows(sa, tend, k: int, t2b: np.ndarray) -> np.ndarray:
    """(n, 3 + SA_CMP_WORDS) int32 [wi, sub, tleft, w0..]: sa_ext_cols plus
    the suffix's first SA_CMP_WORDS 16-char packed text windows pre-shifted
    to start exactly at SA[i]+k — suffix_cmp then needs ONE row gather
    instead of (sa_ext row + text2q quad); int64-safe."""
    base = sa_ext_cols(sa, tend, k)
    gpk = np.asarray(sa, dtype=np.int64) + k
    wi = gpk >> 4
    sub = (gpk & 15).astype(np.uint32)
    t2p = np.concatenate(
        [np.asarray(t2b, dtype=np.uint32), np.zeros(SA_CMP_WORDS + 2, np.uint32)]
    )
    sh = sub << 1
    sh2 = (np.uint32(32) - sh) % np.uint32(32)
    cols = [base[:, 0], base[:, 1], base[:, 2]]
    top = len(t2p) - 1
    for j in range(SA_CMP_WORDS):
        w0 = t2p[np.clip(wi + j, 0, top)]
        w1 = t2p[np.clip(wi + j + 1, 0, top)]
        w = np.where(sub == 0, w0, (w0 << sh) | (w1 >> sh2))
        cols.append(w.view(np.int32))
    return np.stack(cols, axis=1)


def device_bytes_estimate(idx: QuasiIndex, lean: bool | None = None) -> int:
    """Device memory upload_index allocates, from array SHAPES only (safe on
    mmap'd indexes — no data is read). lean=None means what QuasiMapper
    picks with the packed extension: lean when the index carries a CHD.

    The CHD table holds one 24 B row per slot (len(chd_perm) = 2^t_bits),
    not per class as the reference's estimate counts, which undercounts it
    up to ~2.4x. The full upload adds kmer_rows (16 B a k-mer), lut_rows
    (8 B a bucket), sa_ext (12 B a slot) and, unless the SA is int64, the
    flat text (1 B a char) and sa (4 B a slot), which the reference's
    estimate leaves out."""
    has_chd = getattr(idx, "chd_dir", None) is not None
    if lean is None:
        lean = has_chd
    n = len(idx.sa)
    nw = len(idx.text2b)
    b = n * (3 + SA_CMP_WORDS) * 4   # sa_cmp fused rows
    b += n * 16                      # sa_meta (pair rows worst case)
    b += nw * 16                     # text2q quad rows
    if has_chd:
        b += len(idx.chd_dir) * 4 + len(idx.chd_perm) * 24
    b += len(idx.txp_lens) * 12      # txp_align rows
    if not lean:
        b += max(len(idx.kmer_b), 1) * 16 + max(0, len(idx.prefix_lut) - 1) * 8 + n * 12
        if np.asarray(idx.sa).dtype != np.int64:
            b += len(idx.text) + n * 4
    return int(b)


def canonical_class_rows(idx: QuasiIndex) -> np.ndarray:
    """(2^t_bits, 6) int32 CHD table rows [chi, clo, b_fwd, e_fwd, b_rc,
    e_rc]; the class key is the canonical (min of kmer, rc) orientation. An
    orientation absent from the text gets b=e=0 (empty interval -> not
    found); empty slots get a sentinel row no query matches."""
    from rapmap_tpu_torch.index.chd import key64_of, rc_key64_np

    perm = np.asarray(idx.chd_perm, dtype=np.int64)
    pc = np.clip(perm, 0, None)
    cls = np.asarray(idx.chd_cls, dtype=np.int64)  # (n_cls, 2)
    fwd_r, rc_r = cls[:, 0], cls[:, 1]
    key64 = key64_of(idx.kmer_hi, idx.kmer_lo)
    ck = np.where(
        fwd_r >= 0,
        key64[np.clip(fwd_r, 0, None)],
        rc_key64_np(key64[np.clip(rc_r, 0, None)], idx.k),
    )
    kb = np.asarray(idx.kmer_b, dtype=np.int32)
    ke = np.asarray(idx.kmer_e, dtype=np.int32)

    def iv(rowsel):
        ok = rowsel >= 0
        r = np.clip(rowsel, 0, None)
        return (
            np.where(ok, kb[r], 0).astype(np.int32),
            np.where(ok, ke[r], 0).astype(np.int32),
        )

    bf, ef = iv(fwd_r)
    br, er = iv(rc_r)
    cls_rows = np.stack(
        [
            (ck >> np.uint64(32)).astype(np.uint32).view(np.int32),
            (ck & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32),
            bf, ef, br, er,
        ],
        axis=1,
    )
    sentinel = np.array([-1, -1, 0, 0, 0, 0], dtype=np.int32)
    return np.where(
        (perm >= 0)[:, None],
        cls_rows[np.clip(pc, 0, len(cls_rows) - 1)],
        sentinel[None, :],
    ).astype(np.int32)


def kmer_table_rows(idx: QuasiIndex) -> np.ndarray:
    """(K, 4) int32 [hi, lo, b, e]: one row per table probe (a single zero
    row for an empty table)."""
    if not len(idx.kmer_b):
        return np.zeros((1, 4), np.int32)
    return np.stack(
        [
            np.asarray(idx.kmer_hi, dtype=np.uint32).view(np.int32),
            np.asarray(idx.kmer_lo, dtype=np.uint32).view(np.int32),
            np.asarray(idx.kmer_b, dtype=np.int32),
            np.asarray(idx.kmer_e, dtype=np.int32),
        ],
        axis=1,
    )


def legacy_chd_rows(idx: QuasiIndex, kmer_rows: np.ndarray) -> np.ndarray:
    """(2^t_bits, 4) int32 per-strand CHD rows of a CHD that is not
    canonical: kmer_rows[perm], empty slots a row no query matches."""
    perm = np.asarray(idx.chd_perm, dtype=np.int64)
    sentinel = np.array([-1, -1, 0, 0], dtype=np.int32)
    return np.where(
        (perm >= 0)[:, None], kmer_rows[np.clip(perm, 0, len(kmer_rows) - 1)],
        sentinel[None, :],
    ).astype(np.int32)


def upload_index(
    idx: QuasiIndex, device, lean: bool = False, meta_pairs: bool = False
) -> tuple[DeviceQuasiIndex, EngineStatic]:
    """The reference's upload. lean=True drops every array the CHD +
    packed-extension path never gathers (sa_ext, the binary-search
    kmer_rows/lut_rows, the charwise text/sa) and needs a CHD-bearing index;
    the full upload keeps them (text/sa only for an int32 SA). A canonical
    CHD gets 6-column class rows, a legacy one kmer_rows[perm]."""
    if len(np.asarray(idx.sa)) >= 2**31:
        raise ValueError(
            "single-device upload caps at 2^31 SA slots (int32 slot ids on "
            "device); genome-scale indexes need the SA-sharded mode"
        )
    if lean and getattr(idx, "chd_dir", None) is None:
        raise ValueError("lean upload requires a CHD-bearing index")
    big_sa = np.asarray(idx.sa).dtype == np.int64
    st = EngineStatic.for_index(idx)
    sa_txp = np.asarray(idx.sa_txp, dtype=np.int32)
    sa_tpos = np.asarray(idx.sa_tpos, dtype=np.int32)
    off = np.asarray(idx.txp_offsets, dtype=np.int64)
    tl = np.asarray(idx.txp_lens, dtype=np.int32)
    tend = off[sa_txp] + tl[sa_txp]
    if meta_pairs:
        # pair rows [t_i, p_i, t_{i+1}, p_{i+1}]: one 16 B gather resolves
        # TWO adjacent SA positions of an expansion interval (ops.collate
        # cfg.expand_pairs path); the first two columns still serve any
        # single-position gather. Last row duplicates itself as its pair.
        nxt = np.minimum(np.arange(1, len(sa_txp) + 1), len(sa_txp) - 1)
        sa_meta = np.stack([sa_txp, sa_tpos, sa_txp[nxt], sa_tpos[nxt]], axis=1)
    else:
        sa_meta = np.stack([sa_txp, sa_tpos], axis=1)
    t2b = np.asarray(idx.text2b, dtype=np.uint32)
    nw = len(t2b)
    t2p = np.concatenate([t2b, np.zeros(4, np.uint32)])
    text2q = np.stack([t2p[i : i + nw] for i in range(4)], axis=1).view(np.int32)
    sa_cmp = sa_cmp_rows(idx.sa, tend, idx.k, t2b)
    kmer_rows = kmer_table_rows(idx)

    def dev(a, dtype=np.int32):
        a = np.ascontiguousarray(a, dtype=dtype)
        # arrays of a memory-mapped index are read-only; torch wants writable memory
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)

    chd_dir = chd_rows = None
    if st.use_chd:
        chd_dir = dev(np.asarray(idx.chd_dir, dtype=np.int32))
        chd_rows = dev(canonical_class_rows(idx) if st.chd_canonical
                       else legacy_chd_rows(idx, kmer_rows))
    full = not lean
    flat = full and not big_sa
    lut = np.asarray(idx.prefix_lut, dtype=np.int32)
    didx = DeviceQuasiIndex(
        text2q=dev(text2q),
        sa_meta=dev(sa_meta),
        sa_cmp=dev(sa_cmp),
        chd_dir=chd_dir,
        chd_rows=chd_rows,
        sa_ext=dev(sa_ext_cols(idx.sa, tend, idx.k)) if full else None,
        kmer_rows=dev(kmer_rows) if full else None,
        lut_rows=dev(np.stack([lut[:-1], lut[1:]], axis=1)) if full else None,
        text=dev(np.asarray(idx.text), np.int8) if flat else None,
        sa=dev(np.asarray(idx.sa)) if flat else None,
        txp_align=dev(make_txp_align(off, tl)),
    )
    return didx, st
