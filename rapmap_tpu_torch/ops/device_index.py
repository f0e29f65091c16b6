"""Device-resident quasi index: flat tensors on the card + static engine facts.

Port of rapmap_tpu.ops.device_index's lean upload (the CHD + packed-extension
hot path). Every hot probe reads one multi-column row:

  chd_rows  (2^t, 6) [chi, clo, b_fwd, e_fwd, b_rc, e_rc]  one per k-mer class probe
  sa_cmp    (n, 6)   [wi, sub, tleft, w0, w1, w2]          one per extension compare
  sa_meta   (n, 2|4) [sa_txp, sa_tpos (, next pair)]       one per expansion slot
  text2q    (nw, 4)  packed words w..w+3                   long-read compare tails

Words keep the reference's int32 bit patterns (ops.bits widens them on
gather). All derived at upload from the on-disk arrays (disk format unchanged).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from rapmap_tpu_torch.index.format import QuasiIndex


class DeviceQuasiIndex(NamedTuple):
    """Tensors the mapping path gathers from (all int32, on one device)."""

    text2q: torch.Tensor    # (nw, 4): packed words i..i+3
    sa_meta: torch.Tensor   # (n, 2) [sa_txp, sa_tpos] or (n, 4) pair rows
    sa_cmp: torch.Tensor    # (n, 3 + SA_CMP_WORDS)
    chd_dir: torch.Tensor   # (2^m_bits,)
    chd_rows: torch.Tensor  # (2^t_bits, 6) canonical class rows


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
    def for_index(idx: QuasiIndex) -> "EngineStatic":
        lut = np.asarray(idx.prefix_lut)
        max_bucket = int(np.max(np.diff(lut))) if len(lut) > 1 else 1
        steps = max(1, int(np.ceil(np.log2(max_bucket + 1))) + 1)
        pad_tail = len(idx.text) - idx.n_text
        widths = np.asarray(idx.kmer_e) - np.asarray(idx.kmer_b)
        max_w = int(widths.max()) if len(widths) else 1
        chd = idx.meta.get("chd") if getattr(idx, "chd_dir", None) is not None else None
        tl = np.asarray(idx.txp_lens)
        return EngineStatic(
            k=idx.k, prefix_bases=idx.prefix_bases, lookup_steps=steps,
            pad_tail=pad_tail, max_interval_idx=max_w,
            n_txps=int(idx.n_txps),
            max_tpos=int(tl.max()) if len(tl) else 0,
            use_chd=chd is not None,
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


def device_bytes_estimate(idx: QuasiIndex) -> int:
    """Device memory the lean upload needs, from array SHAPES only (safe on
    mmap'd indexes — no data is read). The CHD table holds one 24 B row per
    slot (len(chd_perm) = 2^t_bits), not per class as the reference's
    estimate counts, which undercounts it up to ~2.4x."""
    n = len(idx.sa)
    nw = len(idx.text2b)
    b = n * (3 + SA_CMP_WORDS) * 4   # sa_cmp fused rows
    b += n * 16                      # sa_meta (pair rows worst case)
    b += nw * 16                     # text2q quad rows
    if getattr(idx, "chd_dir", None) is not None:
        b += len(idx.chd_dir) * 4 + len(idx.chd_perm) * 24
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


def upload_index(
    idx: QuasiIndex, device, meta_pairs: bool = False
) -> tuple[DeviceQuasiIndex, EngineStatic]:
    """The reference's lean upload (`upload_index(lean=True)`): only the
    arrays the canonical-CHD + packed-extension path gathers. Requires an
    index that carries the canonical-class CHD; the binary-search probe for
    indexes without one is not part of this package yet."""
    if len(np.asarray(idx.sa)) >= 2**31:
        raise ValueError(
            "single-device upload caps at 2^31 SA slots (int32 slot ids on "
            "device); genome-scale indexes need the SA-sharded mode"
        )
    st = EngineStatic.for_index(idx)
    if not (st.use_chd and st.chd_canonical):
        raise ValueError(
            "upload needs an index with a canonical-class CHD perfect hash "
            "(the native index-build library was unavailable at build time, "
            "or the index predates canonical CHD); the binary-search probe "
            "path is not ported yet"
        )
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

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    didx = DeviceQuasiIndex(
        text2q=dev(text2q),
        sa_meta=dev(sa_meta),
        sa_cmp=dev(sa_cmp),
        chd_dir=dev(np.asarray(idx.chd_dir, dtype=np.int32)),
        chd_rows=dev(canonical_class_rows(idx)),
    )
    return didx, st
