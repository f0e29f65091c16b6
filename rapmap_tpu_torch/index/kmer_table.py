"""k-mer -> SA-interval table construction (host-side).

Replaces the reference's sparsepp hash / BooPHF MPHF (SURVEY.md §2.2) with a
TPU-friendly *sorted* k-mer table: keys as (hi, lo) uint32 pairs in ascending
order plus parallel [b, e) interval arrays, probed on-device by branchless
binary search accelerated by a first-p-bases prefix LUT.
"""

from __future__ import annotations

import numpy as np


def build_kmer_table(
    text_codes: np.ndarray, sa: np.ndarray, k: int, chunk: int = 1 << 22,
    packed_smask: tuple[np.ndarray, np.ndarray] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Single pass over the SA grouping suffixes by their first k chars
    (the reference indexer's SA->hash scan, SURVEY.md §3.1), chunked.

    Keys are extracted from the 2-bit packed text: per SA slot, THREE word
    gathers + a shift tree replace the k (≤32) per-char gathers of the naive
    scan — the build was dominated by those ~k·n random text accesses.
    Sentinel validity falls out of the parallel sentinel-mask words.

    Returns (kmer_hi, kmer_lo, kmer_b, kmer_e); intervals index SA slots and
    cover exactly the suffixes whose first k chars are sentinel-free.
    """
    t = np.asarray(text_codes, dtype=np.int8)
    n = len(sa)
    # packed words + sentinel mask; pad 2 words so gathers (sl>>4)+2 stay in
    # range, with all-sentinel pad words so short suffixes read as invalid.
    # A caller that already packed a LONGER zero-padded text may pass it in
    # (zero pad chars read as sentinels either way): word i of the longer
    # pack equals word i of this pack for all words the scan touches.
    if packed_smask is not None:
        packed, smask = packed_smask
    else:
        packed, smask = pack_text_2bit(t)
    if n:
        try:
            from rapmap_tpu_torch.native import bindings as nat

            res = nat.kmer_table(sa, packed, smask, k)
            if res is not None:
                return res
        except Exception:  # pragma: no cover - native build issues
            pass
    tw = np.concatenate([packed, np.zeros(2, np.uint32)]).astype(np.uint64)
    sm = np.concatenate([smask, np.full(2, 0xFFFFFFFF, np.uint32)]).astype(np.uint64)
    # chars in the word-boundary pad of pack_text_2bit are sentinels already
    # (tpad == 0); chars past n in a caller-padded text may be zeros too —
    # both read as invalid, matching the per-char scan.
    keys = np.empty(n, dtype=np.uint64)
    valid = np.empty(n, dtype=bool)
    m2k = np.uint64(0xFFFFFFFFFFFFFFFF) if k == 32 else np.uint64((1 << (2 * k)) - 1)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        sl = np.asarray(sa[s:e], dtype=np.int64)
        wi = sl >> 4
        # window = w0||w1||w2 (96 bits, big-endian chars); the 2k key bits
        # start at bit offset 2*(sl&15), i.e. right-shift by sh = 96-2*(sl&15)-2k
        sh = (np.uint64(96 - 2 * k) - ((sl.astype(np.uint64) & np.uint64(15)) << np.uint64(1)))
        A_k = (tw[wi] << np.uint64(32)) | tw[wi + 1]
        A_s = (sm[wi] << np.uint64(32)) | sm[wi + 1]
        # clamp both branches' shift counts (the discarded branch must still
        # compute with a defined count — numpy shifts >= 64 are UB)
        shl = np.uint64(32) - np.minimum(sh, np.uint64(32))
        shr = np.maximum(sh, np.uint64(32)) - np.uint64(32)
        hi_part = np.where(sh <= 32, A_k << shl, A_k >> shr)
        hi_sent = np.where(sh <= 32, A_s << shl, A_s >> shr)
        lo_shift = np.minimum(sh, np.uint64(63))  # w2 >> sh == 0 for sh >= 32
        keys[s:e] = (hi_part | (tw[wi + 2] >> lo_shift)) & m2k
        valid[s:e] = ((hi_sent | (sm[wi + 2] >> lo_shift)) & m2k) == 0
    # group: run boundaries where key changes or validity changes.
    # Slot intervals follow the SA dtype: int64 SA (bigSA, possibly >= 2^31
    # slots) -> int64 kmer_b/e, matching the native scan's i64 entry point.
    slot_dt = np.int64 if np.asarray(sa).dtype == np.int64 else np.int32
    vidx = np.nonzero(valid)[0]
    if len(vidx) == 0:
        z = np.zeros(0, dtype=np.uint32)
        return z, z.copy(), np.zeros(0, slot_dt), np.zeros(0, slot_dt)
    vkeys = keys[vidx]
    # valid slots with equal keys are contiguous in SA order (SEMANTICS.md §2)
    starts = np.nonzero(np.concatenate([[True], vkeys[1:] != vkeys[:-1]]))[0]
    ends = np.concatenate([starts[1:], [len(vidx)]])
    kb = vidx[starts].astype(np.int64)
    ke = (vidx[ends - 1] + 1).astype(np.int64)
    ukeys = vkeys[starts]
    # sanity: each group must be contiguous (no invalid slot interleaves a group)
    assert np.all((ke - kb) == (ends - starts)), "k-mer group interleaved by invalid slot"
    hi = (ukeys >> np.uint64(32)).astype(np.uint32)
    lo = (ukeys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo, kb.astype(slot_dt), ke.astype(slot_dt)


def build_prefix_lut(kmer_hi: np.ndarray, kmer_lo: np.ndarray, k: int, prefix_bases: int,
                     chunk: int = 1 << 26) -> np.ndarray:
    """prefix_lut[v] = first k-mer-table row whose first-p-bases value >= v.

    len = 4^p + 1; bucket for prefix v is rows [lut[v], lut[v+1]).
    """
    p = prefix_bases
    sh = 2 * (k - p)
    # the table is key-sorted, so lut[v] = #rows with prefix < v: one counting
    # pass + cumsum instead of 4^p binary searches over the table. The
    # prefixes go into one int64 buffer a chunk of rows (bincount wants intp;
    # feeding it uint32 triggers a pathologically slow cast path), so no
    # temporary spans the table (one would take 17.6 GB at 2.2e9 k-mers).
    counts = np.zeros(4**p, dtype=np.int64)
    pref = np.empty(min(chunk, len(kmer_hi)), dtype=np.int64)
    for s in range(0, len(kmer_hi), chunk):
        hi = kmer_hi[s : s + chunk]
        out = pref[: len(hi)]
        if sh >= 32:
            # prefix lives entirely in the hi word — skip the uint64 key build
            np.right_shift(hi, np.uint32(sh - 32), out=out, casting="unsafe")
        else:
            key = (hi.astype(np.uint64) << np.uint64(32)) | kmer_lo[s : s + chunk].astype(
                np.uint64)
            np.right_shift(key, np.uint64(sh), out=out, casting="unsafe")
        counts += np.bincount(out, minlength=4**p)
    lut = np.zeros(4**p + 1, dtype=np.int64)
    np.cumsum(counts, out=lut[1:])
    # LUT values are k-mer table ROWS; keep int64 when the table can exceed
    # 2^31 rows (genome-scale bigSA indexes)
    return lut.astype(np.int32 if len(kmer_hi) < 2**31 else np.int64)


def pack_text_2bit(text_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """2-bit packed text words (16 bases/uint32, big-endian within word) and a
    sentinel bitmask (bit set where code==0), both padded to a word boundary.

    Fast path for packed-word LCP compares in the extension kernel.
    """
    t = np.asarray(text_codes, dtype=np.int8).view(np.uint8)
    n = len(t)
    nw = (n + 15) // 16
    tpad = np.zeros(nw * 16, dtype=np.uint8)
    tpad[:n] = t
    sent8 = tpad == 0
    bits = ((tpad - np.uint8(1)) & np.uint8(3)).astype(np.uint32)
    bits[sent8] = 0  # the uint8 underflow maps sentinels to 3; zero them
    bits = bits.reshape(nw, 16)
    sent = sent8.reshape(nw, 16)
    packed = np.zeros(nw, dtype=np.uint32)
    smask = np.zeros(nw, dtype=np.uint32)
    for i in range(16):
        packed = (packed << np.uint32(2)) | bits[:, i]
        # sentinel mask: 2 bits per base (11 where sentinel) keeps alignment with packed
        smask = (smask << np.uint32(2)) | (sent[:, i].astype(np.uint32) * np.uint32(3))
    return packed, smask
