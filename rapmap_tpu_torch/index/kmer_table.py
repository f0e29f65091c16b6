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
    (the reference indexer's SA->hash scan, SURVEY.md §3.1), `chunk` slots
    at a time, natively unless the library is missing.

    Keys are extracted from the 2-bit packed text: per SA slot, THREE word
    gathers + a shift tree replace the k (≤32) per-char gathers of the naive
    scan — the build was dominated by those ~k·n random text accesses.
    Sentinel validity falls out of the parallel sentinel-mask words.

    Returns (kmer_hi, kmer_lo, kmer_b, kmer_e); intervals index SA slots and
    cover exactly the suffixes whose first k chars are sentinel-free. Slot
    intervals follow the SA dtype: int64 SA (bigSA, possibly >= 2^31 slots)
    -> int64 kmer_b/e, else int32. Besides its results the scan holds one
    chunk's keys and flags: it counts the groups first, then fills outputs
    of exactly that size.
    """
    n = len(sa)
    # packed words + sentinel mask. A caller that already packed a LONGER
    # zero-padded text may pass it in (zero pad chars read as sentinels
    # either way): word i of the longer pack equals word i of this pack for
    # all words the scan touches.
    if packed_smask is not None:
        packed, smask = packed_smask
    else:
        packed, smask = pack_text_2bit(text_codes)
    if n:
        try:
            from rapmap_tpu_torch.native import bindings as nat

            res = nat.kmer_table(sa, packed, smask, k, chunk=chunk)
            if res is not None:
                return res
        except Exception:  # pragma: no cover - native build issues
            pass
    slot_dt = np.int64 if np.asarray(sa).dtype == np.int64 else np.int32
    ng = sum(len(b) for _, b, _ in _runs(sa, packed, smask, k, chunk))
    hi, lo = np.empty(ng, np.uint32), np.empty(ng, np.uint32)
    kb, ke = np.empty(ng, slot_dt), np.empty(ng, slot_dt)
    gs = ge = 0
    for keys, b, e in _runs(sa, packed, smask, k, chunk):
        hi[gs : gs + len(b)] = keys >> np.uint64(32)
        lo[gs : gs + len(b)] = keys & np.uint64(0xFFFFFFFF)
        kb[gs : gs + len(b)] = b
        ke[ge : ge + len(e)] = e
        gs, ge = gs + len(b), ge + len(e)
    assert gs == ge == ng
    return hi, lo, kb, ke


def _keys_valid(sl: np.ndarray, packed: np.ndarray, smask: np.ndarray, k: int):
    """(key uint64, valid bool) of the suffixes at text positions sl: the 2k
    key bits from three packed words, valid where none of the first k chars
    is a sentinel (words past the pack read as sentinels)."""
    nw = len(packed)
    wi = sl >> 4
    m2k = np.uint64(0xFFFFFFFFFFFFFFFF) if k == 32 else np.uint64((1 << (2 * k)) - 1)

    def words(j):
        i = np.minimum(wi + j, nw - 1)
        past = (wi + j) >= nw
        return (np.where(past, 0, packed[i]).astype(np.uint64),
                np.where(past, 0xFFFFFFFF, smask[i]).astype(np.uint64))

    (t0, s0), (t1, s1), (t2, s2) = words(0), words(1), words(2)
    # window = w0||w1||w2 (96 bits, big-endian chars); the 2k key bits
    # start at bit offset 2*(sl&15), i.e. right-shift by sh = 96-2*(sl&15)-2k
    sh = (np.uint64(96 - 2 * k) - ((sl.astype(np.uint64) & np.uint64(15)) << np.uint64(1)))
    A_k = (t0 << np.uint64(32)) | t1
    A_s = (s0 << np.uint64(32)) | s1
    # clamp both branches' shift counts (the discarded branch must still
    # compute with a defined count — numpy shifts >= 64 are UB)
    shl = np.uint64(32) - np.minimum(sh, np.uint64(32))
    shr = np.maximum(sh, np.uint64(32)) - np.uint64(32)
    hi_part = np.where(sh <= 32, A_k << shl, A_k >> shr)
    hi_sent = np.where(sh <= 32, A_s << shl, A_s >> shr)
    lo_shift = np.minimum(sh, np.uint64(63))  # w2 >> sh == 0 for sh >= 32
    keys = (hi_part | (t2 >> lo_shift)) & m2k
    valid = ((hi_sent | (s2 >> lo_shift)) & m2k) == 0
    return keys, valid


def _runs(sa: np.ndarray, packed: np.ndarray, smask: np.ndarray, k: int, chunk: int):
    """The SA's groups a chunk of slots at a time: per chunk (keys of the
    groups that start in it, their first slots, the ends of the groups that
    close in it). A group is a run of valid slots with one key; the open
    run and its key carry across each chunk's end, and a run left open at
    the SA's end closes there."""
    n = len(sa)
    open_, cur, last = False, np.uint64(0), None
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        keys, valid = _keys_valid(np.asarray(sa[s:e], dtype=np.int64), packed, smask, k)
        prev_valid = np.concatenate([[open_], valid[:-1]])
        same = prev_valid & (np.concatenate([[cur], keys[:-1]]) == keys)
        start = valid & ~same
        # a run closes before slot i when slot i - 1 held it and i does not
        close = prev_valid & ~(valid & same)
        slots = np.arange(s, e, dtype=np.int64)
        starts = keys[start]
        if len(starts):
            # valid slots with equal keys are contiguous in SA order
            # (SEMANTICS.md §2): a key never opens two runs in a row
            chain = starts if last is None else np.concatenate([[last], starts])
            assert not np.any(chain[1:] == chain[:-1]), "k-mer group interleaved by invalid slot"
            last = starts[-1]
        yield starts, slots[start], slots[close]
        open_, cur = bool(valid[-1]), keys[-1]
    if open_:
        yield np.zeros(0, np.uint64), np.zeros(0, np.int64), np.array([n], np.int64)


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


def pack_text_2bit(text_codes: np.ndarray,
                   chunk_words: int = 1 << 22) -> tuple[np.ndarray, np.ndarray]:
    """2-bit packed text words (16 bases/uint32, big-endian within word) and a
    sentinel bitmask (bit set where code==0), both padded to a word boundary.

    Fast path for packed-word LCP compares in the extension kernel. Packs
    `chunk_words` words at a time, so its temporaries stay one chunk's
    (over the whole text they took ~6 bytes a base).
    """
    t = np.asarray(text_codes, dtype=np.int8).view(np.uint8)
    n = len(t)
    nw = (n + 15) // 16
    packed = np.empty(nw, dtype=np.uint32)
    smask = np.empty(nw, dtype=np.uint32)
    for w0 in range(0, nw, chunk_words):
        w1 = min(w0 + chunk_words, nw)
        tpad = np.zeros((w1 - w0) * 16, dtype=np.uint8)
        part = t[w0 * 16 : w1 * 16]
        tpad[: len(part)] = part
        sent8 = tpad == 0
        bits = ((tpad - np.uint8(1)) & np.uint8(3)).astype(np.uint32)
        bits[sent8] = 0  # the uint8 underflow maps sentinels to 3; zero them
        bits = bits.reshape(w1 - w0, 16)
        sent = sent8.reshape(w1 - w0, 16)
        pk = np.zeros(w1 - w0, dtype=np.uint32)
        sm = np.zeros(w1 - w0, dtype=np.uint32)
        for i in range(16):
            pk = (pk << np.uint32(2)) | bits[:, i]
            # sentinel mask: 2 bits per base (11 where sentinel) keeps alignment with packed
            sm = (sm << np.uint32(2)) | (sent[:, i].astype(np.uint32) * np.uint32(3))
        packed[w0:w1], smask[w0:w1] = pk, sm
    return packed, smask
