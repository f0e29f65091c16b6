"""Host-side CHD perfect-hash construction over the k-mer table, its numpy
query model and the upgrade of an index without one (copy of
rapmap_tpu.index.chd).

Replaces the reference's BooPHF minimal perfect hash role
(upstream:include/BooPHF.hpp, SURVEY.md §2.2): the sorted k-mer table stays
the canonical on-disk structure; CHD adds a displacement directory + slot
permutation so the device resolves a k-mer with two gathers flat, instead of
a binary search whose trip count tracks the worst prefix-LUT bucket.
"""

from __future__ import annotations

import logging
import math

import numpy as np

log = logging.getLogger("tqm.index")

MAXD = 65535


def mix32_np(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 (must match native/chd.cpp and ops/lookup.py exactly)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def chd_params(n: int) -> tuple[int, int, int]:
    """(m_bits, t_bits, p_bits): ~2 keys/bucket, load factor <= 0.85,
    4-way-partitioned search on large key sets.

    Bucket size trades directory memory against displacement-search time:
    the sequential search tries ~1/(1-load)^s displacements per size-s
    bucket, so halving s from 4 to 2 cut the 100 Mbase build's CHD stage
    ~4x (145 s -> ~39 s measured) for 2x the (tiny) dir array. p_bits > 0
    splits buckets AND slots into 2^p independent stripes (slot formula
    gains a stripe prefix — native/chd.cpp) so the search threads."""
    m_bits = max(1, math.ceil(math.log2(max(n / 2.0, 1.0))))
    t_bits = max(1, math.ceil(math.log2(n / 0.85)))
    p_bits = 2 if n >= (1 << 20) and m_bits > 3 and t_bits > 3 else 0
    return m_bits, t_bits, p_bits


def build_chd(khi: np.ndarray, klo: np.ndarray, seed0: int = 1):
    """-> dict(dir, perm, seed, m_bits, t_bits) or None when the native
    library is unavailable / placement failed (engine keeps binary search)."""
    n = len(khi)
    if n == 0:
        return None
    try:
        from rapmap_tpu_torch.native import bindings as nat

        if not nat.available():
            return None
    except Exception:  # pragma: no cover - import/runtime issues
        return None
    m_bits, t_bits, p_bits = chd_params(n)
    for attempt in range(8):
        seed = (seed0 + attempt * 1000003) & 0xFFFFFFFF
        res = nat.chd_build(khi, klo, m_bits, t_bits, seed, MAXD, p_bits)
        if res is not None:
            dirv, perm = res
            return dict(dir=dirv, perm=perm, seed=int(seed), m_bits=m_bits,
                        t_bits=t_bits, p_bits=p_bits)
        log.warning("CHD placement failed for seed %d; reseeding", seed)
    log.warning("CHD build gave up after 8 seeds; falling back to binary search")
    return None


def attach_chd(idx, save_dir: str | None = None) -> bool:
    """Build + attach a canonical-class CHD section to an existing index
    (upgrades pre-CHD and legacy per-strand-CHD indexes). Returns True when a
    canonical CHD is present afterwards. The caller must have loaded the
    index with mmap=False if save_dir rewrites in place."""
    if getattr(idx, "chd_dir", None) is not None and idx.meta.get("chd", {}).get(
        "canonical"
    ):
        return True
    chd = build_canonical_chd(
        np.asarray(idx.kmer_hi, np.uint32),
        np.asarray(idx.kmer_lo, np.uint32),
        idx.k,
        seed0=idx.seed + 1,
    )
    if chd is None:
        return False
    idx.chd_dir, idx.chd_perm, idx.chd_cls = chd["dir"], chd["perm"], chd["cls"]
    idx.meta["chd"] = {k: chd[k] for k in ("seed", "m_bits", "t_bits", "p_bits", "canonical")}
    if save_dir:
        from rapmap_tpu_torch.index.format import save_index

        save_index(idx, save_dir)
    return True


def chd_query_np(khi, klo, dirv, perm, seed: int, m_bits: int, t_bits: int,
                 p_bits: int = 0):
    """Numpy model of the device probe: -> row index or -1 (pre-verify).

    The caller must still compare the row's (hi, lo) against the key: alien
    keys return an arbitrary slot whose row simply fails the compare.
    """
    hi = np.asarray(khi, dtype=np.uint32)
    lo = np.asarray(klo, dtype=np.uint32)
    sa = np.uint32((seed * 0x9E3779B9 + 1) & 0xFFFFFFFF)
    sb = np.uint32((seed * 0x85EBCA6B + 2) & 0xFFFFFFFF)
    g = mix32_np(hi ^ mix32_np(lo ^ sa)) & np.uint32((1 << m_bits) - 1)
    hb = mix32_np(hi ^ mix32_np(lo ^ sb))
    d = dirv[g].astype(np.uint32)
    s = mix32_np(hb + d)
    if p_bits:
        stripe = (g >> np.uint32(m_bits - p_bits)) << np.uint32(t_bits - p_bits)
        slot = stripe | (s & np.uint32((1 << (t_bits - p_bits)) - 1))
    else:
        slot = s & np.uint32((1 << t_bits) - 1)
    return perm[slot]


# ---------------------------------------------------------------------------
# Canonical-class CHD: one probe serves BOTH strands
# ---------------------------------------------------------------------------

def rc_key64_np(key64: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of big-endian 2-bit packed k-mers (uint64, low-
    aligned): complement = bitwise NOT of the 2k bits, then reverse the 2-bit
    groups. Must match ops.encode.rc_keys_batch exactly."""
    x = np.asarray(key64, dtype=np.uint64)
    nb = 2 * k
    mask = np.uint64(0xFFFFFFFFFFFFFFFF) if nb == 64 else np.uint64((1 << nb) - 1)
    x = (~x) & mask
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    m8 = np.uint64(0x00FF00FF00FF00FF)
    m16 = np.uint64(0x0000FFFF0000FFFF)
    x = ((x & m2) << np.uint64(2)) | ((x >> np.uint64(2)) & m2)
    x = ((x & m4) << np.uint64(4)) | ((x >> np.uint64(4)) & m4)
    x = ((x & m8) << np.uint64(8)) | ((x >> np.uint64(8)) & m8)
    x = ((x & m16) << np.uint64(16)) | ((x >> np.uint64(16)) & m16)
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    return x >> np.uint64(64 - nb) if nb < 64 else x


def key64_of(khi: np.ndarray, klo: np.ndarray) -> np.ndarray:
    return (np.asarray(khi, np.uint32).astype(np.uint64) << np.uint64(32)) | np.asarray(
        klo, np.uint32
    ).astype(np.uint64)


def build_canonical_chd(khi, klo, k: int, seed0: int = 1):
    """CHD over canonical k-mer classes (class key = min(kmer, rc(kmer))).

    The device probes ONE class per window and reads both strands' SA
    intervals from the class row, halving lookup gathers vs per-strand
    probing (ops/lookup.py). Requires the k-mer table sorted by (hi, lo) —
    the on-disk invariant.

    -> dict(dir, perm, cls (n_cls, 2) int32 [fwd_row, rc_row] (-1 = absent),
            seed, m_bits, t_bits, canonical=True) or None (no native lib /
    placement failure -> caller keeps per-strand probing or binary search)."""
    import time as _time

    n = len(khi)
    if n == 0:
        return None
    if n >= 2**31:  # cls/perm are int32 row ids; genome-scale (>2^31 rows)
        return None  # indexes map via the sharded mode's per-shard CHDs
    res = None
    t0 = _time.time()
    try:
        from rapmap_tpu_torch.native import bindings as nat

        res = nat.canonical_classes(khi, klo, k)
    except Exception:  # pragma: no cover - import/runtime issues
        res = None
    if res is not None:
        chi, clo, fwd_row, rc_row = res
    else:
        # numpy fallback: group rows by class with one argsort. Each class
        # has at most one row per orientation (table keys are unique): the
        # canonical-orientation row (key64 == class) is fwd_row, the other
        # (key64 == rc(class)) is rc_row; palindromes use the same row.
        key64 = key64_of(khi, klo)
        rc64 = rc_key64_np(key64, k)
        can64 = np.minimum(key64, rc64)
        is_can = key64 <= rc64
        order = np.argsort(can64, kind="stable").astype(np.int64)
        sc = can64[order]
        new_cls = np.concatenate([[True], sc[1:] != sc[:-1]])
        gid = np.cumsum(new_cls) - 1
        classes = sc[new_cls]
        n_cls = len(classes)
        fwd_row = np.full(n_cls, -1, np.int32)
        rc_row = np.full(n_cls, -1, np.int32)
        ic = is_can[order]
        fwd_row[gid[ic]] = order[ic].astype(np.int32)
        rc_row[gid[~ic]] = order[~ic].astype(np.int32)
        eq = (key64 == rc64)[order]
        pal = np.zeros(n_cls, bool)
        pal[gid[eq]] = True
        rc_row = np.where(pal, fwd_row, rc_row).astype(np.int32)
        chi = (classes >> np.uint64(32)).astype(np.uint32)
        clo = (classes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    log.info("canonical classes: %d of %d keys (%.1fs)", len(chi), n, _time.time() - t0)
    chd = build_chd(chi, clo, seed0=seed0)
    if chd is None:
        return None
    chd["cls"] = np.stack([fwd_row, rc_row], axis=1)
    chd["canonical"] = True
    return chd
