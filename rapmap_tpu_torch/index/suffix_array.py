"""Suffix array construction (host-side, offline).

The production path is the C++ SA-IS builder in rapmap_tpu/native (libdivsufsort
role, SURVEY.md §2.2); this module provides a pure-numpy prefix-doubling builder
used as fallback and as a cross-check oracle for the native builder, plus a
brute-force verifier for tiny inputs.
"""

from __future__ import annotations

import numpy as np


def suffix_array_numpy(text_codes: np.ndarray) -> np.ndarray:
    """O(n log^2 n) prefix-doubling suffix array over int8 codes.

    Matches a plain suffix sort of the coded string (equal '$' codes tie-broken
    by following text), i.e. the same ordering divsufsort gives the reference.
    """
    t = np.asarray(text_codes, dtype=np.int64)
    n = len(t)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    rank = t.copy()
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    tmp = np.empty(n, dtype=np.int64)
    h = 1
    while True:
        # sort by (rank[i], rank[i+h]) where out-of-range second key sorts first
        second = np.full(n, -1, dtype=np.int64)
        second[: n - h] = rank[h:]
        order = np.lexsort((second, rank))
        sa = order
        # recompute ranks
        r_sa = rank[sa]
        s_sa = second[sa]
        new_group = np.ones(n, dtype=np.int64)
        new_group[0] = 0
        same = (r_sa[1:] == r_sa[:-1]) & (s_sa[1:] == s_sa[:-1])
        new_group[1:] = ~same
        tmp = np.cumsum(new_group)
        rank = np.empty(n, dtype=np.int64)
        rank[sa] = tmp
        if tmp[-1] == n - 1:
            break
        h *= 2
        if h >= n:
            break
    return sa.astype(np.int32 if n < 2**31 else np.int64)


def suffix_array_bruteforce(text_codes: np.ndarray) -> np.ndarray:
    """O(n^2 log n) reference for tests (tiny inputs only)."""
    t = bytes(np.asarray(text_codes, dtype=np.uint8))
    idx = sorted(range(len(t)), key=lambda i: t[i:])
    return np.array(idx, dtype=np.int32)
