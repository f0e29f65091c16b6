"""Packed-word MMP extension: binary search on the full read suffix.

Port of rapmap_tpu.ops.extend_packed (SURVEY.md §7.3 "gather-bound kernel"):

  1. lower_bound of the remaining read suffix Q in [b, e) comparing 16 bases
     per 32-bit word against the 2-bit packed text (big-endian packing makes
     numeric compare == lexicographic compare);
  2. MMP length = k + max(lcp with the two neighbours of the insertion point)
     — sorted order guarantees the max lcp is achieved there;
  3. final interval = equal_range of Q truncated to the MMP length.

The binary searches run a static number of trips (`steps`, which covers the
widest interval the caller can pass) with converged lanes masked, instead of
the reference's loop-until-all-converged: per-lane results are identical,
and the host never waits on the device to decide whether to loop. The
reference's staged quarter-width tail is a lockstep optimisation with the
same output (its docstring says so) and is not carried over.
"""

from __future__ import annotations

import torch

from rapmap_tpu_torch.ops.bits import M32, clz32, shl32, u32
from rapmap_tpu_torch.ops.device_index import DeviceQuasiIndex
from rapmap_tpu_torch.ops.gather import row_gather_nd


def ext_words(L: int, k: int) -> int:
    """32-bit words that cover the L - k chars a read can extend past depth k."""
    return max(1, -(-(L - k) // 16))


def pack_reads(reads: torch.Tensor) -> torch.Tensor:
    """(R, L) int8 codes -> (R, L) words (uint32 in int64): the 16 bases
    starting at each position, big-endian 2-bit (non-ACGT bases contribute
    arbitrary bits and must be masked out by the caller's valid-length logic).
    The result is contiguous: csrc/walk.cu reads it row by row.

    Log-step sliding-window combine: v_k[p] packs bases p..p+2^k-1 into the
    TOP 2^(k+1) bits, and v_{k+1}[p] = v_k[p] | v_k[p+2^k] >> 2^(k+1)."""
    R, L = reads.shape
    c = reads.to(torch.int64)
    bits = torch.where((c >= 1) & (c <= 4), (c - 1) & 3, 0)
    v = torch.cat([bits << 30, bits.new_zeros((R, 16))], dim=1)
    for k in (1, 2, 4, 8):
        shifted = torch.cat([v[:, k:], v.new_zeros((R, k))], dim=1)
        v = v | (shifted >> (2 * k))
    return v[:, :L].contiguous()


def _text_words(
    didx: DeviceQuasiIndex, wi: torch.Tensor, sub: torch.Tensor, W: int
) -> list[torch.Tensor]:
    """Packed 16-base text windows at word index wi + sub chars, advancing by
    16 chars per output word. text2q rows hold words i..i+3, so
    ceil((W+1)/4) row-gathers cover all W+1 raw words needed after the
    sub-word shift."""
    sh = sub << 1
    lo_shift = 32 - sh
    n_quads = -(-(W + 1) // 4)
    raw: list[torch.Tensor] = []
    for m in range(n_quads):
        quad = u32(row_gather_nd(didx.text2q, wi + 4 * m))
        raw += [quad[..., c] for c in range(4)]
    return [
        torch.where(sh == 0, raw[j], shl32(raw[j], sh) | (raw[j + 1] >> lo_shift))
        for j in range(W)
    ]


def suffix_cmp(
    didx: DeviceQuasiIndex,
    qwords: list[torch.Tensor],  # W tensors, per-lane query words
    qlen: torch.Tensor,          # valid query chars beyond depth k
    slot: torch.Tensor,          # SA slot of the candidate suffix (pre-clipped)
    W: int,
):
    """Compare the suffix at SA[slot] (depth-k based) against the query suffix.

    Returns (cmp, lcp): cmp < 0 iff suffix < query, 0 iff prefix-equal over
    qlen chars, > 0 iff suffix > query; lcp in chars.

    The fused sa_cmp row [wi, sub, tleft, w0..w_{F-1}] carries the first F
    suffix words pre-shifted, so a compare of up to 16F chars is ONE row
    gather; longer reads continue into text2q starting F words past (wi, sub).
    """
    row = row_gather_nd(didx.sa_cmp, slot).to(torch.int64)
    tleft = row[..., 2]
    F = didx.sa_cmp.shape[1] - 3
    twords = [row[..., 3 + j] & M32 for j in range(min(W, F))]
    if W > F:
        twords += _text_words(didx, row[..., 0] + F, row[..., 1], W - F)
    cmp = torch.zeros_like(qlen)
    lcp = torch.zeros_like(qlen)
    decided = torch.zeros_like(qlen, dtype=torch.bool)
    for j in range(W):
        qn = (qlen - 16 * j).clamp(0, 16)
        tn = (tleft - 16 * j).clamp(0, 16)
        n = torch.minimum(qn, tn)
        n2 = n * 2
        mask = torch.where(n2 == 0, 0, shl32(torch.full_like(n2, M32), 32 - n2))
        qv = qwords[j] & mask
        tv = twords[j] & mask
        diffpos = clz32(qv ^ tv) >> 1  # chars; 16 if equal
        has_diff = diffpos < n
        word_cmp = torch.where(
            has_diff,
            torch.where(tv < qv, -1, 1),
            # no diff within n: transcript ends first -> suffix smaller;
            # query exhausted -> prefix-equal
            torch.where(tn < qn, -1, 0),
        )
        word_final = has_diff | (tn < qn) | (qn < 16)
        word_lcp = torch.where(has_diff, diffpos, n)
        lcp = torch.where(decided, lcp, lcp + word_lcp)
        cmp = torch.where(decided, cmp, torch.where(word_final, word_cmp, 0))
        decided = decided | word_final
    return cmp, lcp


def _bound_stacked(didx, qwords, qlen, b, e, upper, W: int, steps: int):
    """Batched binary search; `upper` is a per-lane bool (False: first
    S_p >= Q; True: first S_p > Q). Returns (lo, lcp_less, lcp_geq).

    `steps` trips cover every interval of width < 2^(steps-1); converged
    lanes (lo == hi) are masked, so the result equals the reference's
    loop-until-converged for any interval the mapper can pass.

    Fused neighbour lcps: lo only ever moves via lo = mid+1 on a "less"
    compare, so the chronologically-LAST less-compare has mid == lo_final - 1;
    symmetrically the last not-less compare has mid == lo_final. Tracking the
    lcp of the most recent compare per branch therefore yields lcp(Q, S[lo-1])
    (valid iff lo > b) and lcp(Q, S[lo]) (valid iff lo < e) for free."""
    n_sa = didx.sa_cmp.shape[0]
    lo, hi = b, e
    ll = torch.zeros_like(qlen)
    lg = torch.zeros_like(qlen)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        cmp, lcp = suffix_cmp(didx, qwords, qlen, mid.clamp(0, n_sa - 1), W)
        less = (cmp < 0) | (upper & (cmp == 0))
        cont = lo < hi
        ll = torch.where(cont & less, lcp, ll)
        lg = torch.where(cont & ~less, lcp, lg)
        lo, hi = (
            torch.where(cont & less, mid + 1, lo),
            torch.where(cont & ~less, mid, hi),
        )
    return lo, ll, lg


def extend_packed(
    didx: DeviceQuasiIndex,
    preads: torch.Tensor,    # (R, L) packed read words (pack_reads)
    next_bad: torch.Tensor,  # (R, L) from encode.next_bad_batch
    lens: torch.Tensor,      # (R,)
    b0, e0, pos, active, k: int, ext_steps: int, L: int,
    col_off: torch.Tensor,   # (R,) per-lane column offset for right-aligned
    #                          rows (encode.comp_flip_batch rc lanes)
):
    """Returns (b, e, mlen) per lane (one anchor per read row). Lane r's
    data starts at column col_off[r] (position p -> column p + col_off[r])
    and ends at column col_off[r] + lens[r]."""
    W = ext_words(L, k)
    base = pos + k + col_off
    base_c = base.clamp(0, L - 1)
    rows = torch.arange(pos.shape[0], device=pos.device)
    # valid query chars beyond depth k: up to the next N and the read end
    nb = torch.where(base < L, next_bad[rows, base_c], base)
    qlen = (torch.minimum(nb, lens + col_off) - base).clamp(0, L - k)
    qwords = [
        torch.where(
            base + 16 * j < L, preads[rows, (base + 16 * j).clamp(0, L - 1)], 0
        )
        for j in range(W)
    ]
    # inactive lanes get empty search ranges
    b0a = torch.where(active, b0, 0)
    e0a = torch.where(active, e0, 0)
    no_up = torch.zeros_like(active)
    lb, ll, lg = _bound_stacked(didx, qwords, qlen, b0a, e0a, no_up, W, ext_steps)

    R = lb.shape[0]
    l_left = torch.where(lb > b0a, ll, 0)
    l_right = torch.where(lb < e0a, lg, 0)
    ext = torch.minimum(torch.maximum(l_left, l_right), qlen)
    mlen = k + ext

    # equal_range of Q truncated to ext chars, both bounds in one stacked
    # search over NARROWED spans: lower_bound(Q[:ext]) lies in [b0, lb] and
    # upper_bound(Q[:ext]) in [lb, e0); a neighbour lcp below ext closes its
    # side outright (see the reference's extend_packed for the argument).
    ext2 = torch.cat([ext, ext])
    b_st = torch.cat([torch.where(l_left < ext, lb, b0a), lb])
    e_st = torch.cat([lb, torch.where(l_right < ext, lb, e0a)])
    upper = torch.cat([torch.zeros_like(active), torch.ones_like(active)])
    q2 = [torch.cat([q, q]) for q in qwords]
    bounds, _, _ = _bound_stacked(didx, q2, ext2, b_st, e_st, upper, W, ext_steps)
    lb2, ub2 = bounds[:R], bounds[R:]
    ok = active & (ub2 > lb2)
    return (
        torch.where(ok, lb2, b0),
        torch.where(ok, ub2, e0),
        torch.where(ok, mlen, k),
    )

