"""Banded affine-gap alignment scoring of mapping candidates (ksw2 analog).

Port of rapmap_tpu.ops.align (SEMANTICS.md §9): each emitted quasi-mapping
(t, pos, strand) gets an alignment score `AS:i` from a banded, affine-gap,
read-global ("glocal") alignment of the oriented read against the
transcript window [pos - band, pos + L + band).

`score_records` is the mapping path's wrapper. On CUDA tensors it launches
the hand-written kernel of csrc/align.cu (`tqm_banded_scores`: the read's
orientation, the window's extraction from the 2-bit packed text and the DP
fused into one launch, a group of lanes per record row: `group_layout`), or
raises; on CPU tensors it runs `score_records_plain`, the reference's composition in
PyTorch: `extract_ref_windows` (quad-row word gathers, a sub-word shift, a
static unpack) then `banded_scores` (the closed-form Gotoh row, one step a
read column over the (N, 2*band+1) band). Arithmetic is int32 throughout, as
the reference's; packed words ride int64 (ops.bits).

Semantics (normative; SEMANTICS.md §9):
  * scoring: match +ma, mismatch +mp (mp < 0), gap open -(go), gap extend
    -(ge) per additional base, go >= ge; read N bases and positions outside
    the transcript ([0, txp_len)) always mismatch.
  * the read aligns END-TO-END (no soft clipping — the emitted CIGAR stays
    `<len>M`); leading/trailing unused window bases are free.
  * score of a perfect hit = ma * readLen; scores are clamped to
    [0, 2^SCORE_BITS - 1] for the wire.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.ops.bits import shl32, u32
from rapmap_tpu_torch.ops.encode import revcomp_batch

NEG = -(1 << 20)  # -inf stand-in; safe against int32 underflow
SCORE_BITS = 12   # wire clamp: scores ride 12 bits (reads to ~2 kb)
REG_BAND_MAX = 63  # csrc/align.cu keeps the band in its groups' registers up to this half-width
STAGE_MAX_COLS = 16384  # ... for reads of up to this many columns, staged in shared memory
CELLS_PER_LANE = 2  # csrc/align.cu group_lanes' target


def group_layout(band: int) -> tuple[int, int]:
    """(G, C): csrc/align.cu's lanes a record and cells a lane for a band
    of half-width `band` <= REG_BAND_MAX (its group_lanes): the fewest lanes,
    4 at least, that hold the 2*band+1 cells at CELLS_PER_LANE a lane, else
    32; C = ceil((2*band+1) / G)."""
    wb = 2 * band + 1
    g = next((g for g in (4, 8, 16) if g * CELLS_PER_LANE >= wb), 32)
    return g, -(-wb // g)


def make_txp_align(txp_offsets, txp_lens) -> np.ndarray:
    """(n_txps, 3) int32 rows [offset >> 4, offset & 15, txp_len].

    Device code never holds a global text position: a transcript's start
    rides as (word, sub-word) int32 columns, valid for texts up to 2^35
    chars."""
    off = np.asarray(txp_offsets, dtype=np.int64)
    return np.stack(
        [
            (off >> 4).astype(np.int32),
            (off & 15).astype(np.int32),
            np.asarray(txp_lens, dtype=np.int32),
        ],
        axis=1,
    )


def extract_ref_windows(didx, t: torch.Tensor, start: torch.Tensor, W: int) -> torch.Tensor:
    """Transcript-window codes for each record: (N, W) int32 in 0..3, with 5
    at positions outside [0, txp_len) (so they never match a read base).

    Window char j is transcript position start + j of transcript t, read
    from the 2-bit packed text: ceil(W/16)+1 consecutive words of text2q's
    column 0, each word index clipped on its own (a window hanging off
    transcript 0's head keeps its valid chars' words exact), a sub-word shift
    aligning char 0 to a word boundary, then a static unpack. `start` may be
    negative: int32 >> is arithmetic and & two's-complement, so
    (goff >> 4) * 16 + (goff & 15) == goff."""
    ta = didx.txp_align
    if ta is None:
        raise ValueError("index uploaded without txp_align rows")
    N = t.shape[0]
    dev = t.device
    row = ta[t.to(torch.int64).clamp(0, ta.shape[0] - 1)]  # (N, 3) int32
    tw, tsub, tlen = row[:, 0], row[:, 1], row[:, 2]
    start = start.to(torch.int32)
    goff = tsub + start  # window char 0, as a char offset from word tw
    wi = tw + (goff >> 4)
    sub = u32(goff & 15)[:, None]

    nwords = (W + 15) // 16 + 1  # +1: the shift pulls bits from word m+1
    nw_out = (W + 15) // 16
    top = didx.text2q.shape[0] - 1
    m = torch.arange(nwords, dtype=torch.int32, device=dev)[None, :]
    gidx = (wi[:, None] + m).to(torch.int64).clamp(0, top)
    words = u32(didx.text2q[:, 0][gidx])  # (N, nwords)
    # sub-word shift: w'[m] = words[m] << 2*sub | words[m+1] >> (32 - 2*sub)
    sh = sub * 2
    sh2 = (32 - sh) % 32
    lo, hi = words[:, :nw_out], words[:, 1:]
    w = torch.where(sub == 0, lo, shl32(lo, sh) | (hi >> sh2))  # (N, nw_out)
    j = torch.arange(16, dtype=torch.int64, device=dev)
    chars = (w[:, :, None] >> (30 - 2 * j)) & 3  # (N, nw_out, 16)
    win = chars.reshape(N, nw_out * 16)[:, :W].to(torch.int32)
    p = start[:, None] + torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    valid = (p >= 0) & (p < tlen[:, None])
    return torch.where(valid, win, 5).to(torch.int32)


def banded_scores(
    rcodes: torch.Tensor,  # (N, L) int32 read codes 0..3 (4 = N/pad)
    rlens: torch.Tensor,   # (N,) read lengths
    wcodes: torch.Tensor,  # (N, L + 2*band) int32 window codes 0..3 (5 = invalid)
    band: int,
    ma: int, mp: int, go: int, ge: int,
) -> torch.Tensor:
    """Core banded DP -> (N,) int32 scores (may be negative; not clamped).

    Band coordinate d = (window index) - (read index) in [0, 2*band]; read
    position i consumes window chars [i-1, i-1 + 2*band]. H(i, d) = best
    score of read[0:i] ending with read char i at window char i-1+d; E =
    gap-in-read state (from d+1 of the previous row); F = gap-in-window
    state (within-row; exclusive prefix-max closed form, valid for
    go >= ge). Rows freeze once i reaches the lane's read length, so the
    final H is H(len) for every lane regardless of padding."""
    if go < ge:
        raise ValueError("gap-open penalty must be >= gap-extend (Gotoh closed form)")
    N, L = rcodes.shape
    Wb = 2 * band + 1
    if wcodes.shape[1] != L + 2 * band:
        raise ValueError("window codes must hold L + 2*band columns")
    dev = rcodes.device
    i32 = torch.int32
    dge = (torch.arange(Wb, dtype=i32, device=dev) * ge)[None, :]
    ma_t = torch.tensor(ma, dtype=i32, device=dev)
    mp_t = torch.tensor(mp, dtype=i32, device=dev)

    def negs(n):
        return torch.full((N, n), NEG, dtype=i32, device=dev)

    def shift_left(x):  # value at d <- x[d+1]; NEG beyond the band
        return torch.cat([x[:, 1:], negs(1)], dim=1)

    def excl_prefix_max(a):
        p = torch.cat([negs(1), a[:, :-1]], dim=1)
        s = 1
        while s < Wb:
            p = torch.maximum(p, torch.cat([negs(s), p[:, :-s]], dim=1))
            s <<= 1
        return p

    H = torch.zeros((N, Wb), dtype=i32, device=dev)  # free leading window gap
    E = negs(Wb)
    rlens = rlens.to(torch.int64)
    for i in range(L):
        r = rcodes[:, i : i + 1]
        w = wcodes[:, i : i + Wb]
        sub = torch.where((w == r) & (r <= 3), ma_t, mp_t)
        E2 = torch.maximum(shift_left(H) - go, shift_left(E) - ge)
        Hnf = torch.maximum(H + sub, E2)
        F = excl_prefix_max(Hnf + dge) - dge - (go - ge)
        Hn = torch.maximum(Hnf, F)
        act = (i < rlens)[:, None]
        H = torch.where(act, Hn, H)
        E = torch.where(act, E2, E)
    return H.max(dim=1).values


def score_records_plain(didx, cfg, reads, lens, rid, t, pos, strand, valid) -> torch.Tensor:
    """The reference's score_records in PyTorch (what the kernel computes):
    (N,) int32 scores in [0, 2^SCORE_BITS - 1], 0 on dead rows."""
    B, L = reads.shape
    band = cfg.align_band
    lanes = torch.cat([reads, revcomp_batch(reads, lens)], dim=0)
    ridc = rid.to(torch.int64).clamp(0, B - 1)
    lane = (ridc + strand.to(torch.int64) * B).clamp(0, 2 * B - 1)
    rrow = lanes[lane].to(torch.int32)
    rcodes = torch.where((rrow >= 1) & (rrow <= 4), rrow - 1, 4).to(torch.int32)
    rlens = lens[ridc]
    tc = torch.where(valid, t.to(torch.int32), 0)
    start = torch.where(valid, pos.to(torch.int32), 0) - band
    wcodes = extract_ref_windows(didx, tc, start, L + 2 * band)
    sc = banded_scores(rcodes, rlens, wcodes, band, cfg.align_ma, cfg.align_mp,
                       cfg.align_go, cfg.align_ge)
    sc = sc.clamp(0, (1 << SCORE_BITS) - 1)
    return torch.where(valid, sc, 0).to(torch.int32)


def _int_col(x: torch.Tensor, name: str):
    """(tensor, element stride, is-int64) of a 1-D integer column the kernel
    reads in place (strided record columns need no copy)."""
    if x.dim() != 1:
        raise ValueError(f"score_records: {name} must be 1-D")
    if x.dtype not in (torch.int32, torch.int64):
        x = x.to(torch.int32)
    return x, x.stride(0), int(x.dtype == torch.int64)


def banded_scores_cuda(didx, cfg, reads, lens, rid, t, pos, strand, valid,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of csrc/align.cu's `tqm_banded_scores` into `out` (a
    (N,) int32 CUDA tensor; allocated with torch.empty when None: the kernel
    writes every element). Refuses what the kernel does not take."""
    dev = reads.device
    tensors = (reads, lens, rid, t, pos, strand, valid, didx.text2q, didx.txp_align)
    if any(x is None for x in tensors):
        raise ValueError("score_records: index uploaded without txp_align rows")
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("score_records: every tensor must lie on one CUDA device")
    if reads.dim() != 2 or reads.dtype != torch.int8:
        raise TypeError("score_records takes (B, L) int8 reads")
    if cfg.align_go < cfg.align_ge:
        raise ValueError("gap-open penalty must be >= gap-extend (Gotoh closed form)")
    band = int(cfg.align_band)
    if band < 1:
        raise ValueError("score_records: the band half-width must be >= 1")
    if valid.dtype != torch.bool or valid.dim() != 1:
        raise TypeError("score_records takes a 1-D bool valid mask")
    if didx.text2q.dtype != torch.int32 or didx.text2q.dim() != 2:
        raise TypeError("score_records: text2q must be (nw, 4) int32")
    ta = didx.txp_align
    if ta.dtype != torch.int32 or ta.dim() != 2 or ta.shape[1] != 3 or ta.shape[0] < 1:
        raise TypeError("score_records: txp_align must be (n_txps, 3) int32")
    reads, ta = reads.contiguous(), ta.contiguous()
    B, L = reads.shape
    N = rid.shape[0]
    cols = [_int_col(x, n) for x, n in ((rid, "rid"), (t, "t"), (pos, "pos"),
                                         (strand, "strand"))]
    lens_c = _int_col(lens, "lens")
    if lens.shape[0] != B or any(c[0].shape[0] != N for c in cols) or valid.shape[0] != N:
        raise ValueError("score_records: lens must have B rows, the record columns N")
    if out is None:
        out = torch.empty((N,), dtype=torch.int32, device=dev)
    elif out.shape != (N,) or out.dtype != torch.int32 or not out.is_contiguous():
        raise ValueError("score_records: out must be a contiguous (N,) int32 tensor")
    if N == 0 or B == 0 or L == 0:
        return out.zero_()
    Wb = 2 * band + 1
    scratch = None
    if band > REG_BAND_MAX or L > STAGE_MAX_COLS:  # the scratch build: H, E, window ring
        scratch = torch.empty((3, Wb, N), dtype=torch.int32, device=dev)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = kernels.library("align").tqm_banded_scores
    fn.restype = ctypes.c_int
    fn.argtypes = ([vp, i64, i32, vp, i64, i32] + [vp, i64, i32] * 4
                   + [vp, i64, vp, i64, i64, vp, i64, i64] + [i32] * 5 + [vp, vp, vp])
    args = [reads.data_ptr(), B, L, lens_c[0].data_ptr(), lens_c[1], lens_c[2]]
    for x, stride, is64 in cols:
        args += [x.data_ptr(), stride, is64]
    args += [valid.data_ptr(), valid.stride(0),
             didx.text2q.data_ptr(), didx.text2q.shape[0], didx.text2q.stride(0),
             ta.data_ptr(), ta.shape[0], N,
             band, cfg.align_ma, cfg.align_mp, cfg.align_go, cfg.align_ge,
             scratch.data_ptr() if scratch is not None else None, out.data_ptr()]
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tqm_banded_scores launch failed: CUDA error {rc}")
    kernels.LAUNCHES["banded_scores"] += 1
    return out


def score_records(
    didx,
    cfg,
    reads: torch.Tensor,   # (B, L) int8 SEMANTICS codes (1..4, 5 = N)
    lens: torch.Tensor,    # (B,)
    rid: torch.Tensor,     # (N,) read ids
    t: torch.Tensor,       # (N,) transcript ids
    pos: torch.Tensor,     # (N,) mapping positions (leftmost, 0-based)
    strand: torch.Tensor,  # (N,) 0 = fwd, 1 = rc
    valid: torch.Tensor,   # (N,) bool — live record rows
) -> torch.Tensor:
    """Mapping scores for a compacted record buffer -> (N,) int32 in
    [0, 2^SCORE_BITS - 1]; dead rows score 0. The CUDA kernel for CUDA
    tensors (no host sync), the plain version for CPU tensors."""
    tensors = (reads, lens, rid, t, pos, strand, valid, didx.text2q, didx.txp_align)
    if all(x is not None and x.device.type == "cpu" for x in tensors):
        return score_records_plain(didx, cfg, reads, lens, rid, t, pos, strand, valid)
    return banded_scores_cuda(didx, cfg, reads, lens, rid, t, pos, strand, valid)


def stack_pe_rows(reads1, lens1, reads2, lens2, rid, t, p1, s1, has1, p2, s2, has2, live):
    """Both mates' record rows as one score_records input over the stacked
    [mate1; mate2] read batch: (reads, lens, rid, t, pos, strand, valid) of
    2N rows."""
    B = reads1.shape[0]
    return (
        torch.cat([reads1, reads2], dim=0),
        torch.cat([lens1, lens2]),
        torch.cat([rid, rid + B]),
        torch.cat([t, t]),
        torch.cat([p1, p2]),
        torch.cat([s1, s2]),
        torch.cat([live & (has1 != 0), live & (has2 != 0)]),
    )


def score_pe_rows(didx, cfg, reads1, lens1, reads2, lens2, rid, t, p1, s1, has1, p2, s2,
                  has2, live):
    """Both mates of dense PE record rows in ONE scoring pass over the
    stacked [mate1; mate2] read batch -> (sc1, sc2), zero where the mate is
    absent."""
    sc = score_records(didx, cfg, *stack_pe_rows(
        reads1, lens1, reads2, lens2, rid, t, p1, s1, has1, p2, s2, has2, live))
    N = t.shape[0]
    return sc[:N], sc[N:]
