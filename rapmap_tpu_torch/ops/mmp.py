"""MMP search with NIP skipping — the compute core (SACollector rebuild).

Port of rapmap_tpu.ops.mmp's canonical-CHD strand-paired scan, two phases:

  1. *Dense lookup*: one canonical CHD probe per forward window answers both
     strands of every (read, strand) lane at once — no loop.
  2. *Anchor walk*: the NIP-skipping scan; each trip lands directly on the
     next anchor of the lane's anchor mask.

On CUDA tensors the walk is one launch of the hand-written kernel of
csrc/walk.cu (`anchor_walk`): one thread per lane, each looping to its own
convergence, with the packed extension inside it; it finds a lane's next
anchor by a bit scan of its mask row and writes every output byte itself. On
CPU tensors it is `anchor_walk_plain`, which builds the reference's
next-/prev-anchor tables from the masks and runs max_hits_per_strand + 1
trips with finished lanes masked: every trip of an active lane either
records a hit or sets `truncated`, so that many trips finish every lane, and
per-lane results are identical to the reference's loop-until-done. The
reference's dead-lane compaction and narrow tail only change the lockstep
width (its docstring says the output is bit-identical) and are not carried
over.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.ops import encode as denc
from rapmap_tpu_torch.ops.device_index import DeviceQuasiIndex, EngineStatic
from rapmap_tpu_torch.ops.extend_packed import ext_words, extend_packed, pack_reads
from rapmap_tpu_torch.ops.gather import row_gather
from rapmap_tpu_torch.ops.lookup import kmer_lookup_2str

WALK_FUSED_WORDS_MAX = 8  # csrc/walk.cu kRegWords: fused sa_cmp words it holds in registers


class ScanHits(NamedTuple):
    q: torch.Tensor      # (R, H) query positions
    l: torch.Tensor      # (R, H) MMP lengths
    b: torch.Tensor      # (R, H) interval begins
    e: torch.Tensor      # (R, H) interval ends
    n: torch.Tensor      # (R,)  hit counts
    truncated: torch.Tensor  # (R,) bool — hit buffer overflowed (over_budget)


class WalkInputs(NamedTuple):
    """What the dense phase hands the anchor walk. Lane tensors have R = 2B
    rows, [0, B) forward lanes and [B, 2B) rc lanes; the per-window tensors
    have B rows in forward columns, `*f` for forward lanes, `*r`/`*rF` for rc
    lanes (rc lane r reads row r - B). All int64 but the bool masks."""

    preads: torch.Tensor    # (R, L) packed read words
    next_bad: torch.Tensor  # (R, L)
    lens2: torch.Tensor     # (R,)
    col_off2: torch.Tensor  # (R,) 0 for fwd lanes, L - len for rc lanes
    bf: torch.Tensor        # (B, S) forward k-mer interval begins
    ef: torch.Tensor        # (B, S) forward k-mer interval ends
    br: torch.Tensor        # (B, S) rc k-mer interval begins
    er: torch.Tensor        # (B, S) rc k-mer interval ends
    anch_f: torch.Tensor    # (B, S) bool: forward anchors
    anch_rF: torch.Tensor   # (B, S) bool: rc anchors


def walk_params(st: EngineStatic, cfg: MapConfig) -> dict:
    """The walk's static scalars: k, the hit slots H and the bound search's
    trip bound (covers the widest interval an anchor can have)."""
    eff_w = min(cfg.max_interval, st.max_interval_idx)
    return dict(
        k=st.k, H=cfg.max_hits_per_strand,
        ext_steps=max(1, math.ceil(math.log2(eff_w + 1)) + 1),
    )


def dense_phase(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads: torch.Tensor,  # (B, L) int8 — FORWARD reads only
    lens: torch.Tensor,   # (B,) int64
    cfg: MapConfig,
) -> WalkInputs:
    """ONE canonical probe per forward window answers both strands: the rc
    lane's window at position s' is the reverse complement of the fwd window
    at lens-k-s'. The rc lane's anchor walk runs in its own coordinates;
    dense-array accesses map through col = lens - k - pos, and its next
    anchor is the previous rc anchor in fwd coordinates."""
    B, L = reads.shape
    k = st.k
    S = L - k + 1
    if L >= st.pad_tail:
        raise ValueError("read length must stay below the text tail pad")
    dev = reads.device

    lens = lens.to(torch.int64)
    lens2 = torch.cat([lens, lens])
    # rc lanes RIGHT-ALIGNED by a static flip: rc data position p lives at
    # column p + (L - len), threaded into the extension as col_off
    lanes = torch.cat([reads, denc.comp_flip_batch(reads)], dim=0)
    col_off2 = torch.cat([torch.zeros_like(lens), L - lens])
    next_bad = denc.next_bad_batch(lanes, L)
    preads = pack_reads(lanes)

    key_hi, key_lo, kvalid = denc.kmer_keys_from_packed(preads[:B], next_bad[:B], k, S)
    ff, bf, ef, fr, br, er = kmer_lookup_2str(didx, st, key_hi, key_lo)
    s_ix = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    ok = kvalid & ((s_ix + k) <= lens[:, None])
    anch_f = ff & ok & ((ef - bf) <= cfg.max_interval)
    anch_rF = fr & ok & ((er - br) <= cfg.max_interval)  # rc anchors, fwd coords
    return WalkInputs(
        preads=preads, next_bad=next_bad, lens2=lens2, col_off2=col_off2,
        bf=bf, ef=ef, br=br, er=er, anch_f=anch_f, anch_rF=anch_rF,
    )


def scan_batch_paired(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads: torch.Tensor,  # (B, L) int8 — FORWARD reads only
    lens: torch.Tensor,   # (B,) int64
    cfg: MapConfig,
) -> ScanHits:
    """SEMANTICS.md §3 scan over [fwd; rc] lanes: the dense phase with its
    SHARED lookup, then the anchor walk. Rows [0, B) of the result are
    forward lanes, [B, 2B) rc."""
    w = dense_phase(didx, st, reads, lens, cfg)
    return anchor_walk(didx, *w, **walk_params(st, cfg))


def anchor_tables(bf, ef, br, er, anch_f, anch_rF):
    """The reference's lane-aligned walk tables, (2B, S) int64 each: interval
    begins, ends, and the next-anchor (fwd rows) / prev-anchor (rc rows, fwd
    coordinates) scans of the masks, S and -1 where there is none."""
    S = bf.shape[1]
    s_ix = torch.arange(S, dtype=torch.int64, device=bf.device)[None, :]
    nf = torch.where(anch_f, s_ix, S)  # next anchor >= s (fwd lanes)
    next_f = torch.flip(torch.cummin(torch.flip(nf, dims=[1]), dim=1).values, dims=[1])
    pv = torch.where(anch_rF, s_ix, -1)  # prev anchor <= s (rc lanes)
    prev_rF = torch.cummax(pv, dim=1).values
    # lane-aligned stacks: row r < B = fwd arrays, row r >= B = rc arrays
    return (torch.cat([bf, br], dim=0), torch.cat([ef, er], dim=0),
            torch.cat([next_f, prev_rF], dim=0))


def anchor_walk_plain(
    didx: DeviceQuasiIndex,
    preads: torch.Tensor,    # (R, L) packed read words of the [fwd; rc] lanes
    next_bad: torch.Tensor,  # (R, L)
    lens2: torch.Tensor,     # (R,)
    col_off2: torch.Tensor,  # (R,) 0 for fwd lanes, L - len for rc lanes
    bf, ef, br, er, anch_f, anch_rF,  # (B, S) each, as in WalkInputs
    *, k: int, H: int, ext_steps: int,
) -> ScanHits:
    """The anchor walk in PyTorch, all R = 2B lanes in lockstep (rows [0, B)
    forward, [B, 2B) rc): the anchor tables, then H + 1 trips with finished
    lanes masked."""
    db2, de2, anc2 = anchor_tables(bf, ef, br, er, anch_f, anch_rF)
    R, L = preads.shape
    S = db2.shape[1]
    B = R // 2
    dev = preads.device
    is_rc = torch.arange(R, device=dev) >= B

    def at2(arr2d, col):
        return row_gather(arr2d, col.clamp(0, S - 1)[:, None])[:, 0]

    def next_anchor_pos(nxt):
        """Smallest lane-local anchor position >= nxt, else S (full width)."""
        col = torch.where(is_rc, lens2 - k - nxt, nxt)
        v = at2(anc2, col)
        fwd_next = torch.where(nxt < S, v, S)
        rc_next = torch.where((col >= 0) & (v >= 0), lens2 - k - v, S)
        return torch.where(is_rc, rc_next, fwd_next)

    pos = next_anchor_pos(torch.zeros_like(lens2))
    n = torch.zeros_like(lens2)
    trunc = torch.zeros_like(is_rc)
    buf = torch.zeros((R, H, 4), dtype=torch.int64, device=dev)
    lane = torch.arange(R, device=dev)
    for _ in range(H + 1):
        act = (pos < S) & ~trunc
        posc = pos.clamp(0, S - 1)
        col = torch.where(is_rc, lens2 - k - posc, posc)
        b1, e1, mlen = extend_packed(
            didx, preads, next_bad, lens2, at2(db2, col), at2(de2, col), posc,
            act, k, ext_steps, L, col_off=col_off2,
        )
        slot = n.clamp(0, H - 1)
        overflow = act & (n >= H)
        write = act & ~overflow
        rows4 = torch.stack([posc, mlen, b1, e1], dim=-1)
        buf[lane, slot] = torch.where(write[:, None], rows4, buf[lane, slot])
        pos = torch.where(act, next_anchor_pos(posc + (mlen - k + 1).clamp(min=1)), pos)
        n = n + write
        trunc = trunc | overflow
    return ScanHits(
        q=buf[..., 0], l=buf[..., 1], b=buf[..., 2], e=buf[..., 3],
        n=n, truncated=trunc,
    )


def _check_walk_inputs(didx, preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f,
                       anch_rF):
    """Raise on what csrc/walk.cu does not take: anything but contiguous
    int64 lane and interval tensors, bool masks and int32 index tables of the
    expected shapes, all on one CUDA device; sa_cmp rows must be whole 8-byte
    pairs on 8-byte boundaries with at most WALK_FUSED_WORDS_MAX fused words
    (the index builds 3 + 3)."""
    dev = preads.device
    lanes = dict(preads=preads, next_bad=next_bad, lens2=lens2, col_off2=col_off2,
                 bf=bf, ef=ef, br=br, er=er)
    masks = dict(anch_f=anch_f, anch_rF=anch_rF)
    tables = dict(sa_cmp=didx.sa_cmp, text2q=didx.text2q)
    for name, t in {**lanes, **masks, **tables}.items():
        if t.device != dev:
            raise ValueError(f"anchor_walk: {name} lies on {t.device}, preads on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"anchor_walk: {name} must be contiguous")
    for group, dtype in ((lanes, torch.int64), (masks, torch.bool), (tables, torch.int32)):
        for name, t in group.items():
            if t.dtype != dtype:
                raise TypeError(f"anchor_walk: {name} must be {dtype}, got {t.dtype}")
    if preads.dim() != 2 or preads.shape[0] % 2 or preads.shape[0] == 0:
        raise ValueError("anchor_walk: preads must be (2B, L) with B >= 1")
    R, L = preads.shape
    if next_bad.shape != (R, L):
        raise ValueError("anchor_walk: next_bad must have the shape of preads")
    if lens2.shape != (R,) or col_off2.shape != (R,):
        raise ValueError("anchor_walk: lens2 and col_off2 must be (2B,)")
    if bf.dim() != 2 or bf.shape[0] != R // 2 or any(
        t.shape != bf.shape for t in (ef, br, er, anch_f, anch_rF)
    ):
        raise ValueError("anchor_walk: bf, ef, br, er, anch_f and anch_rF must share one "
                         "(B, S) shape")
    if (didx.sa_cmp.dim() != 2 or didx.sa_cmp.shape[1] % 2
            or not 3 < didx.sa_cmp.shape[1] <= 3 + WALK_FUSED_WORDS_MAX):
        raise ValueError("anchor_walk: sa_cmp must be (n, 3 + F) with F odd and "
                         f"F <= {WALK_FUSED_WORDS_MAX}")
    if didx.text2q.dim() != 2 or didx.text2q.shape[1] != 4:
        raise ValueError("anchor_walk: text2q must be (nw, 4)")
    if dev.type != "cuda":
        raise ValueError(f"anchor_walk: no kernel for device {dev}")
    if didx.sa_cmp.data_ptr() % 8:
        raise ValueError("anchor_walk: sa_cmp must start on an 8-byte boundary")


def anchor_walk(
    didx: DeviceQuasiIndex, preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f,
    anch_rF, *, k: int, H: int, ext_steps: int,
) -> ScanHits:
    """The anchor walk over the [fwd; rc] lanes after the dense phase: the
    CUDA kernel of csrc/walk.cu for CUDA tensors (one launch, one thread per
    lane, every output byte written by the kernel: no fill), `anchor_walk_plain`
    for CPU tensors."""
    w = (preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f, anch_rF)
    if all(t.device.type == "cpu" for t in (*w, didx.sa_cmp, didx.text2q)):
        return anchor_walk_plain(didx, *w, k=k, H=H, ext_steps=ext_steps)
    _check_walk_inputs(didx, *w)
    R, L = preads.shape
    S = bf.shape[1]
    if S != L - k + 1 or H < 1:
        raise ValueError("anchor_walk: need S == L - k + 1 and H >= 1")
    dev = preads.device
    buf = torch.empty((R, H, 4), dtype=torch.int64, device=dev)
    n = torch.empty((R,), dtype=torch.int64, device=dev)
    trunc = torch.empty((R,), dtype=torch.bool, device=dev)
    fn = kernels.library("walk").tqm_anchor_walk
    fn.restype = ctypes.c_int
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [vp] * 11 + [i64, i32, vp, i64, i64, i64] + [i32] * 6 + [vp] * 4
    with torch.cuda.device(dev):
        rc = fn(
            *(t.data_ptr() for t in w),
            didx.sa_cmp.data_ptr(), didx.sa_cmp.shape[0], didx.sa_cmp.shape[1] - 3,
            didx.text2q.data_ptr(), didx.text2q.shape[0],
            R, R // 2, L, S, k, H, ext_steps, ext_words(L, k),
            buf.data_ptr(), n.data_ptr(), trunc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tqm_anchor_walk launch failed: CUDA error {rc}")
    kernels.LAUNCHES["anchor_walk"] += 1
    return ScanHits(
        q=buf[..., 0], l=buf[..., 1], b=buf[..., 2], e=buf[..., 3],
        n=n, truncated=trunc,
    )


def scan_dispatch(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads: torch.Tensor,  # (B, L) int8 — FORWARD reads
    lens: torch.Tensor,   # (B,)
    cfg: MapConfig,
) -> ScanHits:
    """Strand-paired scan of forward reads -> (2B, H) lane hits, for every
    device program (chunked or over the whole batch): one anchor-walk launch
    each. Only the canonical-CHD scan is ported; indexes without a canonical
    CHD (the reference's `scan_batch` binary-search path) are refused."""
    if not st.chd_canonical:
        raise NotImplementedError(
            "the binary-search probe path (indexes without a canonical CHD) "
            "is not ported yet"
        )
    return scan_batch_paired(didx, st, reads, lens, cfg)
