"""MMP search with NIP skipping — the compute core (SACollector rebuild).

Port of rapmap_tpu.ops.mmp, two phases:

  1. *Dense lookup*: a k-mer probe of every window of every (read, strand)
     lane at once — no loop. With the canonical-class CHD one probe per
     forward window answers both strands (`dense_phase`); otherwise the
     [fwd; revcomp] lanes are built explicitly and each lane's windows are
     probed through `ops.lookup.kmer_lookup` (legacy CHD or prefix-LUT binary
     search: `lane_phase`).
  2. *Anchor walk*: the NIP-skipping scan; each trip lands directly on the
     next anchor of the lane's anchor mask and extends it, with the packed
     word compare (`ops.extend_packed`) or, with cfg.packed_extension off,
     the charwise per-depth narrowing (`_extend`).

On CUDA tensors the walk is one launch of the hand-written kernel of
csrc/walk.cu (`anchor_walk`): one thread per lane, each looping to its own
convergence, with the extension inside it; it finds a lane's next anchor by a
bit scan of its mask row and writes every output byte itself. The same
kernel walks strand-paired lanes (rc lanes mirrored onto forward columns) or
explicit lanes that are all walked forward (`paired=False`), and is built
once with each extension. On CPU tensors the walk is `anchor_walk_plain` /
`anchor_walk_lanes_plain`, which build the reference's next-(/prev-)anchor
tables from the masks and run max_hits_per_strand + 1 trips with finished
lanes masked: every trip of an active lane either records a hit or sets
`truncated`, so that many trips finish every lane, and per-lane results are
identical to the reference's loop-until-done. The reference's dead-lane
compaction and narrow tail only change the lockstep width (its docstring
says the output is bit-identical) and are not carried over.

The pseudo walks (`pseudo_walk`; the reference's models/pseudo.py
while_loops) are the same walk without an extension: a hit records its
anchor's k-mer interval with length k and the walk jumps k columns. On CUDA
tensors they launch the walk kernel's third build (csrc/walk.cu, no
extension); on CPU tensors `pseudo_walk_plain` / `pseudo_walk_lanes_plain`.
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
from rapmap_tpu_torch.ops.gather import flat_gather, row_gather
from rapmap_tpu_torch.ops.lookup import kmer_lookup, kmer_lookup_2str
from rapmap_tpu_torch.utils.timers import span

WALK_FUSED_WORDS_MAX = 8  # csrc/walk.cu kRegWords: fused sa_cmp words it holds in registers


class ScanHits(NamedTuple):
    q: torch.Tensor      # (R, H) query positions
    l: torch.Tensor      # (R, H) MMP lengths
    b: torch.Tensor      # (R, H) interval begins
    e: torch.Tensor      # (R, H) interval ends
    n: torch.Tensor      # (R,)  hit counts
    truncated: torch.Tensor  # (R,) bool — hit buffer overflowed (over_budget)


class PseudoWalkInputs(NamedTuple):
    """What the pseudo dense phase hands the pseudo walk (models.pseudo):
    WalkInputs without the packed read words and column offsets, which a
    walk without an extension does not read. Strand-paired (R = 2B) or
    explicit lanes (B = R; br/er/anch_rF are bf/ef/anch_f again, unused)."""

    lens2: torch.Tensor   # (R,) int64
    bf: torch.Tensor      # (B, S) int64 interval begins (uint32 values)
    ef: torch.Tensor      # (B, S) int64 interval ends
    br: torch.Tensor
    er: torch.Tensor
    anch_f: torch.Tensor  # (B, S) bool
    anch_rF: torch.Tensor


class WalkInputs(NamedTuple):
    """What the dense phase hands the anchor walk. Lane tensors have R rows.
    Strand-paired (`dense_phase`): R = 2B, [0, B) forward lanes and [B, 2B)
    rc lanes; the per-window tensors have B rows in forward columns, `*f` for
    forward lanes, `*r`/`*rF` for rc lanes (rc lane r reads row r - B).
    Explicit lanes (`lane_phase`): the per-window tensors have R rows, every
    lane is walked forward, and br/er/anch_rF are bf/ef/anch_f again (unused).
    All int64 but the bool masks; preads and next_bad are None on the
    charwise path, which reads the lanes' codes instead."""

    preads: torch.Tensor | None    # (R, L) packed read words
    next_bad: torch.Tensor | None  # (R, L)
    lens2: torch.Tensor     # (R,)
    col_off2: torch.Tensor  # (R,) 0 for fwd and explicit lanes, L - len for paired rc lanes
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
    anchor is the previous rc anchor in fwd coordinates. With
    cfg.packed_extension off the keys are built base by base and no packed
    words are made (the charwise walk reads `lane_codes`)."""
    B, L = reads.shape
    k = st.k
    S = L - k + 1
    if L >= st.pad_tail:
        raise ValueError("read length must stay below the text tail pad")
    dev = reads.device

    lens = lens.to(torch.int64)
    lens2 = torch.cat([lens, lens])
    if cfg.packed_extension:
        # rc lanes RIGHT-ALIGNED by a static flip: rc data position p lives at
        # column p + (L - len), threaded into the extension as col_off
        lanes = torch.cat([reads, denc.comp_flip_batch(reads)], dim=0)
        col_off2 = torch.cat([torch.zeros_like(lens), L - lens])
        next_bad = denc.next_bad_batch(lanes, L)
        preads = pack_reads(lanes)
        key_hi, key_lo, kvalid = denc.kmer_keys_from_packed(preads[:B], next_bad[:B], k, S)
    else:
        col_off2 = torch.zeros_like(lens2)
        next_bad = preads = None
        key_hi, key_lo, kvalid = denc.kmer_keys_batch(reads, k)
    ff, bf, ef, fr, br, er = kmer_lookup_2str(didx, st, key_hi, key_lo)
    s_ix = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    ok = kvalid & ((s_ix + k) <= lens[:, None])
    anch_f = ff & ok & ((ef - bf) <= cfg.max_interval)
    anch_rF = fr & ok & ((er - br) <= cfg.max_interval)  # rc anchors, fwd coords
    return WalkInputs(
        preads=preads, next_bad=next_bad, lens2=lens2, col_off2=col_off2,
        bf=bf, ef=ef, br=br, er=er, anch_f=anch_f, anch_rF=anch_rF,
    )


def lane_codes(reads: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The explicit [fwd; revcomp] lanes of forward reads, (2B, L) int8, each
    row left-aligned: what the charwise walk and `scan_batch` read."""
    return torch.cat([reads, denc.revcomp_batch(reads, lens)], dim=0)


def lane_phase(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads: torch.Tensor,  # (R, L) int8 — rows are (read, strand) lanes
    lens: torch.Tensor,   # (R,)
    cfg: MapConfig,
) -> WalkInputs:
    """The dense phase of `scan_batch`: every window of every lane probed
    through `kmer_lookup` (legacy CHD or prefix-LUT binary search); every
    lane is walked forward."""
    R, L = reads.shape
    k = st.k
    S = L - k + 1
    if L >= st.pad_tail:
        raise ValueError("read length must stay below the text tail pad")
    lens = lens.to(torch.int64)
    if cfg.packed_extension:
        next_bad = denc.next_bad_batch(reads, L)
        preads = pack_reads(reads)
        key_hi, key_lo, kvalid = denc.kmer_keys_from_packed(preads, next_bad, k, S)
    else:
        next_bad = preads = None
        key_hi, key_lo, kvalid = denc.kmer_keys_batch(reads, k)
    found, db, de = kmer_lookup(didx, st, key_hi, key_lo)
    s_ix = torch.arange(S, dtype=torch.int64, device=reads.device)[None, :]
    anchor = found & kvalid & ((s_ix + k) <= lens[:, None]) & ((de - db) <= cfg.max_interval)
    return WalkInputs(
        preads=preads, next_bad=next_bad, lens2=lens, col_off2=torch.zeros_like(lens),
        bf=db, ef=de, br=db, er=de, anch_f=anchor, anch_rF=anchor,
    )


def scan_batch(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads: torch.Tensor,  # (R, L) int8 — rows are (read, strand) lanes
    lens: torch.Tensor,   # (R,)
    cfg: MapConfig,
) -> ScanHits:
    """SEMANTICS.md §3 scan over explicit lanes, each walked forward: the
    probe path of indexes without a canonical CHD."""
    w = lane_phase(didx, st, reads, lens, cfg)
    return anchor_walk(didx, *w, **walk_params(st, cfg), paired=False,
                       codes=None if cfg.packed_extension else reads.contiguous())


def scan_inputs(
    didx: DeviceQuasiIndex,
    st: EngineStatic,
    reads: torch.Tensor,  # (B, L) int8 — FORWARD reads
    lens: torch.Tensor,   # (B,)
    cfg: MapConfig,
) -> tuple[WalkInputs, dict]:
    """The dense half of `scan_dispatch` -> (walk inputs, the keyword
    arguments of `anchor_walk`): `scan_dispatch` is
    `anchor_walk(didx, *w, **kw)` of them."""
    kw = walk_params(st, cfg)
    lens = lens.to(torch.int64)
    if st.chd_canonical:
        w = dense_phase(didx, st, reads, lens, cfg)
        codes = None if cfg.packed_extension else lane_codes(reads, lens)
        return w, dict(kw, paired=True, codes=codes)
    # the reference's non-canonical branch: explicit [fwd; revcomp] lanes
    lanes = lane_codes(reads, lens)
    w = lane_phase(didx, st, lanes, torch.cat([lens, lens]), cfg)
    return w, dict(kw, paired=False, codes=None if cfg.packed_extension else lanes)


def anchor_tables(bf, ef, br, er, anch_f, anch_rF):
    """The reference's lane-aligned walk tables, (2B, S) int64 each: interval
    begins, ends, and the next-anchor (fwd rows) / prev-anchor (rc rows, fwd
    coordinates) scans of the masks, S and -1 where there is none."""
    S = bf.shape[1]
    prev_rF = torch.cummax(torch.where(anch_rF, _cols(S, bf.device), -1), dim=1).values
    # lane-aligned stacks: row r < B = fwd arrays, row r >= B = rc arrays
    return (torch.cat([bf, br], dim=0), torch.cat([ef, er], dim=0),
            torch.cat([next_anchor_table(anch_f), prev_rF], dim=0))


def _cols(S: int, dev) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int64, device=dev)[None, :]


def next_anchor_table(anch: torch.Tensor) -> torch.Tensor:
    """next[r, s] = smallest anchor column s' >= s of row r, else S."""
    S = anch.shape[1]
    nf = torch.where(anch, _cols(S, anch.device), S)
    return torch.flip(torch.cummin(torch.flip(nf, dims=[1]), dim=1).values, dims=[1])


def _col_lower_bound(didx: DeviceQuasiIndex, b, e, d, c, steps: int):
    """Per-lane lower bound of char c in the depth-d text column over
    SA[b:e): `steps` trips, converged lanes masked. Needs the flat sa/text
    arrays, which a big-SA upload drops."""
    if didx.sa is None or didx.text is None:
        raise ValueError("charwise extension needs the flat sa/text arrays; big-SA "
                         "indexes support only packed_extension=True")
    lo, hi = b, e
    for _ in range(steps):
        mid = (lo + hi) >> 1
        g = flat_gather(didx.sa, mid).to(torch.int64)
        less = flat_gather(didx.text, g + d).to(torch.int64) < c
        cont = lo < hi
        lo, hi = torch.where(cont & less, mid + 1, lo), torch.where(cont & ~less, mid, hi)
    return lo


def _extend(didx, reads, lens, b0, e0, pos, active, k: int, ext_steps: int):
    """extendSearchNaive rebuild: per-depth interval narrowing from depth k
    until a mismatch, the read's end or a code outside 1..4 -> (b, e, mlen).
    Lane r reads row r of `reads` (left-aligned codes); the loop runs until
    no lane advances, as the reference's while_loop does."""
    R, L = reads.shape
    rows = torch.arange(R, device=reads.device)
    b, e, alive = b0, e0, active
    d = torch.full_like(b0, k)
    while bool(alive.any()):
        ic = pos + d
        c = reads[rows, ic.clamp(0, L - 1)].to(torch.int64)
        ok = alive & (ic < lens) & (c >= 1) & (c <= 4)
        lb = _col_lower_bound(didx, b, e, d, c, ext_steps)
        ub = _col_lower_bound(didx, b, e, d, c + 1, ext_steps)
        alive = ok & (lb < ub)
        b, e, d = torch.where(alive, lb, b), torch.where(alive, ub, e), d + alive
    return b, e, d


class WalkTables(NamedTuple):
    """A walk's lane-aligned tables, built once a program: interval begins
    and ends and the next-anchor (forward lanes) or previous-anchor (rc
    lanes, forward columns) table, (R, S) int64 each, as `anchor_tables` or
    `next_anchor_table` build them; which lanes are rc (mirrored columns);
    the lanes' read lengths."""

    db2: torch.Tensor    # (R, S) int64
    de2: torch.Tensor    # (R, S) int64
    anc2: torch.Tensor   # (R, S) int64, S and -1 where there is none
    is_rc: torch.Tensor  # (R,) bool
    lens2: torch.Tensor  # (R,) int64


class WalkState(NamedTuple):
    """The lockstep walk between two trips: each lane's next anchor `pos`,
    hit count `n`, overflow flag `trunc` and hit buffer `buf` (R, H, 4)
    [pos, mlen, b, e], and the next trip's extension inputs: whether the
    lane is active, its clamped position and its anchor's interval."""

    pos: torch.Tensor    # (R,) int64
    n: torch.Tensor      # (R,) int64
    trunc: torch.Tensor  # (R,) bool
    buf: torch.Tensor    # (R, H, 4) int64
    act: torch.Tensor    # (R,) bool
    posc: torch.Tensor   # (R,) int64
    b0: torch.Tensor     # (R,) int64
    e0: torch.Tensor     # (R,) int64


def _at2(arr2d, col):
    return row_gather(arr2d, col.clamp(0, arr2d.shape[1] - 1)[:, None])[:, 0]


def _next_anchor_pos(t: WalkTables, nxt, k: int):
    """Smallest lane-local anchor position >= nxt, else S (full width)."""
    S = t.anc2.shape[1]
    col = torch.where(t.is_rc, t.lens2 - k - nxt, nxt)
    v = _at2(t.anc2, col)
    fwd_next = torch.where(nxt < S, v, S)
    rc_next = torch.where((col >= 0) & (v >= 0), t.lens2 - k - v, S)
    return torch.where(t.is_rc, rc_next, fwd_next)


def _with_trip(t: WalkTables, pos, n, trunc, buf, k: int) -> WalkState:
    """The state with the next trip's inputs: act, posc and the anchor's
    interval (gathered on every lane)."""
    S = t.db2.shape[1]
    posc = pos.clamp(0, S - 1)
    col = torch.where(t.is_rc, t.lens2 - k - posc, posc)
    return WalkState(pos, n, trunc, buf, (pos < S) & ~trunc, posc, _at2(t.db2, col),
                     _at2(t.de2, col))


def walk_begin(t: WalkTables, *, k: int, H: int) -> WalkState:
    """The walk before its first trip: every lane at its first anchor, no
    hit, and the first trip's inputs."""
    R = t.lens2.shape[0]
    pos = _next_anchor_pos(t, torch.zeros_like(t.lens2), k)
    buf = torch.zeros((R, H, 4), dtype=torch.int64, device=t.lens2.device)
    return _with_trip(t, pos, torch.zeros_like(t.lens2), torch.zeros_like(t.is_rc), buf, k)


def walk_advance(t: WalkTables, s: WalkState, b1, e1, mlen, *, k: int, H: int,
                 jump: int | None = None) -> WalkState:
    """One trip's home half, after its extension (b1, e1, mlen): an active
    lane records its hit at slot n (or, with n = H, sets trunc) and moves to
    the next anchor at or past posc + max(mlen - k + 1, 1) (the NIP skip),
    or with `jump` posc + jump (the pseudo walks' jump-ahead k); then the
    next trip's inputs. s.buf is written in place."""
    lane = torch.arange(t.lens2.shape[0], device=t.lens2.device)
    slot = s.n.clamp(0, H - 1)
    overflow = s.act & (s.n >= H)
    write = s.act & ~overflow
    rows4 = torch.stack([s.posc, mlen, b1, e1], dim=-1)
    s.buf[lane, slot] = torch.where(write[:, None], rows4, s.buf[lane, slot])
    adv = (mlen - k + 1).clamp(min=1) if jump is None else jump
    pos = torch.where(s.act, _next_anchor_pos(t, s.posc + adv, k), s.pos)
    return _with_trip(t, pos, s.n + write, s.trunc | overflow, s.buf, k)


def walk_hits(s: WalkState) -> ScanHits:
    return ScanHits(q=s.buf[..., 0], l=s.buf[..., 1], b=s.buf[..., 2], e=s.buf[..., 3],
                    n=s.n, truncated=s.trunc)


def _walk_plain(db2, de2, anc2, is_rc, lens2, extend, k: int, H: int,
                jump: int | None = None) -> ScanHits:
    """H + 1 lockstep trips over lane-aligned tables (R, S): forward lanes
    take the next anchor from anc2, rc lanes the previous one in mirrored
    columns; extend(b0, e0, pos, active) -> (b, e, mlen). After a hit the
    walk skips to posc + max(mlen - k + 1, 1) (the NIP skip), or with `jump`
    to posc + jump (the pseudo walks' jump-ahead k). A trip is walk_advance
    after the extension, from walk_begin."""
    t = WalkTables(db2, de2, anc2, is_rc, lens2)
    s = walk_begin(t, k=k, H=H)
    for _ in range(H + 1):
        s = walk_advance(t, s, *extend(s.b0, s.e0, s.posc, s.act), k=k, H=H, jump=jump)
    return walk_hits(s)


def _plain_extend(didx, preads, next_bad, lens2, col_off2, codes, k: int, ext_steps: int):
    """The plain extension of a walk: packed words, or charwise over `codes`."""
    if codes is not None:
        return lambda b0, e0, pos, act: _extend(didx, codes, lens2, b0, e0, pos, act, k,
                                                ext_steps)
    L = preads.shape[1]
    return lambda b0, e0, pos, act: extend_packed(
        didx, preads, next_bad, lens2, b0, e0, pos, act, k, ext_steps, L, col_off=col_off2)


def anchor_walk_plain(
    didx: DeviceQuasiIndex,
    preads: torch.Tensor | None,    # (R, L) packed read words of the [fwd; rc] lanes
    next_bad: torch.Tensor | None,  # (R, L)
    lens2: torch.Tensor,     # (R,)
    col_off2: torch.Tensor,  # (R,) 0 for fwd lanes, L - len for rc lanes
    bf, ef, br, er, anch_f, anch_rF,  # (B, S) each, as in WalkInputs
    *, k: int, H: int, ext_steps: int, codes: torch.Tensor | None = None,
) -> ScanHits:
    """The strand-paired anchor walk in PyTorch, all R = 2B lanes in lockstep
    (rows [0, B) forward, [B, 2B) rc): the anchor tables, then H + 1 trips
    with finished lanes masked. codes (R, L) int8, the explicit left-aligned
    [fwd; revcomp] lanes, selects the charwise extension."""
    db2, de2, anc2 = anchor_tables(bf, ef, br, er, anch_f, anch_rF)
    R = lens2.shape[0]
    is_rc = torch.arange(R, device=lens2.device) >= R // 2
    extend = _plain_extend(didx, preads, next_bad, lens2, col_off2, codes, k, ext_steps)
    return _walk_plain(db2, de2, anc2, is_rc, lens2, extend, k, H)


def anchor_walk_lanes_plain(
    didx: DeviceQuasiIndex,
    preads, next_bad, lens2, col_off2,  # (R, L), (R, L), (R,), (R,) as in WalkInputs
    bf, ef, br, er, anch_f, anch_rF,    # (R, S) each; br, er, anch_rF unused
    *, k: int, H: int, ext_steps: int, codes: torch.Tensor | None = None,
) -> ScanHits:
    """The walk over R explicit lanes, all walked forward, in PyTorch: the
    reference `scan_batch`'s next-anchor table, then H + 1 trips with
    finished lanes masked. codes (R, L) int8 selects the charwise extension."""
    is_rc = torch.zeros(lens2.shape, dtype=torch.bool, device=lens2.device)
    extend = _plain_extend(didx, preads, next_bad, lens2, col_off2, codes, k, ext_steps)
    return _walk_plain(bf, ef, next_anchor_table(anch_f), is_rc, lens2, extend, k, H)


def _no_extend(k: int):
    """The pseudo walks' extension: none, the anchor's interval at length k."""
    return lambda b0, e0, pos, act: (b0, e0, torch.full_like(b0, k))


def pseudo_walk_plain(lens2, bf, ef, br, er, anch_f, anch_rF, *, k: int, H: int) -> ScanHits:
    """The strand-paired pseudo walk in PyTorch (the reference's
    pseudo_scan_batch_paired loop), R = 2B lanes in lockstep: the anchor
    tables, then H + 1 trips with finished lanes masked."""
    db2, de2, anc2 = anchor_tables(bf, ef, br, er, anch_f, anch_rF)
    is_rc = torch.arange(lens2.shape[0], device=lens2.device) >= lens2.shape[0] // 2
    return _walk_plain(db2, de2, anc2, is_rc, lens2, _no_extend(k), k, H, jump=k)


def pseudo_walk_lanes_plain(lens2, bf, ef, br, er, anch_f, anch_rF, *, k: int,
                            H: int) -> ScanHits:
    """The pseudo walk over R explicit lanes, all forward, in PyTorch (the
    reference's pseudo_scan_batch loop); br, er, anch_rF unused."""
    is_rc = torch.zeros(lens2.shape, dtype=torch.bool, device=lens2.device)
    return _walk_plain(bf, ef, next_anchor_table(anch_f), is_rc, lens2, _no_extend(k), k, H,
                       jump=k)


def _check_pseudo_walk_inputs(w: PseudoWalkInputs, paired: bool) -> None:
    """Raise on what the kernel's pseudo build does not take: anything but
    contiguous int64 lengths and intervals and bool masks of one (B, S)
    shape (B = R / 2 when paired, else R), all on one CUDA device."""
    dev = w.lens2.device
    for name, t in w._asdict().items():
        if t.device != dev:
            raise ValueError(f"pseudo_walk: {name} lies on {t.device}, lens2 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"pseudo_walk: {name} must be contiguous")
        want = torch.bool if name.startswith("anch") else torch.int64
        if t.dtype != want:
            raise TypeError(f"pseudo_walk: {name} must be {want}, got {t.dtype}")
    R = w.lens2.shape[0]
    if w.lens2.dim() != 1 or R == 0 or (paired and R % 2):
        raise ValueError("pseudo_walk: lens2 must be (R,) with R >= 1, R = 2B when paired")
    if w.bf.dim() != 2 or w.bf.shape[0] != (R // 2 if paired else R) or any(
        t.shape != w.bf.shape for t in w[2:]
    ):
        raise ValueError("pseudo_walk: bf, ef, br, er, anch_f and anch_rF must share one "
                         "(B, S) shape, B = R / 2 when paired, else R")
    if dev.type != "cuda":
        raise ValueError(f"pseudo_walk: no kernel for device {dev}")


def pseudo_walk(lens2, bf, ef, br, er, anch_f, anch_rF, *, k: int, H: int,
                paired: bool = True) -> ScanHits:
    """The pseudo walk after the pseudo dense phase: the kernel of
    csrc/walk.cu built without an extension for CUDA tensors (one launch,
    one thread per lane, every output byte written by the kernel), the plain
    version for CPU tensors. paired=True walks strand-paired lanes (kernel
    count `pseudo_walk`), paired=False explicit lanes, all forward
    (`pseudo_walk_lanes`). Hits are [q, k, b, e] with b, e the anchor's
    interval as given (uint32 occurrence ids in int64)."""
    w = PseudoWalkInputs(lens2, bf, ef, br, er, anch_f, anch_rF)
    if all(t.device.type == "cpu" for t in w):
        plain = pseudo_walk_plain if paired else pseudo_walk_lanes_plain
        return plain(*w, k=k, H=H)
    _check_pseudo_walk_inputs(w, paired)
    R, S = lens2.shape[0], bf.shape[1]
    if H < 1 or S < 1:
        raise ValueError("pseudo_walk: need H >= 1 and S >= 1")
    dev = lens2.device
    buf = torch.empty((R, H, 4), dtype=torch.int64, device=dev)
    n = torch.empty((R,), dtype=torch.int64, device=dev)
    trunc = torch.empty((R,), dtype=torch.bool, device=dev)
    fn = kernels.library("walk").tqm_pseudo_walk
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [vp] * 7 + [i64, i64] + [i32] * 3 + [vp] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*(t.data_ptr() for t in w), R, R // 2 if paired else R, S, k, H,
                buf.data_ptr(), n.data_ptr(), trunc.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tqm_pseudo_walk launch failed: CUDA error {rc}")
    kernels.LAUNCHES["pseudo_walk" if paired else "pseudo_walk_lanes"] += 1
    return ScanHits(q=buf[..., 0], l=buf[..., 1], b=buf[..., 2], e=buf[..., 3],
                    n=n, truncated=trunc)


def _check_walk_inputs(didx, preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f,
                       anch_rF, paired: bool = True, codes=None):
    """Raise on what csrc/walk.cu does not take: anything but contiguous
    int64 lane and interval tensors, bool masks and index tables of the
    expected types and shapes, all on one CUDA device. Paired lanes: R = 2B
    lanes over (B, S) windows; explicit lanes: R lanes over (R, S). The
    packed extension reads sa_cmp rows of whole 8-byte pairs on 8-byte
    boundaries with at most WALK_FUSED_WORDS_MAX fused words (the index
    builds 3 + 3); the charwise one reads codes (R, L) int8 and the flat
    int32 sa and int8 text, which a big-SA upload drops."""
    charwise = codes is not None
    if charwise and (didx.sa is None or didx.text is None):
        raise ValueError("anchor_walk: the charwise extension needs the flat sa/text "
                         "arrays; big-SA indexes support only packed_extension=True")
    lanes = dict(lens2=lens2, bf=bf, ef=ef, br=br, er=er)
    if charwise:
        tables = dict(sa=(didx.sa, torch.int32), text=(didx.text, torch.int8),
                      codes=(codes, torch.int8))
    else:
        lanes.update(preads=preads, next_bad=next_bad, col_off2=col_off2)
        tables = dict(sa_cmp=(didx.sa_cmp, torch.int32), text2q=(didx.text2q, torch.int32))
    masks = dict(anch_f=anch_f, anch_rF=anch_rF)
    dev = lens2.device
    for name, t in {**lanes, **masks, **{n: v[0] for n, v in tables.items()}}.items():
        if t.device != dev:
            raise ValueError(f"anchor_walk: {name} lies on {t.device}, lens2 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"anchor_walk: {name} must be contiguous")
    expect = [*((n, t, torch.int64) for n, t in lanes.items()),
              *((n, t, torch.bool) for n, t in masks.items()),
              *((n, t, d) for n, (t, d) in tables.items())]
    for name, t, dtype in expect:
        if t.dtype != dtype:
            raise TypeError(f"anchor_walk: {name} must be {dtype}, got {t.dtype}")
    rows = codes if charwise else preads
    if rows.dim() != 2 or rows.shape[0] == 0 or (paired and rows.shape[0] % 2):
        raise ValueError("anchor_walk: lanes must be (R, L) with R >= 1, R = 2B when paired")
    R, L = rows.shape
    if not charwise and next_bad.shape != (R, L):
        raise ValueError("anchor_walk: next_bad must have the shape of preads")
    if lens2.shape != (R,) or (not charwise and col_off2.shape != (R,)):
        raise ValueError("anchor_walk: lens2 and col_off2 must be (R,)")
    if bf.dim() != 2 or bf.shape[0] != (R // 2 if paired else R) or any(
        t.shape != bf.shape for t in (ef, br, er, anch_f, anch_rF)
    ):
        raise ValueError("anchor_walk: bf, ef, br, er, anch_f and anch_rF must share one "
                         "(B, S) shape, B = R / 2 when paired, else R")
    if charwise:
        if didx.sa.dim() != 1 or didx.text.dim() != 1 or not len(didx.sa) or not len(didx.text):
            raise ValueError("anchor_walk: sa and text must be non-empty 1-D tensors")
    elif (didx.sa_cmp.dim() != 2 or didx.sa_cmp.shape[1] % 2
            or not 3 < didx.sa_cmp.shape[1] <= 3 + WALK_FUSED_WORDS_MAX):
        raise ValueError("anchor_walk: sa_cmp must be (n, 3 + F) with F odd and "
                         f"F <= {WALK_FUSED_WORDS_MAX}")
    elif didx.text2q.dim() != 2 or didx.text2q.shape[1] != 4:
        raise ValueError("anchor_walk: text2q must be (nw, 4)")
    if dev.type != "cuda":
        raise ValueError(f"anchor_walk: no kernel for device {dev}")
    if not charwise and didx.sa_cmp.data_ptr() % 8:
        raise ValueError("anchor_walk: sa_cmp must start on an 8-byte boundary")


def anchor_walk(
    didx: DeviceQuasiIndex, preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f,
    anch_rF, *, k: int, H: int, ext_steps: int, paired: bool = True,
    codes: torch.Tensor | None = None,
) -> ScanHits:
    """The anchor walk after the dense phase: the CUDA kernel of csrc/walk.cu
    for CUDA tensors (one launch, one thread per lane, every output byte
    written by the kernel: no fill), the plain version for CPU tensors.
    paired=True walks the strand-paired [fwd; rc] lanes of `dense_phase`,
    paired=False the explicit lanes of `lane_phase`, all forward. codes
    (R, L) int8, the lanes' left-aligned codes, selects the charwise
    extension (kernel `anchor_walk_charwise`); without it the packed one
    (`anchor_walk`, paired; `anchor_walk_lanes`, explicit lanes)."""
    w = (preads, next_bad, lens2, col_off2, bf, ef, br, er, anch_f, anch_rF)
    ext = (codes, didx.sa, didx.text) if codes is not None else (didx.sa_cmp, didx.text2q)
    if all(t.device.type == "cpu" for t in (*w, *ext) if t is not None):
        plain = anchor_walk_plain if paired else anchor_walk_lanes_plain
        return plain(didx, *w, k=k, H=H, ext_steps=ext_steps, codes=codes)
    _check_walk_inputs(didx, *w, paired=paired, codes=codes)
    R, L = (codes if codes is not None else preads).shape
    S = bf.shape[1]
    if S != L - k + 1 or H < 1:
        raise ValueError("anchor_walk: need S == L - k + 1 and H >= 1")
    dev = lens2.device
    buf = torch.empty((R, H, 4), dtype=torch.int64, device=dev)
    n = torch.empty((R,), dtype=torch.int64, device=dev)
    trunc = torch.empty((R,), dtype=torch.bool, device=dev)
    B = R // 2 if paired else R
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib = kernels.library("walk")
    if codes is not None:
        name, fn = "anchor_walk_charwise", lib.tqm_anchor_walk_charwise
        fn.argtypes = [vp] * 9 + [i64, vp, i64, i64, i64] + [i32] * 5 + [vp] * 4
        args = [codes.data_ptr(), lens2.data_ptr(),
                *(t.data_ptr() for t in (bf, ef, br, er, anch_f, anch_rF)),
                didx.sa.data_ptr(), didx.sa.shape[0], didx.text.data_ptr(), didx.text.shape[0],
                R, B, L, S, k, H, ext_steps]
    else:
        name = "anchor_walk" if paired else "anchor_walk_lanes"
        fn = lib.tqm_anchor_walk
        fn.argtypes = [vp] * 11 + [i64, i32, vp, i64, i64, i64] + [i32] * 6 + [vp] * 4
        args = [*(t.data_ptr() for t in w),
                didx.sa_cmp.data_ptr(), didx.sa_cmp.shape[0], didx.sa_cmp.shape[1] - 3,
                didx.text2q.data_ptr(), didx.text2q.shape[0],
                R, B, L, S, k, H, ext_steps, ext_words(L, k)]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(*args, buf.data_ptr(), n.data_ptr(), trunc.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    kernels.LAUNCHES[name] += 1
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
    """Strand-paired scan of forward reads -> (2B, H) lane hits, one
    anchor-walk launch per device program (chunk, or whole batch). Picks the
    canonical-CHD paired scan (one dense probe per k-mer class) when the
    index carries one, else builds [fwd; rc] lanes explicitly and runs the
    per-lane scan (`scan_batch`). Rows [0, B) are forward lanes, [B, 2B) rc."""
    with span("tqm.dense"):
        w, kw = scan_inputs(didx, st, reads, lens, cfg)
    with span("tqm.walk"):
        return anchor_walk(didx, *w, **kw)
