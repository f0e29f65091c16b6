"""The scan of indexes without the canonical CHD and the charwise extension,
rapmap_tpu_torch against rapmap_tpu on the CPU, integer for integer
(tolerance zero): `scan_dispatch` over explicit [fwd; revcomp] lanes
(`scan_batch`, binary-search and legacy-CHD probes) at H = 16 and H = 2;
`anchor_walk_lanes_plain` against the reference's loop and against the
scalar lane model of csrc/walk.cu's forward-lanes mode; the plain `_extend`
against the reference's and against a scalar model of the kernel's charwise
extension, in both walks; packed_extension=False against the packed scan on
both index kinds (tests/test_extend_packed.py); and what the walk wrapper
refuses in the new modes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.models.quasi import QuasiMapper as RefMapper
from rapmap_tpu.ops import encode as rdenc
from rapmap_tpu.ops import mmp as rmmp
from rapmap_tpu.ops.device_index import upload_index as ref_upload
from rapmap_tpu.ops.lookup import kmer_lookup as ref_kmer_lookup
from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.models.quasi import QuasiMapper
from rapmap_tpu_torch.ops.device_index import upload_index
from rapmap_tpu_torch.ops.mmp import (
    ScanHits, _extend, anchor_walk, anchor_walk_lanes_plain, lane_codes, lane_phase,
    scan_batch, scan_dispatch, scan_inputs, walk_params,
)
from tests.test_device_parity import batch_of
from tests.test_torch_lookup import legacy_chd, without_chd
from tests.test_torch_walk import LaneModel, clamp
from tests.util import BASES, sample_reads, toy_index
from tests.test_torch_pe import jax_cache_off  # noqa: F401

L = 60  # k = 11: W = ceil(49 / 16) = 4 > 3 fused words, so text2q tails run


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A repetitive toy transcriptome (shared 40-base prefixes), k = 11, and
    reads of mixed lengths up to 60 with errors and Ns, junk, an all-N read,
    one shorter than k and one of length k."""
    rng = np.random.default_rng(44)
    idx, txps = toy_index(tmp_path_factory.mktemp("scan"), rng, n_txps=8, min_len=120,
                          max_len=300, k=11, shared_prefix=40)
    seqs = []
    for rl in (25, 44, L):
        seqs += [r[1] for r in sample_reads(rng, txps, 10, read_len=rl, rc_frac=0.5,
                                            error_rate=0.04, n_frac=0.02)]
    seqs += [BASES[rng.integers(0, 4, L)].tobytes() for _ in range(3)]
    seqs += [b"N" * L, txps[0][1][:L], b"ACGTACG", txps[1][1][5:16]]
    codes, lens = batch_of(seqs, L)
    return idx, txps, codes, lens


INDEXES = {"canonical_chd": lambda i: i, "no_chd": without_chd, "legacy_chd": legacy_chd}


def _uploads(idx):
    rdidx, rst = ref_upload(idx)
    didx, st = upload_index(index_from_reference(vars(idx)), "cpu")
    return (rdidx, rst), (didx, st)


def _ref_scan(rdidx, rst, codes, lens, cfg):
    f = jax.jit(rmmp.scan_dispatch, static_argnums=(1, 4))
    return f(rdidx, rst, jnp.asarray(codes), jnp.asarray(lens), cfg)


def _assert_hits_equal(got, want):
    for name in ScanHits._fields:
        assert np.array_equal(np.asarray(getattr(got, name)).astype(np.int64),
                              np.asarray(getattr(want, name)).astype(np.int64)), name


@pytest.mark.parametrize("H", [16, 2])
@pytest.mark.parametrize("kind", ["no_chd", "legacy_chd"])
def test_scan_batch_equals_reference(world, kind, H):
    """scan_dispatch's non-canonical branch: explicit [fwd; revcomp] lanes,
    the generic probe, every lane walked forward; all six ScanHits fields.
    H = 2 overflows the hit buffer."""
    idx, _, codes, lens = world
    (rdidx, rst), (didx, st) = _uploads(INDEXES[kind](idx))
    assert not st.chd_canonical
    want = _ref_scan(rdidx, rst, codes, lens, RefConfig(k=idx.k, max_hits_per_strand=H))
    kernels.reset_launches()
    got = scan_dispatch(didx, st, t_(codes), t_(lens.astype(np.int64)),
                        MapConfig(k=idx.k, max_hits_per_strand=H))
    assert not any(kernels.LAUNCHES.values())
    _assert_hits_equal(got, want)
    assert int(got.n.max()) >= 2
    assert bool(got.truncated.any()) == (H == 2)


def _lane_inputs(world, kind, H, packed=True):
    idx, _, codes, lens = world
    _, (didx, st) = _uploads(INDEXES[kind](idx))
    cfg = MapConfig(k=idx.k, max_hits_per_strand=H, packed_extension=packed)
    w, kw = scan_inputs(didx, st, t_(codes), t_(lens.astype(np.int64)), cfg)
    return idx, didx, w, kw


@pytest.mark.parametrize("H", [16, 2])
def test_lanes_plain_equals_reference_scan_batch(world, H):
    """scan_batch, and anchor_walk_lanes_plain over lane_phase, equal the
    reference's scan_batch on the same explicit lanes."""
    idx, _, codes, lens = world
    nochd = without_chd(idx)
    (rdidx, rst), (didx, st) = _uploads(nochd)
    lanes = np.concatenate([codes, np.asarray(rdenc.revcomp_batch(jnp.asarray(codes),
                                                                  jnp.asarray(lens)))])
    lens2 = np.concatenate([lens, lens])
    f = jax.jit(rmmp.scan_batch, static_argnums=(1, 4))
    want = f(rdidx, rst, jnp.asarray(lanes), jnp.asarray(lens2),
             RefConfig(k=idx.k, max_hits_per_strand=H))
    cfg = MapConfig(k=idx.k, max_hits_per_strand=H)
    w = lane_phase(didx, st, t_(lanes), t_(lens2.astype(np.int64)), cfg)
    assert w.bf.shape[0] == len(lanes) and w.br is w.bf and w.anch_rF is w.anch_f
    _assert_hits_equal(anchor_walk_lanes_plain(didx, *w, **walk_params(st, cfg)), want)
    _assert_hits_equal(scan_batch(didx, st, t_(lanes), t_(lens2), cfg), want)


@pytest.mark.parametrize("H", [16, 2])
def test_lane_model_lanes_mode_matches_plain(world, H):
    """csrc/walk.cu's control flow with B = R (every lane forward), lane by
    lane, gives what the lockstep plain version gives; the wrapper takes the
    plain version on CPU tensors and counts no launch."""
    idx, didx, w, kw = _lane_inputs(world, "no_chd", H)
    assert kw["paired"] is False and kw["codes"] is None
    kernels.reset_launches()
    want = anchor_walk(didx, *w, **kw)
    assert not any(kernels.LAUNCHES.values())
    model = LaneModel(didx, kw["k"], w.preads.shape[1], kw["ext_steps"])
    _assert_hits_equal(model.walk(w, H, paired=False), want)


class CharLaneModel(LaneModel):
    """The charwise extension of csrc/walk.cu (extend_charwise,
    col_lower_bound, width1_depth), one lane at a time: searches stop at lo
    == hi within `steps` trips, the depth loop at the first char that does
    not narrow; an interval of width 1 takes the shortcut: sa[b] once, then
    the read's codes against the text 16 chars a step where neither index
    needs a clamp, char by char (clamped) where one does."""

    def __init__(self, didx, codes, k, L, steps):
        super().__init__(didx, k, L, steps)
        self.codes = codes.numpy()
        self.sa = didx.sa.numpy()
        self.text = didx.text.numpy()
        self.vector_steps = 0
        self.scalar_steps = 0

    def col_lower_bound(self, lo, hi, d, c):
        t = 0
        while t < self.steps and lo < hi:
            mid = (lo + hi) >> 1
            g = int(self.sa[clamp(mid, 0, len(self.sa) - 1)])
            if int(self.text[clamp(g + d, 0, len(self.text) - 1)]) < c:
                lo = mid + 1
            else:
                hi = mid
            t += 1
        return lo

    def width1_depth(self, row, ln, pos, d, b):
        n_text = len(self.text)
        g = int(self.sa[clamp(b, 0, len(self.sa) - 1)])
        while True:
            ic = pos + d
            if ic >= ln:
                return d
            tg = g + d
            m = min(ln - ic, 16, self.L - ic, n_text - tg) if ic >= 0 and tg >= 0 else 0
            if m >= 1:
                self.vector_steps += 1
                q, t = row[ic : ic + m], self.text[tg : tg + m]
                stop = [i for i in range(m) if not 1 <= q[i] <= 4 or q[i] != t[i]]
                if stop:
                    return d + stop[0]
                d += m
                continue
            self.scalar_steps += 1
            c = int(row[clamp(ic, 0, self.L - 1)])
            if c < 1 or c > 4 or int(self.text[clamp(tg, 0, n_text - 1)]) != c:
                return d
            d += 1

    def extend_char(self, row, ln, b0, e0, pos, active):
        b, e, d = b0, e0, self.k
        while active:
            if self.steps >= 1 and e - b == 1:
                return b, e, self.width1_depth(row, ln, pos, d, b)
            ic = pos + d
            if ic >= ln:
                break
            c = int(row[clamp(ic, 0, self.L - 1)])
            if c < 1 or c > 4:
                break
            lb = self.col_lower_bound(b, e, d, c)
            ub = self.col_lower_bound(b, e, d, c + 1)
            if lb >= ub:
                break
            b, e, d = lb, ub, d + 1
        return b, e, d

    def extend_lane(self, r, pre, nbad, ln, col_off, b0, e0, pos):
        return self.extend_char(self.codes[r], ln, b0, e0, pos, True)


def _anchors(idx, didx, st, codes, lens, rng):
    """Real anchor intervals at random windows (the extension's
    precondition), some lanes inactive -> (b0, e0, pos, active)."""
    k = idx.k
    R = len(codes)
    pos = rng.integers(0, L - k, R)
    hi, lo, valid = rdenc.kmer_keys_batch(jnp.asarray(codes), k)
    rows = np.arange(R)
    f, b0, e0 = ref_kmer_lookup(*ref_upload(idx), jnp.asarray(np.asarray(hi)[rows, pos]),
                                jnp.asarray(np.asarray(lo)[rows, pos]))
    act = np.asarray(f) & np.asarray(valid)[rows, pos] & (rng.random(R) < 0.9)
    return np.asarray(b0), np.asarray(e0), pos, act


def _text_end_lanes(idx, rng, R):
    """Width-1 intervals [b, b + 1) of SA slots whose suffix starts within
    k + 20 chars of the text's end, and reads that follow the text
    from such a suffix as the clamped gather reads it (the last char
    repeated past the end), a third with a wrong base or an N after the end;
    the text cut to its real chars, so its last char is a base."""
    n = int(idx.n_text)
    k = idx.k
    sa = np.asarray(idx.sa, np.int64)
    text = np.asarray(idx.text)[:n]
    slots = np.flatnonzero(sa >= n - k - 20)
    b0 = rng.choice(slots, R)
    pos = rng.integers(0, 6, R)
    codes = rng.integers(1, 5, (R, L)).astype(np.int8)
    for r in range(R):
        d = np.arange(L - pos[r])
        codes[r, pos[r]:] = text[np.minimum(sa[b0[r]] + d, n - 1)]
        past = n - sa[b0[r]] + pos[r]  # the first read column past the text's end
        if r % 3 == 0 and past + 2 < L:
            codes[r, past + 2] = 5 if r % 2 else 1 + codes[r, past + 2] % 4
    lens = rng.integers(L - 8, L + 1, R).astype(np.int32)
    return codes, lens, b0, b0 + 1, pos, rng.random(R) < 0.95, n


@pytest.mark.parametrize("steps,case", [(24, "anchors"), (3, "anchors"),
                                        (24, "width1_text_end")],
                         ids=["24", "3", "width1_text_end"])
def test_extend_charwise_equals_reference_and_model(world, steps, case):
    """The plain `_extend` equals the reference's on real anchors (and on
    whole-SA intervals: steps = 3 stops searches short of convergence, as
    the static trip bound does), and the kernel's scalar model equals it.
    width1_text_end: width-1 intervals whose reads run past the text's end
    (cut to its real chars), where the gathers clamp to its last char."""
    idx, _, codes, lens = world
    (rdidx, rst), (didx, st) = _uploads(idx)
    rng = np.random.default_rng(steps if case == "anchors" else 61)
    if case == "anchors":
        b0, e0, pos, act = _anchors(idx, didx, st, codes, lens, rng)
        n_sa = len(idx.sa)
        wide = rng.random(len(b0)) < 0.3
        b0 = np.where(wide, 0, b0)
        e0 = np.where(wide, n_sa, e0)
    else:
        codes, lens, b0, e0, pos, act, n = _text_end_lanes(idx, rng, 48)
        rdidx = rdidx._replace(text=rdidx.text[:n])
        didx = didx._replace(text=didx.text[:n])
    want = jax.jit(rmmp._extend, static_argnums=(7, 8))(
        rdidx, jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(b0.astype(np.int32)),
        jnp.asarray(e0.astype(np.int32)), jnp.asarray(pos.astype(np.int32)), jnp.asarray(act),
        idx.k, steps)
    got = _extend(didx, t_(codes), t_(lens.astype(np.int64)), t_(b0.astype(np.int64)),
                  t_(e0.astype(np.int64)), t_(pos.astype(np.int64)), t_(act), idx.k, steps)
    for name, w, g in zip(("b", "e", "mlen"), want, got):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64)), name
    model = CharLaneModel(didx, t_(codes), idx.k, L, steps)
    for r in range(len(codes)):
        m = model.extend_char(codes[r], int(lens[r]), int(b0[r]), int(e0[r]), int(pos[r]),
                              bool(act[r]))
        assert m == tuple(int(x[r]) for x in got), r
    mlen = got[2].numpy()
    assert (mlen[act] > idx.k).any() and model.vector_steps > 0
    if case == "width1_text_end":  # runs past the text's end, by clamped single chars
        past = np.asarray(idx.sa, np.int64)[b0] + mlen > n
        assert past[act].sum() >= 8 and model.scalar_steps > 0
        assert (mlen[act & past] < lens[act & past] - pos[act & past]).any()


@pytest.mark.parametrize("H", [16, 2])
@pytest.mark.parametrize("kind", ["canonical_chd", "no_chd"])
def test_charwise_scan_equals_reference_and_model(world, kind, H):
    """scan_dispatch with packed_extension=False (paired walk over the
    explicit revcomp rows on the canonical CHD; lanes walk without it) equals
    the reference's charwise scan, the packed scan, and the kernel's scalar
    model of either walk with the charwise extension."""
    idx, _, codes, lens = world
    sub = INDEXES[kind](idx)
    (rdidx, rst), (didx, st) = _uploads(sub)
    want = _ref_scan(rdidx, rst, codes, lens,
                     RefConfig(k=idx.k, max_hits_per_strand=H, packed_extension=False))
    cfg = MapConfig(k=idx.k, max_hits_per_strand=H, packed_extension=False)
    w, kw = scan_inputs(didx, st, t_(codes), t_(lens.astype(np.int64)), cfg)
    assert kw["paired"] == (kind == "canonical_chd") and w.preads is None
    assert torch.equal(kw["codes"], lane_codes(t_(codes), t_(lens.astype(np.int64))))
    kernels.reset_launches()
    got = anchor_walk(didx, *w, **kw)
    assert not any(kernels.LAUNCHES.values())
    _assert_hits_equal(got, want)
    packed = scan_dispatch(didx, st, t_(codes), t_(lens.astype(np.int64)),
                           dataclasses.replace(cfg, packed_extension=True))
    _assert_hits_equal(got, packed)
    model = CharLaneModel(didx, kw["codes"], kw["k"], L, kw["ext_steps"])
    _assert_hits_equal(model.walk(w, H, paired=kw["paired"]), got)


@pytest.mark.parametrize("kind", ["canonical_chd", "no_chd"])
def test_packed_scan_equals_charwise(tmp_path, kind):
    """Twin of tests/test_extend_packed.py::test_packed_scan_equals_charwise
    on both index kinds: the port's charwise MapOut and counters equal its
    packed ones and the reference's charwise ones."""
    rng = np.random.default_rng(77)
    idx, txps = toy_index(tmp_path, rng, n_txps=8, min_len=120, max_len=300, k=11,
                          shared_prefix=30)
    idx = INDEXES[kind](idx)
    reads = sample_reads(rng, txps, 48, read_len=52, error_rate=0.04, n_frac=0.02)
    seqs = [r[1] for r in reads] + [BASES[rng.integers(0, 4, 52)].tobytes() for _ in range(6)]
    codes, lens = batch_of(seqs, 52)
    kw = dict(k=idx.k, max_hits_per_strand=42, expand_budget=2048, max_out=256)
    port = {p: QuasiMapper(index_from_reference(vars(idx)),
                           MapConfig(**kw, packed_extension=p), device="cpu")
            for p in (True, False)}
    assert port[False].didx.sa is not None and (port[True].didx.sa is None) == (
        kind == "canonical_chd")
    got = {p: m.map_se(codes, lens) for p, m in port.items()}
    want = RefMapper(idx, RefConfig(**kw, packed_extension=False)).map_se(codes, lens)
    for other in (got[True], want):
        for a, b in zip(got[False], other):
            for f in a._fields:
                assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f
    assert got[False][0].mapped.any()


def test_charwise_refuses_big_sa(tmp_path):
    """A big (int64) SA upload drops the flat sa/text: the charwise scan
    raises, as the reference asserts, and the packed one maps."""
    from rapmap_tpu.index.builder import build_quasi_index as ref_build
    from tests.util import random_transcriptome, write_fasta

    rng = np.random.default_rng(8)
    txps = random_transcriptome(rng, n_txps=3, min_len=120, max_len=200)
    idx = ref_build(write_fasta(str(tmp_path / "t.fa"), txps), k=11, big_sa=True)
    codes, lens = batch_of([r[1] for r in sample_reads(rng, txps, 4, read_len=40)], 40)
    didx, st = upload_index(index_from_reference(vars(idx)), "cpu")
    args = (didx, st, t_(codes), t_(lens.astype(np.int64)))
    assert int(scan_dispatch(*args, MapConfig(k=11)).n.sum()) > 0
    with pytest.raises(ValueError, match="big-SA"):
        scan_dispatch(*args, MapConfig(k=11, packed_extension=False))


# ---- the wrapper refuses what the kernel does not take, in the new modes ------

def _meta(t):
    return None if t is None else torch.empty_like(t, device="meta")


@pytest.mark.parametrize("case, err", [
    ("lanes_shape_dense", ValueError), ("lanes_dtype_mask", TypeError),
    ("charwise_no_flat_arrays", ValueError), ("charwise_dtype_codes", TypeError),
    ("charwise_dtype_text", TypeError), ("charwise_shape_codes", ValueError),
    ("charwise_no_kernel_for_device", ValueError),
])
def test_walk_wrapper_refuses_new_modes(world, case, err):
    """Off the CPU the wrapper never takes a plain version: for the
    forward-lanes mode and the charwise extension it checks dtype, shape,
    the flat arrays and the device, and raises. Tensors on the meta device
    stand in for a device that is not the CPU."""
    packed = case.startswith("lanes")
    idx, didx, w, kw = _lane_inputs(world, "no_chd", 16, packed=packed)
    didx = didx._replace(**{f: _meta(getattr(didx, f)) for f in didx._fields})
    w = w._replace(**{f: _meta(getattr(w, f)) for f in w._fields})
    kw = dict(kw, codes=_meta(kw["codes"]))
    if case == "lanes_shape_dense":
        w = w._replace(bf=w.bf[:-1], ef=w.ef[:-1], br=w.br[:-1], er=w.er[:-1])
    elif case == "lanes_dtype_mask":
        w = w._replace(anch_f=w.anch_f.to(torch.uint8))
    elif case == "charwise_no_flat_arrays":
        didx = didx._replace(sa=None)
    elif case == "charwise_dtype_codes":
        kw["codes"] = kw["codes"].to(torch.int64)
    elif case == "charwise_dtype_text":
        didx = didx._replace(text=didx.text.to(torch.int32))
    elif case == "charwise_shape_codes":
        kw["codes"] = kw["codes"][:-1]
    kernels.reset_launches()
    with pytest.raises(err):
        anchor_walk(didx, *w, **kw)
    assert not any(kernels.LAUNCHES.values())
