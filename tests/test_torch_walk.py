"""The anchor walk of rapmap_tpu_torch (ops.mmp.anchor_walk and its plain
version) against rapmap_tpu's strand-paired scan, against a scalar per-lane
model of the control flow of csrc/walk.cu, and the wrapper's refusals. Every
value is an integer, so every comparison is exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.ops.device_index import upload_index as ref_upload
from rapmap_tpu.ops.mmp import scan_dispatch as ref_scan
from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.ops.device_index import upload_index
from rapmap_tpu_torch.ops.extend_packed import ext_words, extend_packed
from rapmap_tpu_torch.ops.mmp import (
    ScanHits, anchor_walk, anchor_walk_plain, dense_phase, walk_params,
)
from tests.test_device_parity import batch_of
from tests.util import BASES, sample_reads, toy_index

M32 = 0xFFFFFFFF
L_MAX = 90  # k = 11: W = ceil(79 / 16) = 5 > 3 fused words, so text2q tails run


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A small repetitive transcriptome (shared 40-base prefixes), reads of
    mixed lengths up to 90 with errors and Ns, an all-N read, a read shorter
    than k and one of length exactly k."""
    rng = np.random.default_rng(21)
    idx, txps = toy_index(tmp_path_factory.mktemp("walk"), rng, n_txps=8, min_len=120,
                          max_len=260, k=11, shared_prefix=40)
    seqs = []
    for rl in (30, 52, 77, L_MAX):
        seqs += [r[1] for r in sample_reads(rng, txps, 8, read_len=rl, rc_frac=0.5,
                                            error_rate=0.05, n_frac=0.02)]
    seqs += [BASES[rng.integers(0, 4, L_MAX)].tobytes() for _ in range(3)]
    seqs += [b"N" * L_MAX, txps[0][1][:L_MAX], b"ACGTACG", txps[1][1][5:16]]
    codes, lens = batch_of(seqs, L_MAX)
    assert ext_words(L_MAX, idx.k) > 3 and (lens == idx.k).any() and (lens < idx.k).any()
    didx, st = upload_index(index_from_reference(vars(idx)), "cpu")
    return idx, codes, lens, didx, st


def walk_inputs(world, H):
    idx, codes, lens, didx, st = world
    cfg = MapConfig(k=idx.k, max_hits_per_strand=H)
    w = dense_phase(didx, st, t_(codes), t_(lens.astype(np.int64)), cfg)
    return didx, w, walk_params(st, cfg)


@pytest.mark.parametrize("H", [16, 2])
def test_walk_plain_matches_reference(world, H):
    """dense_phase + anchor_walk_plain == the reference's scan, all six
    fields; H = 2 overflows the hit buffer."""
    idx, codes, lens, _, _ = world
    rdidx, rst = ref_upload(idx, lean=True)
    f = jax.jit(ref_scan, static_argnums=(1, 4))
    want = f(rdidx, rst, jnp.asarray(codes), jnp.asarray(lens),
             RefConfig(k=idx.k, max_hits_per_strand=H))
    didx, w, params = walk_inputs(world, H)
    got = anchor_walk_plain(didx, *w, **params)
    for name in ScanHits._fields:
        assert np.array_equal(
            getattr(got, name).numpy().astype(np.int64),
            np.asarray(getattr(want, name)).astype(np.int64),
        ), name
    assert int(got.n.max()) >= 2
    if H == 2:
        assert bool(got.truncated.any())


# ---- a scalar model of csrc/walk.cu: one lane at a time, loops that run to
# ---- their own convergence, 32-bit words as masked Python ints, every
# ---- shift by 32 branched around and every gather clamped by hand

def clamp(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def clz32(x):
    return 32 - x.bit_length()


class LaneModel:
    def __init__(self, didx, k, L, steps):
        self.sa_cmp = didx.sa_cmp.numpy()
        self.text2q = didx.text2q.numpy()
        self.n_sa, cols = self.sa_cmp.shape
        self.F = cols - 3
        self.nw = self.text2q.shape[0]
        self.k, self.L, self.steps = k, L, steps
        self.W = ext_words(L, k)

    def raw_text_word(self, wi0, i):
        row = clamp(wi0 + 4 * (i >> 2), 0, self.nw - 1)
        return int(self.text2q[row, i & 3]) & M32

    def query_word(self, words, base, j):
        c = base + 16 * j
        if c >= self.L:
            return 0
        return int(words[clamp(c, 0, self.L - 1)]) & M32

    def suffix_cmp(self, words, base, qlen, slot):
        row = self.sa_cmp[clamp(slot, 0, self.n_sa - 1)]
        wi, sub, tleft = int(row[0]), int(row[1]), int(row[2])
        sh = sub << 1
        lcp = 0
        for j in range(self.W):
            qn = clamp(qlen - 16 * j, 0, 16)
            tn = clamp(tleft - 16 * j, 0, 16)
            n = min(qn, tn)
            mask = 0 if n == 0 else (M32 << (32 - 2 * n)) & M32
            if j < self.F:
                tw = int(row[3 + j]) & M32
            else:
                jj = j - self.F
                r0 = self.raw_text_word(wi + self.F, jj)
                if sh == 0:
                    tw = r0
                else:
                    r1 = self.raw_text_word(wi + self.F, jj + 1)
                    tw = ((r0 << sh) & M32) | (r1 >> (32 - sh))
            qv = self.query_word(words, base, j) & mask
            tv = tw & mask
            diffpos = clz32(qv ^ tv) >> 1
            has_diff = diffpos < n
            lcp += diffpos if has_diff else n
            if has_diff or tn < qn or qn < 16:
                if has_diff:
                    return (-1 if tv < qv else 1), lcp
                return (-1 if tn < qn else 0), lcp
        return 0, lcp

    def bound_search(self, words, base, qlen, lo, hi, upper):
        ll = lg = 0
        t = 0
        while t < self.steps and lo < hi:
            mid = (lo + hi) >> 1
            cmp, lcp = self.suffix_cmp(words, base, qlen, mid)
            if cmp < 0 or (upper and cmp == 0):
                ll, lo = lcp, mid + 1
            else:
                lg, hi = lcp, mid
            t += 1
        return lo, ll, lg

    def extend(self, words, nbad, ln, col_off, b0, e0, pos, active):
        k, L = self.k, self.L
        base = pos + k + col_off
        nb = int(nbad[clamp(base, 0, L - 1)]) if base < L else base
        qlen = clamp(min(nb, ln + col_off) - base, 0, L - k)
        b0a, e0a = (b0, e0) if active else (0, 0)
        lb, ll, lg = self.bound_search(words, base, qlen, b0a, e0a, False)
        l_left = ll if lb > b0a else 0
        l_right = lg if lb < e0a else 0
        ext = min(max(l_left, l_right), qlen)
        lb2, _, _ = self.bound_search(words, base, ext, lb if l_left < ext else b0a, lb, False)
        ub2, _, _ = self.bound_search(words, base, ext, lb, lb if l_right < ext else e0a, True)
        if active and ub2 > lb2:
            return lb2, ub2, k + ext
        return b0, e0, k

    def walk(self, w, H):
        R, L = w.preads.shape
        S = w.db2.shape[1]
        B, k = R // 2, self.k
        pre, nbad, anc = w.preads.numpy(), w.next_bad.numpy(), w.anc2.numpy()
        db, de = w.db2.numpy(), w.de2.numpy()
        buf = np.zeros((R, H, 4), np.int64)
        n_out = np.zeros(R, np.int64)
        trunc = np.zeros(R, bool)
        for r in range(R):
            is_rc = r >= B
            ln, col_off = int(w.lens2[r]), int(w.col_off2[r])

            def next_anchor_pos(nxt):
                col = ln - k - nxt if is_rc else nxt
                v = int(anc[r, clamp(col, 0, S - 1)])
                if not is_rc:
                    return v if nxt < S else S
                return ln - k - v if (col >= 0 and v >= 0) else S

            pos = next_anchor_pos(0)
            n = 0
            while pos < S:
                if n >= H:
                    trunc[r] = True
                    break
                posc = clamp(pos, 0, S - 1)
                col = clamp(ln - k - posc if is_rc else posc, 0, S - 1)
                b, e, mlen = self.extend(pre[r], nbad[r], ln, col_off, int(db[r, col]),
                                         int(de[r, col]), posc, True)
                buf[r, n] = (posc, mlen, b, e)
                n += 1
                pos = next_anchor_pos(posc + max(mlen - k + 1, 1))
            n_out[r] = n
        return ScanHits(buf[..., 0], buf[..., 1], buf[..., 2], buf[..., 3], n_out, trunc)


@pytest.mark.parametrize("H", [16, 2])
def test_lane_model_matches_walk_plain(world, H):
    """The kernel's control flow, lane by lane, gives what the lockstep
    plain version gives; the wrapper takes the plain version on CPU tensors
    and counts no launch."""
    didx, w, params = walk_inputs(world, H)
    kernels.reset_launches()
    want = anchor_walk(didx, *w, **params)
    assert kernels.LAUNCHES["anchor_walk"] == 0
    model = LaneModel(didx, params["k"], w.preads.shape[1], params["ext_steps"])
    got = model.walk(w, H)
    for name in ScanHits._fields:
        assert np.array_equal(np.asarray(getattr(got, name)).astype(np.int64),
                              getattr(want, name).numpy().astype(np.int64)), name
    if H == 2:
        assert got.truncated.any()
    else:  # some compare ran past the fused words into text2q
        assert (got.l > params["k"] + 48).any()


@pytest.mark.parametrize("steps", [24, 3])
def test_lane_model_matches_extend_packed(world, steps):
    """The extension alone on whole-SA intervals at random positions, some
    lanes inactive; steps = 3 stops the searches short of convergence, as the
    plain version's static trip bound does."""
    idx, codes, lens, didx, st = world
    didx, w, _ = walk_inputs(world, 16)
    rng = np.random.default_rng(5)
    R, L = w.preads.shape
    n_sa = didx.sa_cmp.shape[0]
    pos = rng.integers(0, L - idx.k, R)
    act = rng.random(R) < 0.85
    b0 = rng.integers(0, n_sa // 2, R)
    e0 = np.where(rng.random(R) < 0.5, n_sa, b0 + rng.integers(0, 9, R))
    want = extend_packed(didx, w.preads, w.next_bad, w.lens2, t_(b0), t_(e0), t_(pos),
                         t_(act), idx.k, steps, L, col_off=w.col_off2)
    model = LaneModel(didx, idx.k, L, steps)
    pre, nbad = w.preads.numpy(), w.next_bad.numpy()
    got = np.array([
        model.extend(pre[r], nbad[r], int(w.lens2[r]), int(w.col_off2[r]), int(b0[r]),
                     int(e0[r]), int(pos[r]), bool(act[r]))
        for r in range(R)
    ])
    for c, name in enumerate(("b", "e", "mlen")):
        assert np.array_equal(got[:, c], want[c].numpy()), name


# ---- the wrapper refuses what the kernel does not take -----------------------

def _meta_inputs(world):
    didx, w, params = walk_inputs(world, 16)
    meta = lambda t: torch.empty_like(t, device="meta")  # noqa: E731
    return didx._replace(**{f: meta(getattr(didx, f)) for f in didx._fields}), \
        w._replace(**{f: meta(getattr(w, f)) for f in w._fields}), params


@pytest.mark.parametrize("case, err", [
    ("dtype_lane", TypeError), ("dtype_table", TypeError), ("shape_rows", ValueError),
    ("shape_dense", ValueError), ("non_contiguous", ValueError),
    ("mixed_devices", ValueError), ("no_kernel_for_device", ValueError),
])
def test_walk_wrapper_refuses(world, case, err):
    """Off the CPU the wrapper never takes the plain version: it checks
    device, dtype, shape and contiguity and raises. Tensors on the meta
    device stand in for a device that is not the CPU."""
    didx, w, params = _meta_inputs(world)
    cpu_didx, cpu_w, _ = walk_inputs(world, 16)
    if case == "dtype_lane":
        w = w._replace(next_bad=w.next_bad.to(torch.int32))
    elif case == "dtype_table":
        didx = didx._replace(sa_cmp=didx.sa_cmp.to(torch.int64))
    elif case == "shape_rows":
        w = w._replace(lens2=w.lens2[:-1])
    elif case == "shape_dense":
        w = w._replace(anc2=w.anc2[:, :-1].contiguous())
    elif case == "non_contiguous":
        R, L = w.preads.shape
        w = w._replace(preads=torch.empty((L, R), dtype=torch.int64, device="meta").T)
        assert not w.preads.is_contiguous()
    elif case == "mixed_devices":
        w = w._replace(db2=cpu_w.db2)
    kernels.reset_launches()
    with pytest.raises(err):
        anchor_walk(didx, *w, **params)
    assert kernels.LAUNCHES["anchor_walk"] == 0
