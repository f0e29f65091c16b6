"""The mapping score of rapmap_tpu_torch (ops.align) against rapmap_tpu's
(ops.align, JAX on the CPU) and the numpy oracle (oracle.align): the plain
banded DP, the window extraction, score_records / score_pe_rows on a real
uploaded index, ops.compact.rid_from_counts, a per-record model of the
control flow of csrc/align.cu (the staged read and window, G lanes a record
with the shuffle-scan prefix max, or the scratch ring of wide bands, rows
stopping at the read's length), and the wrapper's refusals. Scores are integers: every comparison
is exact equality (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.encode import encode_reads
from rapmap_tpu.ops import align as ref_align
from rapmap_tpu.ops.compact import rid_from_counts as ref_rid_from_counts
from rapmap_tpu.ops.device_index import upload_index as ref_upload
from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.format import index_from_reference
from rapmap_tpu_torch.oracle.align import banded_score_np, score_mapping_np
from rapmap_tpu_torch.ops import align
from rapmap_tpu_torch.ops.compact import rid_from_counts
from rapmap_tpu_torch.ops.device_index import upload_index
from tests.util import toy_index
from tests.test_torch_pe import jax_cache_off  # noqa: F401


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def dp_inputs(seed, band, N=64, L=40):
    """tests/test_align.py's random DP inputs: half the rows hold the read
    verbatim, some with a point error or a deleted window char; invalid
    window chars (5) and read Ns (4) sprinkled."""
    rng = np.random.default_rng(seed)
    W = L + 2 * band
    rcodes = rng.integers(0, 4, size=(N, L)).astype(np.int32)
    wcodes = rng.integers(0, 4, size=(N, W)).astype(np.int32)
    rlens = rng.integers(8, L + 1, size=N).astype(np.int32)
    for i in range(0, N, 2):
        ln = int(rlens[i])
        wcodes[i, band : band + ln] = rcodes[i, :ln]
        if i % 4 == 0 and ln > 4:
            wcodes[i, band + ln // 2] = (wcodes[i, band + ln // 2] + 1) % 4
        if i % 8 == 0 and ln > 6:
            wcodes[i, band + ln // 3 : band + ln - 1] = wcodes[i, band + ln // 3 + 1 : band + ln]
    wcodes[rng.random((N, W)) < 0.05] = 5
    rcodes[rng.random((N, L)) < 0.03] = 4
    return rcodes, rlens, wcodes


@pytest.mark.parametrize("band,params", [
    (7, (2, -4, 5, 3)),
    (3, (2, -4, 5, 3)),
    (5, (1, -3, 4, 4)),   # go == ge edge of the closed form
    (7, (3, -2, 9, 1)),
    (1, (2, -4, 5, 3)),
    (40, (2, -4, 5, 3)),  # wider than the read: the window spans the band
])
def test_banded_scores_match_reference_and_oracle(band, params):
    ma, mp, go, ge = params
    rcodes, rlens, wcodes = dp_inputs(100 + band, band)
    want = np.asarray(ref_align.banded_scores(
        jnp.asarray(rcodes), jnp.asarray(rlens), jnp.asarray(wcodes), band, ma, mp, go, ge))
    got = align.banded_scores(t_(rcodes), t_(rlens), t_(wcodes), band, ma, mp, go, ge)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    for i in range(len(rlens)):
        ln = int(rlens[i])
        assert got[i] == banded_score_np(rcodes[i, :ln], wcodes[i, : ln + 2 * band],
                                         band, ma, mp, go, ge), i


def test_banded_scores_known_values():
    """tests/test_align.py's known values: a perfect hit, one mismatch, one
    extra window char, one missing window char."""
    band, ma, mp, go, ge = 7, 2, -4, 5, 3
    ln = 30
    rng = np.random.default_rng(7)
    read = rng.integers(0, 4, size=ln).astype(np.int32)

    def win_with(payload, off=band):
        w = rng.integers(0, 4, size=ln + 2 * band).astype(np.int32)
        w[off : off + len(payload)] = payload
        return w

    perfect = win_with(read)
    mism = win_with(read.copy())
    mism[band + 10] = (mism[band + 10] + 1) % 4
    ins = win_with(np.insert(read, 12, (read[12] + 1) % 4))
    dele = win_with(np.delete(read, 12))
    rcodes = np.stack([read] * 4)
    wcodes = np.stack([perfect, mism, ins, dele])
    rlens = np.full(4, ln, np.int32)
    got = align.banded_scores(t_(rcodes), t_(rlens), t_(wcodes), band, ma, mp, go, ge)
    assert got[0] == ma * ln
    assert got[1] == ma * (ln - 1) + mp
    assert got[2] >= ma * ln - go
    assert got[3] >= ma * (ln - 1) - go
    for i in range(4):
        assert got[i] == banded_score_np(rcodes[i], wcodes[i], band, ma, mp, go, ge)


def test_banded_scores_refuses_go_below_ge():
    rcodes, rlens, wcodes = dp_inputs(1, 2, N=4, L=8)
    with pytest.raises(ValueError, match="gap-open"):
        align.banded_scores(t_(rcodes), t_(rlens), t_(wcodes), 2, 2, -4, 2, 3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_align.py's toy index (6 transcripts of 100-300 bp, k = 21),
    both packages' uploads of it, and 32 scored records: reads with 6%
    errors and 2% Ns, a third at their own locus, the others at positions
    past both transcript ends too, on both strands, four windows off
    transcript 0's head, two dead rows."""
    rng = np.random.default_rng(93)
    idx, txps = toy_index(tmp_path_factory.mktemp("align"), rng, n_txps=6, min_len=100,
                          max_len=300, k=21)
    rdidx, _ = ref_upload(idx)
    didx, _ = upload_index(index_from_reference(vars(idx)), "cpu")
    L, B = 48, 32
    codes = np.full((B, L), 5, np.int8)
    lens = np.zeros(B, np.int32)
    t = np.zeros(B, np.int32)
    pos = np.zeros(B, np.int32)
    strand = np.zeros(B, np.int32)
    tl = np.asarray(idx.txp_lens)
    for i in range(B):
        ti = int(rng.integers(0, len(txps)))
        li = int(rng.integers(24, L + 1))
        seq = bytearray(txps[ti][1][:li])
        for j in range(li):
            u = rng.random()
            if u < 0.06:
                seq[j] = b"ACGT"[int(rng.integers(0, 4))]
            elif u < 0.08:
                seq[j] = ord("N")
        codes[i, :li] = encode_reads(np.frombuffer(bytes(seq), dtype=np.uint8))
        lens[i] = li
        t[i] = ti
        pos[i] = int(rng.integers(-10, int(tl[ti]) + 5))
        strand[i] = int(rng.integers(0, 2))
        if i % 3 == 0:  # the read's own locus: a high score
            pos[i], strand[i] = 0, 0
    for i, p in zip(range(4), (-5, 0, 2, 5)):
        t[i], pos[i], strand[i] = 0, p, 0
        codes[i, : lens[i]] = encode_reads(np.frombuffer(txps[0][1][: lens[i]], dtype=np.uint8))
    valid = np.ones(B, bool)
    valid[B - 2 :] = False
    return dict(idx=idx, rdidx=rdidx, didx=didx, codes=codes, lens=lens, t=t, pos=pos,
                strand=strand, valid=valid)


def _ref_scores(w, cfg, rid, t, pos, strand, valid):
    return np.asarray(ref_align.score_records(
        w["rdidx"], RefConfig(k=21, mapping_score=True, **cfg), jnp.asarray(w["codes"]),
        jnp.asarray(w["lens"]), jnp.asarray(rid), jnp.asarray(t), jnp.asarray(pos),
        jnp.asarray(strand), jnp.asarray(valid)))


def _port_scores(w, cfg, rid, t, pos, strand, valid):
    return align.score_records(
        w["didx"], MapConfig(k=21, mapping_score=True, **cfg), t_(w["codes"]),
        t_(w["lens"].astype(np.int64)), t_(rid), t_(t), t_(pos), t_(strand), t_(valid)).numpy()


def test_txp_align_upload_matches_reference(world):
    assert np.array_equal(world["didx"].txp_align.numpy(), np.asarray(world["rdidx"].txp_align))
    assert world["didx"].txp_align.dtype == torch.int32


def test_extract_ref_windows_matches_reference(world):
    """Windows off transcript 0's head, off the last transcript's tail, and
    at every sub-word offset 0..15 (sub 0 takes the unshifted word)."""
    idx = world["idx"]
    off = np.asarray(idx.txp_offsets, np.int64)
    tl = np.asarray(idx.txp_lens, np.int64)
    last = len(tl) - 1
    t = [0] * 6 + [last] * 6
    start = [-40, -17, -16, -1, 0, 3] + [int(tl[last]) + d for d in (-60, -33, -5, -1, 0, 7)]
    for ti in range(len(tl)):  # starts giving each sub-word offset
        for sub in range(16):
            t.append(ti)
            start.append(int((sub - off[ti]) % 16) + 16 * (ti + 1))
    t = np.array(t, np.int32)
    start = np.array(start, np.int32)
    goff = (off[t] & 15) + start
    assert {0, 15} <= set((goff & 15).tolist())
    for W in (17, 60):
        want = np.asarray(ref_align.extract_ref_windows(world["rdidx"], jnp.asarray(t),
                                                        jnp.asarray(start), W))
        got = align.extract_ref_windows(world["didx"], t_(t), t_(start), W)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    assert (want == 5).any() and (want < 4).any()


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(align_band=1),
    dict(align_band=16, align_ma=1, align_mp=-3, align_go=4, align_ge=4),
])
def test_score_records_matches_reference_and_oracle(world, cfg):
    w = world
    B = len(w["lens"])
    rid = np.arange(B, dtype=np.int32)
    want = _ref_scores(w, cfg, rid, w["t"], w["pos"], w["strand"], w["valid"])
    got = _port_scores(w, cfg, rid, w["t"], w["pos"], w["strand"], w["valid"])
    assert got.dtype == np.int32 and np.array_equal(got, want)
    c = MapConfig(k=21, mapping_score=True, **cfg)
    for i in range(B):
        if not w["valid"][i]:
            assert got[i] == 0
            continue
        assert got[i] == score_mapping_np(
            w["idx"], w["codes"][i, : w["lens"][i]], int(w["t"][i]), int(w["pos"][i]),
            int(w["strand"][i]), c.align_band, c.align_ma, c.align_mp, c.align_go,
            c.align_ge), i
    assert (got > 0).sum() >= B // 4


def test_score_pe_rows_matches_reference(world):
    """Dense PE rows over two mate batches: orphans with has = 0 on either
    side and dead rows score 0 on the absent side, as the reference's."""
    w = world
    half = len(w["lens"]) // 2
    # mate 2 of read i: the reverse complement of mate 1, at the same locus
    r1, l1 = w["codes"][:half], w["lens"][:half]
    r2 = np.full_like(r1, 5)
    for i in range(half):
        m = r1[i, : l1[i]][::-1]
        r2[i, : l1[i]] = np.where((m >= 1) & (m <= 4), 5 - m, 5)
    l2 = l1.copy()
    rng = np.random.default_rng(5)
    N = 24
    rid = rng.integers(0, half, N).astype(np.int32)
    t = w["t"][rid]
    p1, s1 = w["pos"][rid], w["strand"][rid]
    p2, s2 = p1.copy(), 1 - s1
    has1 = (rng.random(N) < 0.8).astype(np.int32)
    has2 = (rng.random(N) < 0.8).astype(np.int32)
    has1[:3], has2[3:6] = 0, 0
    live = np.arange(N) < N - 4
    want = ref_align.score_pe_rows(
        w["rdidx"], RefConfig(k=21, mapping_score=True), jnp.asarray(r1), jnp.asarray(l1),
        jnp.asarray(r2), jnp.asarray(l2), *(jnp.asarray(x) for x in (
            rid, t, p1, s1, has1, p2, s2, has2, live)))
    got = align.score_pe_rows(
        w["didx"], MapConfig(k=21, mapping_score=True), t_(r1), t_(l1.astype(np.int64)),
        t_(r2), t_(l2.astype(np.int64)),
        *(t_(x) for x in (rid, t, p1, s1, has1, p2, s2, has2, live)))
    for g, r in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert (got[0][:3] == 0).all() and (got[1][3:6] == 0).all() and (got[0][-4:] == 0).all()
    assert (got[0] > 0).any() and (got[1] > 0).any()


@pytest.mark.parametrize("cap", [1, 7, 40, 64])
def test_rid_from_counts_matches_reference(cap):
    """Reads without records, reads whose records start past the cap (cap 1
    and 7 overflow), and rows past the total."""
    counts = np.array([0, 3, 0, 0, 5, 1, 0, 2, 0, 4, 0, 0], np.int32)
    want = np.asarray(ref_rid_from_counts(jnp.asarray(counts), cap))
    got = rid_from_counts(t_(counts.astype(np.int64)), cap)
    assert got.shape == (cap,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(rid_from_counts(t_(np.zeros(5, np.int64)), 4).numpy(),
                          np.asarray(ref_rid_from_counts(jnp.zeros(5, jnp.int32), 4)))


# ---- a scalar model of csrc/align.cu's control flow -------------------------

NEG = -(1 << 20)


class AlignKernelModel:
    """One record of csrc/align.cu, in Python. Bands up to REG_BAND_MAX: the
    group build, G lanes a record (align.group_layout), lane l owning cells
    l*C .. l*C + C - 1, padding cells past 2b holding NEG and never written;
    the stage first (the window's text words as whole quad rows of text2q
    where the quad lies inside the table, else word by word, each index
    clipped; the oriented read codes; the L + G*C window chars, 5 outside the
    transcript and past the window), then each row: the next lane's first
    cell of the previous row by a shuffle down, the in-lane prefix max, the
    lanes' inclusive prefix max in log2(G) shuffle-up steps shifted one lane
    up, the cells written; the best by an xor reduction; `schedule` hands
    the rows out as the blocks do. Wider bands: the scratch build, one
    thread sweeping a ring of 2b+1 window chars read one at a time from a
    cached text word. Change it with the kernel."""

    def __init__(self, didx, reads, lens, band, ma, mp, go, ge):
        self.quads = didx.text2q.numpy().astype(np.int64) & 0xFFFFFFFF  # row i: words i..i+3
        self.words = self.quads[:, 0]
        self.ta = didx.txp_align.numpy()
        self.reads, self.lens = reads, lens
        self.band, self.ma, self.mp, self.go, self.ge = band, ma, mp, go, ge
        self.quad_loads = 0  # 16-byte quad rows staged
        self.word_loads = 0  # single words staged (a quad off the table) or cached

    def record(self, rid, t, pos, strand, valid) -> int:
        if not valid:
            return 0
        B, L = self.reads.shape
        rid = min(max(int(rid), 0), B - 1)
        t = min(max(int(t), 0), len(self.ta) - 1)
        rlen = int(self.lens[rid])
        n_rows = min(max(rlen, 0), L)
        row = self.reads[rid]
        tw, tsub, tlen = (int(x) for x in self.ta[t])
        start = int(pos) - self.band
        goff = tsub + start

        def read_code(i):
            if strand == 0:
                c = int(row[i])
            else:
                src = rlen - 1 - i
                if src < 0:
                    return 4
                v = int(row[min(src, L - 1)])
                c = 5 - v if 1 <= v <= 4 else 5
            return c - 1 if 1 <= c <= 4 else 4

        nw = len(self.words)
        if self.band > align.REG_BAND_MAX:
            return self._scratch(read_code, n_rows, start, goff, tw, tlen, nw)
        G, C = align.group_layout(self.band)
        W = L + 2 * self.band
        # the stage: words tw + wlo + m, as whole quads where they lie inside
        wlo = goff >> 4
        nwords = ((goff + W - 1) >> 4) - wlo + 1
        staged = []
        for q in range(-(-nwords // 4)):
            w0 = tw + wlo + 4 * q
            if w0 >= 0 and w0 + 3 < nw:
                staged += [int(x) for x in self.quads[w0]]
                self.quad_loads += 1
            else:
                staged += [int(self.words[min(max(w0 + u, 0), nw - 1)]) for u in range(4)]
                self.word_loads += 4
        codes = [read_code(i) for i in range(n_rows)]
        wc = []
        for j in range(L + G * C):
            p, g = start + j, goff + j
            wc.append((staged[(g >> 4) - wlo] >> (30 - 2 * (g & 15))) & 3
                      if j < W and 0 <= p < tlen else 5)
        return self._group(codes, wc, n_rows, G, C)

    def _group(self, codes, wc, n_rows, G, C):
        wb = 2 * self.band + 1
        go, ge, ma, mp = self.go, self.ge, self.ma, self.mp
        real = [[lane * C + j < wb for j in range(C)] for lane in range(G)]
        H = [[0 if real[lane][j] else NEG for j in range(C)] for lane in range(G)]
        E = [[NEG] * C for _ in range(G)]
        w = [[wc[lane * C + j - 1] if lane * C + j >= 1 else 5 for j in range(C)]
             for lane in range(G)]
        for i in range(n_rows):
            rcode = codes[i]
            own = [max(H[lane][0] - go, E[lane][0] - ge) for lane in range(G)]
            nxt = [own[lane + 1] if lane + 1 < G else own[lane] for lane in range(G)]  # shfl down
            q = [NEG] * G
            hnf, e2, pre = [[0] * C for _ in range(G)], [[0] * C for _ in range(G)], \
                [[0] * C for _ in range(G)]
            for lane in range(G):
                w[lane] = w[lane][1:] + [wc[i + lane * C + C - 1]]
                for j in range(C):
                    d = lane * C + j
                    e2[lane][j] = (max(H[lane][j + 1] - go, E[lane][j + 1] - ge) if j + 1 < C
                                   else nxt[lane])
                    hnf[lane][j] = max(H[lane][j] + (ma if w[lane][j] == rcode else mp),
                                       e2[lane][j])
                    pre[lane][j] = q[lane]
                    q[lane] = max(q[lane], hnf[lane][j] + d * ge)
            s = 1
            while s < G:  # shuffle-up scan of the lanes' totals
                q = [max(q[lane], q[lane - s]) if lane >= s else q[lane] for lane in range(G)]
                s <<= 1
            before = [NEG] + q[:-1]
            for lane in range(G):
                for j in range(C):
                    if real[lane][j]:
                        d = lane * C + j
                        f = max(before[lane], pre[lane][j]) - d * ge - (go - ge)
                        E[lane][j] = e2[lane][j]
                        H[lane][j] = max(hnf[lane][j], f)
        best = [max([H[lane][j] for j in range(C) if real[lane][j]], default=NEG)
                for lane in range(G)]
        s = G // 2
        while s:  # xor reduction
            best = [max(best[lane], best[lane ^ s]) for lane in range(G)]
            s //= 2
        return min(max(best[0], 0), (1 << 12) - 1)

    @staticmethod
    def schedule(valid, grid, threads, G):
        """The group build's rows, as its blocks hand them out: block b takes
        rows k * grid + b, a thread each a round of `threads` rows; a dead row
        gets its 0 from that thread, the live ones go through the block's
        list to its groups in turn -> {row: ("zero", b) or ("group", b, g)}."""
        N = len(valid)
        gpb = threads // G
        done = {}
        for b in range(grid):
            share = (N - 1 - b) // grid + 1 if N > b else 0
            for k0 in range(0, share, threads):
                rows = [k * grid + b for k in range(k0, min(k0 + threads, share))]
                live = [r for r in rows if valid[r]]  # ballot order, warp by warp
                for r in rows:
                    if not valid[r]:
                        assert r not in done
                        done[r] = ("zero", b)
                for e, r in enumerate(live):
                    assert r not in done
                    done[r] = ("group", b, e % gpb)
        return done

    def _scratch(self, read_code, n_rows, start, goff, tw, tlen, nw):
        cache = {"idx": -1, "word": 0}

        def window_char(j):
            p = start + j
            if p < 0 or p >= tlen:
                return 5
            g = goff + j
            wi = min(max(tw + (g >> 4), 0), nw - 1)
            if wi != cache["idx"]:
                cache["idx"], cache["word"] = wi, int(self.words[wi])
                self.word_loads += 1
            return (cache["word"] >> (30 - 2 * (g & 15))) & 3

        wb = 2 * self.band + 1
        H, E = [0] * wb, [NEG] * wb
        ring = [0] * wb  # slot j % wb holds char j
        for j in range(wb - 1):
            ring[j] = window_char(j)
        base = 0
        for i in range(n_rows):
            ring[base - 1 if base else wb - 1] = window_char(i + wb - 1)
            self._row(H, E, [ring[(base + d) % wb] for d in range(wb)], read_code(i), wb)
            base = (base + 1) % wb
        return min(max(max(H), 0), (1 << 12) - 1)

    def _row(self, H, E, wc, rcode, wb):
        go, ge, ma, mp = self.go, self.ge, self.ma, self.mp
        p = NEG
        for d in range(wb):
            hs = H[d + 1] if d + 1 < wb else NEG
            es = E[d + 1] if d + 1 < wb else NEG
            e2 = max(hs - go, es - ge)
            hnf = max(H[d] + (ma if wc[d] == rcode else mp), e2)
            f = p - d * ge - (go - ge)
            p = max(p, hnf + d * ge)
            E[d] = e2
            H[d] = max(hnf, f)


def _layout_edges():
    """The bands on either side of each change of csrc/align.cu's group
    layout, up to the first scratch band, less the cases listed by hand."""
    listed = {1, 5, 7, 15, 16, 40}
    edges = set()
    for b in range(2, align.REG_BAND_MAX + 2):
        before = align.group_layout(b - 1)
        after = align.group_layout(b) if b <= align.REG_BAND_MAX else None
        if after != before:
            edges |= {b - 1, b}
    return sorted(edges - listed)


@pytest.mark.parametrize("band,params", [
    (7, (2, -4, 5, 3)),
    (1, (2, -4, 5, 3)),
    (15, (2, -4, 5, 3)),
    (16, (2, -4, 5, 3)),
    (40, (2, -4, 5, 3)),
    (7, (1, -3, 4, 4)),    # go == ge
    (5, (3, -2, 9, 1)),
] + [(b, (2, -4, 5, 3)) for b in _layout_edges()])
def test_kernel_model_matches_plain(world, band, params):
    """The kernel's per-record control flow gives score_records_plain's
    scores on the toy index's records (rc strands, Ns, heads and tails off
    the transcripts, dead rows) plus ragged extra rows: read ids past B,
    a read longer than its row, a zero-length read, transcript ids past
    the last. Bands on either side of every change of the group layout
    (lanes a record, cells a lane) and the first scratch band."""
    w = world
    ma, mp, go, ge = params
    cfg = MapConfig(k=21, mapping_score=True, align_band=band, align_ma=ma, align_mp=mp,
                    align_go=go, align_ge=ge)
    B = len(w["lens"])
    lens = w["lens"].astype(np.int64).copy()
    lens[5], lens[6] = 0, 60  # no rows; longer than the 48 columns
    rid = np.concatenate([np.arange(B), [B + 3, -2, 6, 6]]).astype(np.int32)
    t = np.concatenate([w["t"], [1, 2, 99, 0]]).astype(np.int32)
    pos = np.concatenate([w["pos"], [10, -3, 4, 7]]).astype(np.int32)
    strand = np.concatenate([w["strand"], [1, 0, 1, 1]]).astype(np.int32)
    valid = np.concatenate([w["valid"], [True] * 4])
    plain = align.score_records_plain(w["didx"], cfg, t_(w["codes"]), t_(lens), t_(rid),
                                      t_(t), t_(pos), t_(strand), t_(valid)).numpy()
    model = AlignKernelModel(w["didx"], w["codes"], lens, band, ma, mp, go, ge)
    got = np.array([model.record(*r) for r in zip(rid, t, pos, strand, valid)])
    assert np.array_equal(got, plain)
    assert (plain > 0).sum() >= B // 4 and (plain[~valid] == 0).all()
    if band <= align.REG_BAND_MAX:  # every row once: live ones to a group, dead ones a 0
        G = align.group_layout(band)[0]
        for grid, threads in ((1, 256), (3, 32), (5, 64)):
            sched = AlignKernelModel.schedule(valid, grid, threads, G)
            assert sorted(sched) == list(range(len(valid)))
            assert all((v[0] == "group") == bool(valid[r]) for r, v in sched.items())
    W = 48 + 2 * band
    if band <= align.REG_BAND_MAX:
        # whole quads inside the table, single words at transcript 0's head
        assert model.quad_loads > 0 and model.word_loads > 0
        assert model.quad_loads + model.word_loads // 4 <= valid.sum() * ((W + 15) // 16 + 4) // 4
    else:  # the cached word serves 16 chars: ~(L + 2b) / 16 + 1 loads a record
        assert model.word_loads <= valid.sum() * (W // 16 + 2)


def test_wrapper_never_falls_back_off_the_cpu(world):
    """Tensors that are not all on the CPU take the kernel's path, which
    refuses anything but one CUDA device: no plain fallback, no launch."""
    w = world
    cfg = MapConfig(k=21, mapping_score=True)
    B = len(w["lens"])
    args = [t_(w["codes"]), t_(w["lens"].astype(np.int64)), t_(np.arange(B, dtype=np.int32)),
            t_(w["t"]), t_(w["pos"]), t_(w["strand"]), t_(w["valid"])]
    before = dict(kernels.LAUNCHES)
    for i in (0, 2, 6):
        mixed = list(args)
        mixed[i] = mixed[i].to("meta")
        with pytest.raises(ValueError, match="one CUDA device"):
            align.score_records(w["didx"], cfg, *mixed)
    assert kernels.LAUNCHES == before
    no_ta = w["didx"]._replace(txp_align=None)
    with pytest.raises(ValueError, match="txp_align"):
        align.score_records(no_ta, cfg, *args)
    assert "banded_scores" in kernels.LAUNCHES
