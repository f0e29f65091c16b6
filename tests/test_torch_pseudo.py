"""rapmap_tpu_torch's pseudo path (index/builder.build_pseudo_index,
models/pseudo.py, ops/mmp.pseudo_walk) against rapmap_tpu on the CPU, integer
for integer (tolerance zero): twins of the four cases of tests/test_pseudo.py,
plus both builders' arrays, the uploaded tensors, the wire buffers (SE chunked
and unchunked, PE), the ScanHits of `pseudo_scan_dispatch` for both lane kinds
(hit tables compared modulo 2^32: the reference carries occurrence ids as
int32 bit patterns, the port as their uint32 values), the same on an index
without a CHD (binary-search probe, explicit lanes), a scalar per-lane model
of the kernel's pseudo build (csrc/walk.cu, no extension) against the plain
walks, and the wrapper's refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapmap_tpu.config import MapConfig as RefConfig
from rapmap_tpu.index.builder import build_pseudo_index as ref_build
from rapmap_tpu.index.format import load_index as ref_load
from rapmap_tpu.models.pseudo import PseudoMapper as RefMapper
from rapmap_tpu.models.pseudo import pseudo_scan_dispatch as ref_dispatch
from rapmap_tpu.models.pseudo import upload_pseudo_index as ref_upload
from rapmap_tpu.oracle import pseudomap as ref_pm
from rapmap_tpu_torch import kernels
from rapmap_tpu_torch.config import MapConfig
from rapmap_tpu_torch.index.builder import build_pseudo_index
from rapmap_tpu_torch.index.encode import encode_reads
from rapmap_tpu_torch.index.format import PseudoIndex, load_index
from rapmap_tpu_torch.models.pseudo import (
    PseudoMapper, pseudo_dense_lanes, pseudo_dense_paired, pseudo_scan_dispatch,
    upload_pseudo_index,
)
from rapmap_tpu_torch.ops import encode as denc
from rapmap_tpu_torch.ops.mmp import (
    ScanHits, pseudo_walk, pseudo_walk_lanes_plain, pseudo_walk_plain,
)
from rapmap_tpu_torch.oracle import pseudomap as pm
from tests.test_device_parity import batch_of
from tests.test_torch_walk import MaskModel, clamp, next_anchor_pos
from tests.util import BASES, random_transcriptome, sample_reads, write_fasta
from tests.test_torch_pe import jax_cache_off  # noqa: F401

M32 = 0xFFFFFFFF
ARRAYS = ("kmer_hi", "kmer_lo", "kmer_off", "occ_txp", "occ_pos", "txp_offsets", "txp_lens",
          "chd_dir", "chd_perm", "chd_cls")


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def without_chd(idx):
    meta = {k: v for k, v in idx.meta.items() if k != "chd"}
    return dataclasses.replace(idx, chd_dir=None, chd_perm=None, chd_cls=None, meta=meta)


@pytest.fixture(scope="module")
def pidx(tmp_path_factory):
    """tests/test_pseudo.py's world (6 transcripts of 120-300 bp, k = 11),
    built by both packages; each saves its index, the other loads it."""
    rng = np.random.default_rng(21)
    tmp = tmp_path_factory.mktemp("tpseudo")
    txps = random_transcriptome(rng, n_txps=6, min_len=120, max_len=300)
    fa = write_fasta(str(tmp / "p.fa"), txps)
    ref = ref_build(fa, outdir=str(tmp / "ref_idx"), k=11)
    idx = build_pseudo_index(fa, outdir=str(tmp / "idx"), k=11)
    return idx, ref, txps, tmp


def test_builders_equal_and_indexes_load_in_both(pidx):
    idx, ref, _, tmp = pidx
    assert isinstance(idx, PseudoIndex) and idx.meta == ref.meta and idx.meta["chd"]["canonical"]
    for name in ARRAYS:
        assert np.array_equal(getattr(idx, name), getattr(ref, name)), name
        assert getattr(idx, name).dtype == getattr(ref, name).dtype, name
    assert idx.txp_names == ref.txp_names and idx.k == ref.k and idx.seed == ref.seed
    theirs = load_index(str(tmp / "ref_idx"), verify=True)
    ours = ref_load(str(tmp / "idx"), verify=True)
    assert isinstance(theirs, PseudoIndex)
    for name in ARRAYS:
        assert np.array_equal(getattr(theirs, name), getattr(ref, name)), name
        assert np.array_equal(getattr(ours, name), getattr(idx, name)), name
    assert theirs.meta == ref.meta and ours.meta == idx.meta


@pytest.mark.parametrize("kind", ["chd", "big_occ", "no_chd"])
def test_upload_equals_reference(pidx, kind):
    """The uploaded tensors equal the reference's DevicePseudoIndex element
    for element (int32, the occ_pairs layout included), and so do the
    static facts."""
    idx, ref, _, _ = pidx
    if kind == "no_chd":
        idx, ref = without_chd(idx), without_chd(ref)
    pairs = kind == "big_occ"
    rdidx, rst = ref_upload(ref, force_pairs=pairs)
    didx, st = upload_pseudo_index(idx, "cpu", force_pairs=pairs)
    for name in rdidx._fields:
        want, got = getattr(rdidx, name), getattr(didx, name)
        if want is None:
            assert got is None, name
            continue
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want)), name
    assert dataclasses.asdict(st) == dataclasses.asdict(rst)
    assert st.occ_pairs == pairs and st.chd_canonical == (kind != "no_chd")


def test_pseudo_oracle_exact_reads(pidx):
    """Twin of test_pseudo.py::test_pseudo_oracle_exact_reads on the port's
    oracle, which also equals the reference's read for read."""
    rng = np.random.default_rng(2)
    idx, ref, txps, _ = pidx
    for name, seq, t, p, was_rc in sample_reads(rng, txps, 40, read_len=44):
        read = encode_reads(np.frombuffer(seq, dtype=np.uint8))
        maps = pm.map_read(idx, read)
        assert (t, p, not was_rc) in [(m.txp, m.pos, m.fwd) for m in maps], name
        assert [tuple(vars(m).values()) for m in maps] == [
            tuple(vars(m).values()) for m in ref_pm.map_read(ref, read)]


def _cfg(idx, **kw):
    base = dict(k=idx.k, max_hits_per_strand=8, expand_budget=2048, max_out=256)
    base.update(kw)
    return MapConfig(**base), RefConfig(**base)


def test_pseudo_device_parity(pidx):
    """Twin of test_pseudo.py::test_pseudo_device_parity: map_se against the
    port's oracle, and MapOut and Counters equal to the reference's."""
    rng = np.random.default_rng(4)
    idx, ref, txps, _ = pidx
    reads = sample_reads(rng, txps, 32, read_len=44, error_rate=0.03, n_frac=0.01)
    seqs = [r[1] for r in reads] + [BASES[rng.integers(0, 4, 44)].tobytes()]
    cfg, rcfg = _cfg(idx)
    codes, lens = batch_of(seqs, 44)
    out, ctr = PseudoMapper(idx, cfg, device="cpu").map_se(codes, lens)
    assert not out.over_budget.any()
    for i in range(len(seqs)):
        want = pm.map_read(idx, codes[i][: lens[i]], cfg)
        got = [(int(out.t[i, j]), int(out.pos[i, j]), out.strand[i, j] == 0,
                int(out.score[i, j])) for j in range(out.t.shape[1]) if out.t[i, j] != -1]
        assert got == [(m.txp, m.pos, m.fwd, m.score) for m in want], f"read {i}"
    rout, rctr = RefMapper(ref, rcfg).map_se(codes, lens)
    for name, a, b in zip(out._fields, out, rout):
        assert np.array_equal(a, np.asarray(b)), name
    for name, a, b in zip(ctr._fields, ctr, rctr):
        assert int(a) == int(b), name


def _pairs(rng, txps, n, L):
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    pairs = []
    for _ in range(n):
        seq = txps[int(rng.integers(0, len(txps)))][1]
        if len(seq) < 150:
            continue
        p1 = int(rng.integers(0, len(seq) - 140))
        pairs.append((seq[p1 : p1 + L], seq[p1 + 100 - L : p1 + 100].translate(comp)[::-1]))
    return pairs


def test_pseudo_device_parity_pe(pidx):
    """Twin of test_pseudo.py::test_pseudo_device_parity_pe: map_pe against
    the port's oracle, and every PairOut field equal to the reference's."""
    rng = np.random.default_rng(6)
    idx, ref, txps, _ = pidx
    L = 40
    pairs = _pairs(rng, txps, 12, L)
    cfg, rcfg = _cfg(idx)
    c1, l1 = batch_of([p[0] for p in pairs], L)
    c2, l2 = batch_of([p[1] for p in pairs], L)
    _, _, po, _ = PseudoMapper(idx, cfg, device="cpu").map_pe(c1, l1, c2, l2)
    for i in range(len(pairs)):
        want, conc = pm.map_pair(idx, c1[i][: l1[i]], c2[i][: l2[i]], cfg)
        assert bool(po.concordant[i]) == conc
        got = [(int(po.t[i, j]), int(po.p1[i, j]) if po.has1[i, j] else None,
                int(po.p2[i, j]) if po.has2[i, j] else None)
               for j in range(po.t.shape[1]) if po.t[i, j] != -1]
        assert got == [(m.txp, m.pos1, m.pos2) for m in want], f"pair {i}"
    _, _, rpo, _ = RefMapper(ref, rcfg).map_pe(c1, l1, c2, l2)
    for name, a, b in zip(po._fields, po, rpo):
        assert np.array_equal(a, np.asarray(b)), name


def _wire_world(tmp, seed=91):
    """test_pseudo.py::test_pseudo_wire_chunked_matches_unchunked's world:
    5 transcripts of 150-300 bp, 29 reads of 40 bp and 3 empty pad rows."""
    rng = np.random.default_rng(seed)
    txps = random_transcriptome(rng, n_txps=5, min_len=150, max_len=300)
    fa = write_fasta(str(tmp / "w.fa"), txps)
    reads = sample_reads(rng, txps, 29, read_len=40, error_rate=0.02)
    codes, lens = batch_of([r[1] for r in reads] + [b""] * 3, 40)
    return fa, txps, codes, lens, len(reads)


def _ref_wire(m, handle):
    return np.asarray(handle[2])


def test_pseudo_wire_chunked_matches_unchunked(tmp_path):
    """Twin of test_pseudo.py::test_pseudo_wire_chunked_matches_unchunked:
    the chunked wire equals the unchunked one (records, counts, flags,
    counters); and each raw wire buffer equals the reference's."""
    fa, _, codes, lens, nv = _wire_world(tmp_path)
    idx, ref = build_pseudo_index(fa, k=11), ref_build(fa, k=11)
    base = dict(k=11, max_hits_per_strand=30, expand_budget=512)
    res = {}
    for C in (0, 8):
        m = PseudoMapper(idx, MapConfig(**base, chunk=C), device="cpu")
        h = m.map_se_async(codes, lens, n_valid=nv)
        assert h.C == C
        rm = RefMapper(ref, RefConfig(**base, chunk=C))
        assert np.array_equal(h.wire.numpy(), _ref_wire(rm, rm.map_se_async(codes, lens,
                                                                             n_valid=nv)))
        res[C] = m.fetch(h)
    w1, w2 = res[0], res[8]
    assert w1.counters == w2.counters and w1.counters["reads_mapped"] > 20
    assert np.array_equal(w1.counts, w2.counts)
    assert np.array_equal(w1.flags, w2.flags)
    assert np.array_equal(w1.recs, w2.recs)


@pytest.mark.parametrize("index", ["chd", "no_chd"])
def test_pe_wire_and_nochd_se_wire_equal_reference(pidx, index):
    """The PE wire (one program over the batch, as the reference's only PE
    program) equals the reference's; without the CHD (binary-search probe,
    explicit lanes) so do the SE wires, chunked and unchunked."""
    rng = np.random.default_rng(17)
    idx, ref, txps, _ = pidx
    if index == "no_chd":
        idx, ref = without_chd(idx), without_chd(ref)
    L = 40
    pairs = _pairs(rng, txps, 20, L)[:16]
    c1, l1 = batch_of([p[0] for p in pairs], L)
    c2, l2 = batch_of([p[1] for p in pairs], L)
    cfg, rcfg = _cfg(idx, chunk=8)
    m, rm = PseudoMapper(idx, cfg, device="cpu"), RefMapper(ref, rcfg)
    assert m.st.chd_canonical == (index == "chd")
    h = m.map_pe_async(c1, l1, c2, l2, n_valid=14)
    assert h.C == 0
    assert np.array_equal(h.wire.numpy(), _ref_wire(rm, rm.map_pe_async(c1, l1, c2, l2,
                                                                         n_valid=14)))
    assert m.fetch(h).counters["reads_mapped"] >= 12
    if index == "no_chd":
        for mm, rr in ((m, rm), (PseudoMapper(idx, _cfg(idx)[0], device="cpu"),
                                 RefMapper(ref, _cfg(ref)[1]))):
            got = mm.map_se_async(c1, l1, n_valid=15).wire.numpy()
            assert np.array_equal(got, _ref_wire(rr, rr.map_se_async(c1, l1, n_valid=15)))


# ---- the scan: hits of both lane kinds, against the reference ---------------

@pytest.fixture(scope="module")
def scan_world(pidx):
    """Reads of the pidx world: mixed lengths up to 60 with errors and Ns, an
    all-N read, reads shorter than k, one of length k, empty pad rows."""
    rng = np.random.default_rng(33)
    idx, ref, txps, _ = pidx
    seqs = []
    for rl in (20, 35, 60):
        seqs += [r[1] for r in sample_reads(rng, txps, 8, read_len=rl, error_rate=0.03,
                                            n_frac=0.03)]
    seqs += [b"N" * 60, b"ACGTACG", txps[1][1][5:16], b"", b""]
    codes, lens = batch_of(seqs, 60)
    assert (lens == 0).any() and (lens < idx.k).any() and (lens == idx.k).any()
    return codes, lens


def _hits_equal(got: ScanHits, want, mod32: bool):
    for name in ScanHits._fields:
        g = np.asarray(getattr(got, name)).astype(np.int64)
        w = np.asarray(getattr(want, name)).astype(np.int64)
        if mod32 and name in ("b", "e"):
            w = w & M32  # the reference's int32 bit patterns as uint32 values
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("H", [1, 2, 16])
@pytest.mark.parametrize("index", ["chd", "no_chd"])
def test_scan_dispatch_equals_reference(pidx, scan_world, index, H):
    """pseudo_scan_dispatch's ScanHits equal the reference's, all six
    fields (b, e modulo 2^32), strand-paired lanes on the canonical CHD and
    explicit lanes without it; H = 1 and 2 truncate."""
    idx, ref, _, _ = pidx
    if index == "no_chd":
        idx, ref = without_chd(idx), without_chd(ref)
    codes, lens = scan_world
    cfg, rcfg = _cfg(idx, max_hits_per_strand=H)
    didx, st = upload_pseudo_index(idx, "cpu")
    rdidx, rst = ref_upload(ref)
    want = jax.jit(ref_dispatch, static_argnums=(1, 4))(
        rdidx, rst, jnp.asarray(codes), jnp.asarray(lens), rcfg)
    kernels.reset_launches()
    got = pseudo_scan_dispatch(didx, st, t_(codes), t_(lens), cfg)
    assert not any(kernels.LAUNCHES.values())
    _hits_equal(got, want, mod32=True)
    assert int(got.n.max()) >= min(H, 2)
    if H <= 2:
        assert bool(got.truncated.any())


# ---- a scalar model of the kernel's pseudo build: one lane at a time --------

def pseudo_lane_model(w, k: int, H: int, paired: bool) -> ScanHits:
    """csrc/walk.cu built without an extension, lane by lane: anchors by a
    bit scan of the mask row (forward lanes the next, rc lanes the previous
    in mirrored columns), a hit [posc, k, b, e] from the anchor's interval
    column, then a jump of k."""
    R, S = w.lens2.shape[0], w.bf.shape[1]
    B = R // 2 if paired else R
    buf = np.zeros((R, H, 4), np.int64)
    n_out = np.zeros(R, np.int64)
    trunc = np.zeros(R, bool)
    for r in range(R):
        is_rc = r >= B
        rr = r - B if is_rc else r
        db, de, anch = (w.br, w.er, w.anch_rF) if is_rc else (w.bf, w.ef, w.anch_f)
        mask = MaskModel(anch[rr].numpy())
        ln = int(w.lens2[r])
        pos = next_anchor_pos(mask, is_rc, ln, k, 0)
        n = 0
        while pos < S:
            if n >= H:
                trunc[r] = True
                break
            posc = clamp(pos, 0, S - 1)
            col = clamp(ln - k - posc if is_rc else posc, 0, S - 1)
            buf[r, n] = (posc, k, int(db[rr, col]), int(de[rr, col]))
            n += 1
            pos = next_anchor_pos(mask, is_rc, ln, k, posc + k)
        n_out[r] = n
    return ScanHits(buf[..., 0], buf[..., 1], buf[..., 2], buf[..., 3], n_out, trunc)


@pytest.fixture(scope="module")
def rep_world(tmp_path_factory):
    """tests/test_bigocc.py's repetitive world (an 80-base segment shared by
    5 transcripts, k = 11: its k-mers occur 5 times) with the scan world's
    kinds of reads."""
    rng = np.random.default_rng(21)
    base = random_transcriptome(rng, n_txps=5, min_len=150, max_len=250)
    shared = base[0][1][20:100]
    txps = [(f"t{i}", s[:25] + shared + s[25:]) for i, (_, s) in enumerate(base)]
    idx = build_pseudo_index(write_fasta(str(tmp_path_factory.mktemp("rep") / "t.fa"), txps),
                             k=11)
    seqs = [r[1] for r in sample_reads(rng, txps, 24, read_len=50, error_rate=0.02,
                                       n_frac=0.02)]
    seqs += [b"N" * 60, b"ACGTACG", txps[1][1][5:16], b"", txps[2][1][:60]]
    codes, lens = batch_of(seqs, 60)
    return idx, codes, lens


@pytest.mark.parametrize("H", [1, 2, 16])
@pytest.mark.parametrize("paired", [True, False])
def test_kernel_model_matches_plain(rep_world, paired, H):
    """The kernel's control flow, lane by lane, gives what the lockstep plain
    version gives, for both lane kinds, on reads with Ns, lengths 0, < k and
    k, and with a max_interval of 3 that drops the shared k-mers (width 5)
    from the anchors; the wrapper takes the plain version on CPU tensors and
    counts no launch."""
    idx, codes, lens = rep_world
    cfg = MapConfig(k=idx.k, max_hits_per_strand=H, max_interval=3)
    ln = t_(lens.astype(np.int64))
    if paired:
        didx, st = upload_pseudo_index(idx, "cpu")

        def dense(c):
            return pseudo_dense_paired(didx, st, t_(codes), ln, c)
    else:
        didx, st = upload_pseudo_index(without_chd(idx), "cpu")
        lanes = torch.cat([t_(codes), denc.revcomp_batch(t_(codes), ln)])

        def dense(c):
            return pseudo_dense_lanes(didx, st, lanes, torch.cat([ln, ln]), c)
    w = dense(cfg)
    wide = dense(dataclasses.replace(cfg, max_interval=1000))
    assert bool((wide.anch_f & ~w.anch_f).any())  # the width bound dropped some
    kernels.reset_launches()
    want = pseudo_walk(*w, k=idx.k, H=H, paired=paired)
    assert not any(kernels.LAUNCHES.values())
    plain = pseudo_walk_plain if paired else pseudo_walk_lanes_plain
    _hits_equal(want, plain(*w, k=idx.k, H=H), mod32=False)
    _hits_equal(pseudo_lane_model(w, idx.k, H, paired), want, mod32=False)
    assert int(want.n.sum()) > 0


# ---- the wrapper refuses what the kernel does not take -----------------------

@pytest.mark.parametrize("case, err", [
    ("dtype_interval", TypeError), ("dtype_mask", TypeError), ("shape_rows", ValueError),
    ("shape_dense", ValueError), ("non_contiguous", ValueError),
    ("mixed_devices", ValueError), ("no_kernel_for_device", ValueError),
])
def test_pseudo_walk_wrapper_refuses(pidx, scan_world, case, err):
    """Off the CPU the wrapper never takes the plain version: it checks
    device, dtype, shape and contiguity and raises. Tensors on the meta
    device stand in for a device that is not the CPU."""
    idx, _, _, _ = pidx
    codes, lens = scan_world
    didx, st = upload_pseudo_index(idx, "cpu")
    cpu_w = pseudo_dense_paired(didx, st, t_(codes), t_(lens), _cfg(idx)[0])
    w = cpu_w._replace(**{f: torch.empty_like(t, device="meta")
                          for f, t in cpu_w._asdict().items()})
    if case == "dtype_interval":
        w = w._replace(bf=w.bf.to(torch.int32))
    elif case == "dtype_mask":
        w = w._replace(anch_rF=w.anch_rF.to(torch.uint8))
    elif case == "shape_rows":
        w = w._replace(lens2=w.lens2[:-1])
    elif case == "shape_dense":
        w = w._replace(er=w.er[:, :-1].contiguous())
    elif case == "non_contiguous":
        B, S = w.ef.shape
        w = w._replace(ef=torch.empty((S, B), dtype=torch.int64, device="meta").T)
    elif case == "mixed_devices":
        w = w._replace(bf=cpu_w.bf)
    kernels.reset_launches()
    with pytest.raises(err):
        pseudo_walk(*w, k=idx.k, H=16, paired=True)
    assert not any(kernels.LAUNCHES.values())
