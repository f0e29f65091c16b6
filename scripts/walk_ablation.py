#!/usr/bin/env python3
"""Time the anchor-walk kernel (rapmap_tpu_torch/csrc/walk.cu) against
simpler forms of itself on one CUDA card.

    python3 scripts/walk_ablation.py [--parent DIR] [--rounds 2] [--seed 0]

Builds walk.cu as it stands (`as_is`) and with a design item swapped in or
out, each a text edit of the source that must apply exactly once:

  interleaved   the equal range's two searches interleaved, one trip of each
                per pass so that two row loads are in flight (tried, slower,
                not kept);
  global_words  query words and sa_cmp fields loaded from global memory
                where a compare uses them (4-byte loads), not into registers
                ahead of the compare: the anchor masks and the staged output
                alone;
  interleaved_global_words  both.

With --parent DIR it also builds DIR/rapmap_tpu_torch/csrc/walk.cu and times
it beside the others: a walk kernel of the anchor-mask interface, as this
one, or of the older interface that takes the lane-aligned anchor tables
(db2, de2, anc2 of ops/mmp.py anchor_tables) and a zero-filled hit buffer,
whose fill (`torch.zero_`) is then timed beside it.

Every build is checked against anchor_walk_plain on the smoke chunk of
chip_smoke.py's world (16,384 lanes of 76 bp, H = 16), on outputs that start
as 0xFF bytes. Then each launch is timed on the device under torch.profiler,
warm (100 launches back to back) and cold (50 launches, each after a 1 GiB
fill that evicts the L2), the builds in turn and in reverse turn for each
round. The other two builds of the kernel are timed the same way for this
walk.cu and the parent's (the text edits touch neither): the charwise build
(tqm_anchor_walk_charwise, strand-paired lanes of the same chunk on the full
upload, against anchor_walk_plain with the plain _extend) and the pseudo
build (tqm_pseudo_walk on the same chunk's intervals and masks, against
pseudo_walk_plain). Prints one JSON line; the card's name and power limit
are in it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- the simpler forms, as edits of walk.cu: (start marker, end marker, text
# ---- that replaces the source from the start marker up to the end marker)

INTERLEAVED = (
    "// Binary search in [lo, hi)",
    "// One trip's extension on the sharded index",
    """// Binary search in [lo, hi) for the first S_p >= Q, with the lcps of the
// last "less" and the last "not less" compare.
template <bool kCount>
__device__ int64_t lower_bound(const Index& ix, const Query& q, int qlen, int64_t lo, int64_t hi,
                               int steps, int& ll, int& lg, const Traffic& tr) {
  ll = 0;
  lg = 0;
  for (int t = 0; t < steps && lo < hi; ++t) {
    const int64_t mid = (lo + hi) >> 1;
    const Row row = load_row<kCount>(ix, mid, q.W, tr);
    int cmp, lcp;
    suffix_cmp<kCount>(ix, q, row, qlen, cmp, lcp, tr);
    if (cmp < 0) {
      ll = lcp;
      lo = mid + 1;
    } else {
      lg = lcp;
      hi = mid;
    }
  }
  return lo;
}

// The equal range: the first S_p >= Q in [lo1, hi1) and the first S_p > Q in
// [lo2, hi2), one trip of each per pass so that their row loads overlap.
template <bool kCount>
__device__ void equal_range(const Index& ix, const Query& q, int qlen, int64_t& lo1, int64_t hi1,
                            int64_t& lo2, int64_t hi2, int steps, const Traffic& tr) {
  for (int t = 0; t < steps && (lo1 < hi1 || lo2 < hi2); ++t) {
    const bool a1 = lo1 < hi1;
    const bool a2 = lo2 < hi2;
    const int64_t m1 = (lo1 + hi1) >> 1;
    const int64_t m2 = (lo2 + hi2) >> 1;
    Row r1{}, r2{};
    if (a1) r1 = load_row<kCount>(ix, m1, q.W, tr);
    if (a2) r2 = load_row<kCount>(ix, m2, q.W, tr);
    int cmp, lcp;
    if (a1) {
      suffix_cmp<kCount>(ix, q, r1, qlen, cmp, lcp, tr);
      if (cmp < 0) lo1 = m1 + 1; else hi1 = m1;
    }
    if (a2) {
      suffix_cmp<kCount>(ix, q, r2, qlen, cmp, lcp, tr);
      if (cmp <= 0) lo2 = m2 + 1; else hi2 = m2;
    }
  }
}

template <bool kCount>
__device__ void extend_lane(const Index& ix, const int64_t* words, const int64_t* nbad,
                            int64_t len, int64_t col_off, int64_t b0, int64_t e0,
                            int64_t pos, bool active, int k, int steps, int L, int W,
                            int64_t& b, int64_t& e, int64_t& mlen, const Traffic& tr) {
  Query q;
  q.words = words;
  q.base = pos + k + col_off;
  q.L = L;
  q.W = W;
  const int64_t end = len + col_off;
  load_query(q, static_cast<int>(clamp64(end - q.base, 0, L - k)));
  const int64_t nb =
      q.base < L ? load<kCount>(tr, kNextBad, nbad + clamp64(q.base, 0, L - 1)) : q.base;
  const int qlen = static_cast<int>(clamp64((nb < end ? nb : end) - q.base, 0, L - k));
  const int64_t b0a = active ? b0 : 0;
  const int64_t e0a = active ? e0 : 0;
  int ll, lg;
  const int64_t lb = lower_bound<kCount>(ix, q, qlen, b0a, e0a, steps, ll, lg, tr);
  const int l_left = lb > b0a ? ll : 0;
  const int l_right = lb < e0a ? lg : 0;
  int ext = l_left > l_right ? l_left : l_right;
  ext = ext < qlen ? ext : qlen;
  int64_t lb2 = l_left < ext ? lb : b0a;
  int64_t ub2 = lb;
  equal_range<kCount>(ix, q, ext, lb2, lb, ub2, l_right < ext ? lb : e0a, steps, tr);
  const bool ok = active && ub2 > lb2;
  b = ok ? lb2 : b0;
  e = ok ? ub2 : e0;
  mlen = ok ? k + ext : k;
}

""",
)

GLOBAL_WORDS = (
    "// One lane's query:",
    "// Binary search in [lo, hi)",
    """// One lane's query: the read suffix beyond depth k at column `base`.
struct Query {
  const int64_t* words;
  int64_t base;
  int L;
  int W;
};

template <bool kCount>
__device__ __forceinline__ uint32_t query_word(const Query& q, int j, const Traffic& tr) {
  const int64_t c = q.base + 16 * j;
  if (c >= q.L) return 0u;
  return static_cast<uint32_t>(load<kCount>(tr, kPreads, q.words + clamp64(c, 0, q.L - 1)));
}

__device__ __forceinline__ void load_query(Query&, int) {}

struct Row {
  const int32_t* p;
};

template <bool kCount>
__device__ __forceinline__ Row load_row(const Index& ix, int64_t slot, int, const Traffic& tr) {
  if constexpr (kCount) atomicAdd(tr.rows, 1ull);
  return Row{ix.sa_cmp + clamp64(slot, 0, ix.n_sa - 1) * (3 + ix.F)};
}

template <bool kCount>
__device__ __forceinline__ uint32_t raw_text_word(const Index& ix, int64_t wi0, int i,
                                                  const Traffic& tr) {
  const int64_t row = clamp64(wi0 + 4 * (i >> 2), 0, ix.nw - 1);
  return static_cast<uint32_t>(load<kCount>(tr, kText2q, ix.text2q + row * 4 + (i & 3)));
}

template <bool kCount>
__device__ uint32_t text_word(const Index& ix, const Row& row, int j, const Traffic& tr) {
  if (j < ix.F) return static_cast<uint32_t>(load<kCount>(tr, kSaCmp, row.p + 3 + j));
  const int64_t wi = load<kCount>(tr, kSaCmp, row.p);
  const int sh = load<kCount>(tr, kSaCmp, row.p + 1) << 1;
  const uint32_t r0 = raw_text_word<kCount>(ix, wi + ix.F, j - ix.F, tr);
  if (sh == 0) return r0;
  const uint32_t r1 = raw_text_word<kCount>(ix, wi + ix.F, j - ix.F + 1, tr);
  return (r0 << sh) | (r1 >> (32 - sh));
}

__device__ __forceinline__ bool cmp_word(uint32_t qw, uint32_t tw, int qlen, int tleft, int j,
                                         int& cmp, int& lcp) {
  int qn = qlen - 16 * j;
  qn = qn < 0 ? 0 : (qn > 16 ? 16 : qn);
  int tn = tleft - 16 * j;
  tn = tn < 0 ? 0 : (tn > 16 ? 16 : tn);
  const int n = qn < tn ? qn : tn;
  const uint32_t mask = n == 0 ? 0u : (0xFFFFFFFFu << (32 - 2 * n));
  const uint32_t qv = qw & mask;
  const uint32_t tv = tw & mask;
  const int diffpos = __clz(static_cast<int>(qv ^ tv)) >> 1;
  const bool has_diff = diffpos < n;
  lcp += has_diff ? diffpos : n;
  if (has_diff || tn < qn || qn < 16) {
    cmp = has_diff ? (tv < qv ? -1 : 1) : (tn < qn ? -1 : 0);
    return true;
  }
  return false;
}

template <bool kCount>
__device__ __forceinline__ void suffix_cmp(const Index& ix, const Query& q, const Row& row,
                                           int qlen, int& cmp, int& lcp, const Traffic& tr) {
  cmp = 0;
  lcp = 0;
  const int tleft = load<kCount>(tr, kSaCmp, row.p + 2);
  for (int j = 0; j < q.W; ++j) {
    const bool used = 16 * j < qlen && 16 * j < tleft;
    const uint32_t tw = used ? text_word<kCount>(ix, row, j, tr) : 0u;
    const uint32_t qw = used ? query_word<kCount>(q, j, tr) : 0u;
    if (cmp_word(qw, tw, qlen, tleft, j, cmp, lcp)) return;
  }
}

""",
)

VARIANTS = {
    "as_is": (),
    "interleaved": (INTERLEAVED,),
    "global_words": (GLOBAL_WORDS,),
    "interleaved_global_words": (INTERLEAVED, GLOBAL_WORDS),
}


def edit(src: str, edits) -> str:
    for start, end, text in edits:
        if src.count(start) != 1 or src.count(end) != 1:
            raise RuntimeError(f"walk.cu no longer has one {start!r} and one {end!r}")
        a, b = src.index(start), src.index(end)
        src = src[:a] + text + src[b:]
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout whose csrc/walk.cu to time beside this one")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("walk_ablation: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rapmap_tpu_torch import kernels
    from rapmap_tpu_torch.config import MapConfig
    from rapmap_tpu_torch.ops.device_index import upload_index
    from rapmap_tpu_torch.ops.extend_packed import ext_words
    from rapmap_tpu_torch.ops.mmp import (
        anchor_tables, anchor_walk_plain, dense_phase, pseudo_walk_plain, scan_inputs,
        walk_params,
    )

    out = os.path.join(ROOT, "build", "ablation")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(ROOT, "rapmap_tpu_torch", "csrc", "walk.cu")) as f:
        src = f.read()
    sources = {}
    for name, edits in VARIANTS.items():
        sources[name] = os.path.join(out, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(edit(src, edits))
    parent_tables = False
    if args.parent:
        sources["parent"] = os.path.join(args.parent, "rapmap_tpu_torch", "csrc", "walk.cu")
        with open(sources["parent"]) as f:  # the mask interface names the rc mask anch_r
            parent_tables = "anch_r" not in f.read()
    procs = {n: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", os.path.join(out, f"{n}.so"), p],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n, p in sources.items()}

    # the smoke chunk of chip_smoke.py: its world, its first 8,192 reads
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    idx, codes, lens, _, _ = cs.build_world(args.seed, 10_000, 262_144, work)
    for n, p in procs.items():
        log, _ = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"nvcc {n} failed:\n{log}")
    libs = {n: ctypes.CDLL(os.path.join(out, f"{n}.so")) for n in sources}

    dev = torch.device("cuda")
    didx, st = upload_index(idx, dev, lean=True)
    cfg = MapConfig(k=cs.K)
    C = 8192
    w = dense_phase(didx, st, torch.from_numpy(codes[:C]).to(dev),
                    torch.from_numpy(lens[:C].astype(np.int64)).to(dev), cfg)
    prm = walk_params(st, cfg)
    want = anchor_walk_plain(didx, *w, **prm)
    R, L = w.preads.shape
    S, H, k = w.bf.shape[1], prm["H"], prm["k"]
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    buf = torch.empty((R, H, 4), dtype=torch.int64, device=dev)
    n_out = torch.empty((R,), dtype=torch.int64, device=dev)
    trunc = torch.empty((R,), dtype=torch.uint8, device=dev)
    tail = [didx.sa_cmp.data_ptr(), didx.sa_cmp.shape[0], didx.sa_cmp.shape[1] - 3,
            didx.text2q.data_ptr(), didx.text2q.shape[0], R, R // 2, L, S, k, H,
            prm["ext_steps"], ext_words(L, k), buf.data_ptr(), n_out.data_ptr(),
            trunc.data_ptr(), torch.cuda.current_stream().cuda_stream]
    tables = anchor_tables(*w[4:])

    def launcher(name):
        fn = libs[name].tqm_anchor_walk
        fn.restype = ctypes.c_int
        tabled = name == "parent" and parent_tables
        head = [t.data_ptr() for t in (w[:4] + tables if tabled else w)]
        fn.argtypes = [vp] * (len(head) + 1) + [i64, i32, vp, i64, i64, i64] + [i32] * 6 + [vp] * 4
        args_ = head + tail

        def go():
            if fn(*args_):
                raise RuntimeError(f"{name}: launch failed")
        return go

    gos = {n: launcher(n) for n in sources}
    res = {}
    for name, go in gos.items():
        for t, ff in ((buf, -1), (n_out, -1), (trunc, 0xFF)):
            # a parent of the anchor-table interface needs a zeroed buffer
            t.fill_(0 if name == "parent" and parent_tables else ff)
        go()
        torch.cuda.synchronize()
        got = (buf[..., 0], buf[..., 1], buf[..., 2], buf[..., 3], n_out, trunc.bool())
        res[name] = dict(equal_plain=all(bool(torch.equal(a, b)) for a, b in zip(got, want)),
                         warm_ms=[], cold_ms=[])

    # the charwise and pseudo builds of this walk.cu and the parent's
    fdidx, fst = upload_index(idx, dev)  # the full upload: flat sa and text
    ccfg = MapConfig(k=cs.K, packed_extension=False)
    cw, ckw = scan_inputs(fdidx, fst, torch.from_numpy(codes[:C]).to(dev),
                          torch.from_numpy(lens[:C].astype(np.int64)).to(dev), ccfg)
    cprm = {x: ckw[x] for x in ("k", "H", "ext_steps")}

    def lanes(x):  # what the charwise and pseudo builds read of a walk's inputs
        return [x.lens2, x.bf, x.ef, x.br, x.er, x.anch_f, x.anch_rF]

    other_want = {"charwise": anchor_walk_plain(fdidx, *cw, **cprm, codes=ckw["codes"]),
                  "pseudo": pseudo_walk_plain(*lanes(w), k=k, H=H)}
    ctail = [fdidx.sa.data_ptr(), fdidx.sa.shape[0], fdidx.text.data_ptr(),
             fdidx.text.shape[0], R, R // 2, L, S, k, H, cprm["ext_steps"], buf.data_ptr(),
             n_out.data_ptr(), trunc.data_ptr(), torch.cuda.current_stream().cuda_stream]

    def other_launcher(name, kind):
        lib = libs[name]
        if kind == "charwise":
            fn = lib.tqm_anchor_walk_charwise
            fn.argtypes = [vp] * 9 + [i64, vp, i64, i64, i64] + [i32] * 5 + [vp] * 4
            args_ = [ckw["codes"].data_ptr(), *(t.data_ptr() for t in lanes(cw))] + ctail
        else:
            fn = lib.tqm_pseudo_walk
            fn.argtypes = [vp] * 7 + [i64, i64] + [i32] * 3 + [vp] * 4
            args_ = [t.data_ptr() for t in lanes(w)] + [R, R // 2, S, k, H, buf.data_ptr(),
                                                       n_out.data_ptr(), trunc.data_ptr(),
                                                       torch.cuda.current_stream().cuda_stream]
        fn.restype = ctypes.c_int

        def go():
            if fn(*args_):
                raise RuntimeError(f"{name} {kind}: launch failed")
        return go

    others = {}
    for kind in ("charwise", "pseudo"):
        for name in ("as_is", "parent") if args.parent else ("as_is",):
            go = other_launcher(name, kind)
            for t, ff in ((buf, -1), (n_out, -1), (trunc, 0xFF)):
                t.fill_(ff)
            go()
            torch.cuda.synchronize()
            got = (buf[..., 0], buf[..., 1], buf[..., 2], buf[..., 3], n_out, trunc.bool())
            others[(kind, name)] = dict(
                go=go, res=dict(equal_plain=all(bool(torch.equal(a, b)) for a, b in
                                                zip(got, other_want[kind])),
                                warm_ms=[], cold_ms=[]))

    flush = torch.empty(1 << 28, dtype=torch.int32, device=dev)

    def kernel_ms(work, key):
        """Mean device ms of the kernels whose name holds `key` in work(),
        under torch.profiler; a profiled window that recorded none of them
        (the profiler now and then drops every device event of one) runs
        again, three times at most."""
        for _ in range(3):
            v = [v for n, v in cs.device_kernels(work).items() if key in n]
            if v:
                return sum(x[0] for x in v) / sum(x[1] for x in v)
        raise RuntimeError(f"torch.profiler recorded no {key} kernel in three tries")

    for rnd in range(args.rounds):
        for name in (list(gos) if rnd % 2 == 0 else list(gos)[::-1]):
            go = gos[name]
            res[name]["warm_ms"].append(kernel_ms(lambda: [go() for _ in range(100)],
                                                  "anchor_walk_kernel"))

            def cold():
                for _ in range(50):
                    flush.fill_(1)
                    go()
            res[name]["cold_ms"].append(kernel_ms(cold, "anchor_walk_kernel"))
        for key in (list(others) if rnd % 2 == 0 else list(others)[::-1]):
            go = others[key]["go"]
            others[key]["res"]["warm_ms"].append(kernel_ms(lambda: [go() for _ in range(100)],
                                                           "anchor_walk_kernel"))

            def cold():
                for _ in range(50):
                    flush.fill_(1)
                    go()
            others[key]["res"]["cold_ms"].append(kernel_ms(cold, "anchor_walk_kernel"))
    for (kind, name), v in others.items():
        res[f"{kind}_{name}"] = v["res"]
    if parent_tables:  # the parent's wrapper zeroed the hit buffer before each launch
        res["parent"]["fill_ms"] = [kernel_ms(lambda: [buf.zero_() for _ in range(100)],
                                              "elementwise") for _ in range(args.rounds)]
    print(json.dumps({"device": cs.nvidia_smi_line(), "lanes": R, "read_len": L, "hit_slots": H,
                      "variants": res}), flush=True)
    return 0 if all(v["equal_plain"] for v in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
